"""Gradient-descent solvers as pure update rules on torch tensors.

The port's copy of ``veles_tpu/znicz/solvers.py`` (the Znicz solver
knobs: momentum, AdaGrad, AdaDelta, RProp, L1/L2 blending,
``factor_ortho``).  Each solver is a pair of functions:

- ``init(param) -> state``  (a tuple of tensors, may be empty)
- ``update(grad, param, state, lr) -> (delta, new_state)`` where the caller
  applies ``param + delta``.

The arithmetic is the JAX package's, term for term, so the two packages
round alike.
"""

import torch

__all__ = ["regularized_grad", "Solver", "SGD", "Momentum", "AdaGrad",
           "AdaDelta", "RProp", "factory"]


def regularized_grad(grad, param, weights_decay, l1_vs_l2,
                     factor_ortho=0.0):
    """Add the L1/L2-blended decay term (and optional soft-orthogonality
    push) to a raw gradient.

    reg = decay * ((1 - l1_vs_l2) * w + l1_vs_l2 * sign(w) / 2)
    following the Znicz blending convention; ortho term is the gradient of
    ``factor_ortho/4 * ||W^T W - I||^2`` for 2-D weights.
    """
    g = grad
    if weights_decay:
        g = g + weights_decay * ((1.0 - l1_vs_l2) * param +
                                 0.5 * l1_vs_l2 * torch.sign(param))
    if factor_ortho and param.ndim == 2:
        wtw = param.T @ param
        eye = torch.eye(wtw.shape[0], dtype=param.dtype, device=param.device)
        g = g + factor_ortho * (param @ (wtw - eye))
    return g


class Solver:
    name = None

    def __init__(self, **hyper):
        self.hyper = hyper

    def init(self, param):
        return ()

    def update(self, grad, param, state, lr):
        raise NotImplementedError


class SGD(Solver):
    name = "sgd"

    def update(self, grad, param, state, lr):
        return -lr * grad, state


class Momentum(Solver):
    """Classic heavy-ball: v = mu*v - lr*g; w += v (Znicz
    ``gradient_moment``)."""

    name = "momentum"

    def init(self, param):
        return (torch.zeros_like(param),)

    def update(self, grad, param, state, lr):
        (v,) = state
        v = self.hyper.get("momentum", 0.9) * v - lr * grad
        return v, (v,)


class AdaGrad(Solver):
    name = "adagrad"

    def init(self, param):
        return (torch.zeros_like(param),)

    def update(self, grad, param, state, lr):
        (accum,) = state
        eps = self.hyper.get("epsilon", 1e-8)
        accum = accum + grad * grad
        return -lr * grad / (torch.sqrt(accum) + eps), (accum,)


class AdaDelta(Solver):
    name = "adadelta"

    def init(self, param):
        return (torch.zeros_like(param), torch.zeros_like(param))

    def update(self, grad, param, state, lr):
        accum_g, accum_dx = state
        rho = self.hyper.get("rho", 0.95)
        eps = self.hyper.get("epsilon", 1e-6)
        accum_g = rho * accum_g + (1 - rho) * grad * grad
        dx = -torch.sqrt(accum_dx + eps) / torch.sqrt(accum_g + eps) * grad
        accum_dx = rho * accum_dx + (1 - rho) * dx * dx
        return lr * dx, (accum_g, accum_dx)


class RProp(Solver):
    """Resilient propagation (RPropAll2All parity): per-weight step sizes
    grown/shrunk by gradient sign agreement."""

    name = "rprop"

    def init(self, param):
        return (torch.full_like(param, self.hyper.get("step0", 1e-3)),
                torch.zeros_like(param))

    def update(self, grad, param, state, lr):
        step, prev_g = state
        inc = self.hyper.get("eta_plus", 1.2)
        dec = self.hyper.get("eta_minus", 0.5)
        agree = grad * prev_g
        step = torch.where(
            agree > 0,
            torch.clamp_max(step * inc, self.hyper.get("step_max", 50.0)),
            torch.where(agree < 0,
                        torch.clamp_min(step * dec,
                                        self.hyper.get("step_min", 1e-9)),
                        step))
        return -torch.sign(grad) * step, (step, grad)


_SOLVERS = {c.name: c for c in (SGD, Momentum, AdaGrad, AdaDelta, RProp)}


def factory(name, **hyper):
    try:
        return _SOLVERS[name](**hyper)
    except KeyError:
        raise ValueError("unknown solver %r (have: %s)" %
                         (name, sorted(_SOLVERS)))
