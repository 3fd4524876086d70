"""Carry parameters between the JAX package and the port.

The JAX package's parameter trees are dicts of arrays; the port's are
dicts of tensors in the same ``x @ W`` layout (no transpose to
``nn.Linear``'s ``[out, in]``), so the same names hold the same numbers.
float8 leaves (``w1_q``/``w2_q`` of ``weight_dtype="fp8"``) travel as
their bytes: numpy has no float8 of its own.

Only host arrays cross: pass ``numpy.asarray(leaf)`` of each JAX leaf
(or the leaves themselves, which numpy converts); nothing here imports
JAX.

:func:`workflow_params_from_jax` carries a trained (or freshly
initialized) StandardWorkflow across: each layer's host params and its
solver state, in the layout the port's units read, which is the JAX
package's: ``{"weights": (in, out), "bias": (out,)}`` for an All2All
layer (``ResizableAll2All`` too), plus ``"proj"`` for the attention
unit; 4-D HWIO weights ``(ky, kx, C / grouping, K)`` and ``(K,)``
biases for a conv layer (no transpose to ``conv2d``'s OIHW); ``(F + H,
H)`` and ``(H,)`` for SimpleRNN, ``(F + H, 4H)`` (gates ``i, f, g, o``)
and ``(4H,)`` for LSTM (not ``torch.nn.LSTM``'s layout); ``{}`` for a
paramless layer (pooling, LRN, dropout, activation units).

:func:`trainer_params_from_jax` carries the arrays of a unit trained
without gradients: the Kohonen codebook ``weights (neurons, F)`` of a
``KohonenTrainer`` or ``KohonenForward``, and an ``RBMTrainer``'s
``weights (visible, hidden)``, ``vbias`` and ``hbias``.
"""

import numpy
import torch

from .device import resolve_device

__all__ = ["params_from_jax", "params_to_jax", "trainer_params_from_jax",
           "workflow_params_from_jax"]

_FP8_NAME = "float8_e4m3fn"


def _tensor(arr, device):
    arr = numpy.array(arr)                 # a writable host copy
    if arr.dtype.name == _FP8_NAME:
        raw = torch.from_numpy(arr.view(numpy.uint8))
        return raw.view(torch.float8_e4m3fn).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(tree, device=None):
    """``{name: array}`` (f32 leaves, int8 and float8 quantized leaves,
    their f32 scales) -> ``{name: tensor}`` on ``device`` (default:
    the card)."""
    dev = resolve_device(device)
    return {name: _tensor(leaf, dev) for name, leaf in tree.items()}


def params_to_jax(params, fp8_dtype=None):
    """``{name: tensor}`` -> ``{name: numpy array}``, the inverse of
    :func:`params_from_jax`.  float8 leaves come back as their uint8
    bytes, or viewed as ``fp8_dtype`` (a numpy float8_e4m3fn dtype, as
    ``ml_dtypes`` provides it) when one is given."""
    out = {}
    for name, t in params.items():
        t = t.detach().cpu()
        if t.dtype == torch.float8_e4m3fn:
            raw = t.view(torch.uint8).numpy()
            out[name] = raw.view(fp8_dtype) if fp8_dtype is not None \
                else raw
        else:
            out[name] = t.numpy()
    return out


def workflow_params_from_jax(wf, params, solver_state=None):
    """Load a JAX StandardWorkflow's layers into the port's ``wf``.

    ``params`` is ``[fwd.host_params for fwd in jax_wf.forwards]``
    (numpy ``{"weights": (in, out), "bias": (out,)}`` per All2All layer,
    and ``"proj"`` for an attention layer; HWIO ``weights`` for a conv
    layer; ``{}`` for a paramless one);
    ``solver_state`` is ``[gd.solver_state for gd in jax_wf.gds]``
    (``{name: (numpy, ...)}``, momentum's velocity for the MNIST
    sample; call ``jax_wf.fused_step.sync_solver_state()`` first), or
    None to keep the port's own.  Works before ``wf.initialize`` (the
    forwards then skip their random init) and after it (the fused step
    reloads).  A layer given a tensor it does not have, or one of
    another shape (an OIHW conv kernel for an HWIO one), raises: nothing
    is transposed to fit."""
    from .znicz.nn_units import ParamlessForward
    if len(params) != len(wf.forwards):
        raise ValueError("%d layers given for a workflow of %d"
                         % (len(params), len(wf.forwards)))
    layers = [{k: numpy.asarray(v, numpy.float32) for k, v in p.items()}
              for p in params]
    for fwd, layer in zip(wf.forwards, layers):   # check all, then load
        if layer and isinstance(fwd, ParamlessForward):
            raise ValueError("%s has no parameters, given %s"
                             % (fwd, sorted(layer)))
        have_params = fwd.host_params
        if have_params and set(layer) - set(have_params):
            raise ValueError("%s has no %s" % (
                fwd, sorted(set(layer) - set(have_params))))
        for name, have in have_params.items():
            if name in layer and have.shape != layer[name].shape:
                raise ValueError("%s: %s %r, given %r" % (
                    fwd, name, have.shape, layer[name].shape))
    for fwd, layer in zip(wf.forwards, layers):
        fwd.set_host_params(layer)
    if solver_state is not None:
        if len(solver_state) != len(wf.gds):
            raise ValueError("%d solver states given for %d layers"
                             % (len(solver_state), len(wf.gds)))
        for gd, layer in zip(wf.gds, solver_state):
            gd.solver_state = {
                name: tuple(numpy.array(s, numpy.float32) for s in state)
                for name, state in layer.items()}
    step = wf.fused_step
    if step is not None and step.is_initialized:
        step.load_state()
    return wf


def trainer_params_from_jax(unit, arrays):
    """Load a JAX unit's trained arrays into the port's ``unit`` (a
    ``KohonenTrainer``, ``KohonenForward`` or ``RBMTrainer``).

    ``arrays`` is ``{name: array}`` for every name of ``unit.PARAMS``
    (``numpy.asarray`` of the JAX unit's ``weights.map_read()``, and so
    on), in the JAX layout.  Before ``unit.initialize`` the unit then
    skips its random init; after it, the unit's live state reloads (and
    its accumulator restarts).  A missing or extra name, or a shape
    other than the unit's, raises: nothing is transposed to fit."""
    names = tuple(unit.PARAMS)
    given = {k: numpy.array(v, numpy.float32) for k, v in arrays.items()}
    if set(given) != set(names):
        raise ValueError("%s takes %s, given %s"
                         % (unit, sorted(names), sorted(given)))
    for name in names:
        have = getattr(unit, name)
        if have and have.shape != given[name].shape:
            raise ValueError("%s: %s %r, given %r" % (
                unit, name, have.shape, given[name].shape))
    for name in names:
        getattr(unit, name).mem = given[name]
    if unit.is_initialized:
        unit.load_state()
    return unit
