"""Stochastic pooling (the four units and their two GD units), the port
against the JAX package on the CPU.

Inputs are uniform [-1, 1) NHWC maps from a numpy seed with exact zeros
in them, as a strict-RELU convolution gives: 30 % of the elements, a
window corner of zeros and one of negative values only.  Keys are the
same threefry keys in both packages.

- The mirrors of tests/test_conv_stack.py's
  ``test_stochastic_pooling_eval_is_expectation`` and
  ``test_stochastic_pooling_train_samples_window_elements``.
- Each unit's eval ``apply`` within ``EVAL_ATOL`` of the JAX unit's; its
  train draws (``apply_train``) the JAX unit's choices, and its values
  bit for bit wherever the choices agree.  A choice may differ only at
  a near-tie (JAX's two largest perturbed logits within
  ``NEAR_TIE_RTOL`` of the larger: ``log`` here is not XLA's to the last
  ulp); the test counts them (``differing_draws`` in the junit record).
- Their vjps within ``VJP_ATOL``, the draw's and the expectation's.  The
  JAX vjp of ``apply`` is NaN at every element of a window whose
  weights sum to 0 (its division's derivative ``-g * x / y**2`` squares
  the 1e-30 floor to 0); the port's is finite there (ROADMAP §C).
- ``GDStochasticPooling`` / ``GDStochasticAbsPooling`` against the JAX
  units: through the forward's draw from its ``last_key``, or the eval
  ``apply`` before any draw.
- The depooling pair has no GD unit in either package, so graph mode
  falls back to ``GenericVJPBackward``: the JAX one differentiates the
  eval ``apply`` (the expectation) though the forward drew a sample,
  while the fused step differentiates the draw.  The port does the
  same in each mode (ROADMAP §C).
- A ``StandardWorkflow`` holding ``stochastic_pooling`` and
  ``stochastic_abs_pooling`` after strict-RELU convolutions, and one
  holding ``stochastic_abs_pool_depool``, trained two epochs fused and
  in graph mode against the JAX package's in the same mode: weights
  within ``WEIGHT_RTOL`` of their scale, n_err equal; every draw of the
  port's run is replayed through ``jax.random.categorical`` and a flip
  is counted and must be a near-tie.
- A snapshot resumed bit for bit against an uninterrupted run, fused
  and in graph mode (the fused step's seed and the units' ``KeyTree``
  counters ride the snapshot).
"""

import importlib

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_workers  # noqa: F401  (one torch thread share a worker)
from veles_tpu_torch import prng

EVAL_ATOL = 1e-6
VJP_ATOL = 1e-6
WEIGHT_RTOL = 2e-6
NEAR_TIE_RTOL = 1e-6
SHAPE = (3, 12, 12, 4)

UNIT_CASES = [
    ("StochasticPooling", {"kx": 2, "ky": 2}),
    ("StochasticPooling", {"kx": 3, "ky": 3, "sliding": (2, 2),
                           "padding": 1}),
    ("StochasticAbsPooling", {"kx": 3, "ky": 3, "sliding": (2, 2)}),
    ("StochasticAbsPooling", {"kx": 3, "ky": 2, "sliding": (2, 1),
                              "padding": (1, 2, 2, 0)}),
    ("StochasticPoolingDepooling", {"kx": 2, "ky": 2}),
    ("StochasticAbsPoolingDepooling", {"kx": 3, "ky": 3}),
]
UNIT_IDS = ["%s-%d" % (c[0], i) for i, c in enumerate(UNIT_CASES)]


def _input(shape=SHAPE, seed=1):
    rng = numpy.random.RandomState(seed)
    x = rng.uniform(-1, 1, shape).astype(numpy.float32)
    x[rng.uniform(size=shape) < 0.3] = 0.0
    x[0, :3, :3, :] = 0.0
    x[1, :3, :3, :] = -numpy.abs(x[1, :3, :3, :]) - 0.1
    return x


def _keys(seed, data=0):
    return (jax.random.fold_in(jax.random.key(seed), data),
            prng.fold_in(prng.key(seed), data))


def _unit(pkg, name, x, **kwargs):
    from_ = lambda m: importlib.import_module("%s.%s" % (pkg, m))  # noqa
    cls = getattr(from_("znicz.pooling"), name)
    u = cls(from_("workflow").Workflow(name="w"), **kwargs)
    u.input = from_("memory").Array(x.copy())
    u.initialize(device=from_("backends").Device(backend="cpu"))
    return u


def _pair(name, x, **kwargs):
    return (_unit("veles_tpu", name, x, **kwargs),
            _unit("veles_tpu_torch", name, x, **kwargs))


def differing_draws(got, want, perturbed):
    """The count of draws where ``got`` is not ``want``; each such draw
    must be a near-tie of ``perturbed`` (JAX's Gumbel-perturbed logits,
    the categories on the last axis)."""
    bad = [tuple(i) for i in numpy.argwhere(got != want)]
    for idx in bad:
        lo, hi = numpy.sort(perturbed[idx])[-2:]
        assert hi - lo <= NEAR_TIE_RTOL * abs(hi), (
            "draw %r differs at a gap of %g" % (idx, hi - lo))
    return len(bad)


def _jax_draws(jk, logits):
    """``jax.random.categorical``'s choices over ``logits`` (categories
    last) and the perturbed logits it took the argmax of."""
    logits = jnp.asarray(logits)
    return (numpy.asarray(jax.random.categorical(jk, logits)),
            numpy.asarray(jax.random.gumbel(jk, logits.shape) + logits))


def _unit_draws(ju, tu, x, jk, k):
    """(port choices, JAX choices, JAX perturbed logits) of the units'
    train draws on ``x``: the JAX unit's logits transposed as its
    ``apply_train`` transposes them."""
    p = ju._patches(jnp.asarray(x))
    want, perturbed = _jax_draws(
        jk, jnp.log(ju._probs(p) + 1e-30).transpose(0, 1, 2, 4, 3))
    got = tu._choice(tu._patches(torch.from_numpy(x)), k).numpy()
    return got, want, perturbed


def _agreeing_outputs(tu, x, agree):
    """Which output elements of ``tu`` come from windows whose draws
    agree (``agree``: ``(b, oh, ow, c)``)."""
    if tu.output_shape_for(x.shape) != tuple(x.shape):
        return agree
    k = tu.ky * tu.kx
    mask = torch.from_numpy(agree.astype(numpy.float32))[:, :, :, None, :]
    mask = mask.expand(-1, -1, -1, k, -1)
    return tu._scatter_back(mask, torch.from_numpy(x)).numpy() > 0


def _in_zero_windows(ju, x):
    """The input elements inside a window whose weights sum to 0."""
    p = numpy.asarray(ju._patches(jnp.asarray(x)))
    mag = numpy.abs(p) if ju.ABS else numpy.maximum(p, 0.0)
    zero = numpy.broadcast_to(_seq_sum(mag)[:, :, :, None, :] == 0, p.shape)
    index = numpy.arange(1, x.size + 1, dtype=numpy.float32).reshape(
        x.shape)
    hit = numpy.zeros(x.size + 1, bool)
    hit[numpy.asarray(ju._patches(jnp.asarray(index))).astype(int)[zero]] = \
        True
    return hit[1:].reshape(x.shape)


def _seq_sum(t):
    total = t[:, :, :, 0]
    for j in range(1, t.shape[3]):
        total = total + t[:, :, :, j]
    return total


# -- the mirrors of tests/test_conv_stack.py ----------------------------------

def test_stochastic_pooling_eval_is_expectation():
    x = numpy.abs(numpy.random.RandomState(0).uniform(
        0.1, 1, (2, 4, 4, 2))).astype(numpy.float32)
    u = _unit("veles_tpu_torch", "StochasticPooling", x, kx=2, ky=2)
    u.run()
    out = u.output.map_read()
    win = x[:, :2, :2, :].reshape(2, 4, 2)
    expect = (win * (win / win.sum(1, keepdims=True))).sum(1)
    assert numpy.allclose(out[:, 0, 0, :], expect, atol=1e-5)


def test_stochastic_pooling_train_samples_window_elements():
    x = numpy.random.RandomState(1).uniform(-1, 1, (4, 12, 12, 3)).astype(
        numpy.float32)
    ju, tu = _pair("StochasticPooling", x, kx=2, ky=2)
    out = tu.apply_train({}, torch.from_numpy(x), prng.key(0)).numpy()
    assert tu.last_key == prng.key(0)
    # every output element must be one of its window's elements
    win = x[:, 0:2, 0:2, :].reshape(x.shape[0], 4, x.shape[3])
    for b in range(x.shape[0]):
        for c in range(x.shape[3]):
            assert out[b, 0, 0, c] in win[b, :, c]
    want = numpy.asarray(ju.apply_train({}, jnp.asarray(x),
                                        jax.random.PRNGKey(0)))
    assert out.tobytes() == want.tobytes()


# -- the units against the JAX units ------------------------------------------

@pytest.mark.parametrize("name,kwargs", UNIT_CASES, ids=UNIT_IDS)
def test_unit_forwards_match_jax(name, kwargs, record_property):
    x = _input()
    ju, tu = _pair(name, x, **kwargs)
    want = numpy.asarray(ju.apply({}, jnp.asarray(x)))
    with torch.no_grad():
        got = tu.apply({}, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == tu.output_shape_for(x.shape)
    numpy.testing.assert_allclose(got, want, rtol=0, atol=EVAL_ATOL)
    flips = 0
    for seed in (0, 7, 2024):
        jk, k = _keys(seed, 3)
        got_c, want_c, perturbed = _unit_draws(ju, tu, x, jk, k)
        flips += differing_draws(got_c, want_c, perturbed)
        with torch.no_grad():
            got = tu.apply_train({}, torch.from_numpy(x), k).numpy()
        assert tu.last_key == k
        want = numpy.asarray(ju.apply_train({}, jnp.asarray(x), jk))
        same = _agreeing_outputs(tu, x, got_c == want_c)
        assert got[same].tobytes() == want[same].tobytes()
    record_property("differing_draws", flips)
    print("%s %r: %d of %d draws differ" % (name, kwargs, flips,
                                             3 * got_c.size))


@pytest.mark.parametrize("name,kwargs", UNIT_CASES, ids=UNIT_IDS)
def test_unit_vjps_match_jax(name, kwargs):
    x = _input(seed=2)
    ju, tu = _pair(name, x, **kwargs)
    err = numpy.random.RandomState(3).uniform(
        -1, 1, tu.output_shape_for(x.shape)).astype(numpy.float32)

    def port_vjp(fn):
        xx = torch.from_numpy(x).requires_grad_(True)
        return torch.autograd.grad(fn(xx), xx, torch.from_numpy(err))[
            0].numpy()

    def jax_vjp(fn):
        return numpy.asarray(jax.vjp(fn, jnp.asarray(x))[1](
            jnp.asarray(err))[0])

    # the expectation: NaN in JAX exactly at the zero-weight windows
    got = port_vjp(lambda xx: tu.apply({}, xx))
    want = jax_vjp(lambda xx: ju.apply({}, xx))
    zero = _in_zero_windows(ju, x)
    assert zero.any() or name == "StochasticAbsPoolingDepooling"
    assert numpy.array_equal(numpy.isnan(want), zero)
    assert numpy.isfinite(got).all()
    numpy.testing.assert_allclose(got[~zero], want[~zero], rtol=0,
                                  atol=VJP_ATOL)
    # the draw: the error reaches the drawn elements only
    jk, k = _keys(5)
    got_c, want_c, perturbed = _unit_draws(ju, tu, x, jk, k)
    assert differing_draws(got_c, want_c, perturbed) == 0
    got = port_vjp(lambda xx: tu.apply_train({}, xx, k))
    want = jax_vjp(lambda xx: ju.apply_train({}, xx, jk))
    numpy.testing.assert_allclose(got, want, rtol=0, atol=VJP_ATOL)


@pytest.mark.parametrize("name", ["GDStochasticPooling",
                                  "GDStochasticAbsPooling"])
def test_gd_units_match_jax(name):
    fwd = {"GDStochasticPooling": "StochasticPooling",
           "GDStochasticAbsPooling": "StochasticAbsPooling"}[name]
    from veles_tpu.znicz import gd_pooling as jax_gd
    from veles_tpu_torch.znicz import gd_pooling as port_gd
    x = _input(seed=4)
    kwargs = {"kx": 3, "ky": 3, "sliding": (2, 2), "padding": 1}
    ju, tu = _pair(fwd, x, **kwargs)
    jgd = getattr(jax_gd, name)(ju.workflow)
    jgd.link_forward(ju)
    tgd = getattr(port_gd, name)(tu.workflow)
    tgd.link_forward(tu)
    assert tu.vjp_backward and tgd.VJP_OF_DRAW
    err = numpy.random.RandomState(6).uniform(
        -1, 1, tu.output_shape_for(x.shape)).astype(numpy.float32)

    def both():
        want, jgrads = jgd.backward({}, jnp.asarray(x), None,
                                    jnp.asarray(err))
        with torch.no_grad():
            got, grads = tgd.backward({}, torch.from_numpy(x), None,
                                      torch.from_numpy(err))
        assert grads == jgrads == {}
        return got.numpy(), numpy.asarray(want)

    # before any draw: the eval apply (JAX's NaN at zero-weight windows)
    got, want = both()
    zero = _in_zero_windows(ju, x)
    assert numpy.array_equal(numpy.isnan(want), zero) and zero.any()
    numpy.testing.assert_allclose(got[~zero], want[~zero], rtol=0,
                                  atol=VJP_ATOL)
    # after a train draw: through the same draw, from last_key
    jk, k = _keys(9)
    ju._last_key_ = jk
    tu.apply_train({}, torch.from_numpy(x), k)
    got, want = both()
    assert numpy.count_nonzero(got) <= numpy.prod(err.shape)
    numpy.testing.assert_allclose(got, want, rtol=0, atol=VJP_ATOL)


def test_jax_generic_backward_differentiates_the_expectation():
    """The depooling pair's graph-mode GD unit in the JAX package is the
    ``GenericVJPBackward`` fallback, which differentiates the eval
    ``apply`` though the forward drew; the port's fallback does the
    same, and keeps no train graph for it."""
    from veles_tpu.znicz.nn_units import GenericVJPBackward as JaxGeneric
    from veles_tpu.znicz.standard_workflow import _find_pair as jax_find
    from veles_tpu_torch.znicz.nn_units import GenericVJPBackward
    from veles_tpu_torch.znicz.standard_workflow import _find_pair
    for mapping in ("stochastic_pool_depool", "stochastic_abs_pool_depool"):
        assert jax_find(mapping)[1] is None and _find_pair(mapping)[1] is None
    x = numpy.abs(_input(seed=7)) + 0.05    # no zero-weight window
    ju, tu = _pair("StochasticAbsPoolingDepooling", x, kx=2, ky=2)
    jk, k = _keys(11)
    ju._last_key_ = jk
    jgd = JaxGeneric(ju.workflow)
    jgd.link_forward(ju)
    tgd = GenericVJPBackward(tu.workflow)
    tgd.link_forward(tu)
    assert not tu.vjp_backward and not tgd.VJP_OF_DRAW
    err = numpy.random.RandomState(8).uniform(-1, 1, x.shape).astype(
        numpy.float32)
    want, _ = jgd.backward({}, jnp.asarray(x), None, jnp.asarray(err))
    want = numpy.asarray(want)
    pull = lambda fn: numpy.asarray(  # noqa: E731
        jax.vjp(fn, jnp.asarray(x))[1](jnp.asarray(err))[0])
    numpy.testing.assert_array_equal(want, pull(lambda xx: ju.apply({}, xx)))
    drawn = pull(lambda xx: ju.apply_train({}, xx, jk))
    assert numpy.abs(want - drawn).max() > 0.1
    tu.apply_train({}, torch.from_numpy(x), k)
    with torch.no_grad():
        got, _ = tgd.backward({}, torch.from_numpy(x), None,
                              torch.from_numpy(err))
    numpy.testing.assert_allclose(got.numpy(), want, rtol=0, atol=VJP_ATOL)


# -- StandardWorkflow, both modes ---------------------------------------------

_GD = {"learning_rate": 0.05, "gradient_moment": 0.9}
POOL_LAYERS = [
    {"type": "conv_str", "->": {"n_kernels": 4, "kx": 3, "ky": 3,
                                "padding": 1}, "<-": _GD},
    {"type": "stochastic_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "conv_str", "->": {"n_kernels": 4, "kx": 3, "ky": 3,
                                "padding": 1}, "<-": _GD},
    {"type": "stochastic_abs_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "softmax", "->": {"output_sample_shape": 4}, "<-": _GD},
]
DEPOOL_LAYERS = [
    {"type": "conv_tanh", "->": {"n_kernels": 4, "kx": 3, "ky": 3,
                                 "padding": 1}, "<-": _GD},
    {"type": "stochastic_abs_pool_depool", "->": {"kx": 2, "ky": 2}},
    {"type": "softmax", "->": {"output_sample_shape": 4}, "<-": _GD},
]


def _image_loader(pkg):
    loader = importlib.import_module(pkg + ".loader")

    class Images(loader.FullBatchLoader):
        hide_from_registry = True

        def load_data(self):
            rng = numpy.random.RandomState(6)
            labels = rng.randint(0, 4, 100)
            x = rng.uniform(-0.5, 0.5, (100, 8, 8, 4)).astype(numpy.float32)
            for i, c in enumerate(labels):
                r, q = divmod(int(c), 2)
                x[i, 4 * r:4 * r + 4, 4 * q:4 * q + 4] += 1.0
            self.original_data.mem = x
            self.original_labels = list(labels)
            self.class_lengths[loader.TEST] = 0
            self.class_lengths[loader.VALID] = 30
            self.class_lengths[loader.TRAIN] = 70
    return Images


#: the port's loader at module level, so that a snapshot pickles it
PortImages = _image_loader("veles_tpu_torch")
PortImages.__name__ = PortImages.__qualname__ = "PortImages"


def _workflow(pkg, fused, layers, epochs=2, snapshotter=None):
    m = lambda n: importlib.import_module("%s.%s" % (pkg, n))  # noqa
    m("prng").get().seed(21)
    loader = {"minibatch_size": 20, "prng": m("prng").RandomGenerator()
              .seed(8)}
    if pkg == "veles_tpu":
        loader["prefetch_depth"] = 0
    kwargs = {} if snapshotter is None else {"snapshotter": snapshotter}
    wf = m("znicz.standard_workflow").StandardWorkflow(
        None, name="stochastic", loader_factory=PortImages
        if pkg == "veles_tpu_torch" else _image_loader(pkg),
        loader=loader, layers=[dict(layer) for layer in layers],
        decision={"max_epochs": epochs, "silent": True}, fused=fused,
        **kwargs)
    wf.initialize(device=m("backends").Device(backend="cpu"))
    return wf


def _host(wf):
    return [{k: numpy.array(v) for k, v in f.host_params.items()}
            for f in wf.forwards]


def _scaled_diff(a, b):
    return max(float(numpy.abs(x[k] - y[k]).max() / numpy.abs(y[k]).max())
               for x, y in zip(a, b) for k in y)


def _n_err_by_epoch(wf):
    out = []
    decision = wf.decision
    run = decision.run

    def recording():
        last = bool(decision.last_minibatch)
        run()
        if last:
            out.append((decision.epoch_number, decision.minibatch_class,
                        decision.epoch_n_err[decision.minibatch_class]))
    decision.run = recording
    return out


def _record_draws(wf):
    """Every draw the port's stochastic units make: (key, logits with
    the categories last, choices)."""
    draws = []
    for fwd in wf.forwards:
        if not fwd.stochastic:
            continue

        def recorded(p, key, fwd=fwd, choice=fwd._choice):
            got = choice(p, key)
            with torch.no_grad():
                logits = torch.log(fwd._probs(p.detach()) + 1e-30)
            draws.append((key, logits.permute(0, 1, 2, 4, 3).numpy().copy(),
                          got.numpy().copy()))
            return got
        fwd._choice = recorded
    return draws


def _replayed_flips(draws):
    """Each recorded draw replayed through ``jax.random.categorical``
    with the same key: the count of choices that differ (near-ties
    only)."""
    flips = 0
    for key, logits, got in draws:
        jk = jax.random.wrap_key_data(numpy.asarray(key, numpy.uint32))
        want, perturbed = _jax_draws(jk, logits)
        flips += differing_draws(got, want, perturbed)
    return flips


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "graph"])
@pytest.mark.parametrize("layers", ["pool", "depool"])
def test_workflow_trains_as_the_jax_workflow(layers, fused,
                                             record_property):
    config = {"pool": POOL_LAYERS, "depool": DEPOOL_LAYERS}[layers]
    jwf = _workflow("veles_tpu", fused, config)
    twf = _workflow("veles_tpu_torch", fused, config)
    assert [type(g).__name__ for g in twf.gds] == \
        [type(g).__name__ for g in jwf.gds]
    gd_names = {"pool": ["GDStrictRELUConv", "GDStochasticPooling",
                         "GDStrictRELUConv", "GDStochasticAbsPooling",
                         "GDSoftmax"],
                "depool": ["GDTanhConv", "GenericVJPBackward",
                           "GDSoftmax"]}[layers]
    assert [type(g).__name__ for g in twf.gds] == gd_names
    w0 = _host(twf)
    for t, j in zip(w0, _host(jwf)):
        for k in t:
            assert t[k].tobytes() == j[k].tobytes(), k
    j_epochs, t_epochs = _n_err_by_epoch(jwf), _n_err_by_epoch(twf)
    draws = _record_draws(twf)
    jwf.run()
    twf.run()
    flips = _replayed_flips(draws)
    record_property("differing_draws", flips)
    print("%s %s: %d draws, %d of their choices differ from JAX's"
          % (layers, "fused" if fused else "graph", len(draws), flips))
    assert len(draws) == 2 * 4 * (2 if layers == "pool" else 1)
    assert t_epochs == j_epochs and len(t_epochs) == 4
    w = _host(twf)
    assert _scaled_diff(w, _host(jwf)) <= WEIGHT_RTOL
    assert all(not numpy.array_equal(a[k], b[k])
               for a, b in zip(w, w0) for k in a)


def test_depool_pair_backward_differs_between_the_modes():
    """The port reproduces both JAX modes, and they differ: the fused
    step differentiates the draw, graph mode the expectation."""
    got = {fused: _host(_run(_workflow("veles_tpu_torch", fused,
                                       DEPOOL_LAYERS, epochs=1)))
           for fused in (True, False)}
    assert _scaled_diff(got[False], got[True]) > 1e-3


def _run(wf):
    wf.run()
    return wf


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "graph"])
def test_snapshot_resume_draws_on_bitwise(tmp_path, fused):
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.snapshotter import restore
    ref = _run(_workflow("veles_tpu_torch", fused, POOL_LAYERS, epochs=4))
    _run(_workflow("veles_tpu_torch", fused, POOL_LAYERS, epochs=2,
                   snapshotter={"prefix": "s", "directory": str(tmp_path),
                                "time_interval": 0}))
    resumed = restore(str(tmp_path / "s_current"))
    resumed.decision.max_epochs = 4
    resumed.initialize(device=Device(backend="cpu"))
    resumed.run()
    assert resumed.loader.epoch_number == ref.loader.epoch_number
    assert resumed.decision.epoch_n_err == ref.decision.epoch_n_err
    for got, want in zip(_host(resumed), _host(ref), strict=True):
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
    for a, b in zip(resumed.forwards, ref.forwards):
        if a.stochastic:
            assert a.key_tree.counters == b.key_tree.counters
