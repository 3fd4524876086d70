"""Graph mode's GD units of the port against the JAX package's, on the CPU.

Mirrors tests/test_znicz_core.py ``test_backward_matches_autodiff`` and
``test_gd_device_numpy_parity``, tests/test_conv_stack.py
``test_conv_backward_matches_autodiff`` and tests/test_attention_unit.py
``test_graph_mode_trains_and_updates_proj`` for every GD class the port
has: each forward is built in both packages from the same seed
(``RandomGenerator().seed(13)``; the initial parameters byte-equal) on
the same numpy input, runs once as a train minibatch of graph mode
(``minibatch_class`` TRAIN: a stochastic forward draws its key, a
forward with a vjp backward keeps its graph in the port), then its GD
unit takes the same ``err_output`` with ``batch_size`` 6 of 8 rows
(the padded rows' error zero):

- ``backward`` (the kept graph in the port) against the JAX unit's:
  ``err_input`` and every gradient within ``1e-5 * max(1, max|jax|)``;
- two ``run``s (lr 0.1, momentum 0.9; the second recomputes the
  forward in both): the forward's parameters and ``err_input`` within
  the same tolerance; the dropout unit's bit for bit (the mask
  regenerated from the key the forward recorded, which equals the JAX
  unit's, and both backwards divide by the keep probability).  The
  dropout forward's key and mask are bit-equal too; its output is held
  to the tolerance, because the jitted JAX forward multiplies by the f32
  reciprocal of the keep probability (XLA's rewrite of a division by a
  constant) where the port divides, as the eager JAX unit does;
- the All2All family's explicit backward against torch's autograd of
  the forward (the JAX test's check against ``jax.grad``), within
  ``1e-5 * max(1, max|autograd|)``.

The Pallas-backed units run both ways: ``use_pallas=True`` runs the JAX
kernels in interpret mode and the port's plain versions of K5/K6 and
K7-K9; unset runs the band form and the dense oracle in both.
"""

import importlib

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

TOL = 1e-5          # scaled by max(1, max|reference|)
ROWS, VALID_ROWS = 8, 6

#: (forward module, forward class, GD module, GD class, forward kwargs,
#: input sample shape)
A2A = (12,)
CASES = [
    ("all2all", "All2All", "gd", "GradientDescent",
     {"output_sample_shape": 5}, A2A),
    ("all2all", "All2AllTanh", "gd", "GDTanh",
     {"output_sample_shape": 5}, A2A),
    ("all2all", "All2AllSigmoid", "gd", "GDSigmoid",
     {"output_sample_shape": 5}, A2A),
    ("all2all", "All2AllRELU", "gd", "GDRELU",
     {"output_sample_shape": 5}, A2A),
    ("all2all", "All2AllStrictRELU", "gd", "GDStrictRELU",
     {"output_sample_shape": 5}, A2A),
    ("all2all", "All2AllSoftmax", "gd", "GDSoftmax",
     {"output_sample_shape": 5}, A2A),
    ("all2all", "All2All", "gd", "RPropAll2All",
     {"output_sample_shape": 5}, A2A),
    ("conv", "Conv", "gd_conv", "GradientDescentConv",
     {"n_kernels": 4, "kx": 3, "ky": 3}, (6, 6, 3)),
    ("conv", "ConvTanh", "gd_conv", "GDTanhConv",
     {"n_kernels": 4, "kx": 3, "ky": 3, "padding": 1}, (6, 6, 3)),
    ("conv", "ConvSigmoid", "gd_conv", "GDSigmoidConv",
     {"n_kernels": 3, "kx": 2, "ky": 2, "sliding": (2, 2)}, (6, 6, 3)),
    ("conv", "ConvRELU", "gd_conv", "GDRELUConv",
     {"n_kernels": 3, "kx": 3, "ky": 3}, (6, 6, 3)),
    ("conv", "ConvStrictRELU", "gd_conv", "GDStrictRELUConv",
     {"n_kernels": 4, "kx": 3, "ky": 3, "grouping": 1}, (6, 6, 3)),
    ("pooling", "MaxPooling", "gd_pooling", "GDMaxPooling",
     {"kx": 2, "ky": 2}, (6, 6, 3)),
    ("pooling", "AvgPooling", "gd_pooling", "GDAvgPooling",
     {"kx": 3, "ky": 3, "sliding": (2, 2), "padding": 1}, (6, 6, 3)),
    ("pooling", "MaxAbsPooling", "gd_pooling", "GDMaxAbsPooling",
     {"kx": 2, "ky": 2}, (6, 6, 3)),
    ("lrn", "LRNormalizerForward", "lrn", "LRNormalizerBackward",
     {"use_pallas": False}, (3, 3, 8)),
    ("lrn", "LRNormalizerForward", "lrn", "LRNormalizerBackward",
     {"use_pallas": True}, (3, 3, 8)),
    ("dropout", "DropoutForward", "dropout", "DropoutBackward",
     {"dropout_ratio": 0.4}, (5, 7)),
    ("attention", "MultiHeadAttention", "attention", "GDMultiHeadAttention",
     {"heads": 2, "causal": True}, (8, 8)),
    ("attention", "MultiHeadAttention", "attention", "GDMultiHeadAttention",
     {"heads": 2, "use_pallas": True}, (8, 8)),
] + [("activation", "Forward" + a, "activation", "Backward" + a, {},
      (4, 6)) for a in ("Tanh", "Sigmoid", "RELU", "StrictRELU", "Log",
                        "TanhLog", "SinCos")] + [
    ("activation", "ForwardMul", "activation", "BackwardMul",
     {"factor": 1.5}, (4, 6))]


def _ids(case):
    return "%s-%s" % (case[3], "-".join("%s=%s" % kv
                                        for kv in sorted(case[4].items())))


def _mod(pkg, name):
    return importlib.import_module("%s.znicz.%s" % (pkg, name))


def _core(pkg):
    m = {n: importlib.import_module("%s.%s" % (pkg, n))
         for n in ("backends", "memory", "prng", "workflow", "loader")}
    return (m["backends"].Device(backend="cpu"), m["memory"].Array,
            m["prng"].RandomGenerator, m["workflow"].Workflow,
            m["loader"].TRAIN)


def _error(shape):
    """The error at the output: uniform, the padded rows zero."""
    err = numpy.random.RandomState(2).uniform(-1, 1, shape).astype(
        numpy.float32)
    err[VALID_ROWS:] = 0
    return err


def _build(pkg, case, x, err=_error):
    """The forward (run once as a graph-mode train minibatch) and its GD
    unit (lr 0.1, momentum 0.9, batch_size VALID_ROWS) of ``pkg``;
    ``err`` maps the output's shape to the error."""
    fmod, fcls, gmod, gcls, kwargs, _ = case
    device, Array, RandomGenerator, Workflow, TRAIN = _core(pkg)
    wf = Workflow(name="w")
    fwd = getattr(_mod(pkg, fmod), fcls)(
        wf, prng=RandomGenerator().seed(13), **kwargs)
    fwd.input = Array(x.copy())
    fwd.initialize(device=device)
    gd_kwargs = {"learning_rate": 0.1, "gradient_moment": 0.9}
    if "factor" in kwargs:
        gd_kwargs["factor"] = kwargs["factor"]
    gd = getattr(_mod(pkg, gmod), gcls)(wf, **gd_kwargs)
    gd.link_forward(fwd)
    fwd.minibatch_class = TRAIN
    fwd.run()
    gd.err_output = Array(err(tuple(fwd.output.shape)))
    gd.batch_size = VALID_ROWS
    gd.initialize(device=device)
    return fwd, gd


def _inputs(case):
    rng = numpy.random.RandomState(1)
    x = rng.uniform(-1, 1, (ROWS,) + case[5]).astype(numpy.float32)
    return x


def _close(got, want, what):
    want = numpy.asarray(want)
    got = numpy.asarray(got)
    assert got.shape == want.shape, what
    atol = TOL * max(1.0, float(numpy.abs(want).max()))
    numpy.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                  err_msg=what)


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else numpy.asarray(v)


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_gd_unit_matches_jax(case):
    x = _inputs(case)
    jf, jg = _build("veles_tpu", case, x)
    tf, tg = _build("veles_tpu_torch", case, x)
    err = _error(tuple(jf.output.shape))
    for k, v in tf.host_params.items():
        assert v.tobytes() == numpy.asarray(jf.host_params[k]).tobytes(), k
    stochastic = case[0] == "dropout"
    if stochastic:
        # the key graph mode drew, and so the mask, bit for bit
        assert tf.last_key == tuple(numpy.asarray(
            jax.random.key_data(jf.last_key)).tolist())
        keep = 1.0 - jf.dropout_ratio
        want = numpy.asarray(jax.random.bernoulli(jf.last_key, keep,
                                                  x.shape))
        assert numpy.array_equal(
            tf.mask(tf.last_key, x.shape, "cpu").numpy(), want)
    _close(_host(tf.output.devmem), jf.output.map_read(), "output")
    y = jf.output.map_read()

    # backward: the kept graph (port) against the JAX unit's
    jparams = {k: jnp.asarray(v) for k, v in jf.host_params.items()}
    j_in, j_grads = jg.backward(jparams, jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(err), n_valid=VALID_ROWS)
    with torch.no_grad():
        t_in, t_grads = tg.backward(
            tf.params, tf.input.devmem, tf.output.devmem,
            torch.tensor(err), n_valid=VALID_ROWS)
    assert sorted(t_grads) == sorted(j_grads)
    _close(_host(t_in), j_in, "err_input")
    for k in j_grads:
        _close(_host(t_grads[k]), j_grads[k], "grad " + k)

    # two runs: regularized momentum updates into the forward's Arrays
    for step in range(2):
        jg.run()
        tg.run()
        if stochastic:
            assert tg.err_input.map_read().tobytes() == \
                numpy.asarray(jg.err_input.map_read()).tobytes()
        else:
            _close(tg.err_input.map_read(), jg.err_input.map_read(),
                   "err_input, run %d" % step)
        for k, v in jf.host_params.items():
            _close(tf.host_params[k], v, "%s after run %d" % (k, step))


A2A_CASES = [c for c in CASES if c[2] == "gd"]


@pytest.mark.parametrize("case", A2A_CASES,
                         ids=[_ids(c) for c in A2A_CASES])
def test_explicit_backward_matches_autograd(case):
    """The All2All family's explicit backward equals torch's autograd of
    the forward's ``apply`` (the softmax head's against the logits)."""
    x = _inputs(case)
    err = numpy.random.RandomState(2).uniform(-1, 1, (ROWS, 5)).astype(
        numpy.float32)
    tf, tg = _build("veles_tpu_torch", case, x, lambda shape: err)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in tf.params.items()}
    xx = torch.tensor(x, requires_grad=True)
    apply = tf.apply_logits if case[1] == "All2AllSoftmax" else tf.apply
    loss = (apply(params, xx) * torch.tensor(err)).sum() / ROWS
    auto = torch.autograd.grad(loss, list(params.values()) + [xx])
    with torch.no_grad():
        err_in, grads = tg.backward(tf.params, xx.detach(),
                                    tf.output.devmem, torch.tensor(err))
    for (k, _), g in zip(params.items(), auto):
        _close(_host(grads[k]), _host(g), k)
    _close(_host(err_in), _host(auto[-1]) * ROWS, "err_input")


def test_first_layer_skips_err_input():
    """``need_err_input=False`` (the first GD unit of a graph) leaves
    ``err_input`` empty and computes no input gradient."""
    case = CASES[1]
    x = _inputs(case)
    err = numpy.ones((ROWS, 5), numpy.float32)
    tf, tg = _build("veles_tpu_torch", case, x, lambda shape: err)
    tg.need_err_input = False
    err_in, grads = tg.backward(tf.params, tf.input.devmem,
                                tf.output.devmem, torch.tensor(err))
    assert err_in is None and sorted(grads) == ["bias", "weights"]
    before = tf.host_params["weights"].copy()
    tg.run()
    assert not tg.err_input
    assert not numpy.array_equal(before, tf.host_params["weights"])


def test_attention_graph_mode_trains_and_updates_proj():
    """tests/test_attention_unit.py's graph-mode check on the port: one
    GD run with ``need_err_input=False`` moves weights, proj and bias,
    by the JAX unit's amounts within the tolerance."""
    case = CASES[[c[3] for c in CASES].index("GDMultiHeadAttention")]
    x = _inputs(case)
    err = numpy.random.RandomState(4).uniform(-1, 1, (ROWS,) + case[5]) \
        .astype(numpy.float32)
    runs = {}
    for pkg in ("veles_tpu", "veles_tpu_torch"):
        fwd, gd = _build(pkg, case, x, lambda shape: err)
        gd.batch_size = ROWS
        gd.need_err_input = False
        before = {k: numpy.array(v) for k, v in fwd.host_params.items()}
        gd.run()
        runs[pkg] = (before, {k: numpy.array(v)
                              for k, v in fwd.host_params.items()})
    (jb, ja), (tb, ta) = runs["veles_tpu"], runs["veles_tpu_torch"]
    for name in ("weights", "proj", "bias"):
        assert not numpy.allclose(tb[name], ta[name]), name
        _close(ta[name], ja[name], name)
