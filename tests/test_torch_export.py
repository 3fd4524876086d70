"""The port's export path (``veles_tpu_torch.export``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_export.py`` with the nets it exports (the MNIST FC
net, the CIFAR conv + pool + LRN stack and the attention + softmax
net; AlexNet at its side-67 cut for the byte-level and native checks),
each trained by the JAX package and carried into the port
(``convert.workflow_params_from_jax``):

- the port's workflow lists the JAX workflow's units in its order, so
  both checksums are equal, fused and in graph mode (fault C10: the
  port used to create each GD unit beside its forward);
- each forward's ``export_params()``, ``describe()`` and ``exports``
  equal the JAX unit's for the same constructor arguments;
- ``package_export`` at precision 32 and 16: the zip's names equal,
  ``contents.json`` equal as JSON and every ``.npy`` equal byte for
  byte; ``model.json`` equal to the JAX package's but for ``format``;
- a JAX ``export_model`` package (with StableHLO) served by the port's
  ``PackageLoader.run(device="cpu")`` within 1e-5 of the JAX
  ``PackageLoader.run``, fp32 and fp16;
- a port-written package read by the JAX ``PackageLoader`` (arrays,
  ``unit_params`` and ``model.json``) and replayed by the native engine
  (built here into its own directory; a build failure fails) within
  5e-4 of the JAX live forward, the JAX test's tolerance;
- the mirrors of ``test_fp16_package_loads``,
  ``test_deserialize_is_thread_safe`` (the chain is rebuilt once under
  two concurrent first calls) and ``test_native_cli_runner`` (the
  native binary and the port's runner, ``--device cpu``);
- a class the port lacks raises naming its ROADMAP queue A item; a
  ``misc_units`` class raises that the JAX package records no
  configuration for it.
"""

import json
import os
import subprocess
import sys
import threading
import time
import zipfile

import numpy
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = ("mnist", "convnet", "attention")
PARITY_TOL = 1e-5
NATIVE_TOL = 5e-4       # tests/test_export.py: naive C++ loops vs XLA


@pytest.fixture(scope="module")
def native_build(tmp_path_factory):
    """Build the native runtime once, into this module's own directory
    (the JAX package's tests build ``native/build``; two builds into one
    directory at once would race).  A build failure is a test failure,
    not a skip."""
    build = str(tmp_path_factory.mktemp("native_build"))
    try:
        subprocess.run(["cmake", "-S", os.path.join(REPO, "native"),
                        "-B", build, "-G", "Ninja"],
                       check=True, capture_output=True, timeout=180)
        subprocess.run(["cmake", "--build", build], check=True,
                       capture_output=True, timeout=300)
    except subprocess.CalledProcessError as e:
        pytest.fail("native build FAILED: %s\n%s"
                    % (e, (e.stderr or b"").decode()[-2000:]),
                    pytrace=False)
    except (subprocess.TimeoutExpired, FileNotFoundError) as e:
        pytest.fail("native build FAILED: %r" % e, pytrace=False)
    return build


# -- the nets, in both packages -----------------------------------------------

def _seq_loader(base, loader_mod):
    class SeqLoader(base):
        def load_data(self):
            rng = numpy.random.RandomState(5)
            x = rng.uniform(-1, 1, (80, 6, 8)).astype(numpy.float32)
            self.original_data.mem = x
            self.original_labels = list(
                rng.randint(0, 3, 80).astype(numpy.int32))
            self.class_lengths[loader_mod.TEST] = 0
            self.class_lengths[loader_mod.VALID] = 20
            self.class_lengths[loader_mod.TRAIN] = 60
    return SeqLoader


ATTN_LAYERS = [
    {"type": "multihead_attention", "->": {"heads": 2, "causal": True},
     "<-": {"learning_rate": 0.01}},
    {"type": "softmax", "->": {"output_sample_shape": 3},
     "<-": {"learning_rate": 0.01}}]


def _create(pkg, net, fused=True, epochs=1):
    """``net``'s workflow in ``pkg`` (``veles_tpu`` or
    ``veles_tpu_torch``), weights from seed 42, not initialized."""
    import importlib
    prng = importlib.import_module(pkg + ".prng")
    rg = prng.RandomGenerator
    prng.get().seed(42)
    decision = {"max_epochs": epochs, "silent": True}
    if net == "mnist":
        mod = importlib.import_module(pkg + ".znicz.samples.mnist")
        return mod.create_workflow(
            loader={"minibatch_size": 100, "n_train": 400,
                    "n_valid": 100, "prng": rg().seed(3)},
            decision=decision, fused=fused)
    if net == "convnet":
        mod = importlib.import_module(pkg + ".znicz.samples.cifar")
        return mod.create_workflow(
            loader={"minibatch_size": 50, "n_train": 200, "n_valid": 50,
                    "prng": rg().seed(3)},
            decision=decision, fused=fused)
    if net == "alexnet":
        mod = importlib.import_module(pkg + ".znicz.samples.alexnet")
        return mod.create_workflow(
            loader={"minibatch_size": 4, "n_train": 8, "n_valid": 4,
                    "side": 67, "prng": rg().seed(3)},
            decision=decision)
    loader_mod = importlib.import_module(pkg + ".loader")
    sw = importlib.import_module(pkg + ".znicz.standard_workflow")
    return sw.StandardWorkflow(
        None, name="attn-export",
        loader_factory=_seq_loader(loader_mod.FullBatchLoader, loader_mod),
        loader={"minibatch_size": 20, "prng": rg().seed(6)},
        layers=ATTN_LAYERS, loss_function="softmax", decision=decision,
        fused=fused)


def _jax_trained(net):
    from veles_tpu.backends import Device
    wf = _create("veles_tpu", net, epochs=2 if net == "mnist" else 1)
    wf.initialize(device=Device(backend="cpu"))
    wf.run()
    return wf


def _port_carried(net, jax_wf):
    """The port's ``net`` on the CPU with ``jax_wf``'s weights."""
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.convert import workflow_params_from_jax
    wf = _create("veles_tpu_torch", net)
    wf.initialize(device=Device(backend="cpu"))
    workflow_params_from_jax(
        wf, [{k: numpy.array(v) for k, v in f.host_params.items()}
             for f in jax_wf.forwards])
    return wf


def _jax_live(wf, x):
    import jax
    from veles_tpu.export.model import forward_fn
    return numpy.asarray(jax.jit(forward_fn(wf.forwards))(
        [f.params for f in wf.forwards], x))


class Net:
    def __init__(self, name, tmp):
        self.name = name
        self.jax_wf = _jax_trained(name)
        self.wf = _port_carried(name, self.jax_wf)
        rows = {"mnist": 7, "convnet": 3, "attention": 4, "alexnet": 2}
        self.x = numpy.asarray(
            self.jax_wf.loader.original_data.map_read()[:rows[name]],
            numpy.float32)
        self.live = _jax_live(self.jax_wf, self.x)
        self.tmp = tmp
        self._paths = {}

    def package(self, side, kind="model", precision=32):
        """A package of this net written by ``side`` ("jax" / "port"):
        ``export_model`` or ``package_export``."""
        key = (side, kind, precision)
        if key not in self._paths:
            path = str(self.tmp / ("%s-%s-%s-%d.zip" % ((self.name,) + key)))
            if side == "jax":
                from veles_tpu import export
                wf = self.jax_wf
            else:
                from veles_tpu_torch import export
                wf = self.wf
            if kind == "model":
                export.export_model(wf, path, precision=precision)
            else:
                export.package_export(wf, path, precision=precision)
            self._paths[key] = path
        return self._paths[key]


_NETS = {}


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export")

    def get(name):
        if name not in _NETS:
            _NETS[name] = Net(name, tmp)
        return _NETS[name]
    yield get
    _NETS.clear()


def _zip(path):
    with zipfile.ZipFile(path) as zf:
        return {name: zf.read(name) for name in zf.namelist()}


# -- fault C10: the unit list, and so the checksum ----------------------------

@pytest.mark.parametrize("net,fused", [
    ("mnist", True), ("mnist", False), ("convnet", True),
    ("convnet", False), ("attention", True), ("attention", False),
    ("alexnet", True)])
def test_unit_order_and_checksum_equal_the_jax_workflow(net, fused):
    jwf = _create("veles_tpu", net, fused=fused)
    pwf = _create("veles_tpu_torch", net, fused=fused)
    assert [u.describe() for u in pwf] == [u.describe() for u in jwf]
    assert pwf.name == jwf.name
    assert pwf.checksum == jwf.checksum


# -- the units' package faces -------------------------------------------------

UNIT_CASES = [
    ("all2all", "All2AllTanh", {"output_sample_shape": 7}),
    ("all2all", "All2AllSoftmax",
     {"output_sample_shape": (2, 3), "include_bias": False}),
    ("conv", "ConvStrictRELU",
     {"n_kernels": 4, "kx": 3, "ky": 5, "padding": (1, 2),
      "sliding": (2, 1), "grouping": 2}),
    ("conv", "Conv", {"n_kernels": 3, "kx": 2, "ky": 2}),
    ("pooling", "MaxPooling", {"kx": 3, "ky": 3, "sliding": (2, 2)}),
    ("pooling", "AvgPooling", {"kx": 2, "ky": 3, "padding": 1}),
    ("lrn", "LRNormalizerForward",
     {"n": 3, "alpha": 0.5, "beta": 0.6, "k": 1.5}),
    ("dropout", "DropoutForward", {"dropout_ratio": 0.3}),
    ("attention", "MultiHeadAttention",
     {"heads": 2, "causal": True, "window": 4}),
    ("activation", "ForwardTanh", {}),
]


@pytest.mark.parametrize("module,cls,kwargs", UNIT_CASES,
                         ids=[c[1] + str(i) for i, c in
                              enumerate(UNIT_CASES)])
def test_export_params_describe_and_exports_equal_the_jax_units(
        module, cls, kwargs):
    import importlib
    jax_unit = getattr(importlib.import_module(
        "veles_tpu.znicz." + module), cls)(None, **kwargs)
    unit = getattr(importlib.import_module(
        "veles_tpu_torch.znicz." + module), cls)(None, **kwargs)
    assert unit.export_params() == jax_unit.export_params()
    assert json.dumps(unit.export_params()) == \
        json.dumps(jax_unit.export_params())
    assert unit.describe() == jax_unit.describe()
    assert unit.exports == jax_unit.exports


# -- package_export, byte for byte --------------------------------------------

@pytest.mark.parametrize("precision", [32, 16])
@pytest.mark.parametrize("net", NETS + ("alexnet",))
def test_package_export_equals_the_jax_package_byte_for_byte(
        nets, net, precision):
    n = nets(net)
    want = _zip(n.package("jax", "package", precision))
    got = _zip(n.package("port", "package", precision))
    assert sorted(got) == sorted(want)
    assert json.loads(got.pop("contents.json")) == \
        json.loads(want.pop("contents.json"))
    assert got, "no arrays exported"
    for name, data in want.items():
        assert got[name] == data, name


@pytest.mark.parametrize("net", NETS)
def test_model_json_equals_the_jax_metadata(nets, net):
    n = nets(net)
    want = _zip(n.package("jax"))
    got = _zip(n.package("port"))
    assert "model.stablehlo" in want and "model.stablehlo" not in got
    meta, jax_meta = (json.loads(z["model.json"]) for z in (got, want))
    assert meta.pop("format") != jax_meta.pop("format")
    assert meta == jax_meta
    from veles_tpu_torch.export import export_forward
    assert export_forward(n.wf, batch=4)["input"]["batch"] == 4


# -- a JAX package served by the port -----------------------------------------

@pytest.mark.parametrize("precision", [32, 16])
@pytest.mark.parametrize("net", NETS)
def test_port_serves_a_jax_package_as_the_jax_loader(nets, net, precision):
    from veles_tpu.export import PackageLoader as JaxLoader
    from veles_tpu_torch.export import PackageLoader
    n = nets(net)
    path = n.package("jax", precision=precision)
    want = numpy.asarray(JaxLoader(path).run(n.x))
    pkg = PackageLoader(path)
    got = pkg.run(n.x, device="cpu")
    assert got.shape == want.shape
    assert numpy.abs(got - want).max() <= PARITY_TOL
    assert pkg.workflow_name == n.jax_wf.name
    assert pkg.checksum == n.jax_wf.checksum
    one = pkg.run(n.x[:1], device="cpu")      # any batch size
    assert numpy.abs(one - want[:1]).max() <= PARITY_TOL


# -- a port package read by the JAX loader and the native engine --------------

@pytest.mark.parametrize("net", NETS)
def test_jax_loader_reads_a_port_package(nets, net):
    from veles_tpu.export import PackageLoader as JaxLoader
    n = nets(net)
    port_pkg = JaxLoader(n.package("port"))
    jax_pkg = JaxLoader(n.package("jax"))
    assert port_pkg.workflow_name == jax_pkg.workflow_name
    assert port_pkg.checksum == jax_pkg.checksum
    assert port_pkg.arrays.keys() == jax_pkg.arrays.keys()
    for unit, arrays in jax_pkg.arrays.items():
        assert port_pkg.arrays[unit].keys() == arrays.keys()
        for attr, arr in arrays.items():
            assert numpy.array_equal(port_pkg.arrays[unit][attr], arr)
    for got, want in zip(port_pkg.unit_params(), jax_pkg.unit_params()):
        assert got.keys() == want.keys()
        assert all(numpy.array_equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="stablehlo"):
        port_pkg.deserialize()


@pytest.mark.parametrize("net", NETS + ("alexnet",))
def test_native_engine_replays_a_port_package(native_build, nets, net):
    from veles_tpu_torch.export import PackageLoader
    from veles_tpu_torch.export.native import NativeWorkflow
    n = nets(net)
    path = n.package("port")
    nat = NativeWorkflow(path, library_path=os.path.join(
        native_build, "libveles_native.so"))
    try:
        assert nat.name == n.jax_wf.name
        out = nat.run(n.x)
    finally:
        nat.close()
    assert out.shape == n.live.shape
    assert numpy.abs(out - n.live).max() < NATIVE_TOL
    port = PackageLoader(path).run(n.x, device="cpu")
    assert numpy.abs(port - n.live).max() <= PARITY_TOL


# -- the mirrors of test_export.py --------------------------------------------

def test_fp16_package_loads(nets):
    """fp16 weights promote to fp32 on load: the package's forward is
    the live forward over the weights rounded to fp16, and within the
    JAX test's 2e-2 of the unrounded one."""
    from veles_tpu_torch.export import PackageLoader
    from veles_tpu_torch.export.model import forward_fn
    import torch
    n = nets("mnist")
    pkg = PackageLoader(n.package("port", precision=16))
    out = pkg.run(n.x, device="cpu")
    assert numpy.abs(out - n.live).max() < 2e-2
    rounded = [{k: torch.from_numpy(
        numpy.asarray(v, numpy.float32).astype(numpy.float16)
        .astype(numpy.float32)) for k, v in f.host_params.items()}
        for f in n.wf.forwards]
    with torch.no_grad():
        want = forward_fn(n.wf.forwards)(
            rounded, torch.from_numpy(n.x)).numpy()
    assert numpy.abs(out - want).max() <= PARITY_TOL


def test_deserialize_is_thread_safe(nets, monkeypatch):
    """Two concurrent FIRST requests rebuild the chain once: the loser
    reuses the winner's units (the JAX loader's double-checked lock
    around ``jax.export.deserialize``)."""
    from veles_tpu_torch.export import PackageLoader
    from veles_tpu_torch.export import model as export_model_mod
    pkg = PackageLoader(nets("mnist").package("port"))
    calls = []
    barrier = threading.Barrier(2)
    real = export_model_mod.build_forwards

    def slow_build(*args, **kwargs):
        calls.append(threading.get_ident())
        time.sleep(0.05)            # widen the race window
        return real(*args, **kwargs)

    monkeypatch.setattr(export_model_mod, "build_forwards", slow_build)
    results = {}

    def first_request(i):
        barrier.wait()
        results[i] = pkg.forwards("cpu")

    threads = [threading.Thread(target=first_request, args=(i,))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(calls) == 1          # one rebuild, not two
    assert results[0] is results[1] is pkg.forwards("cpu")


def test_native_cli_runner(native_build, nets, tmp_path):
    """The native binary replays a port package, and the port's runner
    (``python -m veles_tpu_torch.export.loader``, ``--device cpu``)
    writes the same answers, checked against the native engine."""
    n = nets("mnist")
    path = n.package("port")
    in_npy = str(tmp_path / "in.npy")
    numpy.save(in_npy, n.x)
    native_out = str(tmp_path / "native.npy")
    proc = subprocess.run([os.path.join(native_build, "veles_native_run"),
                           path, in_npy, native_out],
                          capture_output=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    out = numpy.load(native_out)
    assert out.shape == (7, 10)
    assert numpy.allclose(out.sum(axis=1), 1.0, atol=1e-4)  # softmax
    port_out = str(tmp_path / "port.npy")
    env = dict(os.environ,
               VELES_NATIVE_LIB=os.path.join(native_build,
                                             "libveles_native.so"))
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.export.loader", path,
         in_npy, port_out, "--device", "cpu", "--check-native"],
        capture_output=True, timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert b"native engine: max |port - native|" in proc.stdout
    port = numpy.load(port_out)
    assert numpy.abs(port - n.live).max() <= PARITY_TOL
    assert numpy.abs(port - out).max() < NATIVE_TOL


# -- the chain's classes ------------------------------------------------------

def test_a_class_the_port_lacks_raises_naming_its_item(nets):
    from veles_tpu_torch.export import build_forwards
    meta = json.loads(_zip(nets("mnist").package("port"))["model.json"])
    for cls, item in (("ResizableAll2All", "item 9"),
                      ("StochasticPooling", "item 6")):
        bad = dict(meta, forwards=[dict(meta["forwards"][0], **{
            "class": cls})])
        with pytest.raises(NotImplementedError, match=item):
            build_forwards(bad, device="cpu")
    bad = dict(meta, forwards=[dict(meta["forwards"][0],
                                    **{"class": "NoSuchUnit"})])
    with pytest.raises(ValueError, match="NoSuchUnit"):
        build_forwards(bad, device="cpu")


def test_structural_classes_raise_that_no_configuration_is_recorded(nets):
    """The ``misc_units`` forwards are ported, but a package does not
    record their structure (the JAX units define no ``export_params``),
    so a chain holding one is refused with that reason; the stochastic
    pooling classes still wait for item 6 (6b)."""
    from veles_tpu.znicz import misc_units as jax_misc
    from veles_tpu.znicz.nn_units import ForwardBase as JaxForwardBase
    from veles_tpu_torch.export import build_forwards
    meta = json.loads(_zip(nets("mnist").package("port"))["model.json"])
    for cls in ("Cutter", "ChannelSplitter", "ChannelMerger", "ZeroFiller",
                "Deconv", "Depooling"):
        assert getattr(jax_misc, cls).export_params is \
            JaxForwardBase.export_params, cls
        bad = dict(meta, forwards=[dict(meta["forwards"][0], **{
            "class": cls, "config": {}})])
        with pytest.raises(NotImplementedError,
                           match="%s cannot be served: the JAX package "
                           "records no configuration for it" % cls):
            build_forwards(bad, device="cpu")
    for cls in ("StochasticPooling", "StochasticAbsPooling",
                "StochasticPoolingDepooling",
                "StochasticAbsPoolingDepooling"):
        bad = dict(meta, forwards=[dict(meta["forwards"][0], **{
            "class": cls})])
        with pytest.raises(NotImplementedError, match="item 6"):
            build_forwards(bad, device="cpu")


def test_rebuilt_chain_is_the_live_forward(nets):
    """Each net's rebuilt chain, over the package's weights, gives the
    port's live forward bit for bit on the CPU (the same units' apply)."""
    import torch
    from veles_tpu_torch.export import PackageLoader
    from veles_tpu_torch.export.model import forward_fn
    for net in NETS:
        n = nets(net)
        pkg = PackageLoader(n.package("port"))
        units = pkg.forwards("cpu")
        assert [type(u).__name__ for u in units] == \
            [type(f).__name__ for f in n.wf.forwards]
        assert [u.name for u in units] == [f.name for f in n.wf.forwards]
        with torch.no_grad():
            x = torch.from_numpy(n.x)
            live = forward_fn(n.wf.forwards)(
                [f.params for f in n.wf.forwards], x).numpy()
        assert numpy.array_equal(pkg.run(n.x, device="cpu"), live)
