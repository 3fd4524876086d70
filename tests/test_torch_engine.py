"""The port's unit engine against the JAX package's.

The host-only modules (``config``, ``mutable``, ``units``,
``workflow``/``plumbing``) are copies; the same scenarios of
``tests/test_config.py``, ``test_mutable.py`` and ``test_units.py`` run
through both packages and must behave alike.  ``memory.Array`` keeps
``tests/test_backends_memory.py``'s validity protocol over torch
tensors, ``Device()`` means the card (and raises without one), and the
port's ``RandomGenerator`` gives the JAX package's bytes for the same
seed (exact equality: both are numpy's Mersenne Twister).
"""

import importlib
import pickle

import numpy
import pytest
import torch

PACKAGES = ["veles_tpu", "veles_tpu_torch"]


def _mod(pkg, name):
    return importlib.import_module("%s.%s" % (pkg, name))


# -- config ------------------------------------------------------------------

def _config_story(pkg):
    cfg = _mod(pkg, "config")
    c = cfg.Config("test")
    c.a.b.value = 3
    c.update({"x": {"y": 1, "z": {"w": 2}}, "top": "s"})
    c.update({"x": {"y": 10}})
    c.update({"lr": cfg.Range(0.1, 0.001, 1.0), "fn": lambda: 7,
              "sub": {"b": cfg.Range(1, [1, 2, 3])}})
    seen = (c.a.b.path, c.get("lr"), c.get("fn"), c.get("absent", "d"),
            sorted(dict(cfg.get_config_ranges(c))))
    with pytest.raises(AttributeError):
        setattr(c, "update", 5)
    with pytest.raises(TypeError):
        c.update(42)
    cfg.fix_config(c)
    cfg.set_config_by_path(c, "test.x.z.w", 5)
    out = c.todict()
    out.pop("fn")
    return seen, out


def test_config_behaves_as_in_jax():
    assert _config_story("veles_tpu_torch") == _config_story("veles_tpu")


# -- mutable -----------------------------------------------------------------

def _bool_story(pkg):
    Bool = _mod(pkg, "mutable").Bool
    a, b, c = Bool(False), Bool(False), Bool(False)
    exprs = [a | b, a & ~b, a ^ b, (a | b) & ~c, a | True, a & False]
    table = []
    for va in (False, True):
        for vb in (False, True):
            for vc in (False, True):
                a <<= va
                b <<= vb
                c <<= vc
                table.append([bool(e) for e in exprs])
    fired = []
    d = Bool(False)
    d.on_true = lambda: fired.append("t")
    d.on_false = lambda: fired.append("f")
    for v in (True, True, False):
        d <<= v
    with pytest.raises(ValueError):
        exprs[0] <<= True
    restored = pickle.loads(pickle.dumps(exprs[0]))
    return table, fired, bool(restored), restored.is_derived


def test_bool_algebra_behaves_as_in_jax():
    assert _bool_story("veles_tpu_torch") == _bool_story("veles_tpu")


# -- units / workflow --------------------------------------------------------

def _graph_story(pkg):
    """test_units.py's chain, AND gate, skip, block, Repeater loop,
    linked attributes and deferred init on one package; returns what
    ran, in order."""
    units = _mod(pkg, "units")
    Workflow = _mod(pkg, "workflow").Workflow
    Repeater = _mod(pkg, "plumbing").Repeater
    Bool = _mod(pkg, "mutable").Bool
    trace = []

    class Counting(units.TrivialUnit):
        def run(self):
            trace.append(self.name)

    wf = Workflow(name="w")
    a, b, c, skip = (Counting(wf, name=n) for n in ("a", "b", "c", "skip"))
    a.link_from(wf.start_point)
    b.link_from(wf.start_point)
    skip.link_from(a, b)                 # AND gate over a and b
    c.link_from(skip)
    wf.end_point.link_from(c)
    skip.gate_skip <<= True
    wf.initialize()
    wf.run()
    story = [list(trace), wf.is_finished]

    trace.clear()
    wf = Workflow(name="loop")
    rep = Repeater(wf)
    body = Counting(wf, name="body")
    done = Bool(False)
    blocked = Counting(wf, name="blocked")

    class Decision(Counting):
        def run(self):
            super().run()
            if trace.count("body") >= 5:
                done.__ilshift__(True)

    dec = Decision(wf, name="dec")
    rep.link_from(wf.start_point)
    body.link_from(rep)
    dec.link_from(body)
    rep.link_from(dec)
    blocked.link_from(dec)
    blocked.gate_block <<= True
    wf.end_point.link_from(dec)
    rep.gate_block = done
    wf.end_point.gate_block = ~done
    wf.initialize()
    wf.run()
    story += [list(trace), wf.is_finished]

    src, dst = Counting(wf, name="src"), Counting(wf, name="dst")
    src.payload, src.value = 1, 1
    dst.link_attrs(src, "payload")
    dst.link_attrs(src, ("mirror", "value"), two_way=True)
    src.payload = 42
    dst.mirror = 9
    live = (dst.payload, src.value)
    dst.payload = 7                      # a one-way write breaks the link
    story += [live, (dst.payload, src.payload)]
    with pytest.raises(AttributeError):
        dst.link_attrs(src, "no_such_attr")

    tries = []

    class Deferring(units.TrivialUnit):
        def initialize(self, **kwargs):
            tries.append(self.name)
            if len(tries) < 3:
                return True
            super().initialize(**kwargs)

    wf = Workflow(name="deferred")
    d = Deferring(wf, name="d")
    d.link_from(wf.start_point)
    wf.end_point.link_from(d)
    wf.initialize()
    return story + [tries, d.is_initialized]


def test_unit_graph_runs_as_in_jax():
    mine = _graph_story("veles_tpu_torch")
    assert mine == _graph_story("veles_tpu")
    assert mine[0] == ["a", "b", "c"] and mine[1]
    assert mine[2].count("body") == 5 and "blocked" not in mine[2]


# -- device and memory -------------------------------------------------------

def test_device_means_the_card_and_raises_without_one(monkeypatch):
    from veles_tpu_torch.backends import CPUDevice, CUDADevice, Device
    from veles_tpu_torch.znicz.samples import mnist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("VELES_BACKEND", raising=False)
    for make in (Device, lambda: Device(backend="auto"),
                 lambda: Device(backend="cuda"), CUDADevice):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(ValueError):
        Device(backend="numpy")          # no host pseudo-device yet
    cpu = Device(backend="cpu")
    assert isinstance(cpu, CPUDevice)
    assert cpu.torch_device == torch.device("cpu")
    monkeypatch.setenv("VELES_BACKEND", "cpu")
    assert isinstance(Device(), CPUDevice)
    monkeypatch.delenv("VELES_BACKEND")
    # the workflow entry point: initialize() with no device is the card
    wf = mnist.create_workflow(loader={"n_train": 60, "n_valid": 60})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wf.initialize()


def test_array_validity_protocol():
    from veles_tpu_torch.memory import Array, Watcher
    a = Array(numpy.arange(12, dtype=numpy.float32).reshape(3, 4))
    assert a.shape == (3, 4) and a.sample_size == 4
    with pytest.raises(RuntimeError, match="no device"):
        a.devmem
    a.initialize("cpu")
    dm = a.devmem
    assert isinstance(dm, torch.Tensor)
    assert numpy.array_equal(dm.numpy(), a.mem)
    dm[0, 0] = -1                        # the two copies never alias
    assert a.mem[0, 0] == 0
    a.map_write()[0, 0] = 99             # host newer: unmap re-uploads
    a.unmap()
    assert float(a.devmem[0, 0]) == 99
    a.devmem = torch.ones((3, 4))        # device newer: map_read pulls
    assert a.map_read()[0, 0] == 1.0
    a.map_invalidate()[...] = 5          # host overwritten, no pull
    assert float(a.devmem[2, 3]) == 5
    Watcher.reset()
    b = Array(numpy.zeros(1024, numpy.float32)).initialize("cpu")
    _ = b.devmem
    assert Watcher.bytes_in_use == 4096
    b.reset()
    assert Watcher.bytes_in_use == 0
    c = pickle.loads(pickle.dumps(a))
    assert numpy.array_equal(c.mem, a.map_read())
    a.shallow_pickle = True
    assert pickle.loads(pickle.dumps(a)).mem is None


def test_accelerated_unit_runs_its_kernel_on_the_device():
    from veles_tpu_torch.accelerated_units import AcceleratedUnit
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.workflow import Workflow

    class Doubler(AcceleratedUnit):
        def __init__(self, workflow, **kwargs):
            super().__init__(workflow, **kwargs)
            self.input = Array(numpy.arange(6, dtype=numpy.float32))
            self.output = Array()
            self.device_inputs = ["input"]
            self.device_outputs = ["output"]

        def kernel(self, x):
            return 2 * x + 1

    u = Doubler(Workflow(name="w"))
    u.initialize(device=Device(backend="cpu"))
    u.run()
    assert numpy.array_equal(u.output.map_read(),
                             2 * numpy.arange(6, dtype=numpy.float32) + 1)


# -- prng --------------------------------------------------------------------

def _prng_bytes(pkg):
    prng = _mod(pkg, "prng")
    g = prng.RandomGenerator().seed(1234)
    w = numpy.zeros((784, 100), numpy.float32)
    g.fill(w, -0.05, 0.05)
    idx = numpy.arange(1000, dtype=numpy.int32)
    g.shuffle(idx)
    state = pickle.dumps(g)
    tail = g.uniform(size=4)
    return (w.tobytes(), idx.tobytes(), g.normal(size=8).tobytes(),
            g.randint(0, 10, 16).tobytes(), tail.tobytes(),
            pickle.loads(state).uniform(size=4).tobytes())


def test_random_generator_gives_the_jax_bytes():
    mine, theirs = _prng_bytes("veles_tpu_torch"), _prng_bytes("veles_tpu")
    assert mine == theirs
    assert mine[4] == mine[5]            # state save/restore replays
    from veles_tpu_torch import prng
    assert prng.get(0) is prng.get(0)
    assert prng.get(1) is not prng.get(0)
