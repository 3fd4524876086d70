"""The port stands alone: no JAX, nothing of veles_tpu, the card by default.

- A fresh interpreter imports ``veles_tpu_torch`` and every submodule;
  afterwards ``sys.modules`` holds no ``jax`` and no ``veles_tpu`` /
  ``veles_tpu.*`` (matched by exact name: ``veles_tpu_torch`` itself
  begins with ``veles_tpu``).
- The digits fixture of the MNIST sample is read by path from
  ``veles_tpu/fixtures/digits``: loading it imports nothing of
  ``veles_tpu`` either.
- ``chip_smoke.py`` imports neither, read from its source.
- Every entry point called without ``device`` on a machine without CUDA
  raises instead of running on the CPU (CUDA is hidden with
  ``monkeypatch`` so the check means the same on any machine): the
  serving face, and the AlexNet and CIFAR samples' workflows, the LRN
  unit and the threefry draws (slice 4); the LRN wrappers run on their
  operand's device; ``ToyDecodeModel`` and the int8-KV append wrapper
  (slice 12), which takes its plain version for CPU tensors without
  counting a launch; the bucket scheduler, the classifier route, the
  fleet and the replica command line (slice 15); the autotuner's probes
  and a decode scheduler resolving ``"auto"`` (slice 16); graph mode's
  workflows (softmax and MSE), its GD and evaluator units and the
  ``InputJoiner`` (slice 17); a package's ``PackageLoader`` (its chain,
  its run), ``build_forwards``, a package served by the scheduler, the
  registry and the server, ``RESTfulAPI`` and the package runner's
  command line (slice 19); a restored workflow's ``initialize()``, the
  ``ShardedBatchLoader`` and a snapshotting ``StandardWorkflow`` (slice
  20); the STL-10 and VideoAE samples' workflows in both modes and a
  ``Deconv`` unit (slice 21).
- A fleet replica run as a subprocess (``python -X importtime -m
  veles_tpu_torch.fleet.replica --device cpu``, serving ``sleep:`` and
  ``toydecode:``, answering both routes) imports neither, read from the
  interpreter's own import log; nor does the package runner (``python
  -X importtime -m veles_tpu_torch.export.loader``) replaying a
  package.
"""

import ast
import json
import os
import subprocess
import sys

import numpy
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _foreign(name):
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name.startswith("jaxlib.") or name == "veles_tpu"
            or name.startswith("veles_tpu."))


def test_package_imports_no_jax_and_nothing_of_veles_tpu():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import veles_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    veles_tpu_torch.__path__, 'veles_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from veles_tpu_torch import datasets\n"
        "_, (images, _), provenance = datasets.load_digits_idx(60, 60)\n"
        "print(json.dumps({'imported': names,\n"
        "                  'fixture': datasets.fixture_dir(),\n"
        "                  'provenance': provenance,\n"
        "                  'valid_images': len(images),\n"
        "                  'modules': sorted(sys.modules)}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "veles_tpu_torch.serving.server" in report["imported"]
    assert "veles_tpu_torch.znicz.samples.flagship" in report["imported"]
    assert "veles_tpu_torch.convert" in report["imported"]
    for name in ("config", "mutable", "units", "workflow", "plumbing",
                 "memory", "backends", "accelerated_units", "prng",
                 "datasets", "normalization", "loader.base",
                 "loader.fullbatch", "znicz.nn_units", "znicz.all2all",
                 "znicz.gd", "znicz.solvers", "znicz.evaluator",
                 "znicz.decision", "znicz.fused", "znicz.standard_workflow",
                 "znicz.samples.mnist", "znicz.attention",
                 "znicz.flash_attention", "parallel.ring", "znicz.conv",
                 "znicz.gd_conv", "znicz.pooling", "znicz.gd_pooling",
                 "znicz.lrn", "znicz.dropout", "znicz.activation",
                 "znicz.samples.alexnet", "znicz.samples.cifar",
                 "serving.toydecode", "serving.kvcache",
                 "znicz.paged_attention", "serving.sessions", "checkpoint",
                 "checkpoint.store", "checkpoint.manifest",
                 "checkpoint.tensors", "checkpoint.snapshot", "kvtier",
                 "kvtier.store", "kvtier.directory",
                 "observability.registry", "observability.trace",
                 "observability.flight", "observability.attribution",
                 "observability.profiler", "distributed",
                 "serving.scheduler", "serving.registry",
                 "serving.metrics", "fleet", "fleet.router",
                 "fleet.supervisor", "fleet.replica", "fleet.chaos",
                 "fleet.__main__", "compilecache", "compilecache.keys",
                 "compilecache.store", "compilecache.manifest",
                 "compilecache.cache", "autotune", "autotune.space",
                 "autotune.store", "autotune.dispatch", "autotune.runner",
                 "autotune.probe", "autotune.__main__", "input_joiner",
                 "export", "export.packager", "export.model",
                 "export.loader", "export.native", "restful_api",
                 "snapshotter", "loader.shards", "znicz.misc_units",
                 "znicz.samples.stl10", "znicz.samples.video_ae"):
        assert "veles_tpu_torch." + name in report["imported"], name
    assert report["fixture"] == os.path.join(ROOT, "veles_tpu", "fixtures",
                                             "digits")
    assert report["provenance"] == "fixture"
    assert report["valid_images"] == 60
    assert [m for m in report["modules"] if _foreign(m)] == []


def test_chip_smoke_imports_no_jax_and_nothing_of_veles_tpu():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module or "")
    assert "veles_tpu_torch" in {m.split(".")[0] for m in imported}
    assert [m for m in imported if _foreign(m)] == []


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    from veles_tpu_torch.convert import params_from_jax
    from veles_tpu_torch.device import resolve_device
    from veles_tpu_torch.serving import DecodeScheduler, InferenceServer
    from veles_tpu_torch.znicz.samples.flagship import (FlagshipDecodeModel,
                                                        init_decode_params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    geo = dict(stages=1, experts=2, d=8, heads=2, hidden=8, vocab=16)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        FlagshipDecodeModel(**geo)
    with pytest.raises(RuntimeError):
        init_decode_params(**geo)
    with pytest.raises(RuntimeError):
        params_from_jax({})
    cpu_model = FlagshipDecodeModel(**geo, device="cpu")
    assert cpu_model.device == torch.device("cpu")
    with pytest.raises(RuntimeError):
        DecodeScheduler(cpu_model, max_prompt_len=4, max_new_tokens=4)
    with pytest.raises(RuntimeError):
        InferenceServer({"m": cpu_model}, max_prompt_len=4,
                        max_new_tokens=4)
    sched = DecodeScheduler(cpu_model, max_prompt_len=4, max_new_tokens=4,
                            device="cpu")
    try:
        assert len(sched.generate([1, 2], 2, timeout=60)["tokens"]) == 2
    finally:
        sched.close()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_slice4_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    """The samples' workflows and the LRN unit initialize on the card by
    default and raise without one; the LRN wrappers' device is their
    operand's (a CPU tensor is the ask), and they refuse any other."""
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.workflow import Workflow
    from veles_tpu_torch.znicz import lrn
    from veles_tpu_torch.znicz.samples import alexnet, cifar
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = {"alexnet": dict(n_train=4, n_valid=4, side=67, n_classes=5,
                             minibatch_size=4),
             "cifar": dict(n_train=20, n_valid=10, minibatch_size=10)}
    for sample in (alexnet, cifar):
        wf = sample.create_workflow(
            loader=small[sample.__name__.rsplit(".", 1)[1]],
            decision={"max_epochs": 1, "silent": True})
        with pytest.raises(RuntimeError):
            wf.initialize()
    unit = lrn.LRNormalizerForward(Workflow(name="w"))
    unit.input = Array(numpy.ones((2, 3, 3, 8), numpy.float32))
    with pytest.raises(RuntimeError):
        unit.initialize()
    unit.initialize(device=Device(backend="cpu"))
    assert not unit._resolved_use_pallas()    # the band form on the CPU
    x = torch.ones((2, 8))
    launches = lrn.lrn.launches, lrn.lrn_backward.launches
    assert torch.equal(lrn.lrn(x), lrn.lrn_reference(x))
    assert torch.equal(lrn.lrn_backward(x, x),
                       lrn.lrn_backward_reference(x, x))
    assert (lrn.lrn.launches, lrn.lrn_backward.launches) == launches
    with pytest.raises(ValueError):
        lrn.lrn(torch.ones((2, 8), device="meta"))
    from veles_tpu_torch import prng
    with pytest.raises(RuntimeError):
        prng.bernoulli(prng.key(1), 0.5, (4,))
    assert prng.bernoulli(prng.key(1), 0.5, (4,), "cpu").shape == (4,)


def test_slice12_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    """``ToyDecodeModel`` keeps its pools on the card by default and
    raises without one; the int8-KV append runs on its operands' device
    (a CPU tensor is the ask) and counts only kernel launches."""
    from veles_tpu_torch.serving import DecodeScheduler, ToyDecodeModel
    from veles_tpu_torch.znicz import paged_attention as pa
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ToyDecodeModel(vocab=31)
    toy = ToyDecodeModel(vocab=31, device="cpu")
    k_pools, _ = toy.make_pools(4, 4)
    assert k_pools[0].device == torch.device("cpu")
    with pytest.raises(RuntimeError):
        DecodeScheduler(toy, max_prompt_len=4, max_new_tokens=4,
                        prefill_chunk_tokens=4, prefix_caching=True)
    q = torch.zeros((3, 4, 2, 8), dtype=torch.int8)
    s = torch.zeros((3, 2))
    blk = torch.tensor([1, 1, 2])
    off = torch.tensor([0, 1, 0])
    vals = torch.ones((3, 2, 8))
    launches = pa.kv_append_int8.launches
    pa.kv_append_int8(q, s, blk, off, vals)
    want_q, want_s = torch.zeros_like(q), torch.zeros_like(s)
    pa.kv_append_int8_reference(want_q, want_s, blk, off, vals)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert int(q[1, 0].max()) == 127 and pa.kv_append_int8.launches == \
        launches


def test_slice15_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    """The bucket scheduler, the classifier route, the fleet supervisor
    and the replica command line run on the card by default and raise
    without one; ``device="cpu"`` is the ask."""
    from veles_tpu_torch.fleet import Fleet, ReplicaSupervisor, replica
    from veles_tpu_torch.serving import BucketScheduler, InferenceServer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        BucketScheduler(lambda x: x, sample_shape=(2,))
    server = InferenceServer()
    try:
        with pytest.raises(RuntimeError):
            server.add_model("m", lambda x: x, sample_shape=(2,))
        assert server.registry.names() == []
    finally:
        server.stop()
    with pytest.raises(RuntimeError):
        ReplicaSupervisor({"m": "sleep:0.001:2"}, replicas=1)
    with pytest.raises(RuntimeError):
        Fleet({"m": "sleep:0.001:2"}, replicas=1)
    with pytest.raises(RuntimeError):
        replica.main(["--model", "m=sleep:0.001:2"])
    sched = BucketScheduler(lambda x: x * 2, sample_shape=(2,),
                            device="cpu")
    try:
        out = sched.submit(numpy.ones((1, 2), numpy.float32)).result(30)
        assert out.tolist() == [[2.0, 2.0]]
    finally:
        sched.close()
    sup = ReplicaSupervisor({"m": "sleep:0.001:2"}, replicas=1,
                            device="cpu")
    assert sup._argv("r0")[-4:-2] == ["--device", "cpu"]


def test_slice16_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    """A probe with no device in its context asks for the card (its
    candidates fail: no winner, the default stays); a decode scheduler
    resolving ``"auto"`` still needs the card unless told the CPU."""
    from veles_tpu_torch.autotune import probe
    from veles_tpu_torch.serving import DecodeScheduler, ToyDecodeModel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = probe.measure("precise_gemm", {"split": "rule"},
                        {"m": 8, "k": 8, "n": 8}, reps=1, windows=1)
    assert not out["ok"] and "no CUDA device" in out["error"]
    out = probe.measure("precise_gemm", {"split": "rule"},
                        {"m": 8, "k": 8, "n": 8, "device": "cpu"},
                        reps=1, windows=1)
    assert out["ok"] and out["gate"] == "passed"
    with pytest.raises(RuntimeError):
        ToyDecodeModel(vocab=31)
    toy = ToyDecodeModel(vocab=31, device="cpu")
    with pytest.raises(RuntimeError):      # the scheduler's default card
        DecodeScheduler(toy, spec_depth="auto")
    s = DecodeScheduler(toy, spec_depth="auto", device="cpu")
    s.close()


def test_slice17_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    """Graph mode (``fused=False``) and the MSE loss initialize on the
    card by default and raise without one; so do a standalone GD unit,
    an evaluator and the ``InputJoiner``.  Told the CPU, they run
    there."""
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.input_joiner import InputJoiner
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.workflow import Workflow
    from veles_tpu_torch.znicz.evaluator import EvaluatorMSE
    from veles_tpu_torch.znicz.gd import GDTanh
    from veles_tpu_torch.znicz.samples import mnist
    from veles_tpu_torch.loader import FullBatchLoaderMSE
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

    class Regression(FullBatchLoaderMSE):
        hide_from_registry = True

        def load_data(self):
            self.original_data.mem = numpy.ones((8, 3), numpy.float32)
            self.original_targets.mem = numpy.ones((8, 2), numpy.float32)
            self.class_lengths[1:] = [4, 4]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loader = {"n_train": 60, "n_valid": 60}
    with pytest.raises(RuntimeError):
        mnist.create_workflow(fused=False, loader=loader).initialize()
    for fused in (False, True):
        mse = StandardWorkflow(
            None, loader_factory=Regression, loss_function="mse",
            loader={"minibatch_size": 4}, fused=fused,
            layers=[{"type": "all2all", "->": {"output_sample_shape": 2}}],
            decision={"max_epochs": 1, "silent": True})
        with pytest.raises(RuntimeError):
            mse.initialize()
        mse.initialize(device=Device(backend="cpu"))
        mse.run()
        assert mse.decision.best_rmse is not None
    wf = mnist.create_workflow(fused=False, loader=loader,
                               decision={"max_epochs": 1, "silent": True})
    wf.initialize(device=Device(backend="cpu"))
    wf.run()
    assert wf.forwards[0].weights.devmem.device == torch.device("cpu")
    for unit in (GDTanh(Workflow(name="w")), EvaluatorMSE(Workflow(
            name="w")), InputJoiner(Workflow(name="w"))):
        with pytest.raises(RuntimeError):
            unit.initialize()
    gd = GDTanh(Workflow(name="w"))
    gd.err_output = Array(numpy.ones((2, 3), numpy.float32))
    gd.initialize(device=Device(backend="cpu"))
    assert gd.err_output.devmem.device == torch.device("cpu")


def _mnist_package(path):
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.export import export_model
    from veles_tpu_torch.znicz.samples import mnist
    wf = mnist.create_workflow(loader={"n_train": 60, "n_valid": 60},
                               decision={"max_epochs": 1, "silent": True})
    wf.initialize(device=Device(backend="cpu"))
    return export_model(wf, str(path))


def test_slice19_entry_points_need_a_card_unless_told_cpu(monkeypatch,
                                                          tmp_path):
    """A package's chain, its run, a package served by the scheduler,
    the registry and the server, and the RESTful facade default to the
    card and raise without one; told the CPU, each serves.  The runner's
    command line without ``--device`` exits non-zero where torch sees
    no card."""
    from veles_tpu_torch.export import PackageLoader, build_forwards
    from veles_tpu_torch.restful_api import RESTfulAPI
    from veles_tpu_torch.serving import (BucketScheduler, InferenceServer,
                                         ModelRegistry)
    path = _mnist_package(tmp_path / "mnist.zip")
    x = numpy.zeros((2, 784), numpy.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pkg = PackageLoader(path)
    for call in (lambda: pkg.forwards(), lambda: pkg.run(x),
                 lambda: pkg.params(),
                 lambda: build_forwards(pkg.model_metadata),
                 lambda: BucketScheduler(path),
                 lambda: ModelRegistry().load_package("m", path),
                 lambda: InferenceServer({"m": path}),
                 lambda: RESTfulAPI(path)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert pkg.run(x, device="cpu").shape == (2, 10)
    sched = BucketScheduler(path, max_batch=2, device="cpu")
    try:
        assert sched.infer(x).shape == (2, 10)
    finally:
        sched.close()
    api = RESTfulAPI(path, max_batch=2, device="cpu")
    try:
        assert api.infer(x)[1].shape == (2, 10)
    finally:
        api.stop()
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.export.loader", path,
         "random"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr


def test_slice20_entry_points_need_a_card_unless_told_cpu(monkeypatch,
                                                          tmp_path):
    """A workflow restored from a snapshot (pickle and shards) and a
    snapshotting ``StandardWorkflow`` initialize on the card without a
    device and raise without one, as does a ``ShardedBatchLoader``;
    told the CPU, each runs there (a restored workflow written on any
    device: a snapshot carries none)."""
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.loader import ShardedBatchLoader, write_shards
    from veles_tpu_torch.snapshotter import restore
    from veles_tpu_torch.workflow import Workflow
    from veles_tpu_torch.znicz.samples import mnist
    cpu = Device(backend="cpu")
    loader = {"n_train": 60, "n_valid": 60}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fmt in ("pickle", "shards"):
        snap = {"prefix": fmt, "directory": str(tmp_path / fmt),
                "time_interval": 0, "format": fmt}
        wf = mnist.create_workflow(loader=loader, snapshotter=snap,
                                   decision={"max_epochs": 1,
                                             "silent": True})
        with pytest.raises(RuntimeError, match="CUDA"):
            wf.initialize()
        wf.initialize(device=cpu)
        wf.run()
        current = str(tmp_path / fmt / (fmt + "_current"))
        with pytest.raises(RuntimeError, match="CUDA"):
            restore(current).initialize()
        back = restore(current)
        back.decision.max_epochs = 2
        back.initialize(device=cpu)
        back.run()
        assert back.fused_step._dev_ == torch.device("cpu")
    write_shards(str(tmp_path / "ds"), numpy.ones((8, 3), numpy.float32),
                 labels=[0, 1] * 4, class_lengths=[0, 4, 4])
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedBatchLoader(Workflow(name="w"), path=str(tmp_path / "ds"),
                           minibatch_size=4).initialize()
    sharded = ShardedBatchLoader(Workflow(name="w"),
                                 path=str(tmp_path / "ds"),
                                 minibatch_size=4)
    sharded.initialize(device=cpu)
    sharded.run()
    assert sharded.minibatch_data.devmem.device == torch.device("cpu")


def test_slice21_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    """The STL-10 and VideoAE samples' workflows, fused and in graph
    mode, and a ``Deconv`` unit initialize on the card without a device
    and raise without one; told the CPU, each runs there."""
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.workflow import Workflow
    from veles_tpu_torch.znicz.misc_units import Deconv
    from veles_tpu_torch.znicz.samples import stl10, video_ae
    cpu = Device(backend="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod, loader in ((stl10, {"n_train": 50, "n_valid": 50}),
                        (video_ae, {"n_train": 50, "n_valid": 50})):
        for fused in (True, False):
            wf = mod.create_workflow(fused=fused, loader=loader,
                                     decision={"max_epochs": 1,
                                               "silent": True})
            with pytest.raises(RuntimeError, match="CUDA"):
                wf.initialize()
            wf = mod.create_workflow(fused=fused, loader=loader,
                                     decision={"max_epochs": 1,
                                               "silent": True})
            wf.initialize(device=cpu)
            wf.run()
            assert wf.forwards[-1].output.devmem.device == \
                torch.device("cpu")
    x = numpy.zeros((2, 6, 6, 3), numpy.float32)
    unit = Deconv(Workflow(name="w"), n_kernels=2, kx=3, ky=3, padding=1)
    unit.input = Array(x)
    with pytest.raises(RuntimeError, match="CUDA"):
        unit.initialize()
    unit = Deconv(Workflow(name="w"), n_kernels=2, kx=3, ky=3, padding=1)
    unit.input = Array(x)
    unit.initialize(device=cpu)
    unit.run()
    assert unit.output.devmem.shape == (2, 6, 6, 2)


def test_package_runner_subprocess_imports_no_jax(tmp_path):
    path = _mnist_package(tmp_path / "mnist.zip")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = str(tmp_path / "out.npy")
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "veles_tpu_torch.export.loader", path, "random", out,
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "input (2, 784) -> output (2, 10)" in proc.stdout
    assert numpy.load(out).shape == (2, 10)
    names = {line.rsplit("|", 1)[-1].strip()
             for line in proc.stderr.splitlines()
             if line.startswith("import time:") and "|" in line}
    assert "veles_tpu_torch.export.model" in names
    assert [m for m in names if _foreign(m)] == []


def test_fleet_replica_subprocess_imports_no_jax(tmp_path):
    """A replica process, asked for the CPU, serving a classifier and a
    decode model: its import log names no jax and nothing of
    veles_tpu."""
    import signal
    import time
    import urllib.request
    env = dict(os.environ, PYTHONPATH=ROOT)
    log_path = tmp_path / "imports.log"
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m",
             "veles_tpu_torch.fleet.replica", "--device", "cpu",
             "--model", "m=sleep:0.001:2",
             "--model", "toy=toydecode:vocab=31,max_prompt=8,max_new=4"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=log_file,
            text=True)
    try:
        announce = json.loads(proc.stdout.readline())["fleet_replica"]
        url = "http://127.0.0.1:%d" % announce["port"]
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(url + "/readyz",
                                            timeout=10) as resp:
                    if resp.status == 200:
                        break
            except OSError:
                pass
            assert time.monotonic() < deadline, "replica never ready"
            time.sleep(0.1)
        for route, payload in (("/api/m", {"input": [[1.0, 2.0]]}),
                               ("/api/toy/generate", {"prompt": [1, 2]})):
            req = urllib.request.Request(
                url + route, json.dumps(payload).encode(),
                {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0
    log = log_path.read_text()
    imported = [line.rsplit("|", 1)[-1].strip()
                for line in log.splitlines()
                if line.startswith("import time:") and "|" in line]
    names = {name for name in imported if name and name != "package"}
    assert "veles_tpu_torch.fleet.replica" in names or \
        "veles_tpu_torch.serving.server" in names
    assert "veles_tpu_torch.serving.scheduler" in names
    assert "torch" in names
    assert [m for m in names if _foreign(m)] == []
