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
  operand's device.
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
                 "znicz.samples.alexnet", "znicz.samples.cifar"):
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
