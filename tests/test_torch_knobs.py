"""Knobs of the JAX workflow that the port does not honour yet raise.

The JAX ``StandardWorkflow`` reads ``snapshotter``, ``epoch_scan``,
``mesh``, ``model_axis``, ``tp_mode`` and ``graph_compile``; its fused
step reads ``compute_dtype``, ``root.common.engine.dtype`` and
``root.common.engine.rng_impl``.  The port refuses each of them, set to
anything but its default, with a ``NotImplementedError`` that names the
knob, so no config trains differently here without a word.  Three stay
accepted: ``web_status`` (ignored), ``precision_level`` (the port is
IEEE f32 already) and ``compute_confusion_matrix=False`` (the port
always computes the matrix).  The MNIST sample at a cut size is the
workflow under test (construction only).

The decode scheduler's options, once refused the same way, are taken:
``"auto"`` for ``prefill_chunk_tokens``, ``spec_depth`` or ``kv_dtype``
resolves through its autotune site (ROADMAP queue A item 3; the tuner
off gives the site's default), and ``kvtier`` builds a tier stack (a
host tier, a disk tier, both, or a ready ``TieredKVStore``).
"""

import pytest

from veles_tpu_torch.backends import Device
from veles_tpu_torch.kvtier import TieredKVStore
from veles_tpu_torch.serving import DecodeScheduler, ToyDecodeModel
from veles_tpu_torch.config import root
from veles_tpu_torch.znicz.samples import mnist

LOADER = {"n_train": 60, "n_valid": 60}

#: (label, create_workflow overrides, root.common.engine settings, the
#: name the error must carry)
REFUSED = [
    ("snapshotter", {"snapshotter": {"prefix": "mnist"}}, {},
     "snapshotter"),
    ("epoch_scan", {"epoch_scan": True}, {}, "epoch_scan"),
    ("mesh", {"mesh": object()}, {}, "mesh"),
    ("model_axis", {"model_axis": "model"}, {}, "model_axis"),
    ("tp_mode", {"tp_mode": "row"}, {}, "tp_mode"),
    ("graph_compile", {"graph_compile": True}, {}, "graph_compile"),
    ("compute_dtype", {"trainer": {"compute_dtype": "bfloat16"}}, {},
     "compute_dtype"),
    ("engine.dtype", {}, {"dtype": "bfloat16"}, "root.common.engine.dtype"),
    ("engine.rng_impl", {}, {"rng_impl": "rbg"},
     "root.common.engine.rng_impl"),
]


@pytest.fixture
def engine():
    """root.common.engine with the keys a case sets removed again."""
    touched = []

    def set_(**values):
        for key, value in values.items():
            touched.append(key)
            setattr(root.common.engine, key, value)
    yield set_
    for key in touched:
        delattr(root.common.engine, key)


@pytest.mark.parametrize("label,overrides,settings,name",
                         REFUSED + [("allowed", None, None, None)],
                         ids=[c[0] for c in REFUSED] + ["allowed"])
def test_ignored_knobs_are_refused(engine, label, overrides, settings,
                                   name):
    if overrides is None:
        # the three accepted knobs, and every refused one at its default
        engine(precision_level=2)
        assert Device(backend="cpu", precision_level=2).BACKEND == "cpu"
        wf = mnist.create_workflow(
            loader=LOADER, web_status=True, precision_level=2,
            snapshotter=None, epoch_scan=False, mesh=None,
            model_axis=None, tp_mode="column", graph_compile=None,
            trainer={"compute_confusion_matrix": False,
                     "compute_dtype": "float32"})
        assert wf.fused_step is not None
        return
    engine(**settings)
    with pytest.raises(NotImplementedError, match=name.replace(".", r"\.")):
        mnist.create_workflow(loader=LOADER, **overrides)


SCHED = dict(max_batch=2, block_size=4, max_prompt_len=8,
             max_new_tokens=4, prefix_caching=True, prefill_chunk_tokens=4,
             device="cpu")


@pytest.mark.parametrize("option", ["prefill_chunk_tokens", "spec_depth",
                                    "kv_dtype"])
def test_scheduler_auto_options_are_refused(option):
    """Refused until queue A item 3 ported the tuner; now ``"auto"``
    with the tuner off takes the site's default (chunks of 32, depth
    2, f32 pools), marked ``default`` in ``stats()``."""
    s = DecodeScheduler(ToyDecodeModel(vocab=31, device="cpu"),
                        name="auto", **dict(SCHED, **{option: "auto"}))
    try:
        stats = s.stats()
        want = {"prefill_chunk_tokens": ("chunk_source", 32),
                "spec_depth": ("spec_source", 2),
                "kv_dtype": ("kv_dtype_source", "f32")}[option]
        assert stats[want[0]] == "default"
        assert stats[option] == want[1]
    finally:
        s.close()


@pytest.mark.parametrize("tier", ["host", "disk", "both", "store"])
def test_scheduler_kvtier_is_taken(tmp_path, tier):
    """``kvtier`` no longer raises: the scheduler builds its tier stack
    from the config (or adopts a ready store, wiring its observer) and
    serves the oracle's tokens."""
    cfg = {"host": {"host_bytes": 1 << 20},
           "disk": {"disk_dir": str(tmp_path)},
           "both": {"host_bytes": 1 << 20, "disk_dir": str(tmp_path)},
           "store": TieredKVStore(disk_dir=str(tmp_path))}[tier]
    toy = ToyDecodeModel(vocab=31, device="cpu")
    sched = DecodeScheduler(toy, name="tiered", kvtier=cfg, **SCHED)
    try:
        assert sched._kvtier.observer is sched.metrics
        assert (sched._kvtier.host is not None) == (tier in ("host",
                                                             "both"))
        assert (sched._kvtier.disk is not None) == (tier != "host")
        assert sched.generate([1, 2, 3, 4, 5], 4, timeout=60)["tokens"] == \
            toy.generate_reference([1, 2, 3, 4, 5], 4)
        assert "kvtier" in sched.stats() and "kv_tiers" in sched.load()
    finally:
        sched.close()
