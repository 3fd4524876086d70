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
"""

import pytest

from veles_tpu_torch.backends import Device
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
