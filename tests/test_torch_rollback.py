"""The weights rollback, alone and with the learning-rate adjuster, the
port against the JAX package, on the CPU.

- tests/test_znicz_extra.py's ``test_rollback_restores_best`` on the
  port.
- The adjuster (``arbitrary``, :data:`_control_shared.SCHEDULE`) and a
  ``WeightsRollback(improvement_limit=1, lr_damping=0.5)`` on MNIST (300
  + 100 digits, 5 epochs), linked after the decision in both orders,
  against the JAX workflow linked alike: each epoch's n_err, the
  ``lr_scale`` it trained at and the rollbacks so far equal (one
  rollback, at the end of epoch 3), the final ``lr_scale`` and
  ``lr_damping`` equal, every parameter tensor within
  ``JAX_WEIGHT_RTOL`` of its largest magnitude.
- The same run with ``epoch_scan=True`` equals the per-step run bit
  for bit (the restore writes into the tensors the scanned step reads).
- The kept copy is a set of clones (training on does not move it), a
  restore writes into the step's live tensors (the same storage before
  and after), and a pickle drops the copy.
- Fault C17: the scanned step's capture (again at every new
  ``lr_scale``) runs with Python's cyclic collector off.
"""

import pickle

import pytest

from _control_shared import (JAX_WEIGHT_RTOL, SCHEDULE, bitwise,
                             host_params, mnist_control, scaled_diff)

ROLLBACK = {"improvement_limit": 1, "lr_damping": 0.5}
ADJUSTER = {"policy": "arbitrary", "points": SCHEDULE}
ORDERS = {"adjuster first": ("adjuster", "rollback"),
          "rollback first": ("rollback", "adjuster")}


def test_rollback_restores_best():
    """tests/test_znicz_extra.py::test_rollback_restores_best: three
    epochs of a tiny model improve at least once."""
    wf, units, _ = mnist_control("veles_tpu_torch", 3, rollback=ROLLBACK,
                                 loader={"minibatch_size": 100})
    wf.run()
    assert units["rollback"]._best_params_ is not None


@pytest.mark.parametrize("order", sorted(ORDERS))
def test_adjuster_and_rollback_match_jax(order):
    kw = dict(adjuster=ADJUSTER, rollback=ROLLBACK, order=ORDERS[order])
    jwf, junits, jrec = mnist_control("veles_tpu", 5, **kw)
    twf, tunits, trec = mnist_control("veles_tpu_torch", 5, **kw)
    jwf.run()
    twf.run()
    assert len(trec) == 5
    assert trec == jrec
    assert [e["rollbacks"] for e in trec] == [0, 0, 0, 0, 1]
    assert [e["lr_scale"] for e in trec] == [1.0, 0.9, 2.0, 0.7, 0.35]
    assert tunits["rollback"].rollbacks == junits["rollback"].rollbacks == 1
    assert twf.fused_step.lr_scale == jwf.fused_step.lr_scale
    assert twf.fused_step.lr_damping == jwf.fused_step.lr_damping == 0.5
    assert scaled_diff(host_params(twf), host_params(jwf)) <= \
        JAX_WEIGHT_RTOL


def test_rollback_into_a_scanned_step_is_the_per_step_run():
    kw = dict(adjuster=ADJUSTER, rollback=ROLLBACK)
    step_wf, step_units, step_rec = mnist_control("veles_tpu_torch", 5, **kw)
    scan_wf, scan_units, scan_rec = mnist_control("veles_tpu_torch", 5,
                                                  epoch_scan=True, **kw)
    step_wf.run()
    scan_wf.run()
    assert type(scan_wf.fused_step).__name__ == "ScanEpochStep"
    assert scan_rec == step_rec
    assert scan_units["rollback"].rollbacks == 1
    assert scan_wf.fused_step.lr_scale == step_wf.fused_step.lr_scale
    assert bitwise(host_params(scan_wf), host_params(step_wf))
    for a, b in zip(scan_wf.fused_step._opt_, step_wf.fused_step._opt_):
        for k in b:
            assert all(x.numpy().tobytes() == y.numpy().tobytes()
                       for x, y in zip(a[k], b[k]))


def test_copy_is_cloned_restored_in_place_and_not_pickled():
    wf, units, _ = mnist_control("veles_tpu_torch", 5, rollback=ROLLBACK,
                                 adjuster=ADJUSTER)
    rb, step = units["rollback"], wf.fused_step
    live = [p.data_ptr() for layer in step._params_ for p in layer.values()]
    kept = []
    run = rb.run

    def watching():
        before = rb.rollbacks
        run()
        if rb._best_params_ is not None and not kept:
            kept.append([{k: v.clone() for k, v in layer.items()}
                         for layer in rb._best_params_])
        if rb.rollbacks > before:
            # restored: the live tensors hold the kept copy
            for layer, best in zip(step._params_, rb._best_params_):
                for k, v in layer.items():
                    assert v.detach().numpy().tobytes() == \
                        best[k].numpy().tobytes()
    rb.run = watching
    wf.run()
    assert rb.rollbacks == 1
    assert [p.data_ptr() for layer in step._params_
            for p in layer.values()] == live
    # the copy is not the live tensors: it differs after training on
    assert any(rb._best_params_[i][k].data_ptr() != p.data_ptr()
               for i, layer in enumerate(step._params_)
               for k, p in layer.items())
    assert kept
    state = rb.__getstate__()
    assert "_best_params_" not in state and "_best_opt_" not in state
    del rb.run
    back = pickle.loads(pickle.dumps(rb))
    assert back._best_params_ is None and back.rollbacks == 1


def test_capture_runs_with_the_collector_off(monkeypatch):
    """Fault C17: ``ScanEpochStep._capture`` keeps the cyclic collector
    off during a capture (under an adjuster the step captures again
    every epoch; a dead workflow's CUDA graphs collected mid-capture
    reset on the capturing stream, which CUDA refuses, and the capture
    fails), and turns it back on after, also when the capture raises.
    On the CPU the graph API is a stand-in that records the collector's
    state."""
    import gc

    import numpy
    import torch
    from veles_tpu_torch.loader import TRAIN
    wf, _, _ = mnist_control("veles_tpu_torch", 1, epoch_scan=True)
    step = wf.fused_step
    seen = []

    class Capture:
        def __init__(self, graph, capture_error_mode=None):
            pass

        def __enter__(self):
            seen.append(("enter", gc.isenabled()))

        def __exit__(self, *exc):
            seen.append(("exit", gc.isenabled()))

    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    idx, sizes = step._class_index_matrix(TRAIN)
    buf = step._upload(idx, sizes.astype(numpy.int64),
                       step._next_seeds(len(sizes)))
    step._capture(buf, True)
    assert seen == [("enter", False), ("exit", False)]
    assert gc.isenabled() and int(buf["pos"]) == 1
    monkeypatch.setattr(step, "_row", lambda *a: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        step._capture(buf, True)
    assert gc.isenabled()
