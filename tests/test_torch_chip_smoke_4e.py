"""The rehearsal of ``chip_smoke.py`` phase 4e (graph mode) on the CPU.

- Phase 4e runs after 4d and before the kernels line, whose K4-K9
  counts take its launches, and phase 5 traces one graph MNIST epoch.
- ``_graph_instrument`` counts train and eval steps, the launches of a
  stand-in counter by class and inside GD units, and the first epoch's
  weights, on the MNIST gate's graph workflow.
- ``graph_train_steps`` draws the same dropout keys on two runs, one key
  a step; the MSE regression in graph and fused mode agree within
  phase 4e's limits.
"""

import os

import pytest

from _chip_smoke_shared import ROOT, Counter, chip_smoke


def test_phase4e_runs_after_4d_and_is_counted_and_traced():
    """Phase 4e (graph mode) runs after 4d, before the kernels line,
    whose K4-K9 counts take its launches, and phase 5 traces one graph
    MNIST epoch."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    main = src[src.index("def main():"):]
    assert main.index("lrn_net_run(") < main.index("graph_phase(") < \
        main.index("kernels_line(")
    for key in ('graph["mnist"]["launches"]["k4"]',
                'graph["lrn_convnet"]["launches"][kid]',
                'run["launches"][kid]\n                              '
                'for run in graph["attention"]'):
        assert key in main, key
    assert "trace_graph_train(torch, card)" in main


def _count_runs(unit, counter):
    run = unit.run

    def counted():
        counter.launches += 1
        run()
    unit.run = counted


def test_graph_instrument_counts_steps_launches_and_the_first_epoch():
    """On the CPU, the MNIST gate's graph workflow for one epoch: a
    stand-in counter bumped by the first forward counts once per train
    and eval step, one bumped by the first GD unit once per train step
    and only inside GD units; the first epoch's weights are the trained
    ones (taken after the epoch's last GD units)."""
    from veles_tpu_torch.loader import TRAIN, VALID
    wf = chip_smoke._mnist_workflow(0, device="cpu", epochs=1, fused=False)
    fwd, gd = Counter(), Counter()
    _count_runs(wf.forwards[0], fwd)
    _count_runs(wf.gds[0], gd)
    counters = {"fwd": fwd, "gd": gd}
    rec, close = chip_smoke._graph_instrument(wf, counters)
    inside = chip_smoke._gd_launches(wf, counters)
    wf.run()
    close()
    n_train, n_valid = (wf.loader.class_lengths[c] for c in (TRAIN, VALID))
    steps = {TRAIN: -(-n_train // 60), VALID: -(-n_valid // 60)}
    assert rec["steps"] == steps
    assert rec["launches"]["fwd"] == steps
    assert rec["launches"]["gd"] == {TRAIN: steps[TRAIN], VALID: 0}
    assert inside == {"fwd": 0, "gd": steps[TRAIN]}
    assert len(rec["epoch_end"]) == 1 and len(rec["train_loss"][0]) == \
        steps[TRAIN]
    first = rec["first_epoch"]
    assert first["n_err"] == list(wf.decision.epoch_n_err)
    for got, want in zip(first["weights"], chip_smoke.host_weights(wf)):
        for k in want:
            assert (got[k] == want[k]).all(), k
    with pytest.raises(AssertionError, match="graph mode"):
        chip_smoke._want_launches("x", {"launches_per_train_eval_step": {
            "k4": (1.0, 2.0)}}, {"k4": (2, 2)})


def test_graph_train_steps_draw_the_same_masks_and_mse_modes_agree():
    """``graph_train_steps`` on the LRN convnet (cut to 200 + 100 images)
    twice on the CPU: the same dropout keys a step, one key a step;
    the MSE regression workflow in graph and fused mode on the CPU
    within phase 4e's limits."""
    runs = []
    for _ in range(2):
        net = chip_smoke.lrn_net_workflow("cpu", fused=False,
                                          n_train=200, n_valid=100)
        runs.append(chip_smoke.graph_train_steps(net, 2))
    (losses, keys), (losses2, keys2) = runs
    assert losses == losses2 and keys == keys2
    assert len(keys) == 2 and keys[0] != keys[1] and len(keys[0]) == 1
    graph = chip_smoke.mse_workflow(False, "cpu")
    fused = chip_smoke.mse_workflow(True, "cpu")
    assert graph.fused_step is None and graph.evaluator is not None
    graph.run()
    fused.run()
    assert chip_smoke._max_diff(chip_smoke.host_weights(graph),
                                chip_smoke.host_weights(fused)) <= \
        chip_smoke.GRAPH_FUSED_WEIGHT_ATOL
    assert abs(graph.decision.best_rmse - fused.decision.best_rmse) <= \
        chip_smoke.GRAPH_FUSED_RMSE_ATOL
    ld = graph.loader
    assert (ld.class_lengths, ld.original_targets.shape) == ([0, 50, 150],
                                                             (200, 3))
