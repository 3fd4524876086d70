"""The rehearsal of ``chip_smoke.py`` phase 3f (exported packages).

- Phase 3f runs on phases 4-4d's trained workflows, after 4d and before
  4e, and its K4 / K5 / K7 launches reach the kernels line; its request
  plans cover the package sizes; ``_per_batch`` refuses a count off its
  prediction.
- End to end on the CPU at a cut size: every part's answers hold
  against the live forward, the AlexNet rows against the CPU, the
  fleet's answers bitwise the in-process ones (both computed with
  torch's own thread count, which the replica processes start with),
  and each part dispatched batches.
"""

import os

import pytest

from _chip_smoke_shared import ROOT, chip_smoke
from _torch_workers import default_threads


def test_phase3f_runs_after_4d_and_its_launches_reach_the_kernels_line():
    """Phase 3f (exported packages) runs on phases 4-4d's trained
    workflows, after 4d and before 4e, and its K4 / K5 / K7 launches are
    added to the kernels line's counts."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    main = src[src.index("def main():"):]
    assert main.index("lrn_net_run(") < main.index("package_phase(") < \
        main.index("graph_phase(") < main.index("kernels_line(")
    for key in ('served = {"mnist": served_wf}',
                'served["attention"] = attention[0]["workflow"]',
                'served["alexnet"] = alexnet[0]["workflow"]',
                'served["lrn"] = lrn_net.pop("workflow")',
                'for name, n in packages["launches"].items():\n'
                '        launches[name] += n'):
        assert key in main, key
    plan = chip_smoke._plan(chip_smoke.PKG_SIZES, rows=chip_smoke.PKG_ROWS)
    assert sum(n for _, n in plan) == 64 and {n for _, n in plan} == \
        {1, 2, 3, 5, 8}
    assert [lo for lo, _ in plan] == \
        [sum(n for _, n in plan[:i]) for i in range(len(plan))]
    alex = chip_smoke._plan(chip_smoke.PKG_SIZES,
                            requests=chip_smoke.ALEX_PKG_REQUESTS)
    assert len(alex) >= 16 and max(n for _, n in alex) <= \
        chip_smoke.ALEX_PKG_MAX_BATCH == 8
    with pytest.raises(AssertionError, match="2 a batch"):
        chip_smoke._per_batch("x", 3, 2, 2)
    with pytest.raises(AssertionError, match="0 dispatched"):
        chip_smoke._per_batch("x", 0, 0, 2)
    chip_smoke._per_batch("x", 4, 2, 2)


def test_phase3f_rehearses_on_the_cpu(monkeypatch):
    """Phase 3f end to end on the CPU at a cut size (the kernels' plain
    versions count no launch, so the per-batch counts are recorded
    instead of held): every part's answers hold against the live
    forward (MNIST, the side-67 AlexNet, a small attention net, the LRN
    convnet), the AlexNet card rows against the CPU, the fleet's
    answers bitwise the in-process ones, and each part dispatched
    batches."""
    import torch
    from veles_tpu_torch.znicz import flash_attention as fa
    from veles_tpu_torch.znicz import gemm, lrn
    calls = []
    monkeypatch.setattr(chip_smoke, "_per_batch",
                        lambda *args: calls.append(args))
    monkeypatch.setattr(chip_smoke, "ALEX_PKG_REQUESTS", 4)
    fleet_part = chip_smoke.package_fleet_part

    def fleet_at_default_threads(*args):
        # the replicas start with torch's own thread count; the answers
        # they are held to bit for bit are computed with it too
        with default_threads():
            return fleet_part(*args)

    monkeypatch.setattr(chip_smoke, "package_fleet_part",
                        fleet_at_default_threads)
    wfs = {"mnist": chip_smoke._mnist_workflow(1, device="cpu", epochs=1),
           "alexnet": chip_smoke.alexnet_workflow(
               "cpu", epochs=1, minibatch_size=4, n_train=8, n_valid=4,
               n_classes=20, side=67),
           "attention": chip_smoke.attention_workflow(
               40, 8, 8, 2, minibatch=10, epochs=1, device="cpu"),
           "lrn": chip_smoke.lrn_net_workflow("cpu", epochs=1, n_train=200,
                                              n_valid=100)}
    for wf in wfs.values():
        wf.run()
    rec = chip_smoke.package_phase(torch, gemm, lrn, fa, "CPU", wfs,
                                   torch.device("cpu"))
    labels = [c[0] for c in calls]
    assert labels[:4] == ["3f MNIST fp32", "3f MNIST fp16", "3f AlexNet",
                          "3f attention"]
    assert sorted(labels[4:6]) == ["3f fleet replica r0",
                                   "3f fleet replica r1"]
    assert labels[6:] == ["3f RESTfulAPI"]
    assert all(launches == 0 and batches > 0 for _, launches, batches, _
               in calls)
    assert [c[3] for c in calls] == [2, 2, 2, 1, 2, 2, 2]
    for run in rec["mnist"]["runs"]:
        assert run["max_rel_err"] <= chip_smoke.PKG_TOL
        assert run["rows"] == 64
    assert rec["alexnet"]["cpu_rel_err"] <= chip_smoke.ALEX_PKG_CPU_TOL
    assert rec["attention"]["rows"] == 12
    assert rec["fleet"]["max_abs_diff"] == 0.0
    assert sum(r["batches"] for r in rec["fleet"]["replicas"].values()) \
        == chip_smoke.FLEET_PKG_REQUESTS
    assert rec["launches"] == {"precise_matmul_l1": 0, "lrn_fwd": 0,
                               "flash_attention_fwd": 0}
