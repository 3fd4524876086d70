"""The rehearsal of ``chip_smoke.py`` phase 4g (STL-10 and VideoAE).

Phase 4g runs after 4f and before the kernels line, which takes its K4
launches; its K4 prediction (6 / 2 a train / eval step fused, 2 / 2 in
graph mode and none inside GD units) holds on the CPU, where a stand-in
counts the plain version's calls, and a wrong prediction fails the
phase; VideoAE at its published size passes the phase's gate on the CPU
with no launch, its graph mode's mean train losses agree with fused
mode's, and the first-steps hold runs in both modes (STL-10's on a cut
loader); ``modes_agree`` refuses graph-mode losses off fused mode's past
its limit; STL-10's synthetic twin is made once per size inside
``stl10_twins_shared``.
"""

import os

import numpy
import pytest

from _chip_smoke_shared import ROOT, Counter, chip_smoke


def test_phase4g_runs_after_4f_and_is_counted_and_traced():
    """Phase 4g (STL-10 and VideoAE) runs after 4f, before the kernels
    line, whose K4 count takes its launches, and phase 5 traces one
    STL-10 epoch."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    main = src[src.index("def main():"):]
    assert main.index("snapshot_phase(") < main.index("conv_phase(") < \
        main.index("kernels_line(")
    assert 'conv["launches"].items()' in main
    assert "trace_stl10(torch, card)" in main


def test_phase4g_k4_launches_as_predicted_on_the_cpu(monkeypatch):
    """On the CPU the K4 wrapper takes its plain version and counts no
    launch, so a stand-in counts the plain version's calls: STL-10 with
    ``precise_gemm=1`` (cut to 100 + 50 images, one epoch) calls it
    ``STL10_K4`` times a train / eval step, fused and in graph mode,
    and never inside a GD unit; ``stl10_run``'s check refuses any other
    count."""
    import torch
    from veles_tpu_torch.znicz import gemm
    counter = Counter()
    plain = gemm.precise_matmul_reference

    def counted(a, b, level=1):
        counter.launches += 1
        return plain(a, b, level)

    monkeypatch.setattr(gemm, "precise_matmul_reference", counted)
    for fused in (True, False):
        wf = chip_smoke.conv_sample_workflow("stl10", "cpu", fused,
                                             precise=1, n_train=100,
                                             n_valid=50)
        rec = chip_smoke._train_record(torch, wf, {"k4": counter}, "STL-10",
                                       "CPU", 0.0, "images")
        assert rec["launches_per_train_eval_step"] == {
            "k4": chip_smoke.STL10_K4[fused]}
        assert (rec["train_steps"], rec["eval_steps"]) == (2, 1)
        if not fused:
            assert rec["gd_launches"] == {"k4": 0}
    monkeypatch.setattr(chip_smoke, "STL10_K4", {True: (5, 2),
                                                 False: (2, 2)})
    with pytest.raises(AssertionError, match="K4 launches per train"):
        chip_smoke.stl10_run(torch, "CPU", True, {"k4": counter}, "cpu",
                             epochs=1, n_train=100, n_valid=50)


def test_phase4g_video_ae_and_holds_rehearse_on_the_cpu():
    """VideoAE at its published size on the CPU in both modes passes
    ``video_ae_run``'s gate with no launch counted, its graph mode's
    mean train losses pass ``modes_agree`` against fused mode's, and
    ``conv_hold`` holds the CPU against itself (VideoAE, both modes;
    STL-10's holds run on a cut loader below).  The gate run stays at
    the published size: the gate is the JAX test's for that size and
    its 15 epochs."""
    import torch
    runs = {}
    for fused in (True, False):
        rec = runs[fused] = chip_smoke.video_ae_run(
            torch, "CPU", fused, {"k4": Counter()}, "cpu")
        assert rec["epochs"] == chip_smoke.VIDEO_AE_EPOCHS
        assert rec["best_validation_rmse"] < 0.5 * rec["targets_std"]
        hold = chip_smoke.conv_hold("video_ae", fused, 0,
                                    devices=("cpu", "cpu"))
        assert hold["max_loss_rel_diff"] == 0.0
        assert hold["max_weight_rel_diff"] == 0.0
    modes = chip_smoke.modes_agree("VideoAE", runs)
    assert modes["max_loss_diff_of_scale"] <= \
        chip_smoke.CONV_MODES_LOSS_RTOL
    assert "first_epoch" not in runs[True]
    assert "first_epoch" not in runs[False]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "graph"])
def test_phase4g_stl10_hold_rehearses_on_a_cut_loader(fused):
    """``conv_hold`` of STL-10 (``precise_gemm=1``) holds the CPU against
    itself on 100 + 50 images (the card's run takes 300 + 100): the
    first steps' losses and weights with a difference of exactly 0."""
    hold = chip_smoke.conv_hold("stl10", fused, 1, devices=("cpu", "cpu"),
                                loader={"n_train": 100, "n_valid": 50})
    assert hold["steps"] == chip_smoke.CONV_HOLD_STEPS
    assert hold["max_loss_rel_diff"] == 0.0
    assert hold["max_weight_rel_diff"] == 0.0


def test_phase4g_modes_agree_refuses_a_graph_epoch_off_the_fused_one():
    """``modes_agree`` takes each epoch's mean train loss against fused
    mode's largest: a graph-mode epoch off by 1e-5 of that passes, one
    off by 1e-3 fails, as does a run with another number of epochs;
    the first epoch's weights are compared tensor by tensor against
    each one's largest magnitude and reported."""
    weights = [{"weights": numpy.array([1.0, -4.0]),
                "bias": numpy.array([0.01, 0.0])}]
    moved = [{"weights": weights[0]["weights"],
              "bias": numpy.array([0.0101, 0.0])}]

    def runs(off, epochs=3):
        losses = [2.0, 0.5, 0.01]
        graph = list(losses)
        graph[2] += off * 2.0
        return {fused: {"first_epoch": {"weights": w, "n_err": [0, 0, 0]},
                        "mean_train_loss": l[:epochs]}
                for fused, w, l in ((True, weights, losses),
                                    (False, moved, graph))}

    got = chip_smoke.modes_agree("t", runs(1e-5))
    assert got["max_loss_diff_of_scale"] == pytest.approx(1e-5)
    assert got["first_epoch_max_weight_rel_diff"] == pytest.approx(1e-2)
    with pytest.raises(AssertionError, match="of their scale"):
        chip_smoke.modes_agree("t", runs(1e-3))
    short = runs(0.0)
    short[False]["mean_train_loss"] = short[False]["mean_train_loss"][:2]
    with pytest.raises(AssertionError, match="of their scale"):
        chip_smoke.modes_agree("t", short)


def test_phase4g_makes_each_stl10_twin_once(monkeypatch):
    """Inside ``stl10_twins_shared`` two STL-10 workflows of one size make
    the synthetic twin once and read the same data; the sample's own
    maker is back after the block."""
    from veles_tpu_torch.znicz.samples import stl10
    made = []
    make = stl10._synthetic_stl10

    def counted(*args):
        made.append(args)
        return make(*args)

    monkeypatch.setattr(stl10, "_synthetic_stl10", counted)
    monkeypatch.setattr(chip_smoke, "_STL10_TWINS", {})
    with chip_smoke.stl10_twins_shared():
        wfs = [chip_smoke.conv_sample_workflow("stl10", "cpu", fused,
                                               n_train=60, n_valid=20)
               for fused in (True, False)]
    assert made == [(60, 20)]
    assert stl10._synthetic_stl10 is counted
    numpy.testing.assert_array_equal(wfs[0].loader.original_data.mem,
                                     wfs[1].loader.original_data.mem)
    assert wfs[0].loader.original_labels == wfs[1].loader.original_labels
