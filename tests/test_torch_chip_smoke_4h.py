"""The rehearsal of ``chip_smoke.py`` phase 4h (stochastic pooling) on
the CPU, at a cut size.

- Phase 4h runs after 4g and before the kernels line, which takes its
  K4 launches, and phase 5 traces one fused stochastic STL-10 epoch.
- ``stochastic_layers`` swaps STL-10's max pooling and first average
  pooling, and VideoAE's max pooling + depooling, for the stochastic
  units of the same windows.
- ``stochastic_phase`` end to end on the CPU: STL-10 on a twin of 10 +
  5 images in minibatches of 5 and VideoAE on 100 + 50 frames, two
  epochs each, fused and graph mode, the draws over 2 images.  K4 (a
  stand-in counting the plain version's calls) runs ``STL10_K4`` times
  a train / eval step and never inside a GD unit; the gates' arithmetic
  is held with the gates opened, and a run short of its gate fails;
  graph against fused mode holds within ``STOCH_MODES_LOSS_RTOL``; the
  draws of the CPU against itself are equal.
- The draws' comparison counts a near-tie that differs and fails a
  difference that is no near-tie.
- No refusal message or docstring of the port names item 6b any more.
"""

import os

import pytest
import torch

from _chip_smoke_shared import ROOT, Counter, chip_smoke, main_source

STL10_CUT = {"n_train": 10, "n_valid": 5, "minibatch_size": 5}
VIDEO_AE_CUT = {"n_train": 100, "n_valid": 50}


def test_phase4h_runs_after_4g_and_is_counted_and_traced():
    main = main_source()
    assert main.index("conv_phase(") < main.index("stochastic_phase(") < \
        main.index("kernels_line(")
    assert 'stochastic["launches"].items()' in main
    assert "trace_stochastic(torch, card)" in main


def test_stochastic_layers_swap_the_samples_pooling():
    stl = chip_smoke.stochastic_layers("stl10")
    assert [layer["type"] for layer in stl] == [
        "conv_str", "stochastic_pooling", "conv_str",
        "stochastic_abs_pooling", "conv_str", "avg_pooling", "all2all",
        "softmax"]
    assert stl[1]["->"] == {"kx": 3, "ky": 3, "sliding": (2, 2)}
    vae = chip_smoke.stochastic_layers("video_ae")
    assert [layer["type"] for layer in vae] == [
        "conv_tanh", "stochastic_abs_pool_depool", "deconv"]
    assert vae[1]["->"] == {"kx": 2, "ky": 2, "sliding": (2, 2)}
    # the samples' own configs are untouched
    from veles_tpu_torch.config import root
    assert [layer["type"] for layer in root.stl10.layers][1] == \
        "max_pooling"


@pytest.fixture
def k4_counter(monkeypatch):
    """K4's plain version counted as its launches, as phase 4g's
    rehearsal counts them."""
    from veles_tpu_torch.znicz import gemm
    counter = Counter()
    plain = gemm.precise_matmul_reference

    def counted(a, b, level=1):
        counter.launches += 1
        return plain(a, b, level)

    monkeypatch.setattr(gemm, "precise_matmul_reference", counted)
    return counter


class _Gemm:
    def __init__(self, counter):
        self.precise_matmul = counter


def test_phase4h_rehearses_on_the_cpu(monkeypatch, k4_counter):
    # the cut runs learn too little for the gates; their arithmetic is
    # held with the gates opened (and shut, below)
    monkeypatch.setattr(chip_smoke, "STL10_GATE_PT", 100.1)
    monkeypatch.setattr(chip_smoke, "VIDEO_AE_GATE", 1e9)
    rec = chip_smoke.stochastic_phase(
        torch, _Gemm(k4_counter), "CPU", device="cpu",
        stl10_loader=STL10_CUT, video_ae_loader=VIDEO_AE_CUT,
        epochs=(2, 2), draw_rows=2)
    stl, vae = rec["stl10"], rec["video_ae"]
    for fused in (True, False):
        run = stl["fused" if fused else "graph"]
        assert run["launches_per_train_eval_step"] == {
            "k4": chip_smoke.STL10_K4[fused]}
        assert (run["train_steps"], run["eval_steps"]) == (4, 2)
        assert run["best_validation_error_pt"] < 100.1
        assert vae["fused" if fused else "graph"]["launches"] == {"k4": 0}
    assert rec["launches"] == {"precise_matmul_l1": sum(
        stl[m]["launches"]["k4"] for m in ("fused", "graph"))} == \
        {"precise_matmul_l1": 4 * 6 + 2 * 2 + 4 * 2 + 2 * 2}
    for part in (stl, vae):
        assert part["graph_vs_fused"]["max_loss_diff_of_scale"] <= \
            chip_smoke.STOCH_MODES_LOSS_RTOL
    draws = stl["draws"]
    assert draws["input_shape"] == [2, 96, 96, 32]
    assert draws["draws"] == 2 * 47 * 47 * 32
    assert draws["differing"] == draws["near_ties"] == 0
    assert draws["agreeing_values_bitwise"]
    monkeypatch.setattr(chip_smoke, "VIDEO_AE_GATE", 0.0)
    with pytest.raises(AssertionError, match="missed its gate"):
        chip_smoke.video_ae_run(
            torch, "CPU", True, {"k4": Counter()}, "cpu", 1,
            layers=chip_smoke.stochastic_layers("video_ae"), **VIDEO_AE_CUT)


def _flip_first_call(monkeypatch, pick):
    """The first ``_choice`` of the stochastic units (the ``device``
    side of ``stochastic_draws``) with one draw changed: ``pick(unit,
    patches, key, choice)`` -> (index, new category)."""
    from veles_tpu_torch.znicz.pooling import StochasticPoolingBase
    real = StochasticPoolingBase._choice
    calls = []

    def flipped(unit, p, key):
        choice = real(unit, p, key)
        if not calls:
            idx, cat = pick(unit, p, key, choice)
            choice = choice.clone()
            choice[idx] = cat
        calls.append(1)
        return choice

    monkeypatch.setattr(StochasticPoolingBase, "_choice", flipped)


def test_phase4h_draws_count_a_near_tie_and_refuse_another_difference(
        monkeypatch):
    """With the Gumbel noise at 0 the perturbed logits are the logits, so
    a window of equal weights (an all-zero one after strict RELU) is an
    exact tie: a draw changed there is counted as a near-tie; a draw
    changed in a window of unequal weights is no near-tie and fails."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.prng import random_generator

    def no_noise():
        for mod in (prng, random_generator):
            monkeypatch.setattr(mod, "gumbel",
                                lambda k, shape, device=None: torch.zeros(
                                    shape, device=device))

    no_noise()
    layers = chip_smoke.stochastic_layers("stl10")

    def window(uniform):
        def pick(unit, p, key, choice):
            probs = unit._probs(p)
            flat = (probs == probs[:, :, :, :1, :]).all(dim=3)
            where = (flat if uniform else ~flat).nonzero()[0]
            return tuple(where.tolist()), (int(choice[tuple(
                where.tolist())]) + 1) % p.shape[3]
        return pick

    _flip_first_call(monkeypatch, window(uniform=True))
    rec = chip_smoke.stochastic_draws(torch, layers, "cpu", rows=2,
                                      **STL10_CUT)
    assert rec["differing"] == rec["near_ties"] == 1
    assert rec["largest_differing_gap"] == 0.0
    assert rec["agreeing_values_bitwise"]
    monkeypatch.undo()
    no_noise()
    _flip_first_call(monkeypatch, window(uniform=False))
    with pytest.raises(AssertionError, match="1 draws differ card against "
                       "CPU, 0 of them near-ties"):
        chip_smoke.stochastic_draws(torch, layers, "cpu", rows=2,
                                    **STL10_CUT)


def test_no_message_or_docstring_of_the_port_names_item_6b():
    """Item 6b is ported: no refusal message, docstring or comment of
    ``veles_tpu_torch`` still points at it."""
    named = []
    for top, _, files in os.walk(os.path.join(ROOT, "veles_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(top, name)) as f:
                    if "6b" in f.read():
                        named.append(os.path.join(top, name))
    assert named == []
    from veles_tpu_torch.export import model
    assert not any("item 6" in reason for reason in model._REFUSED.values())
