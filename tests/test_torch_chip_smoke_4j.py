"""The rehearsal of ``chip_smoke.py`` phase 4j (the recurrent units, the
SOM and the RBM) on the CPU, at a cut size.

- Phase 4j runs after 4i and before the kernels line, which takes its
  K4 launches.
- ``recurrent_phase`` end to end on the CPU: (a) the
  ``ResizableAll2All`` at MNIST's first-layer width with
  ``precise_gemm=1`` (K4 a stand-in counting the wrapper's calls: one a
  forward, three forwards), its resizes keeping the old columns bit for
  bit; (b) the SeqLSTM workflow fused, in graph mode and scanned, and
  SimpleRNN fused, two epochs each (the cut runs learn too little for
  the gate: its arithmetic is held with the gate opened, and a run short
  of it fails), the scanned run bit for bit the fused one; (c)
  DemoKohonen for two epochs against its gate and the CPU's first
  epoch; (d) the RBM for its six epochs against its gate, and the
  hidden draws of the CPU against itself (no flips).
- A forward that does not launch K4 fails, as does a draw that flips
  farther than ``RBM_FLIP_ATOL`` from ``ph``.
- No refusal message of the port names queue A item 9 for the four
  classes of its first two bullets, and no docstring says they are not
  ported.
"""

import os

import pytest
import torch

from _chip_smoke_shared import ROOT, chip_smoke, main_source


def test_phase4j_runs_after_4i_and_is_counted():
    main = main_source()
    assert main.index("scan_phase(") < main.index("recurrent_phase(") < \
        main.index("kernels_line(")
    assert 'recurrent["launches"].items()' in main


@pytest.fixture
def k4_counted(monkeypatch):
    """K4's wrapper counting its calls on the CPU (the card's wrapper
    counts its launches); -> the gemm module."""
    from veles_tpu_torch.znicz import gemm
    real = gemm.precise_matmul

    def counted(a, b, level=1):
        counted.launches += 1
        return real(a, b, level)
    counted.launches = 0
    monkeypatch.setattr(gemm, "precise_matmul", counted)
    return gemm


def test_phase4j_rehearses_on_the_cpu(monkeypatch, k4_counted):
    monkeypatch.setattr(chip_smoke, "SEQ_GATE_PT", 100.1)
    rec = chip_smoke.recurrent_phase(torch, k4_counted, "CPU", device="cpu",
                                     seq_epochs=2, kohonen_epochs=2)
    steps = rec["resize"]["steps"]
    assert [s["neurons"] for s in steps] == [100, 150, 100]
    assert all(s["k4_launches"] == 1 for s in steps)
    assert max(s["err_of_scale"] for s in steps) <= chip_smoke.RESIZE_TOL
    runs = rec["seq"]["runs"]
    assert sorted(runs) == ["lstm fused", "lstm graph", "lstm scanned",
                            "rnn fused"]
    assert runs["lstm scanned"]["epoch_n_err"] == \
        runs["lstm fused"]["epoch_n_err"]
    assert runs["lstm scanned"]["captures"] == 0      # the CPU: no graphs
    assert all(r["k4_launches"] == 0 for r in runs.values())
    assert rec["launches"] == {"precise_matmul_l1": 3}
    som = rec["kohonen"]
    assert som["epochs"] == 2 and som["first_epoch_vs_cpu"] == 0.0
    rbm = rec["rbm"]
    assert rbm["epochs"] == chip_smoke.RBM_EPOCHS
    assert rbm["errors"][-1] < chip_smoke.RBM_GATE * rbm["errors"][0]
    assert rbm["draws"]["flips"] == 0 and rbm["draws"]["uniforms_bitwise"]
    assert rbm["draws"]["draws"] == 50 * 32
    assert "traces" not in rec
    monkeypatch.setattr(chip_smoke, "SEQ_GATE_PT", 0.0)
    with pytest.raises(AssertionError, match="missed its gate"):
        chip_smoke.seq_part(torch, k4_counted, "CPU", "cpu", 1)


def test_phase4j_refuses_a_forward_without_k4_and_a_far_flip(monkeypatch):
    from veles_tpu_torch.znicz import gemm, rbm
    # the real wrapper on the CPU takes its plain version: no launch
    with pytest.raises(AssertionError, match="K4 launched 0 times"):
        chip_smoke.resize_part(torch, gemm, "CPU", "cpu")
    real = rbm.hidden_draw

    def flipped(w, hb, v, seed):
        ph, u, h = real(w, hb, v, seed)
        if w.device.type == "cpu" and not flipped.calls:
            h = h.clone()
            h[0, 0] = 1.0 - h[0, 0]     # far from ph: no rounding flip
        flipped.calls += 1
        return ph, u, h
    flipped.calls = 0
    monkeypatch.setattr(rbm, "hidden_draw", flipped)
    with pytest.raises(AssertionError, match="RBM draws card against CPU"):
        chip_smoke.rbm_draws(torch, "cpu")


def test_no_refusal_or_docstring_names_item_9_for_its_first_bullets():
    from veles_tpu_torch.export import model
    for cls in ("ResizableAll2All", "SimpleRNN", "LSTM", "KohonenForward"):
        assert "item 9" not in model._REFUSED.get(cls, ""), cls
    assert "ResizableAll2All" in model._CLASSES
    named = []
    for top, _, files in os.walk(os.path.join(ROOT, "veles_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(top, name)) as f:
                    text = f.read()
                for unit in ("ResizableAll2All", "Kohonen", "RBM", "LSTM",
                             "SimpleRNN"):
                    for line in text.splitlines():
                        if unit in line and "not ported" in line:
                            named.append((name, line.strip()))
    assert named == []
