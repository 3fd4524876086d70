"""The rehearsal of ``chip_smoke.py`` phase 4k (the training-control
units, MnistAE, Kanji and Lines) on the CPU, at a cut size.

- Phase 4k runs after 4j and before the kernels line, which takes its
  K4 launches.
- ``control_phase`` end to end on the CPU, K4 a stand-in counting the
  plain version's calls (forward and backward, as the card's wrapper
  counts launches): MnistAE fused, in graph mode and scanned (the
  scanned run bit for bit the fused one), Kanji, Lines from its string
  in both modes, the adjuster and the rollback per step and scanned
  (one rollback or more; the scanned run bit for bit the per-step one;
  no graphs on the CPU; the first two epochs of the CPU against
  themselves exactly), and the image saver at ``prefetch_depth`` 0 and
  2 (the same PNGs, each decoded by the script's standard-library
  reader to the minibatch row it names).  The cut runs learn too little
  for the samples' gates: their arithmetic is held with the gates
  opened, and a run short of one fails.  Every part's K4 count is the
  table's (``CONTROL_K4``).
- A part whose forwards do not launch K4 fails, as does a prediction
  that the run does not meet.
- ``read_png`` decodes Pillow's PNGs (every filter type) to their
  pixels.
- No refusal message or docstring of the port calls these units, the
  notation or the samples unported.
"""

import os

import numpy
import pytest
import torch

from _chip_smoke_shared import ROOT, Counter, chip_smoke, main_source


def test_phase4k_runs_after_4j_and_is_counted():
    main = main_source()
    assert main.index("recurrent_phase(") < main.index("control_phase(") < \
        main.index("kernels_line(")
    assert 'control["launches"].items()' in main


@pytest.fixture
def cut(monkeypatch):
    """Phase 4k's sizes cut for the CPU, its gates opened, and K4 a
    stand-in counting the plain version's calls; -> the counter."""
    from veles_tpu_torch.znicz import gemm
    for name, value in (
            ("MNIST_AE_LOADER", {"minibatch_size": 100, "n_train": 200,
                                 "n_valid": 100}),
            ("MNIST_AE_EPOCHS", 2), ("MNIST_AE_GATE", 10.0),
            ("KANJI_LOADER", {"minibatch_size": 50, "n_train": 100,
                              "n_valid": 50}),
            ("KANJI_EPOCHS", 2), ("KANJI_GATE", 10.0),
            ("LINES_LOADER", {"minibatch_size": 40, "n_train": 80,
                              "n_valid": 40}),
            ("LINES_EPOCHS", 2), ("LINES_GATE_PT", 100.1),
            ("GATE_LOADER", {"minibatch_size": 60, "n_train": 300,
                             "n_valid": 100})):
        monkeypatch.setattr(chip_smoke, name, value)
    counter = Counter()
    plain = gemm.precise_matmul_reference

    def counted(a, b, level=1):
        counter.launches += 1
        return plain(a, b, level)

    monkeypatch.setattr(gemm, "precise_matmul_reference", counted)
    return counter


def test_phase4k_rehearses_on_the_cpu(cut):
    from veles_tpu_torch.znicz import gemm
    out = chip_smoke.control_phase(torch, gemm, "CPU", device="cpu",
                                   counters={"k4": cut})
    assert sorted(out["seconds"]) == ["control", "kanji", "lines",
                                      "mnist_ae", "saver"]
    ae = out["mnist_ae"]["runs"]
    assert sorted(ae) == ["fused", "graph", "scanned"]
    assert ae["scanned"]["epoch_n_err"] == ae["fused"]["epoch_n_err"]
    assert len(ae["fused"]["epoch_n_err"]) == 2
    assert ae["scanned"]["captures"] == 0       # the CPU: no graphs
    assert ae["fused"]["per_row"]["k4"] == [5, 2]
    assert ae["graph"]["launches_per_train_eval_step"]["k4"] == (2, 2)
    assert out["kanji"]["launches_per_train_eval_step"]["k4"] == (5, 2)
    lines = out["lines"]["runs"]
    assert lines["fused"]["launches_per_train_eval_step"]["k4"] == (6, 2)
    assert lines["graph"]["launches_per_train_eval_step"]["k4"] == (2, 2)
    control = out["control"]
    step, scan = control["runs"]["per step"], control["runs"]["scanned"]
    assert step["rollbacks"] == scan["rollbacks"] >= 1
    assert step["lr_scale"][:4] == [1.0, 0.9, 2.0, 0.7]
    assert step["lr_scale"] == scan["lr_scale"]
    assert scan["captures"] == 0 and scan["train_captures"] == []
    assert control["cpu_hold"]["max_weight_diff"] == [0.0, 0.0]
    saver = out["saver"]["runs"]
    assert saver["0"]["saved"] == saver["2"]["saved"] > 0
    assert max(saver["0"]["by_epoch"].values()) <= chip_smoke.SAVER_LIMIT
    parts = ("mnist_ae", "kanji", "lines", "control", "saver")
    assert out["launches"] == {"precise_matmul_l1": sum(
        out[p]["k4_launches"] for p in parts)}
    assert all(out[p]["k4_launches"] > 0 for p in parts)


def test_phase4k_refuses_a_missed_gate_or_prediction(cut, monkeypatch):
    from veles_tpu_torch.znicz import gemm
    counters = {"k4": cut}
    monkeypatch.setattr(chip_smoke, "KANJI_GATE", 0.0)
    with pytest.raises(AssertionError, match="missed its gate"):
        chip_smoke.kanji_part(torch, "CPU", counters, "cpu")
    monkeypatch.setattr(chip_smoke, "CONTROL_K4", dict(
        chip_smoke.CONTROL_K4, lines={True: (5, 2), False: (2, 2)}))
    with pytest.raises(AssertionError, match="launches per train / eval"):
        chip_smoke.lines_part(torch, "CPU", counters, "cpu")
    # the real wrapper on the CPU takes its plain version: no launch
    with pytest.raises(AssertionError, match=r"a \[train, eval\] row"):
        chip_smoke.mnist_ae_part(torch, "CPU", {"k4": gemm.precise_matmul},
                                 "cpu")


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_read_png_decodes_pillow_files(tmp_path, mode):
    from PIL import Image
    rng = numpy.random.RandomState(5)
    shape = (9, 13, 3) if mode == "RGB" else (9, 13)
    pixels = rng.randint(0, 256, shape).astype(numpy.uint8)
    pixels[3:6] = pixels[2]          # runs Pillow's filters predict well
    path = str(tmp_path / "x.png")
    Image.fromarray(pixels, mode).save(path, optimize=True)
    assert chip_smoke.read_png(path).tobytes() == pixels.tobytes()
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:-5] + bytes([blob[-5] ^ 1]) + blob[-4:])
    with pytest.raises(AssertionError, match="CRC"):
        chip_smoke.read_png(path)


def test_no_refusal_or_docstring_names_these_unported():
    from veles_tpu_torch.znicz.standard_workflow import REFUSED_KNOBS
    assert not any("mcdnnic" in knob for knob in REFUSED_KNOBS)
    named = []
    words = ("mcdnnic", "LearningRateAdjuster", "lr_adjust", "Rollback",
             "rollback", "ImageSaver", "image_saver", "MnistAE", "mnist_ae",
             "Kanji", "kanji", "Lines sample", "lines")
    for top, _, files in os.walk(os.path.join(ROOT, "veles_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(top, name)) as f:
                    text = f.read()
                for line in text.splitlines():
                    if "not ported" in line or "unported" in line:
                        named += [(name, line.strip()) for w in words
                                  if w in line]
    assert named == []
