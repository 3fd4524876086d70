"""The rehearsal of ``chip_smoke.py`` phase 4f (snapshots) on the CPU.

Phase 4f's fresh process (``chip_smoke.py --resume-child``): the
attention net snapshotted through ``_snap_instrument``'s wrappers
(transient, so the writer pickles it) into SQLite, resumed in a child
that imports only the port and finds the needle loader by name, ends
bit for bit on the uninterrupted run's weights, with its steps counted
by class.
"""

import torch

from _chip_smoke_shared import chip_smoke


def test_phase4f_fresh_process_resumes_an_instrumented_workflow(tmp_path):
    from veles_tpu_torch.mutable import Bool
    counters = chip_smoke._snap_counters("flash")

    def make(epochs, snapshotter=None):
        return chip_smoke.attention_workflow(
            24, 8, 8, 2, n_valid=8, epochs=epochs, device="cpu",
            snapshotter=snapshotter)

    saved = chip_smoke.SNAP_DEVICE
    chip_smoke.SNAP_DEVICE = "cpu"
    try:
        ref = chip_smoke._snap_ref(torch, make(2), counters)
        part = make(1, {"prefix": "a", "format": "db", "interval": 2,
                        "database": str(tmp_path / "s.sqlite3"),
                        "time_interval": 0})
        first = chip_smoke._snap_ref(torch, part, counters)
    finally:
        chip_smoke.SNAP_DEVICE = saved
    assert first["steps"] == [2, 1]
    part.snapshotter.skip = Bool(False)
    part.snapshotter.run()
    assert part.snapshotter.flush()
    (res,), _ = chip_smoke._run_child([{
        "label": "attention", "max_epochs": 2, "device": "cpu",
        "path": part.snapshotter.destination, "counters": "flash",
        "interval": 10 ** 9, "weights": str(tmp_path / "a.npz")}],
        str(tmp_path), "attention")
    assert res["device"] == "cpu" and res["steps"] == [2, 1]
    assert res["launches"] == {"K7": [0, 0], "K8": [0, 0], "K9": [0, 0]}
    chip_smoke._bitwise("resume", res["weights"], ref["weights"])
