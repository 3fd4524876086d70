"""The int8-KV append's CUDA source run on the CPU.

``tools/cuda_emu/check.py`` builds ``veles_tpu_torch/csrc/kv_append.cu``
with g++ against a stand-in for the CUDA runtime (a host thread a CUDA
thread, barriers, shuffles and ballots between them) and holds the pool
and scales it writes bitwise to ``kv_append_int8_reference``.  The quick
cases: a run whose scale grows on most writes from mid-block, a reopen
at offset 0 in mid-call with padding into the trash block, and a decode
step of 32 rows, more runs than one CTA has warps.  The stand-in's
ballot is a full barrier, so a missing ``__syncwarp`` cannot show here;
the card tests hold the same cases on the card.
"""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_kv_append_source_on_the_cpu_stand_in_is_bitwise():
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "cuda_emu" / "check.py"),
         "append", "--quick"], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 12 and all(line.endswith("bitwise")
                                    for line in lines), out.stdout
