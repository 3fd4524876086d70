"""What the ``tests/test_torch_chip_smoke*.py`` files share: the repo
root on ``sys.path`` and ``chip_smoke`` imported from it, the source of
its ``main()``, and a stand-in launch counter.

The rehearsals are split by phase into files of their own, so that
``pytest-xdist --dist loadfile`` spreads them over its workers.
"""

import os
import sys

import _torch_workers  # noqa: F401  (one torch thread share a worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402,F401


def main_source():
    """``chip_smoke.py``'s text from ``def main():`` on."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    return src[src.index("def main():"):]


class Counter:
    """Stands in for a kernel wrapper's launch count on the CPU."""

    launches = 0
