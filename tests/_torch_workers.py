"""Pins torch's CPU threads of a pytest-xdist worker to its share of the
machine's cores.

Every worker of ``pytest -n N`` starts torch with one intra-op thread a
core, so N workers run N times as many OpenMP threads as there are
cores, and torch's spinning threads then slow a convolution-heavy test
by 20x or more (VideoAE and an STL-10 step in six processes at once on
8 cores: ~300 s each, against ~12 s with one thread a process).
Importing this module gives each worker ``cores // N`` threads (at
least 1).  Every worker collects every test module, so one import at
the top of a test module pins every worker; a run without xdist keeps
torch's default.

A thread count can change the last bits of torch's CPU reductions (a
convolution's weight gradient sums in per-thread parts).  A test whose
result must equal one computed with torch's own count (a subprocess's,
which starts with it) or whose tolerance was set at that count runs its
part inside :func:`default_threads`.
"""

import contextlib
import os

import torch

#: torch's own intra-op thread count in this process
DEFAULT_THREADS = torch.get_num_threads()

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")

if os.environ.get("PYTEST_XDIST_WORKER") and _WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(_WORKERS)))


@contextlib.contextmanager
def default_threads():
    """torch's own thread count inside the block, the pinned one after."""
    pinned = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(pinned)
