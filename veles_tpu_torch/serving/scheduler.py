"""Scheduler vocabulary shared by the serving modules.

The part of ``veles_tpu/serving/scheduler.py`` the decode path uses: the
power-of-two bucket ladder, the backpressure and drain exceptions, and
the deadline check.  The request-granularity ``BucketScheduler`` is not
ported yet.
"""

import time

__all__ = ["SchedulerOverflow", "SchedulerClosed", "DeadlineExpired",
           "deadline_expired", "bucket_sizes"]


class SchedulerOverflow(RuntimeError):
    """The bounded request queue is full — shed load (HTTP 429)."""


class SchedulerClosed(RuntimeError):
    """The scheduler is draining or stopped — no new requests."""


class DeadlineExpired(RuntimeError):
    """The request's end-to-end deadline passed before it reached the
    device — shed (HTTP 504) instead of spending batch rows on an
    answer nobody is waiting for."""


def deadline_expired(deadline, now=None):
    """True when an absolute ``time.monotonic()`` deadline has passed
    (None = no deadline)."""
    if deadline is None:
        return False
    return (time.monotonic() if now is None else now) >= deadline


def bucket_sizes(max_size):
    """The power-of-two bucket ladder: 1, 2, 4, ... max_size."""
    if max_size < 1:
        raise ValueError("max_size must be >= 1")
    sizes, b = [], 1
    while b < max_size:
        sizes.append(b)
        b <<= 1
    sizes.append(int(max_size))   # top bucket even when not a power of two
    return sizes
