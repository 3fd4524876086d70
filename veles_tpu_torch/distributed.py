"""Distributed control plane: the respawn policy.

The part of ``veles_tpu/distributed.py`` the fleet supervisor uses:
:class:`RestartBackoff` and :class:`RestartBudgetExhausted`.  The
elastic checkpoint-restart runner, the reaper and the multi-host setup
wait for ROADMAP queue A item 11.
"""

import random

__all__ = ["RestartBackoff", "RestartBudgetExhausted"]


class RestartBudgetExhausted(RuntimeError):
    """A supervised process crashed more times than its budget allows."""


class RestartBackoff:
    """Exponential backoff with jitter and a max-restart budget.

    The respawn policy of :class:`veles_tpu_torch.fleet.supervisor
    .ReplicaSupervisor` (serving replicas): a crash-looping child must
    not hot-spin the host, and many children restarting after a common
    cause must not stampede in lockstep — so the delay grows
    ``base * factor^streak`` (capped at ``cap``) with a ±``jitter``
    fraction of multiplicative noise.

    ``restarts`` counts every restart ever granted (the budget);
    ``streak`` counts consecutive crashes and is what the exponent
    uses — :meth:`note_uptime` resets the streak after a healthy run of
    ``reset_after`` seconds WITHOUT refunding the budget, so a process
    that crashes once a day restarts fast forever while one that
    crashes every second walks up to ``cap`` and eventually exhausts.

    Deterministic for tests: inject ``rng`` (a ``random.random``-like
    callable) and read delays from :meth:`next_delay` — no wall clock
    inside.
    """

    def __init__(self, base=1.0, factor=2.0, cap=60.0, jitter=0.1,
                 max_restarts=5, reset_after=None, rng=None):
        self.base = float(base)
        self.factor = float(factor)
        self.cap = float(cap)
        self.jitter = float(jitter)
        self.max_restarts = (None if max_restarts is None
                             else int(max_restarts))
        self.reset_after = reset_after
        self._rng = rng or random.random
        self.restarts = 0
        self.streak = 0

    @property
    def exhausted(self):
        return (self.max_restarts is not None
                and self.restarts >= self.max_restarts)

    @property
    def remaining(self):
        """Restarts left in the budget (``None`` when unlimited) — the
        supervisor surfaces this in /metrics so an operator sees a
        crash-looper approaching ``failed`` before it parks."""
        if self.max_restarts is None:
            return None
        return max(self.max_restarts - self.restarts, 0)

    def next_delay(self):
        """Grant one restart: seconds to wait before it, or ``None``
        when the budget is exhausted (the caller gives up)."""
        if self.exhausted:
            return None
        delay = min(self.base * self.factor ** self.streak, self.cap)
        if self.jitter:
            delay *= 1.0 + self.jitter * (2.0 * self._rng() - 1.0)
        self.restarts += 1
        self.streak += 1
        return delay

    def note_uptime(self, seconds):
        """The child just ran healthily for ``seconds`` before dying;
        a long-enough run resets the exponent (not the budget)."""
        if self.reset_after is not None and seconds >= self.reset_after:
            self.streak = 0
