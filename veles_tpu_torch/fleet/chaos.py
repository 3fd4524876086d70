"""Deterministic fault injection for fleet replicas.

A copy of ``veles_tpu/fleet/chaos.py``: the same rules, actions and
``VELES_FAULT_PLAN`` wire, installed around the port's replica server.

Robustness claims ("zero failed responses through a SIGKILL", "a
truncated body is never silently double-sent") are only testable if
the faults themselves are REPRODUCIBLE.  This module scripts them: a
:class:`FaultPlan` is a seedable list of rules, serialized as JSON
into the ``VELES_FAULT_PLAN`` environment variable by the supervisor
(``fault_plans={rid: plan}``) and installed inside the replica
subprocess around its HTTP handler — the faults happen at the exact
transport seam the router talks to, not in a mock.

Rules trigger on the ordinal of DATA requests (anything under
``/api``; health, metrics, and admin traffic is exempt so the harness
itself — readiness polls, session migration — stays controllable while
the data plane burns).  A rule is a dict::

    {"at": 3,          # fire on exactly the 3rd data request, or
     "after": 5,       #   on every data request from the 5th on, or
     "every": 7,       #   on every 7th, or
     "probability": p, #   i.i.d. with the plan's seeded RNG
     "path_prefix": "/api/toy",  # optional: only on matching paths
     "action": ...}    # what happens (below)

A ``path_prefix`` narrows a rule to one route (e.g. SIGKILL on the
Nth *generate* call specifically, leaving other data traffic alone);
the ordinal ``n`` still counts every data request, so adding a
narrowed rule never shifts when the other rules fire.

Actions:

- ``latency`` (``seconds``): sleep before handling — added tail.
- ``refuse``: close the connection without a response — the peer sees
  a clean connection error (retryable at the router).
- ``blackhole`` (``seconds``): accept, read, then hold the connection
  open saying nothing — the slow-failure mode that only a deadline or
  socket timeout can cut short.
- ``truncate`` (``bytes``): let the handler answer but cut the
  response BODY after N bytes and close — the exactly-once drill (a
  buffered router retry is safe; a streamed one must abort).
- ``sigkill``: ``SIGKILL`` the replica process — the crash drill.
- ``sigstop`` (``resume_after``): ``SIGSTOP`` the process (hung, not
  dead: the socket stays open, accepts back up) and optionally have a
  detached helper ``SIGCONT`` it later — the gray-failure drill.

Every trigger is counted/ordered deterministically, so the same plan
against the same request sequence produces the same drill, run after
run.
"""

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time

__all__ = ["FaultPlan", "install_from_env", "PLAN_ENV"]

#: the environment variable the supervisor plants plans in
PLAN_ENV = "VELES_FAULT_PLAN"

#: actions that replace the real handler entirely
_PREEMPT = ("refuse", "blackhole", "sigkill", "sigstop")

_KNOWN = ("latency", "refuse", "blackhole", "truncate", "sigkill",
          "sigstop")


class _TruncatingFile:
    """A ``wfile`` stand-in that passes the header block through and
    cuts the response BODY after ``limit`` bytes.

    ``BaseHTTPRequestHandler`` buffers the status line + headers and
    flushes them as one write ending ``\\r\\n\\r\\n``; everything after
    that terminator is body and counts against the limit.  Writes past
    the limit vanish, so the client sees fewer bytes than
    ``Content-Length`` promised, then EOF — a mid-body death."""

    def __init__(self, raw, limit):
        self._raw = raw
        self._limit = int(limit)
        self._in_body = False
        self._sent = 0
        self.truncated = False

    def write(self, data):
        data = bytes(data)
        if not self._in_body:
            head, sep, rest = data.partition(b"\r\n\r\n")
            if not sep:
                self._raw.write(data)
                return len(data)
            self._raw.write(head + sep)
            self._in_body = True
            data = rest
        room = self._limit - self._sent
        if room <= 0:
            self.truncated = self.truncated or bool(data)
            return len(data)
        cut = data[:room]
        self._raw.write(cut)
        self._sent += len(cut)
        if len(cut) < len(data):
            self.truncated = True
        return len(data)

    def flush(self):
        self._raw.flush()

    def close(self):
        self._raw.close()

    def __getattr__(self, name):
        return getattr(self._raw, name)


class FaultPlan:
    """A seeded, scripted sequence of transport faults."""

    def __init__(self, rules, seed=0):
        self.rules = []
        for rule in rules:
            action = rule.get("action")
            if action not in _KNOWN:
                raise ValueError("unknown fault action %r (want one "
                                 "of %s)" % (action, ", ".join(_KNOWN)))
            self.rules.append(dict(rule))
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._count = 0
        self._lock = threading.Lock()
        self.fired = []                 # (ordinal, action) log

    # -- (de)serialization ---------------------------------------------------
    @classmethod
    def from_json(cls, text):
        """``{"seed": s, "rules": [...]}`` or a bare rule list."""
        payload = json.loads(text)
        if isinstance(payload, list):
            return cls(payload)
        return cls(payload.get("rules") or [],
                   seed=payload.get("seed") or 0)

    def to_json(self):
        return json.dumps({"seed": self.seed, "rules": self.rules})

    def env(self, base=None):
        """A copy of ``base`` (default ``os.environ``) carrying this
        plan — what the supervisor hands the replica subprocess."""
        env = dict(os.environ if base is None else base)
        env[PLAN_ENV] = self.to_json()
        return env

    # -- matching ------------------------------------------------------------
    def _matches(self, rule, n):
        if "at" in rule:
            return n == int(rule["at"])
        if "after" in rule:
            return n >= int(rule["after"])
        if "every" in rule:
            return n % int(rule["every"]) == 0
        if "probability" in rule:
            return self._rng.random() < float(rule["probability"])
        return True

    def _next(self, path):
        """Data-request ordinal + the rules that fire on it (empty for
        exempt control-plane paths)."""
        if not path.startswith("/api"):
            return 0, []
        with self._lock:
            self._count += 1
            n = self._count
            hits = [r for r in self.rules if self._matches(r, n)
                    and path.startswith(r.get("path_prefix", "/api"))]
            for rule in hits:
                self.fired.append((n, rule["action"]))
        return n, hits

    # -- the faults ----------------------------------------------------------
    @staticmethod
    def _sigstop(rule):
        resume = rule.get("resume_after")
        if resume:
            # a detached helper delivers the SIGCONT — this process is
            # about to be frozen and cannot resume itself
            subprocess.Popen(
                [sys.executable, "-c",
                 "import os, signal, time; time.sleep(%f); "
                 "os.kill(%d, signal.SIGCONT)"
                 % (float(resume), os.getpid())],
                start_new_session=True,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        os.kill(os.getpid(), signal.SIGSTOP)

    def _preempt(self, handler, rule):
        """Faults that replace the real response.  Returns True when
        the wrapped handler must NOT run."""
        action = rule["action"]
        if action == "refuse":
            # close without a status line: the peer sees EOF where a
            # response belonged — a clean, retryable connection error
            handler.close_connection = True
            return True
        if action == "blackhole":
            time.sleep(float(rule.get("seconds", 300.0)))
            handler.close_connection = True
            return True
        if action == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
            return True                 # not reached
        if action == "sigstop":
            self._sigstop(rule)
            # resumed later: the request proceeds normally — a hung
            # replica answers late, it does not error
            return False
        return False

    def apply(self, handler, method):
        """Run one handler method under this plan."""
        _, hits = self._next(handler.path.split("?", 1)[0])
        truncate = None
        for rule in hits:
            action = rule["action"]
            if action == "latency":
                time.sleep(float(rule.get("seconds", 0.05)))
            elif action == "truncate":
                truncate = int(rule.get("bytes", 0))
            elif self._preempt(handler, rule):
                return None
        if truncate is None:
            return method(handler)
        wrapped = _TruncatingFile(handler.wfile, truncate)
        handler.wfile = wrapped
        try:
            return method(handler)
        finally:
            handler.wfile = wrapped._raw
            if wrapped.truncated:
                # the body is short of Content-Length: close so the
                # peer sees the truncation NOW, not at keep-alive reap
                handler.close_connection = True
                try:
                    wrapped.flush()
                except OSError:
                    pass

    # -- installation --------------------------------------------------------
    def install(self, httpd):
        """Wrap ``httpd``'s handler class so every ``do_*`` method runs
        under this plan.  Returns the plan (chainable)."""
        plan = self
        base = httpd.RequestHandlerClass

        def _wrap(name):
            orig = getattr(base, name)

            def method(handler_self):
                return plan.apply(handler_self, orig)
            method.__name__ = name
            return method

        overrides = {name: _wrap(name) for name in dir(base)
                     if name.startswith("do_")}
        overrides["fault_plan"] = plan
        httpd.RequestHandlerClass = type(
            "Faulty" + base.__name__, (base,), overrides)
        return self


def install_from_env(server, environ=None):
    """Install the ``VELES_FAULT_PLAN`` plan (if any) around an
    :class:`~veles_tpu_torch.serving.server.InferenceServer` — called by the
    fleet replica at startup; a clean environment is a no-op."""
    text = (os.environ if environ is None else environ).get(PLAN_ENV)
    if not text:
        return None
    plan = FaultPlan.from_json(text)
    plan.install(server._httpd)
    return plan
