"""The event log the serving modules write their spans to.

The part of ``veles_tpu/logger.py`` the serving path calls:
``events.span(name, seconds, **info)`` and ``events.event(name,
**info)``.  Records are Chrome-trace JSONL (``ph`` X for spans, i for
instants), loadable in Perfetto, written to
``$VELES_TRACE_DIR/events-<pid>.jsonl`` when that variable is set and
dropped otherwise.  Each record carries the active trace
context (:mod:`.observability.trace`).
"""

import json
import os
import threading
import time

from .observability import trace as _trace

__all__ = ["EventLog", "events"]

TRACE_DIR_ENV = "VELES_TRACE_DIR"


class EventLog:
    """Chrome-trace JSONL writer: ``span`` complete events and
    ``event`` instants."""

    def __init__(self):
        self._file = None
        self._lock = threading.Lock()
        self.path = None
        self._t0 = time.perf_counter()

    @property
    def enabled(self):
        return bool(os.environ.get(TRACE_DIR_ENV))

    def _ensure_open(self):
        if self._file is not None:
            return
        trace_dir = os.environ[TRACE_DIR_ENV]
        os.makedirs(trace_dir, exist_ok=True)
        self.path = os.path.join(trace_dir, "events-%d.jsonl" % os.getpid())
        self._file = open(self.path, "a", buffering=1)   # line buffered

    def event(self, name, kind="single", duration=None, **info):
        """Record one event; a no-op unless ``VELES_TRACE_DIR`` is set."""
        if not self.enabled:
            return
        ctx = _trace.current()
        with self._lock:
            self._ensure_open()
            ts = time.perf_counter() - self._t0
            if duration is not None:
                ts -= duration   # trace-viewer X events anchor at start
            record = {"name": name, "ph": "X" if kind == "span" else "i",
                      "ts": round(ts * 1e6, 1), "pid": os.getpid(),
                      "tid": threading.get_ident()}
            if duration is not None:
                record["dur"] = round(duration * 1e6, 1)
            if ctx is not None:
                info = dict(info, trace_id=ctx.trace_id, span=ctx.span_id)
            if info:
                record["args"] = info
            self._file.write(json.dumps(record) + "\n")

    def span(self, name, seconds, **info):
        """Complete span ending now, lasting ``seconds``."""
        self.event(name, "span", duration=seconds, **info)

    def close(self):
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


#: process-global event log
events = EventLog()
