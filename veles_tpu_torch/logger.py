"""The event log the serving modules and the units write their spans to.

The part of ``veles_tpu/logger.py`` the port calls:
``events.span(name, seconds, **info)`` and ``events.event(name,
**info)`` (``Unit.execute`` spans every unit run while tracing is on).
Records are Chrome-trace JSONL (``ph`` X for spans, i for instants),
loadable in Perfetto.  Tracing is on when ``$VELES_TRACE_DIR`` is set
(records go to ``$VELES_TRACE_DIR/events-<pid>.jsonl``) or when
``root.common.trace.enabled`` is (records go to
``root.common.trace.file``, else the events directory of the config);
otherwise records are dropped.  Each record carries the active trace
context (:mod:`.observability.trace`), and each file opens with a
``trace_start`` record holding the wall clock, the anchor
``tools/merge_traces.py`` aligns several processes' files on.  The
``span_sink`` hook mirrors every event in memory whether or not tracing
is on (the flight recorder's span bridge).
"""

import atexit
import json
import os
import threading
import time

from .config import root
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
        #: optional in-process mirror (the flight recorder's span
        #: bridge): called as ``sink(name, kind, duration, info)``
        #: before the enabled gate; its exceptions are swallowed
        self.span_sink = None
        self._t0 = time.perf_counter()

    @property
    def enabled(self):
        return bool(os.environ.get(TRACE_DIR_ENV) or
                    root.common.trace.get("enabled", False))

    def _ensure_open(self):
        if self._file is not None:
            return
        trace_dir = os.environ.get(TRACE_DIR_ENV)
        name = "events-%d.jsonl" % os.getpid()
        path = (os.path.join(trace_dir, name) if trace_dir else
                root.common.trace.get("file") or
                os.path.join(root.common.dirs.get("events", "."), name))
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._file = open(path, "a", buffering=1)   # line buffered
        # wall-clock anchor: ts values are per-process perf_counter
        # deltas; tools/merge_traces.py aligns files on this record
        self._file.write(json.dumps({
            "name": "trace_start", "ph": "i",
            "ts": round((time.perf_counter() - self._t0) * 1e6, 1),
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": {"unix_time_s": time.time()}}) + "\n")
        atexit.register(self.close)

    def event(self, name, kind="single", duration=None, **info):
        """Record one event; a no-op unless tracing is on (the
        ``span_sink`` mirror fires regardless: it is memory-only)."""
        sink = self.span_sink
        if sink is not None:
            try:
                sink(name, kind, duration, info)
            except Exception:  # noqa: BLE001 — diagnostics never raise
                pass
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
                # explicit trace_id / span kwargs win
                info = dict(info)
                info.setdefault("trace_id", ctx.trace_id)
                info.setdefault("span", ctx.span_id)
                if ctx.parent_id:
                    info.setdefault("parent_span", ctx.parent_id)
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

    def reset(self):
        """Close the output and forget the path, so the next event
        resolves its destination from the config and the environment
        again (tests, forked workers)."""
        self.close()
        with self._lock:
            self.path = None
            self._t0 = time.perf_counter()


#: process-global event log
events = EventLog()
