"""Per-request flight recorder: one timeline per request, always on.

A copy of ``veles_tpu/observability/flight.py``.  The registry answers
*aggregate* questions (p99 gauges, counters, opt-in trace files) but
not "why was THIS request's TTFT 2 s" or "which phase owns the decode
tail".  The flight recorder does: every latency source of the serving
stack (router retries and affinity, admission queueing, chunked
prefill, batched decode steps, speculative verify, KV-tier readmits,
live migration hops) reports a **typed event** into a per-request
timeline, stitched across processes by the ``X-Trace-Id`` wire
(:mod:`~veles_tpu_torch.observability.trace`).  Timelines, their JSONL
records and the ``flight`` entry of a migrated session's state are the
JAX package's format, so either package absorbs the other's.

Bounded by construction:

- a per-replica fixed-size ring of timelines (``capacity``, drop-oldest
  — evicting never blocks the hot path on I/O);
- a per-timeline event cap (``max_events``; beyond it events are
  counted, not stored);
- recording is a lock + list append, and never waits on the device;
  the decode step hot path batches all rows of one step under a single
  lock acquisition
  (:meth:`FlightRecorder.record_step_rows`).

Timelines persist to JSONL (``flight-<pid>.jsonl`` under
``VELES_FLIGHT_DIR``) only on **anomaly triggers** — deadline miss/504,
429 shed, connection retry, migration, SIGKILL-recovery replay, or
TTFT/per-token latency above a rolling p99 threshold — so steady state
stays memory-only and cheap.  ``GET /api/<name>/requests`` (replica),
``GET /fleet/requests`` (router-merged) and ``tools/request_inspect.py``
read the ring; :mod:`~veles_tpu_torch.observability.attribution` turns
timelines into phase-share reports.

Single-source rule: every event kind has exactly ONE producer.  The
decode step is recorded by the scheduler worker (with the per-row
share), NOT by mirroring the ``serving.decode`` span a
:class:`~veles_tpu_torch.observability.profiler.StepProfiler` or
``DecodeMetrics`` may also emit — the optional EventLog bridge
(:meth:`FlightRecorder.install_span_bridge`) therefore skips every span
name that has a first-class producer (:data:`DIRECT_SPAN_KINDS`), and
a per-timeline step-ordinal guard drops duplicates even if two
producers ever race.  Stdlib-only; imports nothing above
``observability``.
"""

import collections
import json
import os
import threading
import time

from .registry import REGISTRY

__all__ = ["FlightRecorder", "RECORDER", "FLIGHT_DIR_ENV",
           "DIRECT_SPAN_KINDS", "configure_from_env"]

#: persistence dir env var (planted per replica by the fleet supervisor)
FLIGHT_DIR_ENV = "VELES_FLIGHT_DIR"

#: span names with a first-class flight producer — the EventLog bridge
#: must NEVER mirror these into timelines (single-source; satellite of
#: the StepProfiler double-count fix: a profiler attached while a
#: decode scheduler is live re-emits step spans, but only the scheduler
#: worker's record_step_rows() feeds the timeline)
DIRECT_SPAN_KINDS = frozenset((
    "serving.decode", "serving.draft", "serving.verify",
    "serving.prefill_chunk", "serving.prefill", "train.step",
    "serving.request", "serving.generate_request", "fleet.route",
))

#: anomaly reasons (the persist triggers)
ANOMALY_REASONS = ("deadline_504", "shed_429", "retry", "migration",
                   "recovery_replay", "ttft_p99", "per_token_p99",
                   "error")


class _Timeline:
    """One request's event list plus bookkeeping.  Events are stored as
    ``(t_wall, kind, info_dict_or_None)`` tuples — rendered to dicts
    only at read time, never on the hot path."""

    __slots__ = ("trace_id", "started", "finished", "status", "events",
                 "dropped", "anomalies", "meta", "persisted",
                 "last_step", "imported")

    def __init__(self, trace_id, t):
        self.trace_id = trace_id
        self.started = t
        self.finished = None
        self.status = None
        self.events = []
        self.dropped = 0
        self.anomalies = []
        self.meta = {}
        self.persisted = False
        self.last_step = -1        # decode-step ordinal dedup guard
        self.imported = []         # event tuples absorbed from a peer

    def to_dict(self, replica=None):
        evs = [_render(e) for e in self.imported]
        evs += [_render(e) for e in self.events]
        evs.sort(key=lambda e: e["t"])
        out = {"trace_id": self.trace_id,
               "started_unix": round(self.started, 6),
               "status": self.status,
               "anomalies": list(self.anomalies),
               "events": evs}
        if replica:
            out["replica"] = replica
        if self.finished is not None:
            out["finished_unix"] = round(self.finished, 6)
        if self.dropped:
            out["events_dropped"] = self.dropped
        if self.meta:
            out["meta"] = dict(self.meta)
        return out


def _render(ev):
    t, kind, info = ev
    rec = {"t": round(t, 6), "kind": kind}
    if type(info) is tuple:
        # compact decode.step storage: (step, share_s, rows) — the
        # per-row hot path appends a shared-shape tuple instead of
        # allocating a dict per row per step
        rec["step"], rec["share_s"], rec["rows"] = info
    elif info:
        rec.update(info)
    return rec


class FlightRecorder:
    """Fixed-size ring of per-request timelines keyed by trace id."""

    def __init__(self, capacity=256, max_events=512, window=512,
                 min_samples=32, persist_dir=None, replica=None,
                 enabled=True):
        self.capacity = int(capacity)
        self.max_events = int(max_events)
        self.min_samples = int(min_samples)
        self.persist_dir = persist_dir
        self.replica = replica
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._ring = collections.OrderedDict()   # trace_id -> _Timeline
        self._ttft_window = collections.deque(maxlen=int(window))
        self._tok_window = collections.deque(maxlen=int(window))
        # rolling p99s are recomputed lazily every _P99_REFRESH inserts
        # — sorting the window on every finish() would dominate the
        # recorder's own overhead budget
        self._p99_cache = {}
        self._p99_stale = {}
        self._file = None
        self._bridge_installed = False
        # hold the label-less CHILD series directly — the metric-family
        # indirection (labels() key build + dict lookup) is measurable
        # at one inc per recorded event
        self._c_requests = REGISTRY.counter(
            "veles_flight_requests_total",
            "Request timelines opened by the flight recorder").labels()
        self._c_events = REGISTRY.counter(
            "veles_flight_events_total",
            "Typed events recorded into flight timelines").labels()
        self._c_dropped = REGISTRY.counter(
            "veles_flight_events_dropped_total",
            "Events dropped by the per-timeline cap").labels()
        self._c_anomalies = REGISTRY.counter(
            "veles_flight_anomalies_total",
            "Anomaly triggers by reason", ("reason",))
        self._c_persisted = REGISTRY.counter(
            "veles_flight_persisted_total",
            "Anomalous timelines persisted to JSONL").labels()

    # -- configuration -------------------------------------------------------
    def configure(self, persist_dir=None, replica=None, enabled=None):
        if persist_dir is not None:
            self.persist_dir = persist_dir
            self._close_file()
        if replica is not None:
            self.replica = replica
        if enabled is not None:
            self.enabled = bool(enabled)

    def _resolve_dir(self):
        return self.persist_dir or os.environ.get(FLIGHT_DIR_ENV)

    # -- recording (hot path) ------------------------------------------------
    def _timeline(self, trace_id, t):
        """Get-or-create under the caller's lock; evicts drop-oldest."""
        tl = self._ring.get(trace_id)
        if tl is not None:
            self._ring.move_to_end(trace_id)
            return tl
        tl = _Timeline(trace_id, t)
        self._ring[trace_id] = tl
        self._c_requests.inc()
        while len(self._ring) > self.capacity:
            self._ring.popitem(last=False)
        return tl

    def record(self, trace_id, kind, **info):
        """Append one typed event to ``trace_id``'s timeline."""
        if not self.enabled or not trace_id:
            return
        t = time.time()
        with self._lock:
            tl = self._timeline(trace_id, t)
            if kind == "decode.step":
                step = info.get("step")
                if step is not None and step <= tl.last_step:
                    return          # duplicate producer — single-source
                tl.last_step = step if step is not None else tl.last_step
            if len(tl.events) >= self.max_events:
                tl.dropped += 1
                self._c_dropped.inc()
                return
            tl.events.append((t, kind, info or None))
        self._c_events.inc()

    def record_step_rows(self, rows, seconds):
        """One decode batch step: ``rows`` is ``[(trace_id, ordinal),
        ...]`` for every active row; each gets the fair per-row share
        (batch cost ÷ active rows) under a SINGLE lock acquisition."""
        if not self.enabled or not rows:
            return
        n_rows = len(rows)
        share = round(seconds / n_rows, 6)
        t = time.time()
        recorded = dropped = 0
        ring_get = self._ring.get
        max_events = self.max_events
        with self._lock:
            for trace_id, step in rows:
                if not trace_id:
                    continue
                # fast path: plain lookup, no LRU touch — this is the
                # highest-frequency producer, and every session is
                # re-touched by its own lifecycle events anyway
                tl = ring_get(trace_id)
                if tl is None:
                    tl = self._timeline(trace_id, t)
                if step is not None and step <= tl.last_step:
                    continue
                tl.last_step = step if step is not None else tl.last_step
                if len(tl.events) >= max_events:
                    tl.dropped += 1
                    dropped += 1
                    continue
                tl.events.append((t, "decode.step",
                                  (step, share, n_rows)))
                recorded += 1
        # counters batch OUTSIDE the ring lock: one registry-lock
        # acquisition per step, not per row (the overhead gate)
        if recorded:
            self._c_events.inc(recorded)
        if dropped:
            self._c_dropped.inc(dropped)

    def annotate(self, trace_id, **meta):
        """Attach request metadata (model, tenant, session, replica
        hop) without consuming an event slot."""
        if not self.enabled or not trace_id:
            return
        with self._lock:
            tl = self._timeline(trace_id, time.time())
            tl.meta.update({k: v for k, v in meta.items()
                            if v is not None})

    # -- anomalies / lifecycle ----------------------------------------------
    def anomaly(self, trace_id, reason, **info):
        """Mark a timeline anomalous (it will persist on finish — or
        now, if already finished) and record the trigger event."""
        if not self.enabled or not trace_id:
            return
        t = time.time()
        with self._lock:
            tl = self._timeline(trace_id, t)
            if reason not in tl.anomalies:
                tl.anomalies.append(reason)
            self._c_anomalies.labels(reason=reason).inc()
            if len(tl.events) < self.max_events:
                info = dict(info)
                info["reason"] = reason
                tl.events.append((t, "anomaly", info))
                self._c_events.inc()
            if tl.finished is not None:
                self._persist_locked(tl)

    def finish(self, trace_id, status="ok", ttft_s=None,
               per_token_s=None):
        """Close a timeline; feeds the rolling p99 windows and persists
        when any anomaly trigger fired.  Latency values above the
        current rolling p99 (after ``min_samples``) are themselves
        anomaly triggers — the tail self-selects for persistence."""
        if not self.enabled or not trace_id:
            return
        t = time.time()
        with self._lock:
            tl = self._timeline(trace_id, t)
            tl.finished = t
            tl.status = status
            for value, window, reason in (
                    (ttft_s, self._ttft_window, "ttft_p99"),
                    (per_token_s, self._tok_window, "per_token_p99")):
                if value is None:
                    continue
                if len(window) >= self.min_samples:
                    p99 = self._p99_cache.get(reason)
                    if p99 is None or \
                            self._p99_stale.get(reason, 0) >= \
                            _P99_REFRESH:
                        p99 = _p99(window)
                        self._p99_cache[reason] = p99
                        self._p99_stale[reason] = 0
                    if value > p99 and reason not in tl.anomalies:
                        tl.anomalies.append(reason)
                        self._c_anomalies.labels(reason=reason).inc()
                        tl.events.append(
                            (t, "anomaly",
                             {"reason": reason,
                              "value_s": round(value, 6),
                              "p99_s": round(p99, 6)}))
                window.append(value)
                self._p99_stale[reason] = \
                    self._p99_stale.get(reason, 0) + 1
            if tl.anomalies:
                self._persist_locked(tl)

    # -- migration travel ----------------------------------------------------
    def export(self, trace_id):
        """JSON-safe snapshot for the session wire (timelines travel
        with migrated sessions); None when the id is unknown."""
        if not trace_id:
            return None
        with self._lock:
            tl = self._ring.get(trace_id)
            if tl is None:
                return None
            return tl.to_dict(replica=self.replica)

    def absorb(self, data):
        """Merge a peer's exported timeline into the local ring (the
        import half of migration travel)."""
        if not self.enabled or not isinstance(data, dict):
            return
        trace_id = data.get("trace_id")
        if not trace_id:
            return
        src = data.get("replica")
        with self._lock:
            tl = self._timeline(trace_id, time.time())
            # source and destination may share one process (in-test
            # migrations): never duplicate events the local timeline
            # already holds
            seen = set((round(t, 6), kind)
                       for t, kind, _ in tl.events + tl.imported)
            for ev in data.get("events", []):
                if not isinstance(ev, dict) or "t" not in ev:
                    continue
                if (round(float(ev["t"]), 6),
                        ev.get("kind")) in seen:
                    continue
                info = {k: v for k, v in ev.items()
                        if k not in ("t", "kind")}
                if src and "replica" not in info:
                    info["replica"] = src
                tl.imported.append((float(ev["t"]),
                                    str(ev.get("kind", "event")),
                                    info or None))
            for reason in data.get("anomalies", []):
                if reason not in tl.anomalies:
                    tl.anomalies.append(reason)
            for k, v in (data.get("meta") or {}).items():
                tl.meta.setdefault(k, v)

    # -- persistence ---------------------------------------------------------
    def _persist_locked(self, tl):
        if tl.persisted:
            return
        directory = self._resolve_dir()
        if not directory:
            return
        try:
            if self._file is None:
                os.makedirs(directory, exist_ok=True)
                self._file = open(os.path.join(
                    directory, "flight-%d.jsonl" % os.getpid()),
                    "a", buffering=1)
            self._file.write(json.dumps(
                tl.to_dict(replica=self.replica)) + "\n")
            tl.persisted = True
            self._c_persisted.inc()
        except OSError:
            pass                    # diagnostics never take down serving

    def _close_file(self):
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None

    # -- reading -------------------------------------------------------------
    def get(self, trace_id):
        with self._lock:
            tl = self._ring.get(trace_id)
            return tl.to_dict(replica=self.replica) \
                if tl is not None else None

    def snapshot(self, trace_id=None, model=None, limit=64):
        """Recent timelines, newest first; optionally one id or one
        model's requests."""
        if trace_id:
            doc = self.get(trace_id)
            return [doc] if doc else []
        with self._lock:
            out = []
            for tl in reversed(self._ring.values()):
                if model and tl.meta.get("model") not in (None, model):
                    continue
                out.append(tl.to_dict(replica=self.replica))
                if len(out) >= limit:
                    break
            return out

    def stats(self):
        with self._lock:
            return {"timelines": len(self._ring),
                    "capacity": self.capacity,
                    "ttft_window": len(self._ttft_window),
                    "per_token_window": len(self._tok_window),
                    "replica": self.replica,
                    "persist_dir": self._resolve_dir()}

    # -- EventLog bridge -----------------------------------------------------
    def install_span_bridge(self, eventlog=None):
        """Mirror generic EventLog spans into EXISTING timelines.

        Only spans carrying an explicit trace id that already has a
        timeline are ingested (the bridge never creates — an ambient
        process-wide trace context must not grow an unbounded
        pseudo-request), and names in :data:`DIRECT_SPAN_KINDS` are
        skipped because their first-class producers already record them
        with richer typed info — the single-source rule that keeps a
        live StepProfiler from double-counting decode steps."""
        if eventlog is None:
            from ..logger import events as eventlog
        eventlog.span_sink = self._span_sink
        self._bridge_installed = True

    def _span_sink(self, name, kind, duration, info):
        if not self.enabled or name in DIRECT_SPAN_KINDS:
            return
        from . import trace as _trace
        ctx = _trace.current()
        trace_id = (info or {}).get("trace_id") or \
            (ctx.trace_id if ctx is not None else None)
        if not trace_id:
            return
        t = time.time()
        with self._lock:
            tl = self._ring.get(trace_id)
            if tl is None:
                return              # bridge never creates timelines
            if len(tl.events) >= self.max_events:
                tl.dropped += 1
                self._c_dropped.inc()
                return
            ev = {"span": name}
            if duration is not None:
                ev["seconds"] = round(duration, 6)
            tl.events.append((t, "span", ev))
            self._c_events.inc()

    # -- tests ---------------------------------------------------------------
    def reset(self):
        with self._lock:
            self._ring.clear()
            self._ttft_window.clear()
            self._tok_window.clear()
            self._p99_cache.clear()
            self._p99_stale.clear()
            self._close_file()


#: finishes between rolling-p99 recomputations (the sort is O(n log n)
#: over the window; amortizing it keeps finish() on the cheap path)
_P99_REFRESH = 16


def _p99(window):
    ordered = sorted(window)
    return ordered[min(len(ordered) - 1,
                       int(0.99 * (len(ordered) - 1) + 0.5))]


#: process-global recorder — per-replica because a replica IS a process
RECORDER = FlightRecorder()


def configure_from_env(replica=None):
    """Adopt ``VELES_FLIGHT_DIR`` (planted by the fleet supervisor) and
    the replica id; called at replica/router startup."""
    RECORDER.configure(persist_dir=os.environ.get(FLIGHT_DIR_ENV),
                       replica=replica)
    return RECORDER
