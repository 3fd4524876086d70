"""Decode-serving metrics: registry-backed counters and latency quantiles.

The part of ``veles_tpu/serving/metrics.py`` the core decode scheduler
touches.  Counter state lives in the process-global
:class:`~veles_tpu_torch.observability.registry.MetricsRegistry`
(labelled by model), so the numbers ``GET /metrics`` reports are the
ones a Prometheus scrape of the registry would see; :class:`DecodeMetrics`
keeps what the registry cannot express — the exact-quantile latency
windows and the recent tok/s ring — plus per-instance baselines so
``snapshot()`` stays scoped to one scheduler's lifetime.
"""

import collections
import threading
import time

from ..logger import events
from ..observability.registry import REGISTRY

__all__ = ["LatencyWindow", "DecodeMetrics"]


class LatencyWindow:
    """Sliding-window latency reservoir with tail quantiles: a bounded
    deque of the most recent ``window`` observations, sorted only when
    summarized."""

    def __init__(self, window=4096):
        self._samples = collections.deque(maxlen=int(window))
        self._lock = threading.Lock()

    def record(self, seconds):
        with self._lock:
            self._samples.append(float(seconds))

    @staticmethod
    def _quantile(ordered, q):
        if not ordered:
            return None
        idx = min(len(ordered) - 1, int(q * len(ordered)))
        return ordered[idx]

    def summary(self):
        with self._lock:
            ordered = sorted(self._samples)
        if not ordered:
            return {"n": 0, "p50_ms": None, "p95_ms": None, "p99_ms": None}
        to_ms = lambda s: round(s * 1e3, 3)  # noqa: E731
        return {"n": len(ordered),
                "p50_ms": to_ms(self._quantile(ordered, 0.50)),
                "p95_ms": to_ms(self._quantile(ordered, 0.95)),
                "p99_ms": to_ms(self._quantile(ordered, 0.99)),
                "mean_ms": to_ms(sum(ordered) / len(ordered)),
                "max_ms": to_ms(ordered[-1])}


#: registry counter families shared by every DecodeMetrics instance
#: (the JAX package's names, so dashboards read either package)
_DECODE_COUNTERS = {
    "sequences": ("veles_serving_decode_sequences_total",
                  "Sequences admitted to the decode scheduler"),
    "completed": ("veles_serving_decode_completed_total",
                  "Sequences that finished generation"),
    "failed": ("veles_serving_decode_failed_total",
               "Sequences failed or cancelled before finishing"),
    "rejected": ("veles_serving_decode_rejected_total",
                 "Generate requests shed by backpressure (HTTP 429)"),
    "tokens": ("veles_serving_decode_tokens_total",
               "Tokens generated (prefill first-tokens included)"),
    "prefill_tokens": ("veles_serving_decode_prefill_tokens_total",
                       "Prompt tokens processed by prefill"),
    "steps": ("veles_serving_decode_steps_total",
              "Decode-step executions"),
    "step_rows": ("veles_serving_decode_step_rows_total",
                  "Active rows across decode steps (sum)"),
    "idle_rows": ("veles_serving_decode_idle_rows_total",
                  "Padding rows across decode steps (sum)"),
    "expired": ("veles_serving_decode_deadline_expired_total",
                "Generate requests shed because their deadline passed "
                "before prefill (HTTP 504)"),
}


class DecodeMetrics:
    """Per-model counters for the token-level decode scheduler: per-step
    latency quantiles (about the inter-token latency), time to first
    token, batch-row utilization, KV-block occupancy and bytes."""

    RATE_WINDOW = 4096  # (timestamp, tokens) pairs for the recent view

    def __init__(self, model="default", registry=None):
        self.model = model
        self.registry = registry or REGISTRY
        self.step_latency = LatencyWindow()
        self.ttft = LatencyWindow()
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._c = {key: self.registry.counter(name, help, ("model",))
                   .labels(model=model)
                   for key, (name, help) in _DECODE_COUNTERS.items()}
        # baselines: the registry series are process-global and
        # monotonic, snapshot() reports deltas from construction
        self._base = {key: c.value for key, c in self._c.items()}
        self._h_step = self.registry.histogram(
            "veles_serving_decode_step_seconds",
            "Decode step wall time (≈ per-token latency under load)",
            ("model",)).labels(model=model)
        self._h_ttft = self.registry.histogram(
            "veles_serving_decode_ttft_seconds",
            "Submit-to-first-token latency (queue + prefill)",
            ("model",)).labels(model=model)
        self._g_active = self.registry.gauge(
            "veles_serving_decode_active_rows",
            "Sequences currently decoding", ("model",)).labels(model=model)
        self._g_kv = self.registry.gauge(
            "veles_serving_kv_blocks_used_ratio",
            "Live KV blocks / allocatable blocks", ("model",)).labels(
                model=model)
        self._g_kv_bytes = self.registry.gauge(
            "veles_decode_kv_bytes_resident",
            "Device bytes held by live KV blocks", ("model",)).labels(
                model=model)
        self._g_kv_dtype = self.registry.gauge(
            "veles_decode_kv_dtype_info",
            "KV-pool element dtype serving this model (info gauge: "
            "value 1 on the active dtype label)", ("model", "kv_dtype"))
        self._g_quantile = self.registry.gauge(
            "veles_serving_decode_step_quantile_ms",
            "Exact decode-step quantiles over the recent window",
            ("model", "quantile"))
        self.registry.register_collector(self)
        self._emissions = collections.deque(maxlen=self.RATE_WINDOW)

    def _count(self, key):
        return int(round(self._c[key].value - self._base[key]))

    def __getattr__(self, name):
        if name in _DECODE_COUNTERS:
            return self._count(name)
        raise AttributeError(name)

    # -- recording (scheduler worker thread) ---------------------------------
    def record_admit(self, prompt_tokens):
        self._c["sequences"].inc()
        self._c["prefill_tokens"].inc(int(prompt_tokens))

    def record_first_token(self, seconds):
        """TTFT for one sequence: submit -> prefill's first token."""
        self.ttft.record(seconds)
        self._h_ttft.observe(seconds)
        self._c["tokens"].inc()
        with self._lock:
            self._emissions.append((time.time(), 1))

    def record_step(self, active_rows, max_rows, seconds):
        self.step_latency.record(seconds)
        self._h_step.observe(seconds)
        self._c["steps"].inc()
        self._c["step_rows"].inc(int(active_rows))
        self._c["idle_rows"].inc(int(max_rows) - int(active_rows))
        self._c["tokens"].inc(int(active_rows))
        with self._lock:
            self._emissions.append((time.time(), int(active_rows)))
        events.span("serving.decode", seconds, model=self.model,
                    rows=int(active_rows), max_rows=int(max_rows))

    def record_complete(self, generated, ok=True):
        self._c["completed" if ok else "failed"].inc()

    def record_reject(self):
        self._c["rejected"].inc()
        events.event("serving.decode_reject", model=self.model)

    def record_expired(self):
        self._c["expired"].inc()
        events.event("serving.decode_deadline_expired", model=self.model)

    def set_occupancy(self, active_rows, kv_ratio):
        self._g_active.set(int(active_rows))
        self._g_kv.set(float(kv_ratio))

    def set_kv_bytes(self, nbytes):
        self._g_kv_bytes.set(int(nbytes))

    def set_kv_dtype(self, kv_dtype):
        self._g_kv_dtype.labels(model=self.model,
                                kv_dtype=str(kv_dtype)).set(1)

    def collect_metrics(self):
        """Scrape-time refresh of the derived quantile gauges."""
        s = self.step_latency.summary()
        for q in ("p50", "p95", "p99"):
            value = s.get("%s_ms" % q)
            if value is not None:
                self._g_quantile.labels(model=self.model,
                                        quantile=q).set(value)

    # -- reader --------------------------------------------------------------
    def snapshot(self):
        now = time.time()
        with self._lock:
            emissions = list(self._emissions)
        counters = {key: self._count(key) for key in _DECODE_COUNTERS}
        uptime = max(now - self._t0, 1e-9)
        recent_tok_s = None
        if len(emissions) >= 2:
            span = emissions[-1][0] - emissions[0][0]
            if span > 0:
                recent_tok_s = round(
                    sum(n for _, n in emissions[1:]) / span, 1)
        rows = counters["step_rows"] + counters["idle_rows"]
        out = dict(counters)
        out.update({
            "uptime_s": round(uptime, 1),
            "lifetime_tok_s": round(counters["tokens"] / uptime, 2),
            "recent_tok_s": recent_tok_s,
            "row_fill": round(counters["step_rows"] / rows, 4)
            if rows else None,
            "step_latency": self.step_latency.summary(),
            "ttft": self.ttft.summary(),
        })
        return out
