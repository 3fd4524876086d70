"""Serving metrics: registry-backed counters and latency quantiles.

The port of ``veles_tpu/serving/metrics.py``.  :class:`ServingMetrics`
serves the request-granularity :class:`~.scheduler.BucketScheduler`
(requests, rows, batches, padding, the ``serving.batch`` span that
links a batch back to its requests).  :class:`DecodeMetrics` serves
the decode scheduler: the core counters, the prefix-cache and
chunked-prefill counters, the speculation series (draft, accept and
reject counts, verify passes and the windowed acceptance rate), the
tiered KV cache's ``veles_kvtier_*`` series (the tier store's
duck-typed observer surface) and the session-migration counters.
Counter state lives in the process-global
:class:`~veles_tpu_torch.observability.registry.MetricsRegistry`
(labelled by model), so the numbers ``GET /metrics`` reports are the
ones a Prometheus scrape of the registry would see; both classes keep
what the registry cannot express (the exact-quantile latency windows
and the recent rps and tok/s rings) plus per-instance baselines, so
``snapshot()`` stays scoped to one scheduler's lifetime.
"""

import collections
import threading
import time

from ..logger import events
from ..observability.registry import REGISTRY

__all__ = ["LatencyWindow", "ServingMetrics", "DecodeMetrics"]


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


def _bind_counters(registry, model, spec):
    """Declare (idempotently) and label-bind one counter child per
    ``spec`` entry.  Both serving metrics classes bind through here, so
    both scheduler kinds in one process re-declare the same families
    instead of colliding, and a second same-named scheduler (hot swap)
    reuses the existing series.  Returns ({key: child}, {key:
    construction-baseline value}): the registry series are
    process-global and monotonic, ``snapshot()`` reports deltas."""
    children = {key: registry.counter(name, help, ("model",))
                .labels(model=model)
                for key, (name, help) in spec.items()}
    return children, {key: child.value for key, child in children.items()}


#: registry counter families shared by every ServingMetrics instance
_COUNTERS = {
    "requests": ("veles_serving_requests_total",
                 "Completed inference requests"),
    "rows": ("veles_serving_rows_total",
             "Sample rows served"),
    "failures": ("veles_serving_failures_total",
                 "Requests answered with an internal error"),
    "rejected": ("veles_serving_rejected_total",
                 "Requests shed by backpressure (HTTP 429)"),
    "batches": ("veles_serving_batches_total",
                "Executed dispatch batches"),
    "batch_rows": ("veles_serving_batch_rows_total",
                   "Real rows across executed batches"),
    "padded_rows": ("veles_serving_padded_rows_total",
                    "Padding rows added by power-of-two bucketing"),
    "expired": ("veles_serving_deadline_expired_total",
                "Requests shed because their end-to-end deadline "
                "passed before device time was spent (HTTP 504)"),
}


class ServingMetrics:
    """Aggregate serving counters for one model.

    Thread-safe; recorded from request threads and the dispatch worker,
    read by ``GET /metrics``.  Counter semantics:

    - ``requests`` / ``rows``: completed inferences (a request may carry
      several sample rows);
    - ``failures``: requests answered with an internal error;
    - ``rejected``: requests shed by backpressure (HTTP 429);
    - ``batches`` / ``batch_rows`` / ``padded_rows``: dispatch-side view —
      fill ratio = batch_rows / (batch_rows + padded_rows).
    """

    RATE_WINDOW = 2048  # completion timestamps kept for the recent-rps view

    def __init__(self, model="default", registry=None):
        self.model = model
        self.registry = registry or REGISTRY
        self.latency = LatencyWindow()
        # dispatch-side batch wall time: what a queued request actually
        # waits per batch ahead of it — the Retry-After estimator's input
        self.batch_latency = LatencyWindow(512)
        self._lock = threading.Lock()
        self._t0 = time.time()
        # baseline at construction: the registry series are process-
        # global and monotonic (Prometheus semantics); snapshot() is
        # per-instance, so it reads deltas from here
        self._c, self._base = _bind_counters(self.registry, model,
                                             _COUNTERS)
        self._h_latency = self.registry.histogram(
            "veles_serving_request_seconds",
            "End-to-end request latency", ("model",)).labels(model=model)
        # seconds counter (floats, kept out of the int _COUNTERS
        # surface): the warmup cost per model (the port's warmup runs
        # each bucket once; nothing compiles)
        self._c_compile_s = self.registry.counter(
            "veles_serving_compile_seconds_total",
            "Wall seconds spent producing bucket executables "
            "(fresh compiles and cache loads)",
            ("model",)).labels(model=model)
        self._base_compile_s = self._c_compile_s.value
        # scrape-time gauges derived from the exact-quantile window and
        # the fill counters (refreshed via collect_metrics just before
        # every /metrics render — Prometheus quantile gauges would be
        # stale or request-path-expensive otherwise)
        self._g_quantile = self.registry.gauge(
            "veles_serving_latency_quantile_ms",
            "Exact latency quantiles over the recent sample window",
            ("model", "quantile"))
        self._g_fill = self.registry.gauge(
            "veles_serving_batch_fill_ratio",
            "Real rows / (real + padding) across executed batches",
            ("model",)).labels(model=model)
        self.registry.register_collector(self)
        self._completions = collections.deque(maxlen=self.RATE_WINDOW)

    def _count(self, key):
        return int(round(self._c[key].value - self._base[key]))

    def __getattr__(self, name):
        # the seed exposed counters as plain attributes; keep that
        # surface (metrics.requests et al.) over the registry state
        if name in _COUNTERS:
            return self._count(name)
        raise AttributeError(name)

    # -- request-side --------------------------------------------------------
    def record_request(self, rows, seconds, ok=True):
        self.latency.record(seconds)
        self._h_latency.observe(seconds)
        self._c["requests"].inc()
        self._c["rows"].inc(int(rows))
        if not ok:
            self._c["failures"].inc()
        with self._lock:
            self._completions.append(time.time())

    def record_reject(self):
        self._c["rejected"].inc()
        events.event("serving.reject", model=self.model)

    def record_expired(self):
        self._c["expired"].inc()
        events.event("serving.deadline_expired", model=self.model)

    def record_compile(self, seconds):
        """One bucket executable produced (compile or cache load)."""
        self._c_compile_s.inc(float(seconds))

    # -- dispatch-side -------------------------------------------------------
    def record_batch(self, bucket, rows, seconds, n_requests, links=None):
        """``links``: request span ids batched into this dispatch — the
        causal glue between per-request and per-batch spans in the
        merged trace."""
        self._c["batches"].inc()
        self._c["batch_rows"].inc(int(rows))
        self._c["padded_rows"].inc(int(bucket) - int(rows))
        self.batch_latency.record(seconds)
        extra = {"links": links} if links else {}
        events.span("serving.batch", seconds, model=self.model,
                    bucket=int(bucket), rows=int(rows),
                    requests=int(n_requests), **extra)

    def collect_metrics(self):
        """Refresh the derived gauges (called by the registry at scrape
        time, holding only a weak reference to this object)."""
        s = self.latency.summary()
        for q in ("p50", "p95", "p99"):
            value = s.get("%s_ms" % q)
            if value is not None:
                self._g_quantile.labels(model=self.model,
                                        quantile=q).set(value)
        filled = self._c["batch_rows"].value
        padded = self._c["padded_rows"].value
        if filled + padded:
            self._g_fill.set(filled / (filled + padded))

    # -- reader --------------------------------------------------------------
    def snapshot(self):
        now = time.time()
        with self._lock:
            completions = list(self._completions)
        counters = {key: self._count(key) for key in _COUNTERS}
        uptime = max(now - self._t0, 1e-9)
        recent_rps = None
        if len(completions) >= 2:
            span = completions[-1] - completions[0]
            if span > 0:
                recent_rps = round((len(completions) - 1) / span, 1)
        filled = counters["batch_rows"]
        padded = counters["padded_rows"]
        out = dict(counters)
        out.update({
            "compile_seconds": round(
                self._c_compile_s.value - self._base_compile_s, 4),
            "uptime_s": round(uptime, 1),
            "lifetime_rps": round(counters["requests"] / uptime, 2),
            "recent_rps": recent_rps,
            "batch_fill": round(filled / (filled + padded), 4)
            if filled + padded else None,
            "rows_per_batch": round(filled / counters["batches"], 2)
            if counters["batches"] else None,
            "latency": self.latency.summary(),
            "batch_latency": self.batch_latency.summary(),
        })
        return out


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
    "migrated_out": ("veles_serving_decode_migrated_out_total",
                     "Live sessions exported to a peer or spilled"),
    "migrated_in": ("veles_serving_decode_migrated_in_total",
                    "Live sessions imported mid-generation"),
    "prefix_hits": ("veles_serving_kv_prefix_hits_total",
                    "Admits that attached to >= 1 already-resident "
                    "KV block (prefix cache hit)"),
    "dedup_blocks": ("veles_serving_kv_blocks_dedup",
                     "KV blocks attached already-resident at admit "
                     "instead of re-prefilled (cumulative)"),
    "chunks": ("veles_serving_prefill_chunks_total",
               "Prefill chunk executions (the chunked path interleaved "
               "with decode steps)"),
    "draft_tokens": ("veles_serving_spec_draft_tokens_total",
                     "Draft tokens proposed by the speculative drafter"),
    "accepted_tokens": ("veles_serving_spec_accepted_tokens_total",
                        "Draft tokens the verify pass accepted"),
    "rejected_tokens": ("veles_serving_spec_rejected_tokens_total",
                        "Draft tokens the verify pass rejected (their KV "
                        "writes are rolled back)"),
    "verify_steps": ("veles_serving_spec_verify_steps_total",
                     "Speculative verify-pass executions"),
}

#: draft/accept outcomes kept for the windowed acceptance-rate gauge
_ACCEPT_WINDOW = 1024

#: resident-prefix fraction bands of the split TTFT histogram: how much
#: of the prompt was already cached when the sequence was admitted
_PREFIX_BANDS = ((0.5, "major"), (0.0, "minor"))


def _prefix_band(resident):
    if not resident:
        return "none"
    for floor, band in _PREFIX_BANDS:
        if resident >= floor:
            return band
    return "none"


class DecodeMetrics:
    """Per-model counters for the token-level decode scheduler: per-step
    latency quantiles (about the inter-token latency), time to first
    token (also split by the resident share of the prompt), batch-row
    utilization, KV-block occupancy and bytes, prefix reuse, prefill
    chunks and the speculation outcomes."""

    RATE_WINDOW = 4096  # (timestamp, tokens) pairs for the recent view

    def __init__(self, model="default", registry=None):
        self.model = model
        self.registry = registry or REGISTRY
        self.step_latency = LatencyWindow()
        self.ttft = LatencyWindow()
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._c, self._base = _bind_counters(self.registry, model,
                                             _DECODE_COUNTERS)
        self._h_step = self.registry.histogram(
            "veles_serving_decode_step_seconds",
            "Decode step wall time (≈ per-token latency under load)",
            ("model",)).labels(model=model)
        self._h_ttft = self.registry.histogram(
            "veles_serving_decode_ttft_seconds",
            "Submit-to-first-token latency (queue + prefill)",
            ("model",)).labels(model=model)
        # TTFT split by how much of the prompt was already resident at
        # admit (bands: none / minor (< 50%) / major (>= 50%))
        self._h_ttft_prefix = self.registry.histogram(
            "veles_serving_decode_ttft_by_prefix_seconds",
            "Submit-to-first-token latency split by resident-prefix "
            "fraction at admit", ("model", "resident"))
        # tiered-KV-cache families (veles_tpu_torch/kvtier): demote and
        # promote flow per tier, byte occupancy gauges, and TTFT banded
        # by the deepest tier that served the admit's longest prefix hit
        # (hbm / host / disk / none)
        self._c_tier_demote = self.registry.counter(
            "veles_kvtier_demotions_total",
            "KV chain blocks demoted into the tier (HBM evictions land "
            "in host RAM, host-RAM overflow cascades to disk)",
            ("model", "tier"))
        self._c_tier_promote = self.registry.counter(
            "veles_kvtier_promotions_total",
            "KV chain blocks promoted out of the tier on readmit",
            ("model", "tier"))
        self._c_disk_readmit = self.registry.counter(
            "veles_kvtier_disk_readmits_total",
            "Chain blocks readmitted into HBM from the disk tier "
            "(zero re-prefill instead of recompute)",
            ("model",)).labels(model=model)
        self._g_tier_bytes = self.registry.gauge(
            "veles_kvtier_bytes",
            "Byte occupancy of the KV tier", ("model", "tier"))
        self._h_ttft_tier = self.registry.histogram(
            "veles_serving_decode_ttft_by_tier_seconds",
            "Submit-to-first-token latency split by the deepest KV "
            "tier serving the admit's longest prefix hit",
            ("model", "tier"))
        self._tier_children = {
            (kind, tier): family.labels(model=model, tier=tier)
            for kind, family in (("demotions", self._c_tier_demote),
                                 ("promotions", self._c_tier_promote))
            for tier in ("host", "disk")}
        self._tier_base = {key: child.value
                           for key, child in self._tier_children.items()}
        self._base_disk_readmit = self._c_disk_readmit.value
        self._g_chunk_queue = self.registry.gauge(
            "veles_serving_prefill_chunk_queue",
            "Sequences currently mid-chunked-prefill",
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
        # speculation: verify-batch-size histogram and a windowed
        # acceptance-rate gauge, refreshed at scrape time from the recent
        # (drafted, accepted) pairs (a lifetime ratio would hide
        # acceptance drifting with the workload)
        self._h_verify = self.registry.histogram(
            "veles_serving_spec_verify_batch_tokens",
            "Tokens per speculative verify pass (rows x (depth + 1))",
            ("model",)).labels(model=model)
        self._g_acceptance = self.registry.gauge(
            "veles_serving_spec_acceptance_rate",
            "Accepted / drafted tokens over the recent window",
            ("model",)).labels(model=model)
        self._acceptance = collections.deque(maxlen=_ACCEPT_WINDOW)
        self.registry.register_collector(self)
        self._emissions = collections.deque(maxlen=self.RATE_WINDOW)

    def _count(self, key):
        return int(round(self._c[key].value - self._base[key]))

    def __getattr__(self, name):
        if name in _DECODE_COUNTERS:
            return self._count(name)
        raise AttributeError(name)

    # -- recording (scheduler worker thread) ---------------------------------
    def record_admit(self, prompt_tokens, prefilled=None):
        """``prefilled``: the prompt tokens the prefill has to process
        (the prompt minus its resident prefix); default the whole
        prompt."""
        self._c["sequences"].inc()
        self._c["prefill_tokens"].inc(int(
            prompt_tokens if prefilled is None else prefilled))

    def record_prefix(self, matched_blocks):
        """One admission's prefix-reuse outcome: 0 matched blocks is a
        miss, anything else a hit of that many dedup'd blocks."""
        if matched_blocks:
            self._c["prefix_hits"].inc()
            self._c["dedup_blocks"].inc(int(matched_blocks))

    def record_chunk(self):
        self._c["chunks"].inc()

    def set_chunk_queue(self, depth):
        self._g_chunk_queue.set(int(depth))

    def record_first_token(self, seconds, resident=None, tier=None):
        """TTFT for one sequence: submit -> prefill's first token.
        ``resident``: the fraction of the prompt already cached at admit
        (None or 0 when prefix caching is off or nothing matched).
        ``tier``: the deepest KV tier the admit's longest prefix hit
        came from ('hbm' | 'host' | 'disk'); defaults from
        ``resident``."""
        self.ttft.record(seconds)
        self._h_ttft.observe(seconds)
        self._h_ttft_prefix.labels(
            model=self.model,
            resident=_prefix_band(resident)).observe(seconds)
        if tier is None:
            tier = "hbm" if resident else "none"
        self._h_ttft_tier.labels(model=self.model,
                                 tier=tier).observe(seconds)
        self._c["tokens"].inc()
        with self._lock:
            self._emissions.append((time.time(), 1))

    # -- tiered KV cache (the kvtier observer surface) -----------------------
    def record_tier_demotion(self, tier, nbytes=0):
        self._tier_children[("demotions", tier)].inc()

    def record_tier_promotion(self, tier, nbytes=0):
        self._tier_children[("promotions", tier)].inc()

    def record_disk_readmit(self):
        self._c_disk_readmit.inc()

    def set_tier_bytes(self, host=0, disk=0):
        self._g_tier_bytes.labels(model=self.model,
                                  tier="host").set(int(host))
        self._g_tier_bytes.labels(model=self.model,
                                  tier="disk").set(int(disk))

    def _tier_count(self, kind, tier):
        key = (kind, tier)
        return int(round(self._tier_children[key].value
                         - self._tier_base[key]))

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

    def record_extra_tokens(self, n):
        """Tokens emitted beyond one a row in a speculative iteration
        (accepted drafts): keeps the tokens counter and the recent tok/s
        window honest about what speculation emits."""
        self._c["tokens"].inc(int(n))
        with self._lock:
            self._emissions.append((time.time(), int(n)))

    def record_draft(self, rows, depth, seconds):
        """One drafter call: ``rows`` live rows each proposed ``depth``
        tokens."""
        self._c["draft_tokens"].inc(int(rows) * int(depth))
        events.span("serving.draft", seconds, model=self.model,
                    rows=int(rows), depth=int(depth))

    def record_verify(self, rows, span, accepted, rejected, seconds):
        """One verify pass over ``rows`` live rows x ``span`` fed
        positions; ``accepted``/``rejected`` are the batch's draft
        outcomes as the host-side accept step decided them."""
        self._c["verify_steps"].inc()
        self._c["accepted_tokens"].inc(int(accepted))
        self._c["rejected_tokens"].inc(int(rejected))
        self._h_verify.observe(int(rows) * int(span))
        with self._lock:
            self._acceptance.append((int(accepted) + int(rejected),
                                     int(accepted)))
        events.span("serving.verify", seconds, model=self.model,
                    rows=int(rows), span=int(span),
                    accepted=int(accepted), rejected=int(rejected))

    def acceptance_rate(self):
        """Accepted / drafted over the recent window (None before any
        speculative step)."""
        with self._lock:
            pairs = list(self._acceptance)
        drafted = sum(d for d, _ in pairs)
        if not drafted:
            return None
        return sum(a for _, a in pairs) / drafted

    def record_complete(self, generated, ok=True):
        self._c["completed" if ok else "failed"].inc()

    def record_reject(self):
        self._c["rejected"].inc()
        events.event("serving.decode_reject", model=self.model)

    def record_expired(self):
        self._c["expired"].inc()
        events.event("serving.decode_deadline_expired", model=self.model)

    def record_migrate(self, n, direction="out"):
        self._c["migrated_out" if direction == "out"
                else "migrated_in"].inc(int(n))

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
        rate = self.acceptance_rate()
        if rate is not None:
            self._g_acceptance.set(rate)

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
        rate = self.acceptance_rate()
        if rate is not None:
            out["acceptance_rate"] = round(rate, 4)
        disk_readmits = int(round(self._c_disk_readmit.value
                                  - self._base_disk_readmit))
        tiers = {"demotions": {t: self._tier_count("demotions", t)
                               for t in ("host", "disk")},
                 "promotions": {t: self._tier_count("promotions", t)
                                for t in ("host", "disk")},
                 "disk_readmits": disk_readmits}
        if disk_readmits or any(v for d in (tiers["demotions"],
                                            tiers["promotions"])
                                for v in d.values()):
            out["kvtier"] = tiers
        return out
