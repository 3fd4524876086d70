"""Phase attribution: flight timelines → "which phase owns the tail".

A copy of ``veles_tpu/observability/attribution.py``: pure functions
over the timeline dicts the
:class:`~veles_tpu_torch.observability.flight.FlightRecorder` produces
(no locks, no registry, importable by tools and benches alike).

The decomposition mirrors how the scheduler actually spends a
request's wall clock:

- **queue** — ``queue.enter`` → ``queue.admit`` gap (admission wait);
- **prefill** — sum of ``prefill.chunk`` seconds;
- **decode** — sum of ``decode.step`` per-row shares (batch cost ÷
  active rows, so shared steps attribute fairly) plus speculative
  draft shares;
- **verify** — speculative verify shares (``spec.step``);
- **tier** — KV-tier readmit time (``tier.hit`` seconds);
- **migration** — ``migrate.export`` → ``migrate.import`` hop gap;
- **other** — the residual against measured wall clock, kept explicit
  so a report that stops covering the tail is visible instead of
  silently wrong.

TTFT is decomposed over events up to the ``first_token`` mark;
per-token latency over events after it.  :func:`aggregate` groups
requests by tenant tag and replica and reports p50/p95/p99 per phase.
"""

__all__ = ["PHASES", "phase_breakdown", "aggregate", "percentile",
           "render_report"]

#: attribution phases, in report order
PHASES = ("queue", "prefill", "decode", "verify", "tier", "migration",
          "other")


def percentile(values, q):
    """Exact percentile of a small sample (same convention as
    serving.metrics.LatencyWindow)."""
    if not values:
        return None
    ordered = sorted(values)
    idx = min(len(ordered) - 1, int(q * (len(ordered) - 1) + 0.5))
    return ordered[idx]


def _zero_phases():
    return {p: 0.0 for p in PHASES}


def _add_event(phases, ev):
    kind = ev.get("kind")
    if kind == "prefill.chunk":
        phases["prefill"] += float(ev.get("seconds", 0.0) or 0.0)
    elif kind == "decode.step":
        phases["decode"] += float(ev.get("share_s", 0.0) or 0.0)
    elif kind == "spec.step":
        phases["decode"] += float(ev.get("draft_share_s", 0.0) or 0.0)
        phases["verify"] += float(ev.get("verify_share_s", 0.0) or 0.0)
    elif kind == "tier.hit":
        phases["tier"] += float(ev.get("seconds", 0.0) or 0.0)


def phase_breakdown(timeline):
    """Decompose ONE timeline dict into phase seconds.

    Returns ``{"ttft_s", "ttft_phases", "per_token_s", "tokens",
    "decode_phases", "coverage"}`` — any piece may be None when its
    marker events are missing (e.g. a shed request never prefilled).
    """
    events = timeline.get("events") or []
    t_enter = t_admit = t_first = None
    ttft_s = None
    tokens = 0
    exports, imports = [], []
    for ev in events:
        kind = ev.get("kind")
        if kind == "queue.enter" and t_enter is None:
            t_enter = ev["t"]
        elif kind == "queue.admit" and t_admit is None:
            t_admit = ev["t"]
        elif kind == "first_token" and t_first is None:
            t_first = ev["t"]
            if ev.get("ttft_s") is not None:
                ttft_s = float(ev["ttft_s"])
        elif kind == "retire":
            tokens = int(ev.get("tokens", 0) or 0)
        elif kind == "migrate.export":
            exports.append(ev["t"])
        elif kind == "migrate.import":
            imports.append(ev["t"])

    ttft_phases = _zero_phases()
    decode_phases = _zero_phases()
    for ev in events:
        target = ttft_phases if (t_first is not None and
                                 ev["t"] <= t_first) else decode_phases
        _add_event(target, ev)
    if t_enter is not None and t_admit is not None:
        ttft_phases["queue"] = max(0.0, t_admit - t_enter)
    # an admitted request still WAITS while the engine serves other
    # sessions (head-of-line long prefills, interleaved decode steps
    # between its own chunks) — that service wait is queueing from the
    # request's perspective.  prefill.chunk events are stamped at chunk
    # COMPLETION, so each chunk's start is t - seconds; the gap back to
    # the previous mark (admission, or the previous chunk's end) is
    # wait, not compute
    mark = t_admit
    for ev in events:
        if ev.get("kind") != "prefill.chunk" or \
                (t_first is not None and ev["t"] > t_first):
            continue
        if mark is not None:
            start = ev["t"] - float(ev.get("seconds", 0.0) or 0.0)
            ttft_phases["queue"] += max(0.0, start - mark)
        mark = ev["t"]
    # migration: each export pairs with the next import after it; the
    # gap is wall time the session spent in flight between replicas
    mig = 0.0
    for t_exp in exports:
        after = [t for t in imports if t >= t_exp]
        if after:
            mig += after[0] - t_exp
    if mig:
        target = ttft_phases if (t_first is not None and exports and
                                 exports[0] <= t_first) else decode_phases
        target["migration"] += mig

    coverage = None
    if ttft_s is None and t_first is not None and t_enter is not None:
        ttft_s = max(0.0, t_first - t_enter)
    if ttft_s:
        covered = sum(v for p, v in ttft_phases.items() if p != "other")
        ttft_phases["other"] = max(0.0, ttft_s - covered)
        coverage = min(1.0, covered / ttft_s) if ttft_s > 0 else None

    per_token_s = None
    finished = timeline.get("finished_unix")
    if t_first is not None and finished is not None and tokens > 1:
        per_token_s = max(0.0, finished - t_first) / (tokens - 1)
        covered = sum(v for p, v in decode_phases.items()
                      if p != "other")
        decode_phases["other"] = max(
            0.0, (finished - t_first) - covered)

    return {"ttft_s": ttft_s, "ttft_phases": ttft_phases,
            "per_token_s": per_token_s, "tokens": tokens,
            "decode_phases": decode_phases, "coverage": coverage}


def aggregate(timelines, group_by=("tenant", "replica")):
    """Many timelines → per-group phase-attribution report.

    Groups by the requested meta keys (missing values group under
    ``"-"``); returns ``{group: {"count", "anomalies", "ttft_ms":
    {p50,p95,p99}, "per_token_ms": {...}, "ttft_phase_ms": {phase:
    mean}, "ttft_phase_pct": {...}, "per_token_phase_ms": {...},
    "coverage"}}``."""
    groups = {}
    for tl in timelines:
        meta = tl.get("meta") or {}
        key = "/".join(str(meta.get(k) or tl.get(k) or "-")
                       for k in group_by)
        g = groups.setdefault(key, {
            "count": 0, "anomalies": 0, "ttft": [], "per_token": [],
            "ttft_phases": _zero_phases(),
            "decode_phases": _zero_phases(), "coverage": []})
        g["count"] += 1
        if tl.get("anomalies"):
            g["anomalies"] += 1
        br = phase_breakdown(tl)
        if br["ttft_s"] is not None:
            g["ttft"].append(br["ttft_s"])
            for p in PHASES:
                g["ttft_phases"][p] += br["ttft_phases"][p]
        if br["per_token_s"] is not None:
            g["per_token"].append(br["per_token_s"])
            for p in PHASES:
                g["decode_phases"][p] += br["decode_phases"][p]
        if br["coverage"] is not None:
            g["coverage"].append(br["coverage"])

    out = {}
    for key, g in groups.items():
        n_ttft = max(1, len(g["ttft"]))
        n_tok = max(1, len(g["per_token"]))
        ttft_total = sum(g["ttft_phases"].values())
        row = {
            "count": g["count"], "anomalies": g["anomalies"],
            "ttft_ms": _quantiles_ms(g["ttft"]),
            "per_token_ms": _quantiles_ms(g["per_token"]),
            "ttft_phase_ms": {
                p: round(1e3 * g["ttft_phases"][p] / n_ttft, 3)
                for p in PHASES},
            "per_token_phase_ms": {
                p: round(1e3 * g["decode_phases"][p] / n_tok, 3)
                for p in PHASES},
            "coverage": round(sum(g["coverage"]) /
                              len(g["coverage"]), 4)
            if g["coverage"] else None,
        }
        if ttft_total > 0:
            row["ttft_phase_pct"] = {
                p: round(100.0 * g["ttft_phases"][p] / ttft_total, 1)
                for p in PHASES}
        out[key] = row
    return out


def _quantiles_ms(values):
    if not values:
        return None
    return {"p50": round(1e3 * percentile(values, 0.50), 3),
            "p95": round(1e3 * percentile(values, 0.95), 3),
            "p99": round(1e3 * percentile(values, 0.99), 3)}


def render_report(agg, group_by=("tenant", "replica")):
    """Human-readable phase-attribution table."""
    lines = []
    header = "%-24s %6s %5s %10s %10s  %s" % (
        "/".join(group_by), "count", "anom", "ttft_p99", "tok_p99",
        "ttft phase shares")
    lines.append(header)
    lines.append("-" * len(header))
    for key in sorted(agg):
        row = agg[key]
        ttft = row.get("ttft_ms") or {}
        tok = row.get("per_token_ms") or {}
        pct = row.get("ttft_phase_pct") or {}
        shares = " ".join("%s=%s%%" % (p, pct[p])
                          for p in PHASES if pct.get(p))
        lines.append("%-24s %6d %5d %10s %10s  %s" % (
            key, row["count"], row["anomalies"],
            _fmt_ms(ttft.get("p99")), _fmt_ms(tok.get("p99")),
            shares or "-"))
        if row.get("coverage") is not None:
            lines.append("%-24s %s" % (
                "", "coverage=%.1f%% of wall-clock TTFT attributed"
                % (100.0 * row["coverage"])))
    return "\n".join(lines)


def _fmt_ms(v):
    return "-" if v is None else ("%.1fms" % v)
