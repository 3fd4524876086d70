"""Measurement runner: fresh subprocesses, hard caps.

The port's counterpart of ``veles_tpu/autotune/runner.py``.  Every
candidate is measured by :mod:`veles_tpu_torch.autotune.probe` in a
FRESH subprocess: a launch that faults (a CUDA error poisons the whole
context), an out-of-memory, or a hang kills one probe, never the tuning
run.  A CUDA kernel's candidates are launch arguments of one built
library, not separate compiles, so :func:`tune_site` can also measure
all of a site's candidates in ONE isolated process (``batch=True``):
one process start and one CUDA context instead of one per candidate,
and a probe that dies loses that site's tuning only (the default
stays).

Isolation is a full PROCESS GROUP: children start in their own session
(``start_new_session=True``) and a timeout kills the whole group with
SIGKILL — a hung Pallas compile, a SIGSTOP'd child, or a grandchild the
probe spawned can never leak past the runner's hard cap.

Ranking is drift-robust: every probe measures its candidate AND the
site's hand-picked default config in the same process with interleaved
min-of-windows timing, and candidates are ranked by that in-process
ratio — machine-load drift between probes cancels instead of picking
the winner.  A candidate whose correctness gate fails is discarded no
matter how fast it ran: a fast-but-wrong config can never win.
"""

import json
import os
import signal
import subprocess
import sys
import time

from ..logger import events
from ..observability.registry import REGISTRY
from . import space as _space
from .dispatch import default_store

_c_tunes = REGISTRY.counter(
    "veles_autotune_tunes_total", "Completed tune_site runs")
_c_candidates = REGISTRY.counter(
    "veles_autotune_candidates_total", "Candidate measurements launched")
_c_gate_failures = REGISTRY.counter(
    "veles_autotune_gate_failures_total",
    "Candidates discarded because their correctness gate failed")
_c_timeouts = REGISTRY.counter(
    "veles_autotune_timeouts_total",
    "Candidate probes killed at the wall-clock cap (whole process "
    "group)")


def run_isolated(argv, timeout, env=None, cwd=None):
    """Run ``argv`` in its own process group under a hard wall-clock
    cap.  On timeout the WHOLE group gets SIGKILL — a stopped child or
    a spawned grandchild dies with it.  Returns
    ``(returncode, stdout, stderr, timed_out)`` (text, never raises
    for timeouts)."""
    proc = subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=env, cwd=cwd, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
        return proc.returncode, out.decode(errors="replace"), \
            err.decode(errors="replace"), False
    except subprocess.TimeoutExpired:
        _kill_group(proc)
        out, err = proc.communicate()
        return proc.returncode, out.decode(errors="replace"), \
            err.decode(errors="replace"), True


def _kill_group(proc):
    """SIGKILL the child's whole process group (it is its own session
    leader), then the child directly as a belt-and-braces fallback."""
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except (OSError, ProcessLookupError):
        pass
    try:
        proc.kill()
    except OSError:
        pass


def _last_json_line(text):
    for raw in reversed(text.strip().splitlines()):
        raw = raw.strip()
        if not raw.startswith("{"):
            continue
        try:
            return json.loads(raw)
        except ValueError:
            continue
    return None


def measure_candidate(site, config, ctx=None, *, timeout=120.0,
                      env=None):
    """One candidate in one fresh isolated subprocess -> the probe's
    JSON dict, or ``{"ok": False, "error": ...}``."""
    argv = [sys.executable, "-m", "veles_tpu_torch.autotune.probe",
            "--site", site, "--config", json.dumps(config)]
    if ctx:
        argv += ["--ctx", json.dumps(ctx)]
    rc, out, err, timed_out = run_isolated(argv, timeout,
                                           env=_probe_env(env))
    if timed_out:
        _c_timeouts.inc()
        return {"ok": False, "config": config,
                "error": "timeout after %.0fs (process group killed)"
                         % timeout}
    line = _last_json_line(out)
    if line is None:
        return {"ok": False, "config": config,
                "error": "probe exit %d, no JSON: %s"
                         % (rc, err.strip()[-300:])}
    return line


def _probe_env(env):
    env = dict(os.environ if env is None else env)
    # the probe imports veles_tpu_torch relative to the repo
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def measure_site(site, configs, ctx=None, *, timeout=300.0, env=None):
    """Every config of ``configs`` in ONE fresh isolated subprocess ->
    ``{json(config): probe dict}``; a probe that times out or dies
    marks every config ``{"ok": False, "error": ...}``."""
    argv = [sys.executable, "-m", "veles_tpu_torch.autotune.probe",
            "--site", site, "--configs", json.dumps(list(configs))]
    if ctx:
        argv += ["--ctx", json.dumps(ctx)]
    rc, out, err, timed_out = run_isolated(argv, timeout,
                                           env=_probe_env(env))
    line = None if timed_out else _last_json_line(out)
    if timed_out:
        _c_timeouts.inc()
        error = "timeout after %.0fs (process group killed)" % timeout
    elif line is None or "results" not in line:
        error = "probe exit %d, no JSON: %s" % (rc, err.strip()[-300:])
    else:
        return {json.dumps(r.get("config"), sort_keys=True): r
                for r in line["results"]}
    return {json.dumps(c, sort_keys=True):
            {"ok": False, "config": c, "error": error} for c in configs}


def tune_site(site, ctx=None, *, store=None, timeout=120.0, env=None,
              measure=None, log_fn=None, batch=False):
    """Measure every candidate of ``site`` for ``ctx``, persist the
    gated winner, and return the stored record (None when nothing
    measured successfully — dispatch then keeps the default).

    ``measure(site, config, ctx)`` is injectable for tests; the real
    one is a fresh-subprocess probe per candidate, or with ``batch``
    one subprocess for them all (``timeout`` then caps that process).
    The default measured first is the site's at ``ctx``.
    """
    sp = _space.site(site)
    ctx = dict(ctx or {})
    shape_class = sp.shape_class(ctx)
    candidates = sp.candidates(ctx)
    default = candidates[0]
    say = log_fn or (lambda msg: None)
    if measure is None and batch:
        batched = measure_site(site, candidates, ctx, timeout=timeout,
                               env=env)
        measure = lambda s, c, x: batched[  # noqa: E731
            json.dumps(c, sort_keys=True)]
    elif measure is None:
        measure = lambda s, c, x: measure_candidate(  # noqa: E731
            s, c, x, timeout=timeout, env=env)
    t_start = time.perf_counter()
    results = []
    for config in candidates:
        _c_candidates.inc()
        t0 = time.perf_counter()
        res = measure(site, config, ctx)
        dt = time.perf_counter() - t0
        res = dict(res or {})
        res.setdefault("config", config)
        ok = bool(res.get("ok"))
        gate = res.get("gate", "unmeasured")
        if ok and gate != "passed":
            _c_gate_failures.inc()
        events.span("autotune.candidate", dt, site=site,
                    shape_class=shape_class, config=json.dumps(config),
                    ok=ok, gate=gate)
        say("%s %s: %s%s" % (
            site, json.dumps(config, sort_keys=True),
            "score %.3f" % res["score"]
            if ok and gate == "passed" and "score" in res
            else res.get("error", gate),
            " (gate %s)" % gate if ok and gate != "passed" else ""))
        results.append(res)
    # only gated, successfully measured candidates can win
    viable = [r for r in results
              if r.get("ok") and r.get("gate") == "passed"
              and "score" in r]
    total_dt = time.perf_counter() - t_start
    if not viable:
        events.span("autotune.tune", total_dt, site=site,
                    shape_class=shape_class,
                    candidates=len(candidates), winner="none")
        say("%s: no viable candidate (of %d) — keeping the default"
            % (site, len(candidates)))
        return None
    # score = candidate seconds / reference seconds, both measured
    # interleaved in the SAME process — lower is better.  The reference
    # workload is the site's default config, so cross-probe machine
    # drift divides out and scores compare across subprocesses.
    winner = min(viable, key=lambda r: r["score"])
    # speedup vs HAND-PICKED = default candidate's score / winner's
    # (each normalized by its own in-process reference).  candidates[0]
    # is always the declared default; if its probe failed, fall back to
    # 1/score, exact whenever the reference IS the default config.
    default_score = next(
        (r["score"] for r in viable if r["config"] == candidates[0]),
        None)
    if default_score is not None and winner["score"] > 0:
        speedup = default_score / winner["score"]
    else:
        speedup = 1.0 / winner["score"] if winner["score"] > 0 else 0.0
    if store is None:
        store = default_store()
    record = None
    if store is not None:
        record = store.put(
            site, shape_class, winner["config"], default=default,
            speedup=speedup, gate="passed",
            baseline_s=winner.get("ref_s"),
            best_s=winner.get("cand_s"),
            candidates_tried=len(results),
            extra={"viable": len(viable),
                   "gate_failures": sum(
                       1 for r in results
                       if r.get("ok") and r.get("gate") != "passed")})
    _c_tunes.inc()
    events.span("autotune.tune", total_dt, site=site,
                shape_class=shape_class, candidates=len(candidates),
                winner=json.dumps(winner["config"], sort_keys=True),
                speedup=round(speedup, 3))
    say("%s/%s: winner %s, %.2fx vs hand-picked (%d/%d candidates "
        "viable)" % (site, shape_class,
                     json.dumps(winner["config"], sort_keys=True),
                     speedup, len(viable), len(results)))
    return record
