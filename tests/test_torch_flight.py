"""The port's flight recorder and request attribution, held against the
JAX package.

Mirrors every test of ``tests/test_flight.py`` with the port's
recorder, scheduler, server and router on ``device="cpu"``, and adds
the cross-package contract:

- the port's scheduler records the JAX scheduler's timelines: for the
  same prompts and geometry (the flagship core scheduler, the toy with
  prefix caching, chunks and speculation), each request's event kinds
  and their counts are equal, and the tokens equal
  ``generate_reference``;
- the trace wire (``payload``/``adopt``, ``inject_env``/``adopt_env``,
  ``http_headers``), an exported timeline and a session state carrying
  ``trace_id`` and ``flight`` written by either package are adopted or
  absorbed by the other;
- ``tools/merge_traces.py`` aligns the port's ``events-<pid>.jsonl``
  files, one of them with its ``trace_start`` anchor lost, and
  ``tools/request_inspect.py`` reads the port's server (both tools
  unedited).

Tolerances: tokens equal; event kinds and counts equal.
"""

import collections
import json
import os
import subprocess
import sys
import time
import urllib.parse
import urllib.request

import pytest

from veles_tpu.observability import flight as jax_flight
from veles_tpu.observability import trace as jax_trace
from veles_tpu.serving import DecodeScheduler as JaxScheduler
from veles_tpu.serving import ToyDecodeModel as JaxToy
from veles_tpu.serving.sessions import pack_states as jax_pack_states
from veles_tpu.serving.sessions import unpack_states as jax_unpack_states
from veles_tpu.znicz.samples import flagship as jf
from veles_tpu_torch.logger import events
from veles_tpu_torch.observability import attribution
from veles_tpu_torch.observability import trace as _trace
from veles_tpu_torch.observability.flight import (DIRECT_SPAN_KINDS,
                                                  RECORDER, FlightRecorder)
from veles_tpu_torch.serving import (DecodeScheduler, InferenceServer,
                                     ToyDecodeModel, pack_states,
                                     unpack_states)
from veles_tpu_torch.znicz.samples.flagship import (FlagshipDecodeModel,
                                                    generate_reference)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEO = dict(stages=2, experts=2, d=16, heads=2, hidden=32, vocab=32, seed=0)
GEOM = dict(max_batch=4, block_size=4, max_prompt_len=8,
            max_new_tokens=8)


@pytest.fixture(scope="module")
def model():
    m = FlagshipDecodeModel(**GEO, device="cpu")
    # pin per-step wall time so exports catch sessions mid-generation
    m.step_host_delay = 0.02
    return m


@pytest.fixture(scope="module")
def oracle(model):
    memo = {}

    def run(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = generate_reference(model.params, prompt, n,
                                           heads=model.heads)
        return memo[key]
    return run


def _reset(recorder):
    recorder.reset()
    recorder.configure(persist_dir="", enabled=True)
    recorder.replica = None     # configure(replica=None) keeps the id


@pytest.fixture(autouse=True)
def clean_recorders():
    """Both packages' process-global recorders are shared with every
    other serving test: each test starts and ends with pristine rings."""
    for rec in (RECORDER, jax_flight.RECORDER):
        _reset(rec)
    yield
    for rec in (RECORDER, jax_flight.RECORDER):
        _reset(rec)


def _wait_decoding(sched, sids, timeout=60):
    """Block until each of ``sids`` has a decode row (or finished), read
    in one job on the worker, so an export cuts mid-generation whatever
    the machine's load."""
    def rows():
        return ({s.req.sid for s in sched._sessions.values()},
                set(sched._finished))
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        live, done = sched._run_job(rows)
        if live and all(sid in live or sid in done for sid in sids):
            return
    raise AssertionError("sessions %s never started decoding" % sids)


# -- recorder bounds -----------------------------------------------------------

def test_ring_drops_oldest():
    rec = FlightRecorder(capacity=4)
    rec.configure(persist_dir="")
    for i in range(6):
        rec.record("t%d" % i, "queue.enter")
    ids = {tl["trace_id"] for tl in rec.snapshot(limit=64)}
    assert ids == {"t2", "t3", "t4", "t5"}
    assert rec.get("t0") is None
    assert rec.stats()["timelines"] == 4


def test_per_timeline_event_cap():
    rec = FlightRecorder(max_events=5)
    rec.configure(persist_dir="")
    for i in range(9):
        rec.record("cap", "decode.step", step=i, share_s=0.001)
    doc = rec.get("cap")
    assert len(doc["events"]) == 5
    assert doc["events_dropped"] == 4


def test_step_ordinal_dedup_single_source():
    rec = FlightRecorder()
    rec.configure(persist_dir="")
    rec.record_step_rows([("one", 3)], seconds=0.004)
    rec.record_step_rows([("one", 3)], seconds=0.004)   # replay
    rec.record("one", "decode.step", step=3, share_s=0.004)
    steps = [e for e in rec.get("one")["events"]
             if e["kind"] == "decode.step"]
    assert len(steps) == 1
    assert steps[0]["step"] == 3 and steps[0]["rows"] == 1


def test_span_bridge_never_mirrors_direct_kinds():
    """With the port's EventLog bridge installed and a live span
    context, spans with a first-class producer add no events; other
    spans land only in timelines that already exist."""
    rec = FlightRecorder()
    rec.configure(persist_dir="")
    old_sink = events.span_sink
    rec.install_span_bridge(events)
    try:
        with _trace.span_context() as ctx:
            tid = ctx.trace_id
            rec.record(tid, "queue.enter")
            for name in sorted(DIRECT_SPAN_KINDS):
                events.span(name, 0.001, model="m")
            events.span("kernel.custom_phase", 0.002)
        doc = rec.get(tid)
        kinds = [e["kind"] for e in doc["events"]]
        assert kinds == ["queue.enter", "span"]
        assert doc["events"][1]["span"] == "kernel.custom_phase"
        with _trace.span_context():
            events.span("kernel.custom_phase", 0.002)
        assert rec.stats()["timelines"] == 1
    finally:
        events.span_sink = old_sink


# -- anomaly persistence -------------------------------------------------------

def test_only_anomalous_timelines_persist(tmp_path):
    rec = FlightRecorder(persist_dir=str(tmp_path))
    rec.record("calm", "queue.enter")
    rec.finish("calm", status="ok")
    rec.record("bad", "queue.enter")
    rec.anomaly("bad", "retry")
    rec.finish("bad", status="ok")
    files = list(tmp_path.glob("flight-*.jsonl"))
    assert len(files) == 1
    recs = [json.loads(line) for line in open(files[0])]
    assert [r["trace_id"] for r in recs] == ["bad"]
    assert recs[0]["anomalies"] == ["retry"]
    rec.record("late", "queue.enter")
    rec.finish("late", status="ok")
    rec.anomaly("late", "recovery_replay")
    recs = [json.loads(line) for line in open(files[0])]
    assert {r["trace_id"] for r in recs} == {"bad", "late"}


def test_rolling_p99_triggers_persistence(tmp_path):
    rec = FlightRecorder(persist_dir=str(tmp_path), min_samples=8)
    for i in range(20):
        tid = "calm%d" % i
        rec.record(tid, "queue.enter")
        rec.finish(tid, status="ok", ttft_s=0.010, per_token_s=0.001)
    rec.record("tail", "queue.enter")
    rec.finish("tail", status="ok", ttft_s=0.500, per_token_s=0.001)
    doc = rec.get("tail")
    assert "ttft_p99" in doc["anomalies"]
    files = list(tmp_path.glob("flight-*.jsonl"))
    assert files, "tail latency above rolling p99 did not persist"
    recs = [json.loads(line) for line in open(files[0])]
    assert any(r["trace_id"] == "tail" for r in recs)


# -- migration travel: one trace id across replicas ---------------------------

def test_absorb_dedups_shared_events():
    rec = FlightRecorder()
    rec.configure(persist_dir="", replica="src")
    rec.record("mig", "queue.enter", model="m")
    rec.record("mig", "prefill.chunk", seconds=0.01)
    exported = rec.export("mig")
    assert exported["replica"] == "src"
    before = len(rec.get("mig")["events"])
    rec.absorb(exported)
    assert len(rec.get("mig")["events"]) == before
    dst = FlightRecorder()
    dst.configure(persist_dir="", replica="dst")
    dst.absorb(exported)
    doc = dst.get("mig")
    assert [e["kind"] for e in doc["events"]] == ["queue.enter",
                                                  "prefill.chunk"]
    assert all(e["replica"] == "src" for e in doc["events"])


def test_migrated_generation_keeps_one_trace_id(model, oracle):
    """A session exported mid-generation and imported on a peer
    scheduler finishes under the same trace id, and the one timeline
    holds enter / admit / export on the source, import and the rest of
    the steps on the destination."""
    a = DecodeScheduler(model, name="fla", device="cpu", **GEOM)
    b = DecodeScheduler(model, name="flb", device="cpu", **GEOM)
    try:
        prompt, n = [3, 1, 4, 1, 5], 8
        with _trace.span_context() as ctx:
            tid = ctx.trace_id
            fut = a.submit(prompt, n, session_id="mig0")
        _wait_decoding(a, ["mig0"])
        states = a.export_sessions(["mig0"])
        assert states, "export caught no live session"
        assert states[0].get("trace_id") == tid
        assert states[0].get("flight", {}).get("trace_id") == tid
        done, errors = b.import_sessions(
            unpack_states(pack_states(states)))
        assert errors == [] and done == ["mig0"]
        a.release_migrated(done, target="127.0.0.1:1")
        marker = fut.result(30)
        assert marker["migrated"]
        kind, val = b.attach("mig0")
        result = val if kind == "finished" else val.result(60)
        assert result["tokens"] == oracle(prompt, n)
        doc = RECORDER.get(tid)
        kinds = [e["kind"] for e in doc["events"]]
        for expected in ("queue.enter", "queue.admit", "first_token",
                         "migrate.export", "migrate.import", "retire"):
            assert expected in kinds, (expected, kinds)
        assert kinds.index("migrate.export") < \
            kinds.index("migrate.import")
        assert "migration" in doc["anomalies"]
        assert doc["status"] == "ok"
        assert len(RECORDER.snapshot(trace_id=tid)) == 1
        br = attribution.phase_breakdown(doc)
        assert br["ttft_s"] is not None and br["tokens"] == n
    finally:
        a.close(drain=True)
        b.close(drain=True)


# -- live scheduler + HTTP ring ------------------------------------------------

def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, json.dumps(payload).encode(),
        dict({"Content-Type": "application/json"}, **(headers or {})))
    return urllib.request.urlopen(req, timeout=30)


def test_scheduler_timeline_and_http_requests_route(model, oracle):
    """The client's X-Trace-Id keys the timeline, ``GET
    /api/<model>/requests`` serves it back, and attribution covers the
    bulk of the measured TTFT."""
    srv = InferenceServer({"flag": model}, device="cpu", **GEOM)
    tid = "cafe1234feedbeef"
    try:
        body = json.loads(_post(
            "%s/api/flag/generate" % srv.url,
            {"prompt": [1, 2, 3], "max_new_tokens": 4},
            {"X-Trace-Id": tid}).read())
        assert body["tokens"] == oracle([1, 2, 3], 4)
        doc = json.loads(urllib.request.urlopen(
            "%s/api/flag/requests?id=%s" % (srv.url, tid),
            timeout=10).read())
        assert "flight" in doc
        tls = doc["requests"]
        assert [tl["trace_id"] for tl in tls] == [tid]
        kinds = [e["kind"] for e in tls[0]["events"]]
        for expected in ("request.recv", "queue.enter", "queue.admit",
                         "first_token", "decode.step", "retire",
                         "request.done"):
            assert expected in kinds, (expected, kinds)
        assert tls[0]["meta"]["model"] == "flag"
        assert tls[0]["status"] == "ok"
        br = attribution.phase_breakdown(tls[0])
        assert br["ttft_s"] is not None
        assert br["coverage"] is not None and br["coverage"] > 0.5
        doc = json.loads(urllib.request.urlopen(
            "%s/api/flag/requests" % srv.url, timeout=10).read())
        assert tid in {tl["trace_id"] for tl in doc["requests"]}
        # the JAX package's request_inspect tool reads the port's ring
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools",
                                          "request_inspect.py"),
             srv.url, "--model", "flag", "--id", tid, "--json"],
            capture_output=True, text=True, timeout=120, check=True)
        stitched = json.loads(out.stdout)["requests"][tid]
        assert [e["kind"] for e in stitched["events"]] == kinds
        assert stitched["status"] == "ok"
    finally:
        srv.stop()


def test_fleet_requests_route_merges_router_and_replica(model, oracle):
    """``GET /fleet/requests`` groups the router's dispatch timeline
    with the replica's serving timeline under one trace id."""
    from tools.request_inspect import stitch
    from veles_tpu_torch.fleet.router import FleetRouter
    srv = InferenceServer({"flag": model}, device="cpu", **GEOM)
    router = FleetRouter(port=0, poll_interval=0.05)
    try:
        router.add_replica("r0", "127.0.0.1", srv.port)
        deadline = time.time() + 10
        while router.ready_count() < 1 and time.time() < deadline:
            time.sleep(0.02)
        assert router.ready_count() == 1
        resp = _post("%s/api/flag/generate" % router.url,
                     {"prompt": [2, 7], "max_new_tokens": 3})
        tid = resp.headers.get("X-Trace-Id")
        assert json.loads(resp.read())["tokens"] == oracle([2, 7], 3)
        assert tid
        doc = json.loads(urllib.request.urlopen(
            "%s/fleet/requests?id=%s" % (router.url,
                                         urllib.parse.quote(tid)),
            timeout=10).read())
        frags = doc["requests"][tid]
        sources = {tl.get("replica") for tl in frags}
        assert "router" in sources and "r0" in sources
        assert "router" in doc["flight"] and "r0" in doc["flight"]
        merged = stitch(frags)
        kinds = [e["kind"] for e in merged["events"]]
        assert "router.dispatch" in kinds
        assert "first_token" in kinds
        assert merged["replicas"] == ["r0", "router"]
        assert merged["status"] == "ok"
    finally:
        router.stop()
        srv.stop()


# -- attribution math ----------------------------------------------------------

def test_phase_breakdown_synthetic_sums():
    t0 = 1000.0
    tl = {"trace_id": "x", "started_unix": t0,
          "finished_unix": t0 + 1.0, "status": "ok",
          "events": [
              {"t": t0, "kind": "queue.enter"},
              {"t": t0 + 0.2, "kind": "queue.admit"},
              {"t": t0 + 0.5, "kind": "prefill.chunk", "seconds": 0.1},
              {"t": t0 + 0.6, "kind": "first_token", "ttft_s": 0.6},
              {"t": t0 + 0.7, "kind": "decode.step", "step": 1,
               "share_s": 0.05, "rows": 2},
              {"t": t0 + 0.9, "kind": "tier.hit", "seconds": 0.02},
              {"t": t0 + 1.0, "kind": "retire", "tokens": 5},
          ]}
    br = attribution.phase_breakdown(tl)
    assert br["ttft_s"] == pytest.approx(0.6)
    ph = br["ttft_phases"]
    assert ph["queue"] == pytest.approx(0.4)
    assert ph["prefill"] == pytest.approx(0.1)
    assert ph["other"] == pytest.approx(0.1)
    assert br["coverage"] == pytest.approx(0.5 / 0.6)
    assert br["per_token_s"] == pytest.approx(0.4 / 4)
    dp = br["decode_phases"]
    assert dp["decode"] == pytest.approx(0.05)
    assert dp["tier"] == pytest.approx(0.02)
    assert dp["other"] == pytest.approx(0.33)
    assert sum(ph.values()) == pytest.approx(br["ttft_s"])
    assert sum(dp.values()) == pytest.approx(0.4)
    # the JAX package's attribution gives the same breakdown
    from veles_tpu.observability import attribution as jax_attribution
    assert jax_attribution.phase_breakdown(tl) == br


def test_aggregate_groups_and_renders():
    def mk(tid, replica, ttft):
        t0 = 100.0
        return {"trace_id": tid, "started_unix": t0, "replica": replica,
                "finished_unix": t0 + ttft + 0.1, "status": "ok",
                "events": [
                    {"t": t0, "kind": "queue.enter"},
                    {"t": t0 + ttft * 0.5, "kind": "queue.admit"},
                    {"t": t0 + ttft, "kind": "prefill.chunk",
                     "seconds": ttft * 0.5},
                    {"t": t0 + ttft, "kind": "first_token",
                     "ttft_s": ttft},
                    {"t": t0 + ttft + 0.1, "kind": "retire",
                     "tokens": 2},
                ]}
    tls = [mk("a", "r0", 0.2), mk("b", "r0", 0.4), mk("c", "r1", 1.0)]
    agg = attribution.aggregate(tls, group_by=("replica",))
    assert set(agg) == {"r0", "r1"}
    assert agg["r0"]["count"] == 2 and agg["r1"]["count"] == 1
    assert agg["r1"]["ttft_ms"]["p99"] == pytest.approx(1000.0)
    pct = agg["r1"]["ttft_phase_pct"]
    assert pct["queue"] == pytest.approx(50.0)
    assert pct["prefill"] == pytest.approx(50.0)
    assert agg["r1"]["coverage"] == pytest.approx(1.0)
    report = attribution.render_report(agg, group_by=("replica",))
    assert "r0" in report and "r1" in report and "coverage" in report
    from veles_tpu.observability import attribution as jax_attribution
    assert jax_attribution.render_report(
        jax_attribution.aggregate(tls, group_by=("replica",)),
        group_by=("replica",)) == report


# -- merge_traces over the port's EventLog files ------------------------------

_WRITER = """
import os, sys, time
sys.path.insert(0, %r)
from veles_tpu_torch.logger import events
events.span("job.run", 0.00001)
time.sleep(0.00004)
events.span("decode.step", 0.000005)
events.close()
print(events.path)
"""


def test_merge_traces_anchorless_stream_aligns(tmp_path, capsys):
    """Two processes trace through the port's EventLog; the second
    one's ``trace_start`` line is lost, as when a SIGKILL lands before
    the header flushes.  The merge keeps the anchored stream on the
    wall clock and rebases the torn one's first event to t=0 with a
    warning."""
    from tools.merge_traces import merge
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WRITER % ROOT], stdout=subprocess.PIPE,
        text=True, env=dict(os.environ,
                            VELES_TRACE_DIR=str(tmp_path / name)))
        for name in ("ok", "torn")]
    try:
        paths = [p.communicate(timeout=60)[0].strip() for p in procs]
    finally:
        for p in procs:
            p.kill()
    ok, torn = paths
    assert os.path.basename(ok).startswith("events-")
    recs = [json.loads(line) for line in open(ok)]
    assert recs[0]["name"] == "trace_start"
    assert [r["name"] for r in recs[1:]] == ["job.run", "decode.step"]
    lines = open(torn).read().splitlines()
    assert json.loads(lines[0])["name"] == "trace_start"
    with open(torn, "w") as f:
        f.write("\n".join(lines[1:]) + "\n")
    doc = merge([ok, torn])
    assert "no trace_start anchor" in capsys.readouterr().err
    by_pid = {}
    for rec in doc["traceEvents"]:
        by_pid.setdefault(rec["pid"], []).append(rec)
    assert len(by_pid) == 2
    torn_pid = json.loads(lines[1])["pid"]
    torn_ts = sorted(r["ts"] for r in by_pid[torn_pid])
    assert torn_ts[0] == pytest.approx(0.0)
    raw = sorted(json.loads(line)["ts"] for line in lines[1:])
    assert torn_ts[1] == pytest.approx(raw[1] - raw[0], abs=0.2)
    ok_recs = [json.loads(line) for line in open(ok)]
    ok_pid = ok_recs[0]["pid"]
    # the only anchored stream is the origin: its records keep their ts
    assert sorted(r["ts"] for r in by_pid[ok_pid]) == \
        pytest.approx(sorted(r["ts"] for r in ok_recs))
    capsys.readouterr()
    doc = merge([torn])
    assert not capsys.readouterr().err
    assert min(r["ts"] for r in doc["traceEvents"]) == \
        pytest.approx(raw[0])


# -- against the JAX scheduler -------------------------------------------------

def _kinds(recorder, tid):
    return collections.Counter(e["kind"]
                               for e in recorder.get(tid)["events"])


def _timelines(sched, tracer, recorder, prompts, n):
    """Submit ``prompts`` one after another, each in its own trace
    context; -> (tokens, per-request Counter of event kinds)."""
    tokens, kinds = [], []
    for prompt in prompts:
        with tracer.span_context() as ctx:
            fut = sched.submit(prompt, n)
        tokens.append(fut.result(120)["tokens"])
        kinds.append(_kinds(recorder, ctx.trace_id))
    return tokens, kinds


TOY_OPTIONS = dict(max_batch=3, block_size=4, max_prompt_len=16,
                   max_new_tokens=8, prefix_caching=True,
                   prefill_chunk_tokens=4, spec_depth=2)


@pytest.mark.parametrize("kind", ["flagship-core", "toy-options"])
def test_timelines_match_jax_scheduler(kind):
    """The same prompts through both packages' schedulers give each
    request the same event kinds, as many of each, and the oracle's
    tokens."""
    if kind == "flagship-core":
        port_model = FlagshipDecodeModel(**GEO, device="cpu")
        jax_model = jf.FlagshipDecodeModel(**GEO)
        geom = GEOM
        prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9]]

        def want(p, n):
            return generate_reference(port_model.params, p, n,
                                      heads=port_model.heads)
    else:
        port_model = ToyDecodeModel(vocab=31, device="cpu")
        jax_model = JaxToy(vocab=31)
        geom = TOY_OPTIONS
        shared = [3, 1, 4, 1, 5, 9, 2, 6, 5]
        prompts = [shared + [3, 5], shared + [8], [7, 7, 2],
                   shared + [3, 5] + [1, 2, 3]]

        def want(p, n):
            return port_model.generate_reference(p, n)
    port = DecodeScheduler(port_model, name="tl", device="cpu", **geom)
    jax_s = JaxScheduler(jax_model, name="tl", cache=False, **geom)
    try:
        got_port, kinds_port = _timelines(port, _trace, RECORDER,
                                          prompts, 6)
        got_jax, kinds_jax = _timelines(jax_s, jax_trace,
                                        jax_flight.RECORDER, prompts, 6)
    finally:
        port.close(drain=True)
        jax_s.close(drain=True)
    assert got_port == got_jax == [want(p, 6) for p in prompts]
    assert kinds_port == kinds_jax
    for counts in kinds_port:
        assert counts["queue.enter"] == counts["queue.admit"] == 1
        assert counts["first_token"] == counts["retire"] == 1
        assert counts["prefill.chunk"] >= 1
    if kind == "toy-options":
        assert sum(c["spec.step"] for c in kinds_port) > 0
        assert sum(c["tier.hit"] for c in kinds_port) > 0
    else:
        assert all(c["decode.step"] == 5 for c in kinds_port)


def test_trace_wire_crosses_packages(monkeypatch):
    """A payload, an environment and HTTP headers written by either
    package's trace module are adopted by the other's."""
    for src, dst in ((jax_trace, _trace), (_trace, jax_trace)):
        with src.span_context() as ctx:
            wire = src.payload()
            headers = src.http_headers()
            env = src.inject_env({})
        assert headers == {"X-Trace-Id": ctx.trace_id}
        with dst.adopt(json.loads(json.dumps(wire))) as adopted:
            assert adopted.trace_id == ctx.trace_id
            assert adopted.parent_id == ctx.span_id
            assert dst.current() is adopted
        with dst.span_context(trace_id=headers["X-Trace-Id"]) as inner:
            assert inner.trace_id == ctx.trace_id
        try:
            got = dst.adopt_env(env)
            assert got.trace_id == ctx.trace_id
            assert got.parent_id == ctx.span_id
            assert dst.current() is got
        finally:
            dst.set_ambient(None)
        assert dst.current() is None


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_timeline_export_absorbs_across_packages(direction):
    """An exported timeline (the ``flight`` entry of the session wire)
    written by either package's recorder is absorbed by the other's,
    its events tagged with their origin."""
    src, dst = ((jax_flight.RECORDER, RECORDER)
                if direction == "jax-to-port"
                else (RECORDER, jax_flight.RECORDER))
    src.configure(replica="src")
    src.record("x1", "queue.enter", model="m", prompt_tokens=3)
    src.record_step_rows([("x1", 2)], 0.004)
    src.record("x1", "prefill.chunk", seconds=0.01, start=0, end=3)
    src.anomaly("x1", "migration")
    exported = json.loads(json.dumps(src.export("x1")))
    dst.absorb(exported)
    dst.record("x1", "migrate.import", session="s")
    doc = dst.get("x1")
    kinds = [e["kind"] for e in doc["events"]]
    assert kinds[:4] == [e["kind"] for e in exported["events"]]
    assert kinds[-1] == "migrate.import"
    assert all(e["replica"] == "src" for e in doc["events"][:4])
    step = [e for e in doc["events"] if e["kind"] == "decode.step"][0]
    assert (step["step"], step["rows"]) == (2, 1)
    assert doc["anomalies"] == ["migration"]


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_session_flight_crosses_packages(direction):
    """A session exported mid-generation by one package's scheduler
    carries its trace id and timeline; the other package imports it,
    absorbs the timeline and finishes the generation in it."""
    port_model = ToyDecodeModel(vocab=31, device="cpu")
    jax_model = JaxToy(vocab=31)
    port_model.step_host_delay = jax_model.step_host_delay = 0.03
    port = DecodeScheduler(port_model, name="xport", device="cpu", **GEOM)
    jax_s = JaxScheduler(jax_model, name="xjax", cache=False, **GEOM)
    if direction == "jax-to-port":
        src, dst, tracer = jax_s, port, jax_trace
        src_rec, dst_rec = jax_flight.RECORDER, RECORDER
        wire = (jax_pack_states, unpack_states)
    else:
        src, dst, tracer = port, jax_s, _trace
        src_rec, dst_rec = RECORDER, jax_flight.RECORDER
        wire = (pack_states, jax_unpack_states)
    prompt = [3, 1, 4, 1, 5, 9, 2]
    try:
        with tracer.span_context() as ctx:
            fut = src.submit(prompt, 8, session_id="x0")
        _wait_decoding(src, ["x0"])
        states = src.export_sessions(["x0"])
        assert states[0]["trace_id"] == ctx.trace_id
        assert states[0]["flight"]["trace_id"] == ctx.trace_id
        moved = wire[1](json.loads(json.dumps(wire[0](states))))
        done, errors = dst.import_sessions(moved)
        assert errors == [] and done == ["x0"]
        src.release_migrated(done, target="peer")
        assert fut.result(60)["migrated"]
        kind, val = dst.attach("x0")
        result = val if kind == "finished" else val.result(60)
        assert result["tokens"] == port_model.generate_reference(prompt, 8)
    finally:
        port.close(drain=True)
        jax_s.close(drain=True)
    doc = dst_rec.get(ctx.trace_id)
    kinds = [e["kind"] for e in doc["events"]]
    for expected in ("queue.enter", "queue.admit", "first_token",
                     "migrate.export", "migrate.import", "retire"):
        assert expected in kinds, (expected, kinds)
    assert kinds.index("migrate.export") < kinds.index("migrate.import")
    assert doc["status"] == "ok" and "migration" in doc["anomalies"]
    assert src_rec.get(ctx.trace_id)["anomalies"] == ["migration"]
