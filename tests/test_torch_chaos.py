"""Deterministic fault injection and the failover guarantees of the
port's fleet.

Mirrors ``tests/test_chaos.py`` with replicas spawned as ``python -m
veles_tpu_torch.fleet.replica --device cpu`` subprocesses, the fault
plans the JAX package's (the same ``VELES_FAULT_PLAN`` wire):

- a FaultPlan is reproducible (same seed, same request sequence, same
  faults at the same ordinals) and fires only on data-plane paths;
- exactly-once through truncation: a buffered response cut mid-body
  retries once on the peer; a streamed one aborts the client
  connection, never answers twice;
- the circuit breaker walks closed -> open -> half-open -> closed, and
  trips on a replica whose data plane refuses while its health answers;
- a hung (SIGSTOP) replica is marked down, its in-flight requests fail
  over, and SIGCONT re-admits it through the half-open probe;
- a seeded drill (SIGKILL, black-hole, truncation) over an open loop
  carrying deadlines answers every request 200, 429/503 or 504, never a
  raw failure; the same over int8 toy replicas, every 200 bitwise the
  oracle's tokens;
- ``X-Deadline-Ms`` flows router -> replica -> scheduler (504 without a
  batch row); a disk KV tier survives a SIGKILL and re-advertises.

Outcomes are held by counters, never by a wall-clock bound; each fleet
runs under its own time limit (a watchdog kills its replicas) and stops
in a ``finally``.
"""

import http.client
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import pytest

from veles_tpu_torch.fleet import FaultPlan, Fleet
from veles_tpu_torch.fleet.chaos import _TruncatingFile

from test_torch_fleet import BACKOFF, running

# -- FaultPlan unit -----------------------------------------------------------

class _FakeHandler:
    def __init__(self, path):
        self.path = path
        self.close_connection = False


def _fired(plan, paths):
    """Drive a plan over a request sequence; yields, per request,
    (connection_was_refused, handler_actually_ran)."""
    out = []
    for path in paths:
        handler = _FakeHandler(path)
        hit = []
        plan.apply(handler, lambda h, _hit=hit: _hit.append("ran"))
        out.append((handler.close_connection, hit == ["ran"]))
    return out


def test_fault_plan_ordinals_and_exemptions():
    plan = FaultPlan([{"at": 2, "action": "refuse"},
                      {"after": 4, "action": "refuse"}])
    paths = ["/api/m", "/healthz", "/api/m", "/metrics", "/api/m",
             "/admin/sessions/export", "/api/m", "/api/m"]
    results = _fired(plan, paths)
    # control-plane requests neither count against ordinals nor fault;
    # data ordinals here are 1,2,3,4,5 at indices 0,2,4,6,7
    refused = [i for i, (closed, _) in enumerate(results) if closed]
    assert refused == [2, 6, 7]
    assert all(ran for i, (_, ran) in enumerate(results)
               if i not in refused)
    assert all(not ran for i, (_, ran) in enumerate(results)
               if i in refused)
    assert plan.fired == [(2, "refuse"), (4, "refuse"), (5, "refuse")]


def test_fault_plan_seed_reproducible():
    rules = [{"probability": 0.5, "action": "refuse"}]
    runs = []
    for _ in range(2):
        plan = FaultPlan(rules, seed=42)
        runs.append([closed for closed, _ in
                     _fired(plan, ["/api/m"] * 32)])
    assert runs[0] == runs[1]
    assert any(runs[0]) and not all(runs[0])
    different = [closed for closed, _ in
                 _fired(FaultPlan(rules, seed=43), ["/api/m"] * 32)]
    assert different != runs[0]


def test_fault_plan_env_roundtrip():
    plan = FaultPlan([{"at": 3, "action": "truncate", "bytes": 16}],
                     seed=9)
    env = plan.env({})
    clone = FaultPlan.from_json(env["VELES_FAULT_PLAN"])
    assert clone.seed == 9 and clone.rules == plan.rules


def test_fault_plan_rejects_unknown_action():
    with pytest.raises(ValueError):
        FaultPlan([{"at": 1, "action": "meteor"}])


def test_fault_plan_path_prefix_narrows_rule():
    """A path_prefix rule fires only on matching routes, and a
    narrowed rule never shifts the global data-request ordinals the
    other rules count against."""
    plan = FaultPlan([
        {"at": 2, "action": "refuse", "path_prefix": "/api/toy"},
        {"at": 4, "action": "refuse"},
    ])
    paths = ["/api/toy/generate", "/api/other",   # ordinals 1, 2
             "/api/toy/generate",                 # 3
             "/api/other"]                        # 4
    results = _fired(plan, paths)
    refused = [i for i, (closed, _) in enumerate(results) if closed]
    # ordinal 2 lands on /api/other — the narrowed rule stays quiet;
    # the unnarrowed at=4 rule still fires on the 4th data request
    assert refused == [3]
    assert plan.fired == [(4, "refuse")]


class _Sink:
    def __init__(self):
        self.data = b""

    def write(self, b):
        self.data += b
        return len(b)

    def flush(self):
        pass


def test_truncating_file_cuts_body_not_headers():
    sink = _Sink()
    f = _TruncatingFile(sink, 4)
    f.write(b"HTTP/1.1 200 OK\r\nContent-Length: 10\r\n\r\n")
    f.write(b"0123456789")
    assert sink.data.endswith(b"\r\n\r\n0123")
    assert f.truncated
    assert b"Content-Length: 10" in sink.data   # headers intact



# -- fleet helpers ------------------------------------------------------------

def _post(url, payload, headers=None, timeout=60):
    req = urllib.request.Request(
        url, json.dumps(payload).encode(),
        {"Content-Type": "application/json", **(headers or {})})
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
        return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _sleep_fleet(replicas=2, fault_plans=None, request_timeout=5,
                 row_sleep="0.005", dim=4):
    return Fleet({"m": "sleep:%s:%d" % (row_sleep, dim)},
                 replicas=replicas, poll_interval=0.1, device="cpu",
                 request_timeout=request_timeout,
                 fault_plans=fault_plans, backoff=BACKOFF)


def _rep_counters(router, rid):
    """One replica's router-side counters (the registry is process-
    global, so tests assert on deltas)."""
    met = router.merged_metrics()["router"]["replicas"][rid]
    return {k: met[k] for k in
            ("truncated", "aborted", "retries", "breaker_trips")}


def _delta(router, rid, before):
    now = _rep_counters(router, rid)
    return {k: now[k] - before[k] for k in before}


def _wait(predicate, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError("timed out waiting for " + what)


def _retrying_post(url, payload, headers=None, tries=20):
    """A well-behaved client: retries 503 (no replica to take it)."""
    status, body = -1, {}
    for _ in range(tries):
        try:
            status, body, _ = _post(url, payload, headers=headers,
                                    timeout=30)
        except Exception as e:  # noqa: BLE001 — a raw failure
            status, body = -1, {"error": repr(e)}
        if status != 503:
            break
        time.sleep(0.1)
    return status, body


# -- exactly-once through truncation ------------------------------------------

def test_truncated_buffered_response_retries_exactly_once():
    fleet = _sleep_fleet(fault_plans={
        "r0": {"rules": [{"at": 1, "action": "truncate", "bytes": 8}]}})
    with running(fleet):
        _wait(lambda: fleet.router.ready_count() == 2, 60, "both ready")
        before = _rep_counters(fleet.router, "r0")
        statuses = [
            _post(fleet.url + "/api/m", {"input": [[1, 2, 3, 4]]})[0]
            for _ in range(6)]
        assert statuses == [200] * 6, statuses
        moved = _delta(fleet.router, "r0", before)
        assert moved["truncated"] == 1, moved
        assert moved["retries"] == 1, moved
        assert moved["aborted"] == 0, moved


def test_truncated_streamed_response_aborts_not_doublesends():
    fleet = _sleep_fleet(
        fault_plans={"r0": {"rules": [{"after": 1, "action": "truncate",
                                       "bytes": 1000}]}},
        row_sleep="0.0001", dim=2048)
    with running(fleet):
        _wait(lambda: fleet.router.ready_count() == 2, 60, "both ready")
        fleet.router.set_admitting("r1", False)
        before = _rep_counters(fleet.router, "r0")
        payload = {"input": [[1.0] * 2048] * 16}
        with pytest.raises((urllib.error.URLError, OSError,
                            http.client.HTTPException,
                            json.JSONDecodeError)):
            req = urllib.request.Request(
                fleet.url + "/api/m", json.dumps(payload).encode(),
                {"Content-Type": "application/json"})
            resp = urllib.request.urlopen(req, timeout=30)
            json.loads(resp.read())
        moved = _delta(fleet.router, "r0", before)
        assert moved["aborted"] == 1, moved
        assert moved["retries"] == 0, moved


# -- circuit breaker ----------------------------------------------------------

def test_breaker_state_machine():
    """closed → open after threshold consecutive failures, half-open
    after cooldown + an answered poll, closed on the next answered
    poll; a half-open failure re-opens instantly; open/half-open
    excludes the replica from dispatch (prefer included)."""
    from veles_tpu_torch.fleet.router import FleetRouter, _Replica
    router = FleetRouter(poll_interval=60, breaker_threshold=3,
                         breaker_cooldown=0.1)
    try:
        rep = _Replica("x", "127.0.0.1", 1)
        with router._lock:
            router._replicas["x"] = rep
        for _ in range(2):
            router._note_failure(rep)
        assert rep.breaker == "closed"
        router._note_failure(rep)
        assert rep.breaker == "open"
        router._breaker_probe(rep)             # cooldown not elapsed
        assert rep.breaker == "open"
        time.sleep(0.12)
        router._breaker_probe(rep)
        assert rep.breaker == "half_open"
        router._note_failure(rep)              # half-open failure
        assert rep.breaker == "open"
        time.sleep(0.12)
        router._breaker_probe(rep)
        router._breaker_probe(rep)
        assert rep.breaker == "closed" and rep.fail_streak == 0
        rep.up = rep.ready = True
        assert router.pick() is rep
        with router._lock:
            rep.inflight -= 1
            rep.breaker = "open"
        assert router.pick() is None
        assert router.pick(prefer="x") is None
    finally:
        router.stop()


def test_breaker_trips_on_refusing_data_plane():
    fleet = _sleep_fleet(fault_plans={
        "r0": {"rules": [{"after": 1, "action": "refuse"}]}})
    with running(fleet):
        _wait(lambda: fleet.router.ready_count() == 2, 60, "both ready")
        before = _rep_counters(fleet.router, "r0")
        for _ in range(40):
            status, _, _ = _post(fleet.url + "/api/m",
                                 {"input": [[1, 2, 3, 4]]})
            assert status == 200
            if fleet.router.replica("r0").breaker == "open":
                break
            # let the poll revive r0 so it is offered traffic again
            _wait(lambda: fleet.router.replica("r0").up, 30,
                  "the poll to revive r0")
        moved = _delta(fleet.router, "r0", before)
        assert moved["breaker_trips"] >= 1, moved


# -- hung replica (SIGSTOP) ---------------------------------------------------

def test_sigstop_hung_replica_fails_over_and_readmits():
    fleet = _sleep_fleet(request_timeout=2)
    with running(fleet):
        router = fleet.router
        victim = "r0"
        pid = fleet.supervisor._replicas[victim].pid
        try:
            _wait(lambda: router.ready_count() == 2, 60, "both ready")
            router.set_admitting("r1", False)   # pin dispatch to victim
            os.kill(pid, signal.SIGSTOP)
            results = []

            def fire():
                results.append(_retrying_post(
                    fleet.url + "/api/m", {"input": [[1, 2, 3, 4]]})[0])
            threads = [threading.Thread(target=fire) for _ in range(3)]
            for t in threads:
                t.start()
            # all three must sit on the frozen victim before the peer
            # admits again: three timeouts are what trip the breaker
            _wait(lambda: router.replica(victim).inflight >= 3, 30,
                  "requests in flight on the frozen victim")
            router.set_admitting("r1", True)    # failover destination
            _wait(lambda: not router.replica(victim).up, 30,
                  "the poll to mark the hung replica down")
            for t in threads:
                t.join(60)
            assert results == [200] * 3, results
            assert router.replica(victim).breaker == "open"
            os.kill(pid, signal.SIGCONT)
            _wait(lambda: (router.replica(victim).up and
                           router.replica(victim).breaker == "closed"),
                  30, "SIGCONT re-admission via half-open")
            assert fleet.supervisor.describe()[victim]["restarts"] == 0
        finally:
            try:
                os.kill(pid, signal.SIGCONT)
            except (OSError, TypeError):
                pass
            router.set_admitting("r1", True)


# -- the seeded drills --------------------------------------------------------

def _drill(fleet, route, payload, want=None, clients=4, min_ok=20):
    """Clients post back to back (retrying 503) until the SIGKILLed
    replica has respawned ready and ``min_ok`` answers came back after
    it; -> status-class counts and the raw failures."""
    counts = {"ok": 0, "shed": 0, "expired": 0, "failed": 0,
              "mismatch": 0}
    failures = []
    lock = threading.Lock()
    done = threading.Event()

    def client():
        while not done.is_set():
            status, body = _retrying_post(
                fleet.url + route, payload,
                headers={"X-Deadline-Ms": "8000"}, tries=10)
            with lock:
                if status == 200:
                    counts["ok"] += 1
                    if want is not None and body.get("tokens") != want:
                        counts["mismatch"] += 1
                elif status in (429, 503):
                    counts["shed"] += 1
                elif status == 504:
                    counts["expired"] += 1
                else:
                    counts["failed"] += 1
                    failures.append((status, body))
    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    try:
        _wait(lambda: fleet.supervisor.describe()["r0"]["restarts"] >= 1,
              120, "the planned SIGKILL of r0")
        _wait(lambda: fleet.router.ready_count() == 3, 120,
              "the killed replica to respawn ready")
        ok = counts["ok"]
        _wait(lambda: counts["ok"] >= ok + min_ok, 120,
              "answers after the respawn")
    finally:
        done.set()
        for t in threads:
            t.join(120)
    assert not any(t.is_alive() for t in threads)
    return counts, failures


def test_seeded_chaos_drill_zero_unexplained_failures():
    plans = {
        "r0": {"seed": 1, "rules": [{"at": 10, "action": "sigkill"}]},
        "r1": {"seed": 2, "rules": [{"every": 9, "action": "truncate",
                                     "bytes": 20}]},
        "r2": {"seed": 3, "rules": [{"at": 7, "action": "blackhole",
                                     "seconds": 1.5}]},
    }
    fleet = _sleep_fleet(replicas=3, fault_plans=plans, request_timeout=4)
    with running(fleet):
        counts, failures = _drill(fleet, "/api/m",
                                  {"input": [[1, 2, 3, 4]]})
        assert counts["failed"] == 0, (counts, failures[:3])
        assert counts["ok"] > 20, counts
        sup = fleet.router.merged_metrics()["supervisor"]
        assert sup["r0"]["restarts_remaining"] <= 9, sup
        assert sup["r1"]["failed"] is False


def test_chaos_drill_int8_replicas_exact_under_faults():
    """The drill against int8 toy replicas: every 200 is bitwise the
    oracle's tokens, and the respawn still serves int8 pools."""
    from veles_tpu_torch.serving import ToyDecodeModel
    spec = ("toydecode:vocab=64,block=4,max_batch=4,max_prompt=16,"
            "max_new=8,num_blocks=32,kv_dtype=int8")
    plans = {
        "r0": {"seed": 5, "rules": [{"at": 8, "action": "sigkill"}]},
        "r1": {"seed": 6, "rules": [{"every": 9, "action": "truncate",
                                     "bytes": 20}]},
        "r2": {"seed": 7, "rules": [{"at": 7, "action": "blackhole",
                                     "seconds": 1.5}]},
    }
    fleet = Fleet({"toy": spec}, replicas=3, poll_interval=0.1,
                  device="cpu", request_timeout=5, fault_plans=plans,
                  backoff=BACKOFF)
    prompt = [9, 8, 7, 6]
    want = ToyDecodeModel(vocab=64, device="cpu").generate_reference(
        prompt, 6)
    with running(fleet):
        counts, failures = _drill(fleet, "/api/toy/generate",
                                  {"prompt": prompt, "max_new_tokens": 6},
                                  want=want, min_ok=10)
        assert counts["failed"] == 0, (counts, failures[:3])
        assert counts["mismatch"] == 0, counts
        # the respawn serves int8 pools (read on the control plane: the
        # plan counts every /api request, and its at=8 SIGKILL fires in
        # each new process too)
        views = {}

        def respawned_int8():
            met = fleet.router.merged_metrics()["replicas"]
            views.update(met.get("r0", {}).get("toy") or {})
            return bool(views)
        _wait(respawned_int8, 120, "the respawned r0's metrics")
        assert views["kv_dtype"] == "int8"
        assert views["block_bytes"] > 0


def test_deadline_expired_in_server_queue_returns_504():
    """A request whose budget is smaller than the queue ahead of it
    answers 504 without a batch row, while the queued work completes."""
    fleet = _sleep_fleet(replicas=1, row_sleep="0.05", request_timeout=10)
    with running(fleet):
        blockers = []

        def block():
            blockers.append(_post(fleet.url + "/api/m",
                                  {"input": [[1.0] * 4] * 20},
                                  timeout=60)[0])
        threads = [threading.Thread(target=block) for _ in range(2)]
        for t in threads:
            t.start()
        _wait(lambda: fleet.router.replica("r0").inflight >= 2, 30,
              "both blockers in flight")
        status, body, _ = _post(fleet.url + "/api/m",
                                {"input": [[1, 2, 3, 4]]},
                                headers={"X-Deadline-Ms": "120"})
        for t in threads:
            t.join(60)
        assert status == 504, (status, body)
        assert blockers.count(200) == 2, blockers


# -- tiered KV cache under SIGKILL --------------------------------------------

def test_sigkill_disk_tier_survives_respawn(tmp_path):
    from veles_tpu_torch.kvtier import PREFIX_HEADER, prefix_key_header
    spec = ("toydecode:vocab=64,block=4,max_batch=2,max_prompt=16,"
            "max_new=8,num_blocks=8,prefix=1,chunk=8,tier_disk=1")
    fleet = Fleet({"toy": spec}, replicas=2, poll_interval=0.1,
                  device="cpu", request_timeout=5,
                  kvtier_dir=str(tmp_path), backoff=BACKOFF)
    with running(fleet):
        router = fleet.router
        victim = "r0"
        _wait(lambda: router.ready_count() == 2, 60, "both ready")
        desc = fleet.supervisor.describe()
        victim_url = "http://%s:%d" % (fleet.supervisor.host,
                                       desc[victim]["port"])
        prompt = [5, 6, 7, 8, 9, 10, 11, 12]
        hdr = {PREFIX_HEADER: prefix_key_header(prompt, 4)}
        status, warm, _ = _post(victim_url + "/api/toy/generate",
                                {"prompt": prompt, "max_new_tokens": 6})
        assert status == 200, (status, warm)
        for i in range(4):
            filler = [20 + 3 * i + j for j in range(8)]
            s, _, _ = _post(victim_url + "/api/toy/generate",
                            {"prompt": filler, "max_new_tokens": 6})
            assert s == 200
        key = hdr[PREFIX_HEADER].split(",")[0]
        _wait(lambda: router.fleet_kv(key)["replicas"]
              .get(victim) in ("host", "disk"),
              30, "warm chain demoted and advertised")
        os.kill(fleet.supervisor._replicas[victim].pid, signal.SIGKILL)
        statuses = [_retrying_post(
            fleet.url + "/api/toy/generate",
            {"prompt": prompt, "max_new_tokens": 6}, headers=hdr)[0]
            for _ in range(6)]
        assert statuses == [200] * 6, statuses
        _wait(lambda: router.ready_count() == 2, 120,
              "killed replica to respawn ready")
        assert fleet.supervisor.describe()[victim]["restarts"] >= 1
        _wait(lambda: router.fleet_kv(key)["replicas"]
              .get(victim) == "disk",
              30, "disk chains re-advertised after respawn")
        status, again, _ = _post(fleet.url + "/api/toy/generate",
                                 {"prompt": prompt, "max_new_tokens": 6},
                                 headers=hdr)
        assert status == 200
        assert again["tokens"] == warm["tokens"], (warm, again)
