"""The port's serving fleet: router, supervisor, replicas, rolling
updates, failover.

Mirrors ``tests/test_fleet.py`` with replicas spawned as ``python -m
veles_tpu_torch.fleet.replica --device cpu`` subprocesses serving the
per-row ``sleep:`` stand-in and ``toydecode:``.  Every outcome is held by
counters and ids, never by a wall-clock ratio:

- the shared RestartBackoff walks base * factor^n with bounded jitter,
  honours its budget and resets its exponent (not its budget) after a
  healthy run, with the JAX package's schedule;
- a closed loop is spread over both replicas with zero failures (the
  JAX package's scaling test asserts a 2.4x throughput ratio, which a
  loaded CPU breaks; the spread and the failure count are what the
  router decides);
- the router merges ``/healthz`` ``/readyz`` ``/models`` ``/metrics``
  and the supervisor's restart budget; one trace id links router ->
  replica request -> ``serving.batch`` across processes;
- a rolling update under load flips every replica with zero failed and
  zero shed responses;
- a request in flight on a SIGKILLed replica is answered through
  exactly one retry; a SIGKILL under mixed load (classifier and decode,
  every token bitwise the toy's ``generate_reference``) fails nothing,
  the victim respawns ready, and ``GET /fleet/requests`` merges the
  router's and the replica's halves of a request under one trace id;
- on the card (marked ``gpu``): the respawned replica builds no kernel
  (the build directory is unchanged across the respawn).

Each fleet runs under its own time limit: past it a watchdog kills the
replicas, so the waits fail instead of hanging; every fleet stops in a
``finally``.  ``cache_dir=`` reaches every replica's environment.
"""

import contextlib
import glob
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import pytest

from veles_tpu_torch.distributed import RestartBackoff
from veles_tpu_torch.fleet import Fleet

ROW_SLEEP = 0.02      # device-time-per-row of the stand-in model
TOY = ("toydecode:vocab=64,block=4,max_batch=4,max_prompt=16,max_new=8,"
       "num_blocks=32")
BACKOFF = {"base": 0.1, "factor": 2.0, "cap": 2.0, "max_restarts": 10}
FLEET_LIMIT_S = 240


# -- RestartBackoff (shared respawn policy) -----------------------------------

def test_restart_backoff_schedule_deterministic():
    policy = RestartBackoff(base=1.0, factor=2.0, cap=10.0, jitter=0.5,
                            max_restarts=6, rng=lambda: 0.5)
    delays = [policy.next_delay() for _ in range(7)]
    assert delays == [1.0, 2.0, 4.0, 8.0, 10.0, 10.0, None]
    assert policy.exhausted and policy.restarts == 6
    assert policy.remaining == 0


def test_restart_backoff_jitter_bounds():
    lo = RestartBackoff(base=4.0, jitter=0.25, rng=lambda: 0.0)
    hi = RestartBackoff(base=4.0, jitter=0.25, rng=lambda: 1.0)
    assert lo.next_delay() == pytest.approx(3.0)
    assert hi.next_delay() == pytest.approx(5.0)


def test_restart_backoff_healthy_uptime_resets_streak_not_budget():
    policy = RestartBackoff(base=1.0, factor=2.0, cap=60.0, jitter=0.0,
                            max_restarts=4, reset_after=30.0)
    assert policy.next_delay() == 1.0
    assert policy.next_delay() == 2.0
    policy.note_uptime(31.0)
    assert policy.next_delay() == 1.0
    policy.note_uptime(5.0)
    assert policy.next_delay() == 2.0
    assert policy.next_delay() is None


def test_restart_backoff_schedule_equals_jax_package():
    from veles_tpu.distributed import RestartBackoff as JaxBackoff
    draws = [0.1, 0.9, 0.5, 0.3, 0.7, 0.2, 0.8, 0.6]

    def schedule(cls):
        it = iter(draws)
        policy = cls(base=0.5, factor=3.0, cap=7.0, jitter=0.3,
                     max_restarts=7, reset_after=10.0,
                     rng=lambda: next(it))
        out = []
        for uptime in (1.0, 12.0, 1.0, 1.0, 20.0, 1.0, 1.0, 1.0):
            policy.note_uptime(uptime)
            out.append((policy.next_delay(), policy.streak,
                        policy.remaining))
        return out
    assert schedule(RestartBackoff) == schedule(JaxBackoff)


# -- fleet helpers --------------------------------------------------------------

@contextlib.contextmanager
def running(fleet, limit=FLEET_LIMIT_S):
    """Start ``fleet``; past ``limit`` seconds a watchdog SIGKILLs its
    replicas (every wait below has its own timeout, so the test then
    fails instead of hanging); always stop it."""
    def kill():
        fleet.supervisor._stopping = True
        for handle in fleet.supervisor._replicas.values():
            if handle.proc is not None and handle.proc.poll() is None:
                handle.proc.kill()
    watchdog = threading.Timer(limit, kill)
    watchdog.daemon = True
    watchdog.start()
    try:
        fleet.start(ready_timeout=limit)
        yield fleet
    finally:
        watchdog.cancel()
        fleet.stop()


def _post(url, payload, headers=None, timeout=60):
    req = urllib.request.Request(
        url, json.dumps(payload).encode(),
        {"Content-Type": "application/json", **(headers or {})})
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
        return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _get(url, timeout=10):
    try:
        resp = urllib.request.urlopen(url, timeout=timeout)
        return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _closed_loop(url, clients, requests, until=None, route="/api/m",
                 payload=None):
    """``clients`` threads posting back to back, ``requests`` each (or
    until ``until`` is set); -> status-class counts."""
    counts = {"ok": 0, "shed": 0, "failed": 0}
    lock = threading.Lock()
    payload = payload or {"input": [[0.5] * 4]}

    def client():
        n = 0
        while (n < requests) if until is None else not until.is_set():
            n += 1
            try:
                status, _, _ = _post(url + route, payload)
            except Exception:  # noqa: BLE001 — counted as a failure
                status = -1
            with lock:
                key = ("ok" if status == 200 else
                       "shed" if status == 429 else "failed")
                counts[key] += 1
    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(FLEET_LIMIT_S)
    assert not any(t.is_alive() for t in threads)
    return counts


def _wait(predicate, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError("timed out waiting for " + what)


def _dispatched(fleet):
    met = fleet.router.merged_metrics()["router"]["replicas"]
    return {rid: view["dispatched"] for rid, view in met.items()}


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Two replicas of the per-row-sleep model and the toy decoder on
    the CPU, tracing into a shared VELES_TRACE_DIR."""
    trace_dir = str(tmp_path_factory.mktemp("fleet_trace"))
    fl = Fleet({"m": "sleep:%s:4" % ROW_SLEEP, "toy": TOY}, replicas=2,
               device="cpu", max_batch=4, queue_limit=256,
               poll_interval=0.1, backoff=BACKOFF,
               env=dict(os.environ, VELES_TRACE_DIR=trace_dir))
    fl.trace_dir = trace_dir
    with running(fl):
        yield fl


def _toy_reference(prompt, n):
    from veles_tpu_torch.serving import ToyDecodeModel
    return ToyDecodeModel(vocab=64, device="cpu").generate_reference(
        prompt, n)


# -- spread and control plane ---------------------------------------------------

def test_fleet_spreads_load_by_counts(fleet):
    """Four clients, ten requests each: every one answered 200 and both
    replicas took traffic (the JAX package's test asserts a throughput
    ratio instead)."""
    before = _dispatched(fleet)
    counts = _closed_loop(fleet.url, 4, 10)
    assert counts == {"ok": 40, "shed": 0, "failed": 0}
    after = _dispatched(fleet)
    moved = {rid: after[rid] - before.get(rid, 0) for rid in after}
    assert sum(moved.values()) == 40
    assert all(n > 0 for n in moved.values()), moved


def test_fleet_merged_endpoints(fleet):
    status, health = _get(fleet.url + "/healthz")
    assert status == 200 and health["ready_replicas"] == 2
    assert set(health["replicas"]) == {"r0", "r1"}
    for rep in health["replicas"].values():
        assert rep["up"] and rep["ready"] and rep["admitting"]
    status, ready = _get(fleet.url + "/readyz")
    assert status == 200 and ready["ready"]
    status, models = _get(fleet.url + "/models")
    assert status == 200
    assert set(models["models"]) == {"m", "toy"}
    assert set(models["models"]["m"]) == {"r0", "r1"}
    assert models["replicas"]["r0"]["m"]["device"] == "cpu"
    status, met = _get(fleet.url + "/metrics")
    assert status == 200
    for rid in ("r0", "r1"):
        view = met["router"]["replicas"][rid]
        assert view["up"] is True and view["ready"] is True
        assert isinstance(view["dispatched"], int)
        assert isinstance(view["retries"], int)
        assert {"m", "toy"} <= set(met["replicas"][rid])
    from veles_tpu_torch.observability.registry import REGISTRY
    up = REGISTRY.gauge("veles_fleet_replica_up", labels=("replica",))
    assert {key[0] for key in up.children()} >= {"r0", "r1"}


def test_supervisor_restart_budget_in_metrics(fleet):
    status, met = _get(fleet.url + "/metrics")
    assert status == 200
    sup = met["supervisor"]
    assert set(sup) == {"r0", "r1"}
    for rid, view in sup.items():
        assert view["failed"] is False
        assert view["restarts_remaining"] == 10 - view["restarts"]
        assert view["crash_streak"] >= 0
    desc = fleet.supervisor.describe()
    for rid, view in desc.items():
        assert view["restarts_remaining"] == sup[rid]["restarts_remaining"]


def test_fleet_trace_one_id_router_to_batch(fleet):
    """One trace id spans router -> replica request -> serving.batch,
    recorded by different processes; the batch span is looked for until
    the replica has written it (it follows the answer)."""
    from tools.merge_traces import merge
    from veles_tpu_torch.config import root
    from veles_tpu_torch.logger import events
    events.reset()
    root.common.trace.enabled = True
    root.common.trace.file = os.path.join(fleet.trace_dir,
                                          "events-router.jsonl")
    trace_id = "feedfacefeedface"
    try:
        status, _, headers = _post(fleet.url + "/api/m",
                                   {"input": [[1, 2, 3, 4]]},
                                   headers={"X-Trace-Id": trace_id})
        assert status == 200
        assert headers.get("X-Trace-Id") == trace_id
    finally:
        root.common.trace.enabled = False
        root.common.trace.file = None
        events.reset()
    found = {}

    def linked():
        paths = glob.glob(os.path.join(fleet.trace_dir, "events-*"))
        merged = merge(paths)["traceEvents"]
        ours = [e for e in merged
                if (e.get("args") or {}).get("trace_id") == trace_id]
        by_name = {}
        for e in ours:
            by_name.setdefault(e["name"], []).append(e)
        spans = {e["args"].get("span")
                 for e in by_name.get("serving.request", ())}
        found["batches"] = [
            e for e in merged if e["name"] == "serving.batch"
            and set((e.get("args") or {}).get("links") or ()) & spans]
        found["by_name"] = by_name
        return "fleet.route" in by_name and found["batches"]
    _wait(linked, 30, "the traced request's spans in the merged trace")
    by_name = found["by_name"]
    assert {e["pid"] for e in by_name["fleet.route"]} != \
        {e["pid"] for e in by_name["serving.request"]}


def test_fleet_rolling_update_zero_downtime(fleet):
    """A version rollout under load: zero failed and zero shed answers,
    every replica on the new version."""
    done = threading.Event()
    counts = {}
    loader = threading.Thread(target=lambda: counts.update(
        _closed_loop(fleet.url, 4, 0, until=done)))
    loader.start()
    try:
        _wait(lambda: sum(_dispatched(fleet).values()) > 0, 30,
              "load to start")
        result = fleet.rolling_update("m", "sleep:0.01:4", version="v2")
    finally:
        done.set()
        loader.join(FLEET_LIMIT_S)
    assert result["updated"] == ["r0", "r1"]
    assert counts["failed"] == 0 and counts["shed"] == 0, counts
    assert counts["ok"] > 0
    _, models = _get(fleet.url + "/models")
    assert {rid: view["version"]
            for rid, view in models["models"]["m"].items()} == \
        {"r0": "v2", "r1": "v2"}


# -- failover -------------------------------------------------------------------

def test_fleet_inflight_retry_on_sigkill(fleet):
    """A request in flight on a SIGKILLed replica is answered 200
    through exactly one retry on the peer; the victim respawns."""
    router = fleet.router
    victim, peer = router.replica_ids()
    before = int(router._c_retry.labels(replica=victim).value)
    restarts = fleet.supervisor.describe()[victim]["restarts"]
    result = {}
    try:
        router.set_admitting(peer, False)      # pin dispatch to the victim

        def fire():
            result.update(zip(("status", "body", "headers"), _post(
                fleet.url + "/api/m", {"input": [[1, 2, 3, 4]] * 40})))
        t = threading.Thread(target=fire)
        t.start()
        _wait(lambda: router.replica(victim).inflight >= 1, 30,
              "the request in flight on the victim")
        router.set_admitting(peer, True)       # the retry's destination
        fleet.supervisor.kill(victim, signal.SIGKILL)
        t.join(60)
    finally:
        router.set_admitting(peer, True)
    assert result.get("status") == 200, result
    assert int(router._c_retry.labels(replica=victim).value) == before + 1
    _wait(lambda: router.ready_count() == 2, 120, "the victim's respawn")
    assert fleet.supervisor.describe()[victim]["restarts"] == restarts + 1


def test_fleet_sigkill_zero_failures_and_ready_respawn(fleet):
    """SIGKILL one replica under classifier and decode load: zero
    failed answers, every decode answer bitwise the toy's oracle, the
    victim respawns ready, and the router's and the replica's halves of
    a traced decode request merge under one trace id."""
    router = fleet.router
    victim = router.replica_ids()[-1]
    restarts = fleet.supervisor.describe()[victim]["restarts"]
    prompts = [[3, 1, 2], [9, 8, 7, 6], [5, 5, 5], [1, 2, 3, 4, 5]]
    done = threading.Event()
    counts = {"ok": 0, "failed": 0, "mismatch": 0}
    failures = []
    lock = threading.Lock()

    def client(i):
        prompt = prompts[i % len(prompts)]
        want = _toy_reference(prompt, 6)
        while not done.is_set():
            status, body = -1, {}
            for _ in range(20):      # a well-behaved client retries 503
                try:
                    status, body, _ = _post(
                        fleet.url + "/api/toy/generate",
                        {"prompt": prompt, "max_new_tokens": 6})
                except Exception as e:  # noqa: BLE001 — counted
                    status, body = -1, {"error": repr(e)}
                if status != 503:
                    break
                time.sleep(0.05)
            with lock:
                if status == 200:
                    counts["ok"] += 1
                    counts["mismatch"] += body.get("tokens") != want
                else:
                    counts["failed"] += 1
                    failures.append((status, body))
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(4)]
    sleepers = threading.Thread(target=lambda: counts.update(
        sleep=_closed_loop(fleet.url, 2, 0, until=done)))
    for t in threads + [sleepers]:
        t.start()
    try:
        _wait(lambda: counts["ok"] >= 8, 60, "decode load to run")
        fleet.supervisor.kill(victim, signal.SIGKILL)
        _wait(lambda: fleet.supervisor.describe()[victim]["restarts"]
              > restarts, 60, "the supervisor to see the death")
        _wait(lambda: router.ready_count() == 2, 120,
              "the victim's respawn")
        ok_at_respawn = counts["ok"]
        _wait(lambda: counts["ok"] >= ok_at_respawn + 8, 60,
              "load after the respawn")
    finally:
        done.set()
        for t in threads + [sleepers]:
            t.join(FLEET_LIMIT_S)
    assert counts["failed"] == 0, failures[:3]
    assert counts["mismatch"] == 0, counts
    assert counts["sleep"]["failed"] == 0, counts
    status, ready = _get("http://%s:%d/readyz" % (
        fleet.supervisor.host, fleet.supervisor.describe()[victim]["port"]))
    assert status == 200 and ready["ready"]
    # one trace id across the router and the replica
    status, body, headers = _post(fleet.url + "/api/toy/generate",
                                  {"prompt": [4, 4], "max_new_tokens": 3})
    assert status == 200 and body["tokens"] == _toy_reference([4, 4], 3)
    tid = headers["X-Trace-Id"]
    status, doc = _get(fleet.url + "/fleet/requests?id=" + tid)
    frags = doc["requests"][tid]
    kinds = {tl.get("replica"): [e["kind"] for e in tl["events"]]
             for tl in frags}
    assert "router" in kinds and len(kinds) == 2
    assert "router.dispatch" in kinds["router"]
    replica = [r for r in kinds if r != "router"][0]
    assert {"queue.enter", "first_token", "retire"} <= set(kinds[replica])


def test_cache_dir_refused(tmp_path):
    """Refused until the build cache was ported (ROADMAP queue A item
    3): now a fleet's ``cache_dir=`` reaches every replica's
    environment, with the tuning directory ``inject_env`` forwards."""
    from veles_tpu_torch.config import root
    fleet = Fleet({"m": "sleep:0.01:4"}, replicas=1, device="cpu",
                  cache_dir=str(tmp_path / "cc"))
    prior = root.common.autotune.get("dir", None)
    try:
        root.common.autotune.dir = str(tmp_path / "tune")
        env = fleet.supervisor._child_env("r0")
    finally:
        root.common.autotune.dir = prior
        fleet.router.stop()
    assert env["VELES_COMPILE_CACHE_DIR"] == str(tmp_path / "cc")
    assert env["VELES_AUTOTUNE_DIR"] == str(tmp_path / "tune")


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the replicas run on the card)")


def _build_dir_state():
    from veles_tpu_torch import _build
    return sorted((p.name, p.stat().st_mtime_ns)
                  for p in _build.BUILD_DIR.glob("*"))


@pytest.mark.gpu
def test_fleet_on_the_card_sigkill_respawns_ready(cuda):
    """Two replicas on the card (the default device): SIGKILL one under
    decode load; nothing fails, every answer is the oracle's, the victim
    respawns ready, and the build directory is unchanged across the
    respawn.  The toy decoder launches no hand kernel, so that last
    check shows only that a replica's start builds nothing; a replica
    model that runs a kernel waits for package serving (ROADMAP queue A
    item 8)."""
    fl = Fleet({"toy": TOY}, replicas=2, max_batch=4, poll_interval=0.1,
               backoff=BACKOFF)
    with running(fl):
        victim = fl.router.replica_ids()[-1]
        built = _build_dir_state()
        want = _toy_reference([3, 1, 2], 6)
        payload = {"prompt": [3, 1, 2], "max_new_tokens": 6}
        answers = [_post(fl.url + "/api/toy/generate", payload)[:2]
                   for _ in range(4)]
        fl.supervisor.kill(victim, signal.SIGKILL)
        _wait(lambda: fl.supervisor.describe()[victim]["restarts"] >= 1,
              60, "the supervisor to see the death")
        for _ in range(8):
            for _ in range(20):
                status, body = _post(fl.url + "/api/toy/generate",
                                     payload)[:2]
                if status != 503:
                    break
                time.sleep(0.05)
            answers.append((status, body))
        _wait(lambda: fl.router.ready_count() == 2, 120,
              "the victim's respawn")
        assert [(s, b.get("tokens")) for s, b in answers] == \
            [(200, want)] * len(answers)
        assert _build_dir_state() == built
