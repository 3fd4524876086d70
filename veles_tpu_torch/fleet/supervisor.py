"""Replica lifecycle: spawn, watch, respawn-with-backoff, roll out.

The port of ``veles_tpu/fleet/supervisor.py``: the supervisor owns N
replica subprocesses, each a :mod:`veles_tpu_torch.fleet.replica` on
the supervisor's ``device`` (the card by default; ``"cpu"`` for the
tests) —

- **warm spawn**: every replica inherits the persistent build cache
  (``cache_dir=``, or the supervisor's configured one) and the tuning
  store through its environment (:func:`~veles_tpu_torch.compilecache
  .inject_env`), so a respawn against a warm cache builds no kernel and
  resolves the same tuned plans; and the supervisor's trace context
  and its own flight-record and KV-tier directories, so its spans join
  the fleet trace;
- **crash recovery**: a monitor thread polls the child processes; a
  dead replica is marked down in the router immediately and respawned
  on the shared :class:`~veles_tpu_torch.distributed.RestartBackoff`
  policy
  (exponential + jitter, max-restart budget) — a crash-looping replica
  backs off instead of hot-spinning and eventually parks as
  ``failed``;
- **rolling model updates**: :meth:`rolling_update` walks the replicas
  one at a time — stop new dispatch at the router, wait for the
  replica's in-flight requests to drain, hot-load the new model
  version through ``POST /admin/models`` (the registry warms the new
  scheduler fully BEFORE the swap and drains the old one after), then
  re-admit — so an open-loop load across the fleet sees zero failed
  responses while every replica flips to the new version.
"""

import collections
import json
import os
import signal
import subprocess
import sys
import threading
import time

from ..compilecache import inject_env as _cache_inject_env
from ..compilecache.cache import CACHE_DIR_ENV
from ..device import resolve_device
from ..distributed import RestartBackoff
from ..logger import events
from ..observability import trace as _trace
from .router import _DISPATCH_ERRORS, get_json


class _ReplicaProc:
    """One supervised replica subprocess."""

    def __init__(self, rid, backoff):
        self.id = rid
        self.backoff = backoff
        self.proc = None
        self.port = None
        self.state = "new"        # new|starting|up|respawning|failed|stopped
        self.spawned_at = None
        self.respawn_due = None
        self.announce = threading.Event()
        self.log_tail = collections.deque(maxlen=200)

    @property
    def pid(self):
        return self.proc.pid if self.proc is not None else None

    def describe(self):
        return {"state": self.state, "port": self.port, "pid": self.pid,
                "failed": self.state == "failed",
                "restarts": self.backoff.restarts,
                "restarts_remaining": self.backoff.remaining,
                "crash_streak": self.backoff.streak}


class ReplicaSupervisor:
    """Spawn and babysit ``replicas`` serving subprocesses.

    ``models``: mapping/iterable of ``name -> spec`` handed to every
    replica (a :func:`~veles_tpu_torch.fleet.replica.resolve_model_spec`
    spec).  ``router``: a :class:`~veles_tpu_torch.fleet.router
    .FleetRouter` kept in sync with the replica set (optional: the
    supervisor also works headless).  ``device``: the replicas'
    ``--device``, resolved here (None: the card, raising without one),
    so a fleet asked for the card on a host without one fails at once
    instead of crash-looping its replicas.
    """

    def __init__(self, models, replicas=2, router=None, *,
                 host="127.0.0.1", max_batch=64, queue_limit=256,
                 workers=1, cache_dir=None, kvtier_dir=None,
                 flight_dir=None, python=None, env=None,
                 backoff=None, spawn_timeout=180.0, poll_interval=0.1,
                 fault_plans=None, clock=time.monotonic, device=None):
        items = models.items() if hasattr(models, "items") else models
        self.models = [(str(n), s) for n, s in items]
        self.router = router
        self.host = host
        self.max_batch = int(max_batch)
        self.queue_limit = int(queue_limit)
        self.workers = int(workers)
        self.device = resolve_device(device)
        self.cache_dir = cache_dir
        self.kvtier_dir = kvtier_dir
        self.flight_dir = flight_dir
        self.python = python or sys.executable
        self.spawn_timeout = float(spawn_timeout)
        self.poll_interval = float(poll_interval)
        self._clock = clock
        self._backoff_kw = backoff or {}
        self._replicas = {}
        for i in range(int(replicas)):
            rid = "r%d" % i
            self._replicas[rid] = _ReplicaProc(
                rid, RestartBackoff(**self._backoff_kw))
        self._env = env
        # rid -> fault plan (dict or JSON string) injected into that
        # replica's environment: the deterministic chaos hook (see
        # .chaos); replicas without a plan run clean
        self.fault_plans = dict(fault_plans or {})
        self._lock = threading.Lock()
        self._stopping = False
        self._monitor = None

    # -- spawning ------------------------------------------------------------
    def _child_env(self, rid=None):
        env = dict(os.environ if self._env is None else self._env)
        if self.cache_dir:
            # the shared build cache rides the environment
            # (compilecache.resolve_config reads it), so every replica
            # and every respawn loads the same kernel libraries
            env[CACHE_DIR_ENV] = os.path.abspath(str(self.cache_dir))
        env = _cache_inject_env(env) or env
        if self.kvtier_dir and rid is not None:
            # per-replica disk tier, path keyed by the STABLE replica id
            # so a respawn re-opens the same index and re-advertises its
            # surviving chains (the chaos drill's warm-restart invariant)
            env["VELES_KVTIER_DIR"] = os.path.join(
                str(self.kvtier_dir), rid)
        if self.flight_dir and rid is not None:
            # per-replica flight-record dir: anomalous request
            # timelines persist here and SURVIVE a SIGKILL — the
            # chaos drill's evidence trail (tools/request_inspect.py
            # --dir reads them offline)
            env["VELES_FLIGHT_DIR"] = os.path.join(
                str(self.flight_dir), rid)
        plan = self.fault_plans.get(rid) if rid is not None else None
        if plan is not None:
            env["VELES_FAULT_PLAN"] = (plan if isinstance(plan, str)
                                       else json.dumps(plan))
        return _trace.inject_env(env) or env

    def _argv(self, rid):
        argv = [self.python, "-m", "veles_tpu_torch.fleet.replica",
                "--replica-id", rid, "--port", "0",
                "--host", self.host,
                "--max-batch", str(self.max_batch),
                "--queue-limit", str(self.queue_limit),
                "--workers", str(self.workers),
                "--device", str(self.device)]
        for name, spec in self.models:
            argv += ["--model", "%s=%s" % (name, spec)]
        return argv

    def _spawn(self, handle):
        handle.state = "starting"
        handle.announce = threading.Event()
        handle.spawned_at = self._clock()
        repo = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        handle.proc = subprocess.Popen(
            self._argv(handle.id), cwd=repo,
            env=self._child_env(handle.id),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        threading.Thread(target=self._drain_stdout, args=(handle,),
                         daemon=True,
                         name="veles-fleet-%s-log" % handle.id).start()
        events.event("fleet.spawn", replica=handle.id,
                     pid=handle.proc.pid)

    def _drain_stdout(self, handle):
        """Read the child's output forever: parse the announce line,
        keep a tail for diagnostics, never let the pipe fill."""
        proc = handle.proc
        for line in proc.stdout:
            line = line.rstrip("\n")
            handle.log_tail.append(line)
            if handle.port is None or not handle.announce.is_set():
                try:
                    announced = json.loads(line).get("fleet_replica")
                except (ValueError, AttributeError):
                    announced = None
                if announced and proc is handle.proc:
                    handle.port = int(announced["port"])
                    handle.state = "up"
                    if self.router is not None:
                        self.router.add_replica(handle.id, self.host,
                                                handle.port)
                    handle.announce.set()

    def start(self):
        """Spawn every replica (concurrently — they warm in parallel)
        and register each with the router as it announces."""
        with self._lock:
            for handle in self._replicas.values():
                self._spawn(handle)
        for handle in self._replicas.values():
            if not handle.announce.wait(self.spawn_timeout):
                raise RuntimeError(
                    "replica %s did not announce within %.0fs:\n%s"
                    % (handle.id, self.spawn_timeout,
                       "\n".join(handle.log_tail)))
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name="veles-fleet-supervisor")
        self._monitor.start()
        return self

    # -- monitoring / respawn ------------------------------------------------
    def _monitor_loop(self):
        while not self._stopping:
            now = self._clock()
            with self._lock:
                handles = list(self._replicas.values())
            for handle in handles:
                self._check(handle, now)
            time.sleep(self.poll_interval)

    def _check(self, handle, now):
        if handle.state in ("failed", "stopped", "new"):
            return
        if handle.state == "respawning":
            if now >= handle.respawn_due:
                handle.respawn_due = None
                self._spawn(handle)
            return
        if handle.proc is None or handle.proc.poll() is None:
            return
        # the replica died: out of the router NOW, respawn on backoff
        rc = handle.proc.returncode
        if self.router is not None:
            self.router.mark_down(handle.id)
        handle.backoff.note_uptime(now - (handle.spawned_at or now))
        delay = handle.backoff.next_delay()
        events.event("fleet.replica_died", replica=handle.id, rc=rc,
                     respawn_in=delay)
        if delay is None:
            handle.state = "failed"
            return
        handle.state = "respawning"
        handle.respawn_due = now + delay

    # -- readiness -----------------------------------------------------------
    def _replica_ready(self, handle):
        if handle.state != "up" or handle.port is None:
            return False
        try:
            status, body = get_json(self.host, handle.port, "/readyz",
                                    timeout=2.0)
        except _DISPATCH_ERRORS + (ValueError,):
            return False
        return status == 200 and bool(body and body.get("ready"))

    def wait_ready(self, timeout=180.0, replicas=None):
        """Block until every (non-failed) replica answers ready;
        returns the ready ids.  Raises on timeout."""
        deadline = time.monotonic() + timeout
        want = set(replicas if replicas is not None else self._replicas)
        while True:
            ready = {rid for rid in want
                     if self._replica_ready(self._replicas[rid])}
            live = {rid for rid in want
                    if self._replicas[rid].state != "failed"}
            if ready >= live and live:
                return sorted(ready)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "replicas not ready after %.0fs: %s"
                    % (timeout, {rid: self._replicas[rid].describe()
                                 for rid in want - ready}))
            time.sleep(0.05)

    # -- drills / control ----------------------------------------------------
    def kill(self, rid, sig=signal.SIGKILL):
        """Fault injection: kill one replica (the monitor respawns it)."""
        handle = self._replicas[rid]
        if handle.proc is not None and handle.proc.poll() is None:
            os.kill(handle.proc.pid, sig)

    def replica_ids(self):
        return sorted(self._replicas)

    def describe(self):
        return {rid: h.describe() for rid, h in self._replicas.items()}

    # -- session migration ---------------------------------------------------
    def _admin(self, handle, action, body, timeout=60.0):
        return get_json(self.host, handle.port,
                        "/admin/sessions/" + action, method="POST",
                        timeout=timeout, body=body)

    def _pick_target(self, source_rid):
        for rid in self.replica_ids():
            handle = self._replicas[rid]
            if rid != source_rid and handle.state == "up" \
                    and handle.port is not None:
                return rid
        return None

    def migrate_sessions(self, source_rid, target_rid=None):
        """Move every live decode session off ``source_rid`` to a peer.

        Three phases, each idempotent against a crash between them:
        export (the source frees the rows and PARKS the clients'
        futures — nothing is answered yet), import at the target (each
        session lands independently), release at the source (the
        parked clients get the 307 redirect the router follows to the
        new home).  Sessions the target rejected are re-imported at
        the source — a failed migrate degrades to "nothing moved",
        never to a lost session."""
        source = self._replicas[source_rid]
        if source.port is None:
            raise RuntimeError("replica %s has no address" % source_rid)
        status, body = self._admin(source, "export", {})
        if status != 200:
            raise RuntimeError("session export on %s answered %s: %s"
                               % (source_rid, status, body))
        sessions = (body or {}).get("sessions") or []
        summary = {"source": source_rid, "target": target_rid,
                   "moved": [], "restored": [], "errors": []}
        if not sessions:
            return summary
        if target_rid is None:
            target_rid = self._pick_target(source_rid)
            summary["target"] = target_rid
        target = self._replicas.get(target_rid) if target_rid else None
        imported = []
        if target is not None and target.port is not None:
            try:
                _, tbody = self._admin(target, "import",
                                       {"sessions": sessions})
            except _DISPATCH_ERRORS + (ValueError,):
                tbody = None
            if isinstance(tbody, dict):
                imported = [str(s) for s in tbody.get("imported") or []]
                summary["errors"] = list(tbody.get("errors") or [])
        if imported:
            self._admin(source, "release",
                        {"session_ids": imported,
                         "target": "%s:%d" % (self.host, target.port)},
                        timeout=30.0)
            if self.router is not None:
                for sid in imported:
                    self.router.note_session_home(sid, target_rid)
            summary["moved"] = imported
        # anything that did not land at the target goes back home —
        # its parked future is reused, the client never notices
        landed = set(imported)
        leftover = [s for s in sessions
                    if str(s.get("session_id")) not in landed]
        if leftover:
            self._admin(source, "import", {"sessions": leftover})
            summary["restored"] = [str(s.get("session_id"))
                                   for s in leftover]
        events.event("fleet.migrate", source=source_rid,
                     target=target_rid, moved=len(imported),
                     restored=len(leftover))
        return summary

    def drain(self, rid, drain_timeout=30.0):
        """Quiesce one replica: stop NEW dispatch at the router,
        migrate its live sessions to a peer (so the wait below is
        bounded by migration time, not by generation length), then
        wait out the remaining in-flight requests."""
        if self.router is not None:
            self.router.set_admitting(rid, False)
        summary = None
        try:
            summary = self.migrate_sessions(rid)
        except Exception:  # noqa: BLE001 — fall back to waiting it out
            events.event("fleet.migrate_failed", replica=rid)
        if self.router is not None:
            self._drain_router_inflight(rid, drain_timeout)
        return summary

    # -- rolling model updates -----------------------------------------------
    def rolling_update(self, name, spec, version=None,
                       drain_timeout=30.0, admin_timeout=300.0):
        """Zero-downtime version rollout: one replica at a time —
        quiesce at the router, drain in-flight, hot-load, re-admit.

        The replica itself keeps serving its OLD version until the new
        scheduler is fully warm (registry hot-swap semantics), so the
        only reason to quiesce is to keep tail latency flat while the
        replica pays the warmup CPU.  Raises on the first replica that
        fails to load, leaving it quiesced and the rest untouched."""
        t0 = time.monotonic()
        updated = []
        for rid in self.replica_ids():
            handle = self._replicas[rid]
            if handle.state == "failed":
                continue
            if not handle.announce.wait(self.spawn_timeout):
                raise RuntimeError("replica %s has no address" % rid)
            if self.router is not None:
                self.router.set_admitting(rid, False)
                try:
                    # live sessions move to a peer instead of pinning
                    # the drain to their generation length; on any
                    # migration failure the old behavior (wait out the
                    # generations) still holds
                    self.migrate_sessions(rid)
                except Exception:  # noqa: BLE001
                    events.event("fleet.migrate_failed", replica=rid)
                self._drain_router_inflight(rid, drain_timeout)
            try:
                status, body = get_json(
                    self.host, handle.port, "/admin/models",
                    method="POST", timeout=admin_timeout,
                    body={"name": name, "model": spec,
                          "version": version})
                if status != 200:
                    raise RuntimeError(
                        "hot-load on %s answered %s: %s"
                        % (rid, status, body))
                self.wait_ready(timeout=admin_timeout, replicas=[rid])
            except Exception:
                events.event("fleet.rollout_failed", replica=rid,
                             model=name, version=version)
                raise
            finally:
                # re-admit on success AND on failure of a LATER step —
                # the replica still serves (old or new version); only
                # an unreachable one stays out via the health poll
                if self.router is not None:
                    self.router.set_admitting(rid, True)
            updated.append(rid)
            events.event("fleet.rollout_step", replica=rid, model=name,
                         version=version)
        return {"model": name, "version": version, "updated": updated,
                "seconds": round(time.monotonic() - t0, 3)}

    def _drain_router_inflight(self, rid, timeout):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            rep = self.router.replica(rid)
            if rep is None or rep.inflight <= 0:
                return
            time.sleep(0.01)

    # -- shutdown ------------------------------------------------------------
    def stop(self, drain=True, timeout=20.0):
        """SIGTERM every replica (graceful drain in the child), reap,
        SIGKILL stragglers."""
        self._stopping = True
        if self._monitor is not None:
            self._monitor.join(self.poll_interval * 4 + 1.0)
        with self._lock:
            handles = list(self._replicas.values())
        for handle in handles:
            handle.state = "stopped"
            if handle.proc is not None and handle.proc.poll() is None:
                handle.proc.send_signal(
                    signal.SIGTERM if drain else signal.SIGKILL)
        deadline = time.monotonic() + timeout
        for handle in handles:
            if handle.proc is None:
                continue
            try:
                handle.proc.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                handle.proc.kill()
                handle.proc.wait(5.0)
            if self.router is not None:
                self.router.mark_down(handle.id)


class Fleet:
    """Convenience composition: a router plus a supervised replica set.

    >>> fleet = Fleet({"m": "sleep:0.002:4"}, replicas=3).start()
    >>> # POST fleet.url + "/api/m" ...
    >>> fleet.stop()
    """

    def __init__(self, models, replicas=3, router_port=0,
                 host="127.0.0.1", poll_interval=0.2,
                 request_timeout=60.0, **supervisor_kw):
        from .router import FleetRouter
        self.router = FleetRouter(port=router_port, host=host,
                                  poll_interval=poll_interval,
                                  request_timeout=request_timeout)
        try:
            self.supervisor = ReplicaSupervisor(
                models, replicas=replicas, router=self.router, host=host,
                **supervisor_kw)
        except Exception:
            self.router.stop()
            raise
        # restart budgets / crash-looper state ride the one merged
        # /metrics payload the router already serves
        self.router.supervisor_info = self.supervisor.describe

    @property
    def url(self):
        return self.router.url

    @property
    def port(self):
        return self.router.port

    def start(self, ready_timeout=300.0):
        self.supervisor.start()
        self.supervisor.wait_ready(ready_timeout)
        return self

    def rolling_update(self, name, spec, **kwargs):
        return self.supervisor.rolling_update(name, spec, **kwargs)

    def migrate_sessions(self, source_rid, target_rid=None):
        return self.supervisor.migrate_sessions(source_rid, target_rid)

    def drain(self, rid, **kwargs):
        return self.supervisor.drain(rid, **kwargs)

    def stop(self, drain=True):
        self.supervisor.stop(drain=drain)
        self.router.stop()
