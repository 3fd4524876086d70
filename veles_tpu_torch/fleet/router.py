"""The fleet front router: one logical service over N replicas.

A copy of ``veles_tpu/fleet/router.py`` (stdlib HTTP and the port's
observability and ``kvtier`` modules; it runs no model, so nothing of
it touches the card).  A byte-level HTTP proxy (it never parses request
payloads: routing must stay cheap next to model latency) in front of
the replica set, one service over many single-process replicas:

- **least-loaded dispatch**: a background thread polls every replica's
  ``GET /readyz`` (readiness + the schedulers' load snapshot) at
  ``poll_interval``; each request is forwarded to the admitting, ready
  replica with the lowest score = router-side in-flight count + queue
  utilization + KV occupancy.  The router's own in-flight counter moves
  per request, so burst skew is corrected between polls;
- **exactly-once retry**: inference requests are idempotent (pure
  functions of the payload), so a request that fails at the
  *connection* level — the replica died mid-flight — is retried ONCE
  against a different replica and the first replica is marked down
  immediately (the poll thread revives it after respawn).  The retry
  window closes the moment any response byte reaches the client:
  small bodies (``Content-Length`` ≤ ``stream_threshold``) are fully
  buffered first, so a mid-body death is still retryable; larger
  bodies stream, and a mid-stream death ABORTS the client connection
  (a truncated answer must read as an error, never as a silent
  double-send).  Replica HTTP statuses (429 backpressure included)
  pass through untouched: shed is a replica decision, not a router
  retry;
- **circuit breaking**: ``breaker_threshold`` consecutive
  connection-level failures trip a replica's breaker open — no traffic
  until the health poll doubles as the half-open probe
  (open → half-open after ``breaker_cooldown``, half-open → closed on
  the next answered poll).  A replica that flaps on reconnect stops
  eating the retry budget of every request;
- **deadlines**: a client ``X-Deadline-Ms`` header (REMAINING budget in
  milliseconds — relative, so no cross-process clocks) is parsed once,
  checked before every dispatch leg (expired → 504 without touching a
  replica), and re-emitted with the budget left so the replica's
  scheduler can shed queued work that can no longer make it;
- **session affinity**: ``X-Session-Id`` pins follow-up requests to the
  replica that owns the live session (affinity survives a drain —
  ``prefer`` bypasses only the admitting flag).  A replica answering
  307 + ``X-Veles-Migrated`` means the session moved mid-flight; the
  router follows to ``X-Veles-Session-Target`` with ``X-Veles-Attach``
  so the client transparently gets the full answer from the new home;
- **merged control plane**: ``/healthz`` (router liveness + per-replica
  up/ready/admitting/breaker), ``/readyz`` (200 iff ≥1 replica is
  ready), ``/models`` (union of the replicas' registries), ``/metrics``
  (router dispatch/retry/breaker counters, every replica's own
  snapshot, and the supervisor's restart-budget view when wired) —
  plus ``veles_fleet_*`` series in the process-global registry;
- **trace propagation**: every request runs in a ``fleet.route`` span
  (trace id from the client's ``X-Trace-Id`` or fresh) and the id is
  forwarded, so the merged Chrome trace reads router → replica request
  → ``serving.batch`` under one trace id.
"""

import collections
import http.client
import json
import socket
import threading
import time
import urllib.parse
from http.server import ThreadingHTTPServer

from ..httpjson import JsonRequestHandler
from ..kvtier import PREFIX_HEADER, PrefixDirectory
from ..logger import events
from ..observability import trace as _trace
from ..observability.flight import RECORDER as _flight
from ..observability.registry import REGISTRY

#: connection-level failures that mark a replica down and allow the
#: one retry; anything the replica ANSWERED is passed through instead
_DISPATCH_ERRORS = (OSError, http.client.HTTPException)

#: breaker states → gauge values (monotone in badness)
_BREAKER_GAUGE = {"closed": 0, "half_open": 1, "open": 2}

#: sentinel: the response already streamed through to the client
_STREAMED = object()


class ResponseAborted(Exception):
    """Bytes already reached the client when the replica connection
    died — the response can neither be retried (double-send) nor
    completed (truncated); the only honest move is closing the client
    socket so the truncation reads as a transport error."""


class _Truncated(Exception):
    """The replica connection died mid-body BEFORE any byte reached
    the client (fully-buffered small response) — retryable."""


def get_json(host, port, path, timeout=2.0, method="GET", body=None):
    """One short-lived JSON request to a replica (poll/merge paths —
    the proxy hot path keeps persistent connections instead)."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        headers = {}
        if body is not None:
            body = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        conn.request(method, path, body, headers)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, json.loads(data) if data else None
    finally:
        conn.close()


class _Replica:
    """Router-side view of one replica."""

    __slots__ = ("id", "host", "port", "up", "ready", "admitting",
                 "inflight", "load", "generation", "fail_streak",
                 "breaker", "breaker_opened_at")

    def __init__(self, rid, host, port):
        self.id = rid
        self.host = host
        self.port = port
        self.up = False
        self.ready = False
        self.admitting = True       # rollout drain flips this off
        self.inflight = 0
        self.load = {}
        self.generation = 0         # bumps on re-register (respawn)
        self.fail_streak = 0        # consecutive connection failures
        self.breaker = "closed"     # closed | open | half_open
        self.breaker_opened_at = 0.0

    def score(self):
        """Lower = less loaded.  In-flight dominates (it is exact and
        instant); the polled queue/KV signals break ties and catch
        pressure the router did not itself create."""
        s = float(self.inflight)
        for model_load in (self.load or {}).values():
            s += float(model_load.get("utilization") or 0.0)
            s += float(model_load.get("kv_occupancy") or 0.0)
        return s

    def describe(self):
        return {"host": self.host, "port": self.port, "up": self.up,
                "ready": self.ready, "admitting": self.admitting,
                "inflight": self.inflight, "load": self.load,
                "breaker": self.breaker,
                "fail_streak": self.fail_streak}


class _RouterHandler(JsonRequestHandler):
    server_ref = None
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    # reap idle keep-alive connections; overridden per router from
    # request_timeout (single source of truth — see FleetRouter)
    timeout = 60

    def do_POST(self):
        path = self.path.split("?", 1)[0]
        if path != "/api" and not path.startswith("/api/"):
            self.send_json(404, {"error": "not found"})
            return
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b""
        router = self.server_ref
        with _trace.span_context(
                trace_id=self.headers.get("X-Trace-Id") or None) as ctx:
            t0 = time.perf_counter()
            status, rid, retried = router.dispatch(self, path, body, ctx)
            events.span("fleet.route", time.perf_counter() - t0,
                        replica=rid, status=status, retried=retried,
                        path=path)

    def do_GET(self):
        router = self.server_ref
        path = self.path.split("?", 1)[0].rstrip("/")
        if path == "/healthz":
            self.send_json(200, router.health())
        elif path == "/readyz":
            ready = router.ready_count() > 0
            self.send_json(200 if ready else 503,
                           {"ready": ready,
                            "ready_replicas": router.ready_count(),
                            "replicas": len(router.replica_ids())})
        elif path == "/models":
            self.send_json(200, router.merged_models())
        elif path == "/metrics":
            self.send_json(200, router.merged_metrics())
        elif path == "/fleet/kv":
            query = urllib.parse.parse_qs(
                urllib.parse.urlparse(self.path).query)
            key = (query.get("key") or [None])[0]
            self.send_json(200, router.fleet_kv(key))
        elif path == "/fleet/requests":
            query = urllib.parse.parse_qs(
                urllib.parse.urlparse(self.path).query)
            rid = (query.get("id") or [None])[0]
            self.send_json(200, router.fleet_requests(rid))
        else:
            self.send_json(404, {"error": "not found"})


class FleetRouter:
    """Least-loaded HTTP front end over registered replicas.

    Replicas are registered by the supervisor (:meth:`add_replica`) —
    the router never spawns processes; it only watches, scores, and
    forwards.  Usable standalone against hand-started replicas too.
    """

    #: bound on 307 migration follows per request (a follow is not a
    #: retry: the source ANSWERED; it just answered "moved")
    max_follows = 4

    def __init__(self, port=0, host="127.0.0.1", poll_interval=0.2,
                 request_timeout=60.0, registry=None,
                 breaker_threshold=3, breaker_cooldown=1.0,
                 stream_threshold=65536):
        self.request_timeout = float(request_timeout)
        self.poll_interval = float(poll_interval)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown = float(breaker_cooldown)
        self.stream_threshold = int(stream_threshold)
        self._replicas = {}
        self._lock = threading.Lock()
        self._rr = 0                    # tie-break rotation
        self._tl = threading.local()    # per-thread persistent conns
        # session id → owning replica id (LRU-bounded)
        self._affinity = collections.OrderedDict()
        self._affinity_cap = 4096
        # wired by Fleet to supervisor.describe — restart budgets show
        # up in the one merged /metrics payload operators already poll
        self.supervisor_info = None
        registry = registry or REGISTRY
        self._g_up = registry.gauge(
            "veles_fleet_replica_up",
            "1 while the replica answers its readiness poll",
            ("replica",))
        self._g_ready = registry.gauge(
            "veles_fleet_replica_ready",
            "1 while the replica reports ready (warmup ladder done, "
            "not draining)", ("replica",))
        self._g_breaker = registry.gauge(
            "veles_fleet_breaker_state",
            "Circuit breaker: 0 closed, 1 half-open, 2 open",
            ("replica",))
        self._c_dispatch = registry.counter(
            "veles_fleet_dispatch_total",
            "Requests forwarded to the replica", ("replica",))
        self._c_retry = registry.counter(
            "veles_fleet_retries_total",
            "Requests retried on another replica after a dead one",
            ("replica",))
        self._c_no_replica = registry.counter(
            "veles_fleet_no_replica_total",
            "Requests shed because no ready replica was available")
        self._c_expired = registry.counter(
            "veles_fleet_deadline_expired_total",
            "Requests shed at the router because their X-Deadline-Ms "
            "budget ran out before a replica could answer")
        self._c_truncated = registry.counter(
            "veles_fleet_truncated_total",
            "Buffered replica responses that died mid-body (retried "
            "safely: no client byte had been written)", ("replica",))
        self._c_aborted = registry.counter(
            "veles_fleet_aborted_total",
            "Streamed responses aborted mid-body — client connection "
            "closed instead of retrying (exactly-once)", ("replica",))
        self._c_breaker = registry.counter(
            "veles_fleet_breaker_trips_total",
            "Times the replica's circuit breaker opened", ("replica",))
        self._c_follow = registry.counter(
            "veles_fleet_session_follows_total",
            "307 migration redirects followed to a session's new home")
        # fleet-wide prefix directory (kvtier/directory.py): replicas
        # advertise resident chain keys in their /readyz load payload;
        # requests carrying X-Veles-Prefix-Keys are steered to the
        # replica holding the longest resident run of them
        self.prefix_directory = PrefixDirectory()
        self._c_aff_hit = registry.counter(
            "veles_fleet_affinity_hits_total",
            "Requests routed to the replica holding the longest "
            "resident prefix of their prompt chain")
        self._c_aff_fallback = registry.counter(
            "veles_fleet_affinity_fallbacks_total",
            "Requests that carried prefix keys but fell back to "
            "least-loaded (no eligible replica held any of them)")
        handler = type("Handler", (_RouterHandler,),
                       {"server_ref": self,
                        "timeout": max(self.request_timeout, 1.0)})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.block_on_close = False
        self.host = host
        self.port = self._httpd.server_address[1]
        self._closed = False
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="veles-fleet-router")
        self._thread.start()
        self._poller = threading.Thread(
            target=self._poll_loop, daemon=True,
            name="veles-fleet-router-poll")
        self._poller.start()

    @property
    def url(self):
        return "http://%s:%d" % (self.host, self.port)

    # -- replica set ---------------------------------------------------------
    def add_replica(self, rid, host, port):
        """(Re-)register a replica; a respawn re-registers the same id
        with its new port and starts not-ready until the poll sees it."""
        with self._lock:
            prior = self._replicas.get(rid)
            rep = _Replica(rid, host, int(port))
            if prior is not None:
                rep.admitting = prior.admitting
                rep.generation = prior.generation + 1
            self._replicas[rid] = rep
        self._g_up.labels(replica=rid).set(0)
        self._g_ready.labels(replica=rid).set(0)
        self._g_breaker.labels(replica=rid).set(0)
        self._probe(rep)            # first state without poll latency
        return rep

    def remove_replica(self, rid):
        with self._lock:
            rep = self._replicas.pop(rid, None)
        if rep is not None:
            self._g_up.labels(replica=rid).set(0)
            self._g_ready.labels(replica=rid).set(0)
            self.prefix_directory.drop(rid)
        return rep is not None

    def replica_ids(self):
        with self._lock:
            return list(self._replicas)

    def replica(self, rid):
        with self._lock:
            return self._replicas.get(rid)

    def ready_count(self):
        with self._lock:
            return sum(1 for r in self._replicas.values()
                       if r.up and r.ready)

    def set_admitting(self, rid, admitting):
        """Rollout drain control: an un-admitting replica gets no NEW
        dispatches but keeps its in-flight ones (watch ``inflight``);
        session-affine requests still reach it (``prefer``) until the
        supervisor migrates its sessions away."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is not None:
                rep.admitting = bool(admitting)

    def mark_down(self, rid):
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is not None:
                rep.up = rep.ready = False
        self._g_up.labels(replica=rid).set(0)
        self._g_ready.labels(replica=rid).set(0)

    # -- session affinity ----------------------------------------------------
    def note_session_home(self, sid, rid):
        """Record (or move) a session's owning replica."""
        with self._lock:
            self._affinity.pop(sid, None)
            self._affinity[sid] = rid
            while len(self._affinity) > self._affinity_cap:
                self._affinity.popitem(last=False)

    def _session_home(self, sid):
        with self._lock:
            return self._affinity.get(sid)

    def _replica_at(self, hostport):
        """Map a ``host:port`` migration target to a replica id."""
        if not hostport:
            return None
        host, _, port = str(hostport).rpartition(":")
        try:
            port = int(port)
        except ValueError:
            return None
        with self._lock:
            for rep in self._replicas.values():
                if rep.port == port and (not host or rep.host == host):
                    return rep.id
        return None

    # -- circuit breaker -----------------------------------------------------
    def _note_failure(self, rep):
        """A connection-level dispatch failure: grow the streak; at
        ``breaker_threshold`` consecutive failures the breaker opens
        and the replica gets no traffic until its half-open probe
        passes (a half-open failure re-opens immediately)."""
        with self._lock:
            rep.fail_streak += 1
            tripped = (rep.breaker == "half_open"
                       or (rep.breaker == "closed"
                           and rep.fail_streak >= self.breaker_threshold))
            if tripped:
                rep.breaker = "open"
                rep.breaker_opened_at = time.monotonic()
        if tripped:
            self._c_breaker.labels(replica=rep.id).inc()
            self._g_breaker.labels(replica=rep.id).set(2)
            events.event("fleet.breaker_open", replica=rep.id,
                         streak=rep.fail_streak)

    def _note_success(self, rep):
        with self._lock:
            reopened = rep.breaker != "closed"
            rep.fail_streak = 0
            rep.breaker = "closed"
        if reopened:
            self._g_breaker.labels(replica=rep.id).set(0)

    def _breaker_probe(self, rep):
        """The health poll IS the half-open probe: open → half-open
        once the cooldown elapsed and the replica answered its poll,
        half-open → closed on the NEXT answered poll (two consecutive
        good polls before traffic returns)."""
        now = time.monotonic()
        with self._lock:
            if rep.breaker == "open" and \
                    now - rep.breaker_opened_at >= self.breaker_cooldown:
                rep.breaker = "half_open"
            elif rep.breaker == "half_open":
                rep.breaker = "closed"
                rep.fail_streak = 0
            else:
                return
            state = rep.breaker
        self._g_breaker.labels(replica=rep.id).set(_BREAKER_GAUGE[state])
        if state == "closed":
            events.event("fleet.breaker_closed", replica=rep.id)

    # -- health polling ------------------------------------------------------
    def _probe(self, rep):
        try:
            status, body = get_json(rep.host, rep.port, "/readyz",
                                    timeout=max(self.poll_interval * 4,
                                                1.0))
        except _DISPATCH_ERRORS + (ValueError,):
            rep.up = rep.ready = False
            with self._lock:
                if rep.breaker == "half_open":
                    rep.breaker = "open"
                    rep.breaker_opened_at = time.monotonic()
            self._g_breaker.labels(replica=rep.id).set(
                _BREAKER_GAUGE[rep.breaker])
        else:
            rep.up = True
            rep.ready = status == 200 and bool(
                isinstance(body, dict) and body.get("ready"))
            if isinstance(body, dict):
                rep.load = body.get("load") or {}
                # resident-chain advertisement piggybacked on the load
                # poll: merge every model's kv_tiers into the fleet
                # prefix directory (an answer without any clears stale
                # entries — the replica restarted tierless)
                tiers = {}
                for model_load in rep.load.values():
                    adv = (model_load or {}).get("kv_tiers")
                    if not isinstance(adv, dict):
                        continue
                    for tier, keys in adv.items():
                        tiers.setdefault(tier, []).extend(keys or ())
                self.prefix_directory.update(rep.id, tiers)
            self._breaker_probe(rep)
        self._g_up.labels(replica=rep.id).set(int(rep.up))
        self._g_ready.labels(replica=rep.id).set(int(rep.ready))

    def _poll_loop(self):
        while not self._closed:
            self.refresh()
            time.sleep(self.poll_interval)

    def refresh(self):
        """Probe every replica NOW (the poll loop's body; also called
        synchronously when dispatch finds no candidate, so a request
        arriving right after a replica turned ready — or right after
        the last candidate died — sees fresh state instead of a stale
        503)."""
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            if self._closed:
                return
            self._probe(rep)

    # -- dispatch ------------------------------------------------------------
    def pick(self, exclude=(), prefer=None):
        """Least-loaded admitting replica; ``prefer`` names the
        session-affine home, honored even while it is DRAINING (only
        up/ready/breaker gate it — a drain must not orphan sessions
        mid-migration)."""
        with self._lock:
            if prefer is not None and prefer not in exclude:
                rep = self._replicas.get(prefer)
                if rep is not None and rep.up and rep.ready \
                        and rep.breaker == "closed":
                    rep.inflight += 1
                    return rep
            candidates = [r for r in self._replicas.values()
                          if r.up and r.ready and r.admitting
                          and r.breaker == "closed"
                          and r.id not in exclude]
            if not candidates:
                return None
            best = min(r.score() for r in candidates)
            ties = [r for r in candidates if r.score() == best]
            # round-robin among equally-loaded replicas: a light load
            # must not pin itself to whichever replica sorts first
            rep = ties[self._rr % len(ties)]
            self._rr += 1
            rep.inflight += 1   # reserve under the lock (burst-safe)
            return rep

    def _conn_for(self, rep):
        conns = getattr(self._tl, "conns", None)
        if conns is None:
            conns = self._tl.conns = {}
        key = (rep.id, rep.generation)
        conn = conns.get(key)
        if conn is None:
            conn = http.client.HTTPConnection(
                rep.host, rep.port, timeout=self.request_timeout)
            conn.connect()
            conn.sock.setsockopt(socket.IPPROTO_TCP,
                                 socket.TCP_NODELAY, 1)
            conns[key] = conn
        return key, conn

    def _drop_conn(self, key):
        conns = getattr(self._tl, "conns", None)
        if conns is not None:
            conn = conns.pop(key, None)
            if conn is not None:
                conn.close()

    def _forward(self, rep, path, body, headers, handler):
        """One proxy leg.  Buffered responses return
        ``(status, headers, data)``; large responses stream straight
        through and return ``(status, headers, _STREAMED)``.

        Raises: ``_DISPATCH_ERRORS`` before the replica answered
        (retryable), :class:`_Truncated` when a buffered body died
        before any client byte (retryable), :class:`ResponseAborted`
        when the client already saw bytes (NOT retryable)."""
        key, conn = self._conn_for(rep)
        try:
            conn.request("POST", path, body, headers)
            resp = conn.getresponse()
        except _DISPATCH_ERRORS:
            self._drop_conn(key)
            raise
        length = resp.getheader("Content-Length")
        try:
            length = int(length) if length is not None else None
        except ValueError:
            length = None
        if length is not None and length <= self.stream_threshold:
            try:
                data = resp.read()
            except _DISPATCH_ERRORS as exc:
                self._drop_conn(key)
                raise _Truncated() from exc
            if len(data) != length:
                self._drop_conn(key)
                raise _Truncated()
            return resp.status, resp.getheaders(), data
        # streaming: the status line reaches the client immediately, so
        # any failure past this point is an abort, never a retry
        resp_headers = resp.getheaders()
        handler.send_response(resp.status)
        passed = {"content-type", "retry-after", "x-trace-id"}
        for name, value in resp_headers or ():
            if name.lower() in passed:
                handler.send_header(name, value)
        if length is not None:
            handler.send_header("Content-Length", str(length))
        else:
            # unsized upstream body: delimit by closing the connection
            handler.send_header("Connection", "close")
            handler.close_connection = True
        handler.end_headers()
        sent = 0
        try:
            while True:
                chunk = resp.read(65536)
                if not chunk:
                    break
                handler.wfile.write(chunk)
                sent += len(chunk)
        except _DISPATCH_ERRORS as exc:
            self._drop_conn(key)
            raise ResponseAborted() from exc
        if length is not None and sent != length:
            self._drop_conn(key)
            raise ResponseAborted()
        return resp.status, resp_headers, _STREAMED

    @staticmethod
    def _parse_deadline(handler):
        """Client ``X-Deadline-Ms`` (remaining budget) → absolute
        monotonic deadline, or None."""
        raw = handler.headers.get("X-Deadline-Ms")
        if not raw:
            return None
        try:
            ms = float(raw)
        except ValueError:
            return None
        return time.monotonic() + max(ms, 0.0) / 1e3

    def _affinity_pick(self, handler):
        """Cache-aware routing: map the request's X-Veles-Prefix-Keys
        (the prompt's chain keys, leading blocks first) to the replica
        holding the longest resident run of them.  Only *biases* the
        first dispatch leg among currently-eligible replicas — unlike
        session affinity it respects the admitting flag, and a holder
        that is down/draining degrades to least-loaded (counted as a
        fallback, never a failure)."""
        raw = handler.headers.get(PREFIX_HEADER)
        if not raw:
            return None
        keys = [k.strip() for k in raw.split(",") if k.strip()]
        if not keys:
            return None
        with self._lock:
            eligible = {r.id for r in self._replicas.values()
                        if r.up and r.ready and r.admitting
                        and r.breaker == "closed"}
        rid, matched = self.prefix_directory.best_replica(
            keys, candidates=eligible)
        if rid is not None and matched:
            self._c_aff_hit.inc()
            return rid
        self._c_aff_fallback.inc()
        return None

    def _retry_budget(self):
        """Connection-level legs allowed per request: one per known
        replica (min 2).  Retrying is always safe here — a leg that
        wrote ANY client byte ends in :class:`ResponseAborted`, not a
        retry — so the budget is about not looping forever, not about
        duplicate answers."""
        return max(2, len(self._replicas))

    def dispatch(self, handler, path, body, ctx):
        """Forward one request; writes the response through ``handler``.
        Returns ``(status, replica_id, retried)`` for the route span."""
        headers = {"Content-Type": handler.headers.get("Content-Type")
                   or "application/json",
                   **_trace.http_headers(ctx)}
        sid = handler.headers.get("X-Session-Id") or None
        if sid:
            headers["X-Session-Id"] = sid
        tenant = handler.headers.get("X-Veles-Tenant")
        if tenant:
            headers["X-Veles-Tenant"] = tenant
            _flight.annotate(ctx.trace_id, tenant=tenant)
        deadline = self._parse_deadline(handler)
        tried = []
        retried = False
        follows = 0
        attach = False
        prefer = self._session_home(sid) if sid else None
        if prefer is None:
            prefer = self._affinity_pick(handler)
            if prefer is not None:
                _flight.record(ctx.trace_id, "router.affinity",
                               replica=prefer)
        rep = None
        while True:
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # shed BEFORE a replica spends device time on an
                    # answer nobody is waiting for
                    self._c_expired.inc()
                    _flight.anomaly(ctx.trace_id, "deadline_504")
                    _flight.finish(ctx.trace_id, status="deadline_504")
                    handler.send_json(
                        504, {"error": "deadline expired"},
                        headers=_trace.http_headers(ctx))
                    return 504, rep.id if rep else None, retried
                headers["X-Deadline-Ms"] = str(
                    max(int(remaining * 1e3), 1))
            if attach:
                headers["X-Veles-Attach"] = "1"
            rep = self.pick(exclude=tried, prefer=prefer)
            if rep is None:
                self.refresh()      # stale view ≠ empty fleet
                rep = self.pick(exclude=tried, prefer=prefer)
            if rep is None:
                self._c_no_replica.inc()
                _flight.anomaly(ctx.trace_id, "shed_429",
                                detail="no_replica")
                _flight.finish(ctx.trace_id, status="no_replica")
                handler.send_json(
                    503, {"error": "no ready replica"},
                    headers={"Retry-After": "1",
                             **_trace.http_headers(ctx)})
                return 503, None, retried
            tried.append(rep.id)
            prefer = None
            _flight.record(ctx.trace_id, "router.dispatch",
                           replica=rep.id, attempt=len(tried))
            try:
                status, resp_headers, data = self._forward(
                    rep, path, body, headers, handler)
            except ResponseAborted:
                self._note_failure(rep)
                self.mark_down(rep.id)
                self._c_aborted.labels(replica=rep.id).inc()
                handler.close_connection = True
                return 499, rep.id, retried
            except _Truncated:
                self._note_failure(rep)
                self.mark_down(rep.id)
                self._c_truncated.labels(replica=rep.id).inc()
                if len(tried) < self._retry_budget():
                    self._c_retry.labels(replica=rep.id).inc()
                    _flight.record(ctx.trace_id, "router.retry",
                                   replica=rep.id, reason="truncated")
                    _flight.anomaly(ctx.trace_id, "retry")
                    retried = True
                    continue
                break
            except _DISPATCH_ERRORS:
                # the replica died under us: it gets no new traffic
                # until the poll (or supervisor re-register) revives
                # it, and THIS request retries on a peer — safe, since
                # not one response byte reached the client (the
                # streamed case raises ResponseAborted instead)
                self._note_failure(rep)
                self.mark_down(rep.id)
                if len(tried) < self._retry_budget():
                    self._c_retry.labels(replica=rep.id).inc()
                    _flight.record(ctx.trace_id, "router.retry",
                                   replica=rep.id, reason="connection")
                    _flight.anomaly(ctx.trace_id, "recovery_replay")
                    retried = True
                    continue
                break
            finally:
                with self._lock:
                    rep.inflight -= 1
            self._note_success(rep)
            self._c_dispatch.labels(replica=rep.id).inc()
            lower = {name.lower(): value
                     for name, value in (resp_headers or ())}
            moved = lower.get("x-veles-migrated")
            if status == 307 and moved and data is not _STREAMED \
                    and follows < self.max_follows:
                # the session migrated mid-request: follow to its new
                # home and re-attach — one answer, no client redirect
                follows += 1
                self._c_follow.inc()
                _flight.record(
                    ctx.trace_id, "router.follow", session=sid,
                    target=lower.get("x-veles-session-target"))
                sid = moved
                headers["X-Session-Id"] = sid
                attach = True
                prefer = self._replica_at(
                    lower.get("x-veles-session-target"))
                if prefer is not None:
                    self.note_session_home(sid, prefer)
                tried = []      # a follow is an answer, not a failure
                continue
            if sid and status == 200:
                self.note_session_home(sid, rep.id)
            if data is not _STREAMED:
                self._respond(handler, status, resp_headers, data)
            _flight.finish(ctx.trace_id,
                           status="ok" if status < 400
                           else "status_%d" % status)
            return status, rep.id, retried
        _flight.anomaly(ctx.trace_id, "error", detail="dispatch_failed")
        _flight.finish(ctx.trace_id, status="dispatch_failed")
        handler.send_json(502, {"error": "dispatch failed on %d "
                                "replicas" % len(tried),
                                "replicas": tried},
                          headers=_trace.http_headers(ctx))
        return 502, tried[-1] if tried else None, True

    @staticmethod
    def _respond(handler, status, resp_headers, data):
        """Pass a replica answer through byte-for-byte (429 Retry-After
        and trace headers included)."""
        handler.send_response(status)
        passed = {"content-type", "retry-after", "x-trace-id"}
        for name, value in resp_headers or ():
            if name.lower() in passed:
                handler.send_header(name, value)
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)

    # -- merged control plane ------------------------------------------------
    def health(self):
        with self._lock:
            reps = {rid: rep.describe()
                    for rid, rep in self._replicas.items()}
        return {"status": "ok", "replicas": reps,
                "ready_replicas": sum(1 for r in reps.values()
                                      if r["up"] and r["ready"])}

    def merged_models(self):
        """Union of the replicas' ``/models`` — per-model, per-replica
        (versions differ mid-rollout, and that must be visible)."""
        out = {"models": {}, "replicas": {}}
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            if not rep.up:
                continue
            try:
                _, body = get_json(rep.host, rep.port, "/models",
                                   timeout=2.0)
            except _DISPATCH_ERRORS + (ValueError,):
                continue
            if not isinstance(body, dict):
                continue
            out["replicas"][rep.id] = body
            for name, desc in body.items():
                out["models"].setdefault(name, {})[rep.id] = {
                    "version": desc.get("version"),
                    "ready": desc.get("ready")}
        return out

    def fleet_kv(self, key=None):
        """The ``GET /fleet/kv`` payload: with ``key=``, that chain
        key's tier residency per replica (hbm / host / disk / absent);
        without, the whole advertised directory plus the affinity
        counters — tools/kv_inspect.py --fleet renders both."""
        if key:
            residency = self.prefix_directory.residency(str(key))
            return {"key": str(key),
                    "replicas": {rid: residency.get(rid, "absent")
                                 for rid in self.replica_ids()}}
        return {"replicas": self.prefix_directory.snapshot(max_keys=64),
                "affinity_hits": int(self._c_aff_hit.value),
                "affinity_fallbacks": int(self._c_aff_fallback.value)}

    def fleet_requests(self, trace_id=None):
        """The ``GET /fleet/requests`` payload: flight-recorder
        timelines merged across the router and every live replica,
        grouped by trace id — one request's full cross-process story
        (tools/request_inspect.py renders it).  With ``id=``, only
        that trace."""
        path = "/api/requests"
        if trace_id:
            path += "?id=" + urllib.parse.quote(str(trace_id))
        merged = {}

        def _absorb(source, timelines):
            for tl in timelines or ():
                tid = tl.get("trace_id") if isinstance(tl, dict) \
                    else None
                if not tid:
                    continue
                tl.setdefault("replica", source)
                merged.setdefault(tid, []).append(tl)

        _absorb("router", _flight.snapshot(trace_id=trace_id))
        with self._lock:
            reps = list(self._replicas.values())
        stats = {"router": _flight.stats()}
        for rep in reps:
            if not rep.up:
                continue
            try:
                _, body = get_json(rep.host, rep.port, path,
                                   timeout=2.0)
            except _DISPATCH_ERRORS + (ValueError,):
                continue
            if not isinstance(body, dict):
                continue
            _absorb(rep.id, body.get("requests"))
            stats[rep.id] = body.get("flight")
        return {"requests": merged, "flight": stats}

    def merged_metrics(self):
        """Router counters + every live replica's own /metrics + the
        supervisor's restart-budget view (when wired by Fleet)."""
        with self._lock:
            reps = list(self._replicas.values())
        router = {"replicas": {},
                  "no_replica_sheds": int(self._c_no_replica.value),
                  "deadline_expired": int(self._c_expired.value),
                  "session_follows": int(self._c_follow.value),
                  "affinity_hits": int(self._c_aff_hit.value),
                  "affinity_fallbacks": int(
                      self._c_aff_fallback.value)}
        merged = {"router": router, "replicas": {}}
        for rep in reps:
            router["replicas"][rep.id] = {
                "up": rep.up, "ready": rep.ready,
                "admitting": rep.admitting, "inflight": rep.inflight,
                "breaker": rep.breaker,
                "fail_streak": rep.fail_streak,
                "breaker_trips": int(
                    self._c_breaker.labels(replica=rep.id).value),
                "dispatched": int(
                    self._c_dispatch.labels(replica=rep.id).value),
                "retries": int(
                    self._c_retry.labels(replica=rep.id).value),
                "truncated": int(
                    self._c_truncated.labels(replica=rep.id).value),
                "aborted": int(
                    self._c_aborted.labels(replica=rep.id).value),
            }
            if rep.up:
                try:
                    _, body = get_json(rep.host, rep.port, "/metrics",
                                       timeout=2.0)
                    merged["replicas"][rep.id] = body
                except _DISPATCH_ERRORS + (ValueError,):
                    merged["replicas"][rep.id] = {"error": "unreachable"}
        if self.supervisor_info is not None:
            try:
                merged["supervisor"] = self.supervisor_info()
            except Exception:  # noqa: BLE001 — metrics must not 500
                merged["supervisor"] = {"error": "unavailable"}
        return merged

    def stop(self):
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
