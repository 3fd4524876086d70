"""The inference server: bounded queue, backpressure, drain, endpoints.

The port of ``veles_tpu/serving/server.py``: a stdlib
``ThreadingHTTPServer`` over a :class:`~.registry.ModelRegistry`.  Per
request: parse (400 on a malformed payload), resolve the model (404),
submit to its scheduler — which either batches or admits it, or sheds
it (:class:`SchedulerOverflow` -> 429 + ``Retry-After``) — and answer
JSON.  A failure *inside* inference is a 500 with a generic body and a
server-side log record; the traceback never leaves the process.  Every
answer carries ``X-Trace-Id`` (the client's, or a fresh one), which
keys the request's flight timeline
(:mod:`veles_tpu_torch.observability.flight`): the handler opens it
(``request.recv``, the model and the ``X-Veles-Tenant`` tag) and closes
it with the anomaly the status implies (429, 504, 5xx).

Endpoints:
    POST /api                      infer on the default model
    POST /api/<model>              infer on a named model (``{"input":
                                   [[...], ...]}`` -> ``{"result",
                                   "output"}``; classifier models)
    POST /api/<model>/generate     autoregressive decode (``session_id``
                                   in the body or ``X-Session-Id``:
                                   re-attach to that session if it is
                                   known here, else start it under that
                                   id)
    POST /api/generate             the same on the default model
    GET  /healthz                  liveness + model listing
    GET  /readyz                   503 until every model is warm
    GET  /metrics                  per-model metrics + stats
    GET  /models                   registry description
    GET  /api/<model>/kv           the KV pool's dump and integrity list
    GET  /api/<model>/requests     the flight recorder's timelines
                                   (``?id=<trace id>`` for one)
    POST /admin/models             hot-load a model version, behind
                                   ``enable_admin`` (404 without it)
    POST /admin/sessions/export    live-session migration, behind
    POST /admin/sessions/import    ``enable_admin``
    POST /admin/sessions/release
    GET  /admin/sessions           session ids: active, migrating,
                                   finished

A generate whose session migrated away while the request waited is
answered 307 with ``X-Veles-Migrated`` (and ``X-Veles-Session-Target``
when the exporter named one); a follow with ``X-Veles-Attach: 1`` for
a session unknown here is answered 410.

Shutdown is a graceful drain: stop accepting, finish every admitted and
queued request, then stop the HTTP front end.
"""

import logging
import threading
import time
import urllib.parse
import uuid
from concurrent.futures import TimeoutError as _FutureTimeout
from http.server import ThreadingHTTPServer

from ..httpjson import ClientError, JsonRequestHandler
from ..logger import events
from ..observability import trace as _trace
from ..observability.flight import RECORDER as _flight
from .registry import ModelRegistry
from .scheduler import (DeadlineExpired, SchedulerClosed,
                        SchedulerOverflow, deadline_expired)
from .sessions import pack_state, unpack_states

__all__ = ["InferenceServer"]

log = logging.getLogger("veles_tpu_torch.serving")

#: how long a migration follow (``X-Veles-Attach: 1``) waits for the
#: session's import to commit before answering 410
ATTACH_WAIT_S = 5.0


class _ServingHandler(JsonRequestHandler):
    server_ref = None           # class attr bound per InferenceServer
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    timeout = 60                # idle keep-alive reaper, per server

    def do_POST(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        if path == "/admin/models":
            self._admin_load()
        elif path.startswith("/admin/sessions/"):
            self._admin_sessions(path[len("/admin/sessions/"):])
        elif path == "/api/generate":
            self._generate(None)
        elif path.startswith("/api/") and path.endswith("/generate"):
            self._generate(path[len("/api/"):-len("/generate")] or None)
        elif path == "/api":
            self._infer(None)
        elif path.startswith("/api/"):
            self._infer(path[len("/api/"):])
        else:
            self.send_json(404, {"error": "not found"})

    def do_GET(self):
        srv = self.server_ref
        path = self.path.split("?", 1)[0].rstrip("/")
        if path == "/healthz":
            self.send_json(200, {
                "status": "draining" if srv.draining else "ok",
                "models": srv.registry.names(),
                "default_model": srv.registry.default_name,
                "uptime_s": round(time.time() - srv.started, 1)})
        elif path == "/readyz":
            ready = srv.registry.ready() and not srv.draining
            self.send_json(200 if ready else 503, {
                "ready": ready,
                "draining": srv.draining,
                "models": {name: entry.scheduler.ready
                           for name, entry in self._entries()},
                "load": srv.registry.load_snapshot()})
        elif path == "/metrics":
            self.send_json(200, srv.registry.metrics_snapshot())
        elif path == "/models":
            self.send_json(200, srv.registry.describe())
        elif path.startswith("/api/") and path.endswith("/kv"):
            # live KV pool introspection: resident prefixes, refcounts,
            # dedupe ratio, speculation tallies, integrity verdict
            name = path[len("/api/"):-len("/kv")] or None
            entry = srv.registry.get(name)
            if entry is None or not hasattr(entry.scheduler, "kv_dump"):
                self.send_json(404, {"error": "no decode model %r"
                                     % name})
                return
            try:
                self.send_json(200, entry.scheduler.kv_dump())
            except Exception as exc:  # noqa: BLE001 — draining et al.
                self.send_json(503, {"error": str(exc)})
        elif path.startswith("/api/") and path.endswith("/requests"):
            # the flight recorder's ring: per-request timelines
            # (tools/request_inspect.py; the fleet router merges these
            # into GET /fleet/requests)
            name = path[len("/api/"):-len("/requests")] or None
            query = urllib.parse.parse_qs(
                urllib.parse.urlparse(self.path).query)
            rid = (query.get("id") or [None])[0]
            self.send_json(200, {
                "requests": _flight.snapshot(trace_id=rid, model=name),
                "flight": _flight.stats()})
        elif path == "/admin/sessions" and srv.enable_admin:
            self.send_json(200, {"sessions": {
                name: entry.scheduler.session_ids()
                for name, entry in self._decode_entries()}})
        else:
            self.send_json(404, {"error": "not found"})

    # -- deadlines -----------------------------------------------------------
    def _deadline(self):
        """``X-Deadline-Ms`` (REMAINING budget in ms) -> an absolute
        ``time.monotonic()`` deadline, or None."""
        raw = self.headers.get("X-Deadline-Ms")
        if not raw:
            return None
        try:
            ms = float(raw)
        except ValueError:
            return None
        return time.monotonic() + max(ms, 0.0) / 1e3

    def _shed_expired(self, trace_hdr):
        self.send_json(504, {"error": "deadline expired"},
                       headers=trace_hdr)
        return 504

    def _result_timeout(self, deadline):
        """The configured request timeout, tightened to the request's
        remaining deadline."""
        timeout = self.server_ref.request_timeout
        if deadline is not None:
            timeout = min(timeout, max(deadline - time.monotonic(), 0.001))
        return timeout

    def _shed(self, entry, message, headers, close=False):
        """429 + a ``Retry-After`` computed from the scheduler's queue
        depth and its recent batch or step latency."""
        try:
            retry = entry.scheduler.retry_after_s()
        except Exception:  # noqa: BLE001 — a hint must never 500 a shed
            retry = 1
        headers = dict(headers, **{"Retry-After": str(int(retry))})
        if close:
            headers["Connection"] = "close"
        self.send_json(429, {"error": message, "model": entry.name,
                             "retry_after_s": int(retry)},
                       headers=headers)
        return 429

    # -- admin: versioned hot-load -------------------------------------------
    def _admin_load(self):
        """``POST /admin/models {"name", "model", "version"?,
        "default"?}`` -> registry hot-load (the fleet's rolling-update
        hook).  404 unless the server was built with ``enable_admin``."""
        srv = self.server_ref
        if not srv.enable_admin:
            self.send_json(404, {"error": "not found"})
            return
        try:
            payload = self.read_json_body()
            if not isinstance(payload, dict) or \
                    not payload.get("name") or "model" not in payload:
                raise ClientError("bad admin payload")
        except ClientError:
            self.send_json(400, {
                "error": "body must be {'name': ..., 'model': <spec>, "
                         "'version'?: ...}"})
            return
        name = str(payload["name"])
        try:
            spec = payload["model"]
            model = (srv.model_resolver(spec)
                     if srv.model_resolver is not None else spec)
            entry = srv.registry.add(
                name, model, version=payload.get("version"),
                default=bool(payload.get("default", False)))
        except Exception as exc:  # noqa: BLE001 — report, keep serving
            log.exception("admin hot-load of %r failed", name)
            self.send_json(500, {"error": "hot-load failed: %s"
                                 % str(exc)[:300], "model": name})
            return
        self.send_json(200, {"model": entry.name,
                             "version": entry.version,
                             "ready": entry.scheduler.ready})

    # -- admin: session migration --------------------------------------------
    def _entries(self, model=None):
        """(name, entry) pairs, optionally of one model name."""
        srv = self.server_ref
        out = []
        for name in ([model] if model else srv.registry.names()):
            entry = srv.registry.get(name)
            if entry is not None:
                out.append((name, entry))
        return out

    def _decode_entries(self, model=None):
        """The (name, entry) pairs whose schedulers speak the session
        protocol."""
        return [(name, entry) for name, entry in self._entries(model)
                if hasattr(entry.scheduler, "export_sessions")]

    def _admin_sessions(self, action):
        """``POST /admin/sessions/{export,import,release}``: the
        migration surface (``enable_admin`` only).

        export:  {"model"?, "session_ids"?} -> {"sessions": [packed]}
                 (each tagged with its model name; exported sessions
                 are PARKED here until release confirms the import)
        import:  {"sessions": [packed]} -> {"imported": [...],
                 "errors": [[sid, reason], ...]}; each session lands on
                 its own, and 409 means nothing landed
        release: {"session_ids": [...], "target"?} -> completes the
                 parked futures with a redirect marker
        """
        if not self.server_ref.enable_admin:
            self.send_json(404, {"error": "not found"})
            return
        try:
            payload = self.read_json_body() if int(
                self.headers.get("Content-Length", 0)) else {}
            if not isinstance(payload, dict):
                raise ClientError("body is not a JSON object")
        except ClientError as exc:
            self.send_json(400, {"error": str(exc)})
            return
        try:
            if action == "export":
                sids = payload.get("session_ids")
                sessions = []
                for name, entry in self._decode_entries(
                        payload.get("model")):
                    for state in entry.scheduler.export_sessions(sids):
                        sessions.append(dict(pack_state(state), model=name))
                self.send_json(200, {"sessions": sessions,
                                     "count": len(sessions)})
            elif action == "import":
                raw = payload.get("sessions") or []
                by_model = {}
                for packed in raw:
                    by_model.setdefault(packed.get("model"),
                                        []).append(packed)
                imported, errors = [], []
                for model, group in by_model.items():
                    entries = self._decode_entries(model)
                    if not entries:
                        errors.extend((p.get("session_id"),
                                       "no decode model %r" % model)
                                      for p in group)
                        continue
                    states = unpack_states(group)
                    for state in states:
                        state.pop("model", None)
                    done, errs = entries[0][1].scheduler.import_sessions(
                        states)
                    imported.extend(done)
                    errors.extend(errs)
                # 409 when NOTHING landed (and something was sent): the
                # exporter keeps everything and aborts the migration
                self.send_json(409 if raw and not imported else 200, {
                    "imported": imported,
                    "errors": [[sid, str(reason)]
                               for sid, reason in errors]})
            elif action == "release":
                sids = payload.get("session_ids") or []
                released = []
                for _, entry in self._decode_entries(payload.get("model")):
                    released.extend(entry.scheduler.release_migrated(
                        sids, target=payload.get("target")))
                self.send_json(200, {"released": released})
            else:
                self.send_json(404, {"error": "unknown session action %r"
                                     % action})
        except Exception as exc:  # noqa: BLE001 — report, keep serving
            log.exception("admin session %s failed", action)
            self.send_json(500, {"error": "%s failed: %s"
                                 % (action, str(exc)[:300])})

    def _swapped(self, name, entry):
        """The entry that replaced ``entry`` under ``name`` since this
        request resolved it.  A hot swap closes the replaced scheduler,
        so a request that resolved it just before the swap finds it
        closed: it goes to the replacement, which was warm before the
        swap.  Re-raises SchedulerClosed when nothing replaced it (the
        server is draining)."""
        fresh = self.server_ref.registry.resolve(name)
        if fresh is None or fresh is entry or self.server_ref.draining:
            raise SchedulerClosed("model %r is shut down" % entry.name)
        return fresh

    # -- the flight-recorder lifecycle ---------------------------------------
    def _flight_open(self, ctx, name, path):
        """Open (or continue) the request's flight timeline: the trace
        id is the stitching key, the tenant tag rides as metadata."""
        tid = ctx.trace_id
        _flight.annotate(tid, model=name or "<default>",
                         tenant=self.headers.get("X-Veles-Tenant"))
        _flight.record(tid, "request.recv", path=path,
                       model=name or "<default>")

    def send_json(self, code, payload, headers=None):
        """Send now, or, inside :meth:`_answer`, hold the response until
        the request's flight timeline is closed."""
        held = getattr(self, "_held", None)
        if held is not None:
            held.append((code, payload, headers))
            return
        super().send_json(code, payload, headers)

    def _answer(self, ctx, name, path, traced, span):
        """Run ``traced(name, ctx)`` (the request body; it returns the
        HTTP status it answered) with its responses held, close the
        flight timeline, and only then write them: a client that reads
        ``GET /api/<name>/requests`` once it has its answer finds the
        timeline closed."""
        t0 = time.perf_counter()
        self._flight_open(ctx, name, path)
        self._held = []
        status = 500
        try:
            status = traced(name, ctx)
        finally:
            held, self._held = self._held, None
            events.span(span, time.perf_counter() - t0,
                        model=name or "<default>", status=status)
            self._flight_close(ctx, status)
            for response in held:
                self.send_json(*response)

    def _flight_close(self, ctx, status):
        """Close the timeline with the anomaly the response status
        implies (shed, deadline, server fault).  A 200 decode answer
        was already finished by the scheduler's retire; a 307 stays
        open: the destination replica finishes it."""
        tid = ctx.trace_id
        _flight.record(tid, "request.done", status=int(status))
        if status == 429:
            _flight.anomaly(tid, "shed_429")
            _flight.finish(tid, status="shed_429")
        elif status == 504:
            _flight.anomaly(tid, "deadline_504")
            _flight.finish(tid, status="deadline_504")
        elif status >= 500:
            _flight.anomaly(tid, "error", status=int(status))
            _flight.finish(tid, status="error_%d" % status)
        elif status == 200:
            _flight.finish(tid, status="ok")

    # -- the classifier path -------------------------------------------------
    def _infer(self, name):
        # request -> batch causality: the request runs in a span context
        # (the client's X-Trace-Id, or a fresh id), the scheduler
        # captures it at submit, and the batch span links back to it
        with _trace.span_context(
                trace_id=self.headers.get("X-Trace-Id") or None) as ctx:
            self._answer(ctx, name, "infer", self._infer_traced,
                         "serving.request")

    def _infer_traced(self, name, ctx):
        """The request body; returns the HTTP status it answered."""
        srv = self.server_ref
        entry = srv.registry.resolve(name)
        trace_hdr = {"X-Trace-Id": ctx.trace_id}
        try:
            batch = self.read_input_payload()
            if batch.ndim == 1:
                batch = batch[None]         # single-sample convenience
            if entry is None:
                self.send_json(404, {
                    "error": "unknown model %r" % (name or "<default>"),
                    "models": srv.registry.names()}, headers=trace_hdr)
                return 404
            if not hasattr(entry, "infer"):
                self.send_json(400, {
                    "error": "model %r is a decode model; use POST "
                             "/api/%s/generate" % (entry.name, entry.name)},
                    headers=trace_hdr)
                return 400
            entry.scheduler.validate(batch)
        except ValueError as e:             # ClientError included
            self.send_json(400, {"error": str(e)}, headers=trace_hdr)
            return 400
        deadline = self._deadline()
        if deadline_expired(deadline):
            # expired before submission: shed without touching the queue
            entry.scheduler.metrics.record_expired()
            return self._shed_expired(trace_hdr)
        try:
            try:
                result, out = entry.infer(
                    batch, timeout=self._result_timeout(deadline),
                    deadline=deadline)
            except SchedulerClosed:
                entry = self._swapped(name, entry)
                result, out = entry.infer(
                    batch, timeout=self._result_timeout(deadline),
                    deadline=deadline)
        except SchedulerOverflow as e:
            return self._shed(entry, "server overloaded: %s" % e,
                              trace_hdr)
        except DeadlineExpired:
            return self._shed_expired(trace_hdr)
        except _FutureTimeout:
            if deadline_expired(deadline):
                return self._shed_expired(trace_hdr)
            log.warning("inference on %r exceeded request_timeout",
                        entry.name)
            self.send_json(500, {"error": "request timed out",
                                 "model": entry.name}, headers=trace_hdr)
            return 500
        except SchedulerClosed:
            self.send_json(503, {"error": "server is draining"},
                           headers={"Connection": "close", **trace_hdr})
            return 503
        except Exception:  # noqa: BLE001 — server fault, logged here
            error_id = uuid.uuid4().hex[:12]
            log.exception("inference failed on model %r (error id %s)",
                          entry.name, error_id)
            self.send_json(500, {"error": "internal inference error",
                                 "model": entry.name, "id": error_id},
                           headers=trace_hdr)
            return 500
        self.send_json(200, {"result": result, "output": out.tolist()},
                       headers=trace_hdr)
        return 200

    # -- the decode path -----------------------------------------------------
    def _generate(self, name):
        with _trace.span_context(
                trace_id=self.headers.get("X-Trace-Id") or None) as ctx:
            self._answer(ctx, name, "generate", self._generate_traced,
                         "serving.generate_request")

    def _read_generate_payload(self):
        """{"prompt": [...], "max_new_tokens": n?, "session_id": s?} ->
        (prompt, n, session_id)."""
        payload = self.read_json_body()
        if not isinstance(payload, dict) or "prompt" not in payload:
            raise ClientError(
                "body must be {'prompt': [tokens], 'max_new_tokens': n?}")
        max_new = payload.get("max_new_tokens")
        if max_new is not None and not isinstance(max_new, int):
            raise ClientError("'max_new_tokens' must be an integer")
        sid = payload.get("session_id")
        if sid is not None and not isinstance(sid, str):
            raise ClientError("'session_id' must be a string")
        return payload["prompt"], max_new, sid

    def _generate_traced(self, name, ctx):
        """The request body; returns the HTTP status it answered."""
        srv = self.server_ref
        entry = srv.registry.resolve(name)
        trace_hdr = {"X-Trace-Id": ctx.trace_id}
        try:
            prompt, max_new, sid = self._read_generate_payload()
            sid = self.headers.get("X-Session-Id") or sid
            if entry is None:
                self.send_json(404, {
                    "error": "unknown model %r" % (name or "<default>"),
                    "models": srv.registry.names()}, headers=trace_hdr)
                return 404
            if not hasattr(entry, "generate"):
                self.send_json(400, {
                    "error": "model %r is not a decode model; use "
                             "POST /api/%s" % (entry.name, entry.name)},
                    headers=trace_hdr)
                return 400
            entry.scheduler.validate(
                prompt, max_new if max_new is not None
                else entry.scheduler.max_new_tokens)
        except (ValueError, TypeError) as e:     # ClientError included
            self.send_json(400, {"error": str(e)}, headers=trace_hdr)
            return 400
        deadline = self._deadline()
        if deadline_expired(deadline):
            entry.scheduler.metrics.record_expired()
            return self._shed_expired(trace_hdr)
        # a migration follow: the session is (or shortly will be) live
        # here, so attach instead of generating again
        attach = self.headers.get("X-Veles-Attach") == "1"
        try:
            result = None
            if sid:
                result = self._session_result(entry, sid, deadline, attach)
            if result is None:
                if attach:
                    self.send_json(410, {"error": "unknown session",
                                         "session_id": sid},
                                   headers=trace_hdr)
                    return 410
                try:
                    result = entry.generate(
                        prompt, max_new,
                        timeout=self._result_timeout(deadline),
                        session_id=sid, deadline=deadline)
                except SchedulerClosed:
                    entry = self._swapped(name, entry)
                    result = entry.generate(
                        prompt, max_new,
                        timeout=self._result_timeout(deadline),
                        session_id=sid, deadline=deadline)
        except SchedulerOverflow as e:
            return self._shed(entry, "server overloaded: %s" % e, trace_hdr)
        except SchedulerClosed:
            # drain: in-flight sequences finish, NEW submits shed with
            # retryable backpressure
            return self._shed(entry, "server is draining", trace_hdr,
                              close=True)
        except DeadlineExpired:
            return self._shed_expired(trace_hdr)
        except _FutureTimeout:
            if deadline_expired(deadline):
                return self._shed_expired(trace_hdr)
            log.warning("generate on %r exceeded request_timeout",
                        entry.name)
            self.send_json(500, {"error": "request timed out",
                                 "model": entry.name}, headers=trace_hdr)
            return 500
        except Exception:  # noqa: BLE001 — server fault, logged here
            error_id = uuid.uuid4().hex[:12]
            log.exception("generate failed on model %r (error id %s)",
                          entry.name, error_id)
            self.send_json(500, {"error": "internal inference error",
                                 "model": entry.name, "id": error_id},
                           headers=trace_hdr)
            return 500
        if result.get("migrated"):
            # the session moved while this request waited: a redirect a
            # router follows to the session's new home (its tokens so
            # far moved with it, so the target answers the whole,
            # bitwise-identical sequence)
            headers = dict(trace_hdr)
            headers["X-Veles-Migrated"] = str(
                result.get("session_id") or sid or "")
            if result.get("target"):
                headers["X-Veles-Session-Target"] = str(result["target"])
            self.send_json(307, dict(result, model=entry.name),
                           headers=headers)
            return 307
        self.send_json(200, dict(result, model=entry.name),
                       headers=trace_hdr)
        return 200

    def _session_result(self, entry, sid, deadline, attach):
        """The result of an EXISTING session ``sid``: waits on its live
        future, returns a finished result at once, or None when the id
        is unknown here (the caller starts it).  A migration follow
        (``attach``) polls for up to :data:`ATTACH_WAIT_S`: the redirect
        can land a beat before the target's import commits."""
        scheduler = entry.scheduler
        wait_until = time.monotonic() + (ATTACH_WAIT_S if attach else 0.0)
        while True:
            found = scheduler.attach(sid)
            if found is not None:
                break
            if time.monotonic() >= wait_until or \
                    deadline_expired(deadline):
                return None
            time.sleep(0.02)
        kind, value = found
        if kind == "finished":
            return value
        return value.result(self._result_timeout(deadline))


class InferenceServer:
    """Serve one or more models over HTTP.

    ``models``: optional mapping/iterable of (name, model) registered at
    construction; more can be added later through ``registry`` or
    :meth:`add_model`.  ``scheduler_defaults`` apply to every model
    registered through this server: the decode scheduler's
    (``max_batch``, ``block_size``, ``max_prompt_len``,
    ``max_new_tokens``, ``num_blocks``, ``queue_limit``,
    ``prefix_caching``, ``prefill_chunk_tokens``, ``spec_depth``,
    ``kvtier``, ``kv_dtype``; under a model's own ``decode_defaults``)
    and the bucket scheduler's (``max_batch``, ``queue_limit``,
    ``workers``, ``max_wait``, ``warmup``, ``background_warmup``,
    ``sample_shape``, ``buckets``); ``cache`` and ``manifest`` go to
    both, and ``device`` defaults to the card for both.  ``enable_admin`` opens ``POST /admin/models`` and the
    ``/admin/sessions`` surface; ``model_resolver`` maps an admin
    ``"model"`` spec to something the registry accepts (the fleet
    replica's :func:`~veles_tpu_torch.fleet.replica.resolve_model_spec`).
    """

    def __init__(self, models=None, registry=None, port=0,
                 host="127.0.0.1", request_timeout=60.0,
                 enable_admin=False, model_resolver=None,
                 **scheduler_defaults):
        self.registry = registry or ModelRegistry(**scheduler_defaults)
        self.request_timeout = request_timeout
        self.enable_admin = bool(enable_admin)
        self.model_resolver = model_resolver
        self.started = time.time()
        self.draining = False
        if models:
            items = models.items() if hasattr(models, "items") else models
            for name, model in items:
                self.registry.add(name, model)
        handler = type("Handler", (_ServingHandler,),
                       {"server_ref": self,
                        "timeout": max(float(request_timeout), 1.0)})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        # in-flight handler threads are daemons; the graceful-drain
        # guarantee is the scheduler's (finish every queued request)
        self._httpd.block_on_close = False
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="veles-tpu-torch-serving")
        self._thread.start()

    @property
    def url(self):
        return "http://%s:%d" % (self.host, self.port)

    def add_model(self, name, model, **kwargs):
        return self.registry.add(name, model, **kwargs)

    def stop(self, drain=True):
        """Graceful shutdown: mark draining, finish every admitted
        request/sequence, then stop the HTTP front end.  The schedulers
        close FIRST, while the listener still answers, so a request
        arriving mid-drain gets a structured shed (429 + Retry-After on
        the generate route, 503 on the classifier route) instead of a
        connection reset."""
        self.draining = True
        self.registry.close(drain=drain)
        self._httpd.shutdown()
        self._httpd.server_close()
