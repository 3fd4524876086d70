"""The inference server: generate endpoint, backpressure, drain.

The decode half of ``veles_tpu/serving/server.py``: a stdlib
``ThreadingHTTPServer`` over a :class:`~.registry.ModelRegistry` of
decode models.  Per request: parse (400 on a malformed payload),
resolve the model (404), submit to its decode scheduler — which either
admits it or sheds it (:class:`SchedulerOverflow` -> 429 +
``Retry-After``) — and answer JSON.  A failure *inside* inference is a
500 with a generic body and a server-side log record; the traceback
never leaves the process.  Every answer carries ``X-Trace-Id`` (the
client's, or a fresh one).

Endpoints:
    POST /api/<model>/generate     autoregressive decode
    POST /api/generate             the same on the default model
    GET  /healthz                  liveness + model listing
    GET  /readyz                   503 until every model is warm
    GET  /metrics                  per-model decode metrics + stats
    GET  /models                   registry description
    GET  /api/<model>/kv           the KV pool's dump and integrity list

Shutdown is a graceful drain: stop accepting, finish every admitted and
queued sequence, then stop the HTTP front end.  The classifier route
(``POST /api/<model>``), the admin hot-load and the session-migration
endpoints are not ported yet.
"""

import logging
import threading
import time
import uuid
from concurrent.futures import TimeoutError as _FutureTimeout
from http.server import ThreadingHTTPServer

from ..httpjson import ClientError, JsonRequestHandler
from ..logger import events
from ..observability import trace as _trace
from .registry import ModelRegistry
from .scheduler import (DeadlineExpired, SchedulerClosed,
                        SchedulerOverflow, deadline_expired)

__all__ = ["InferenceServer"]

log = logging.getLogger("veles_tpu_torch.serving")


class _ServingHandler(JsonRequestHandler):
    server_ref = None           # class attr bound per InferenceServer
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    timeout = 60                # idle keep-alive reaper, per server

    def do_POST(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        if path == "/api/generate":
            self._generate(None)
        elif path.startswith("/api/") and path.endswith("/generate"):
            self._generate(path[len("/api/"):-len("/generate")])
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
            if entry is None:
                self.send_json(404, {"error": "no decode model %r"
                                     % name})
                return
            try:
                self.send_json(200, entry.scheduler.kv_dump())
            except Exception as exc:  # noqa: BLE001 — draining et al.
                self.send_json(503, {"error": str(exc)})
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

    def _result_timeout(self, deadline):
        """The configured request timeout, tightened to the request's
        remaining deadline."""
        timeout = self.server_ref.request_timeout
        if deadline is not None:
            timeout = min(timeout, max(deadline - time.monotonic(), 0.001))
        return timeout

    def _shed(self, entry, message, headers, close=False):
        """429 + a ``Retry-After`` computed from the scheduler's queue
        depth and its recent step latency."""
        retry = entry.scheduler.retry_after_s()
        headers = dict(headers, **{"Retry-After": str(int(retry))})
        if close:
            headers["Connection"] = "close"
        self.send_json(429, {"error": message, "model": entry.name,
                             "retry_after_s": int(retry)},
                       headers=headers)
        return 429

    # -- the decode path -----------------------------------------------------
    def _generate(self, name):
        with _trace.span_context(
                trace_id=self.headers.get("X-Trace-Id") or None) as ctx:
            t0 = time.perf_counter()
            status = self._generate_traced(name, ctx)
            events.span("serving.generate_request",
                        time.perf_counter() - t0,
                        model=name or "<default>", status=status)

    def _read_generate_payload(self):
        """{"prompt": [...], "max_new_tokens": n?} -> (prompt, n)."""
        payload = self.read_json_body()
        if not isinstance(payload, dict) or "prompt" not in payload:
            raise ClientError(
                "body must be {'prompt': [tokens], 'max_new_tokens': n?}")
        max_new = payload.get("max_new_tokens")
        if max_new is not None and not isinstance(max_new, int):
            raise ClientError("'max_new_tokens' must be an integer")
        return payload["prompt"], max_new

    def _generate_traced(self, name, ctx):
        """The request body; returns the HTTP status it answered."""
        srv = self.server_ref
        entry = srv.registry.resolve(name)
        trace_hdr = {"X-Trace-Id": ctx.trace_id}
        try:
            prompt, max_new = self._read_generate_payload()
            if entry is None:
                self.send_json(404, {
                    "error": "unknown model %r" % (name or "<default>"),
                    "models": srv.registry.names()}, headers=trace_hdr)
                return 404
            entry.scheduler.validate(
                prompt, max_new if max_new is not None
                else entry.scheduler.max_new_tokens)
        except (ValueError, TypeError) as e:     # ClientError included
            self.send_json(400, {"error": str(e)}, headers=trace_hdr)
            return 400
        deadline = self._deadline()
        if deadline_expired(deadline):
            entry.scheduler.metrics.record_expired()
            self.send_json(504, {"error": "deadline expired"},
                           headers=trace_hdr)
            return 504
        try:
            result = entry.generate(prompt, max_new,
                                    timeout=self._result_timeout(deadline),
                                    deadline=deadline)
        except SchedulerOverflow as e:
            return self._shed(entry, "server overloaded: %s" % e, trace_hdr)
        except SchedulerClosed:
            # drain: in-flight sequences finish, NEW submits shed with
            # retryable backpressure
            return self._shed(entry, "server is draining", trace_hdr,
                              close=True)
        except DeadlineExpired:
            self.send_json(504, {"error": "deadline expired"},
                           headers=trace_hdr)
            return 504
        except _FutureTimeout:
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
        self.send_json(200, dict(result, model=entry.name),
                       headers=trace_hdr)
        return 200


class InferenceServer:
    """Serve one or more decode models over HTTP.

    ``models``: optional mapping/iterable of (name, model) registered at
    construction; more can be added later through ``registry``.
    ``scheduler_defaults`` (``max_batch``, ``block_size``,
    ``max_prompt_len``, ``max_new_tokens``, ``num_blocks``,
    ``queue_limit``, ``prefix_caching``, ``prefill_chunk_tokens``,
    ``spec_depth``, ``kv_dtype``, ``device``) apply to every model
    registered through this server, under a model's own
    ``decode_defaults``; ``device`` defaults to the card.
    """

    def __init__(self, models=None, port=0, host="127.0.0.1",
                 request_timeout=60.0, **scheduler_defaults):
        self.registry = ModelRegistry(**scheduler_defaults)
        self.request_timeout = request_timeout
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

    def stop(self, drain=True):
        """Graceful shutdown: mark draining, finish every admitted
        request/sequence, then stop the HTTP front end.  The schedulers
        close FIRST, while the listener still answers, so a request
        arriving mid-drain gets 429 + Retry-After instead of a
        connection reset."""
        self.draining = True
        self.registry.close(drain=drain)
        self._httpd.shutdown()
        self._httpd.server_close()
