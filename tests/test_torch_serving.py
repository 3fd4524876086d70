"""The port's classifier route: BucketScheduler, the registry's
classifier entries and hot-load, ``POST /api/<model>``, held against
the JAX package.

Mirrors ``tests/test_serving.py`` on ``device="cpu"``, with the port's
MNIST workflow (its parameters carried over from the JAX workflow by
``convert.workflow_params_from_jax``) and with its exported package
(written by the port's ``export_model``; the JAX package's own for the
static-batch ladder):

- concurrent clients with mixed batch sizes get the JAX ``JaxModel``'s
  answers within 1e-6 of their scale, with ``precise_gemm`` 0 and 1;
  the scheduler warmed one runner per bucket and compiled nothing;
- a row's answer does not depend on the bucket it was padded into:
  every row of every bucket within 1e-6 of its scale of the row's own
  unpadded forward (the CPU's plain matmuls differ in the last bits
  between a 1-row and an n-row product), with ``precise_gemm`` 0 and 1;
- the 429 / 400 / 404 / 500 taxonomy, ``Retry-After`` from the backlog,
  graceful drain, the ``/readyz`` gate, keep-alive, several models and
  removal, the typed overflow, two dispatch workers;
- ``POST /admin/models`` is 404 unless ``enable_admin``, and hot-swaps
  versions under concurrent traffic with zero failed requests and every
  answer from the old or the new version, held by counts (no time
  bound: the JAX package's test of it fails under load);
- a package path, a ``PackageLoader``, ``ModelRegistry.load_package``
  and ``POST /admin/models`` serve packages (the JAX tests on
  ``mnist_package``: mixed batches, two models, the error taxonomy,
  keep-alive), the ``RESTfulAPI`` facade stays warm at any batch size,
  a static-batch package's ladder is the JAX scheduler's, and a
  ``TorchModel`` counts its dispatched batches' kernel launches (not
  the warmup's); a build cache (``cache=``) and a warmup manifest are
  taken;
- a 500's flight timeline is closed before the client has the answer,
  also under many concurrent failing requests (fault C8: the server
  used to write the answer first and close the timeline after).
"""

import collections
import http.client
import json
import threading
import time
import urllib.error
import urllib.request
import zipfile

import numpy
import pytest

from veles_tpu_torch.serving import (BucketScheduler, InferenceServer,
                                     SchedulerOverflow, bucket_sizes)
from veles_tpu_torch.serving.scheduler import OpaqueModel

MNIST_LOADER = {"minibatch_size": 100, "n_train": 400, "n_valid": 100}
#: the JAX test's input: 64 rows, mixed batch sizes from 8 clients
X = numpy.random.RandomState(7).uniform(-1, 1, (64, 784)).astype(
    numpy.float32)
TOL = 1e-6


def _layers(precise):
    return [{"type": "all2all_tanh",
             "->": {"output_sample_shape": 100, "precise_gemm": precise}},
            {"type": "softmax",
             "->": {"output_sample_shape": 10, "precise_gemm": precise}}]


def _jax_workflow(precise):
    from veles_tpu import prng
    from veles_tpu.backends import Device
    from veles_tpu.prng import RandomGenerator
    from veles_tpu.znicz.samples import mnist
    prng.get().seed(42)
    wf = mnist.create_workflow(
        loader=dict(MNIST_LOADER, prng=RandomGenerator().seed(3)),
        decision={"max_epochs": 1, "silent": True},
        layers=_layers(precise))
    wf.initialize(device=Device(backend="cpu"))
    return wf


def _port_workflow(precise, jax_wf=None):
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.convert import workflow_params_from_jax
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.znicz.samples import mnist
    prng.get().seed(42)
    wf = mnist.create_workflow(
        loader=dict(MNIST_LOADER, prng=RandomGenerator().seed(3)),
        decision={"max_epochs": 1, "silent": True},
        layers=_layers(precise))
    wf.initialize(device=Device(backend="cpu"))
    if jax_wf is not None:
        workflow_params_from_jax(
            wf, [{k: numpy.array(v) for k, v in f.host_params.items()}
                 for f in jax_wf.forwards])
    return wf


@pytest.fixture(scope="module")
def mnist_wf():
    """The port's MNIST workflow (untrained: serving does not care)."""
    return _port_workflow(0)


@pytest.fixture(scope="module")
def jax_mnist():
    return _jax_workflow(0)


@pytest.fixture(scope="module")
def mnist_package(jax_mnist, tmp_path_factory):
    """The port's ``export_model`` of its MNIST workflow, its weights
    carried from the JAX workflow (the JAX test's ``mnist_package``)."""
    from veles_tpu_torch.export import export_model
    path = str(tmp_path_factory.mktemp("serving") / "mnist_pkg.zip")
    export_model(_port_workflow(0, jax_mnist), path)
    return path


def _jax_answers(jwf, x):
    from veles_tpu.export.model import forward_fn as jax_forward_fn
    from veles_tpu.serving.scheduler import JaxModel
    run, _ = JaxModel(jax_forward_fn(jwf.forwards),
                      [f.params for f in jwf.forwards],
                      (784,)).compile(len(x))
    return numpy.asarray(run(x))


def _post(port, payload, route="/api", headers=None):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, route),
        json.dumps(payload).encode(),
        dict({"Content-Type": "application/json"}, **(headers or {})))
    return json.loads(urllib.request.urlopen(req, timeout=60).read())


def _post_err(port, payload, route="/api", with_headers=False):
    try:
        _post(port, payload, route)
    except urllib.error.HTTPError as e:
        if with_headers:
            return e.code, json.loads(e.read()), e.headers
        return e.code, json.loads(e.read())
    raise AssertionError("expected an HTTP error")


def _within(got, want, tol=TOL):
    """max |got - want| <= tol * max |want| (each row's own scale)."""
    got, want = numpy.asarray(got), numpy.asarray(want)
    scale = numpy.maximum(numpy.abs(want).max(axis=-1, keepdims=True),
                          1e-30)
    return bool((numpy.abs(got - want) <= tol * scale).all())


def test_bucket_sizes_ladder():
    assert bucket_sizes(1) == [1]
    assert bucket_sizes(8) == [1, 2, 4, 8]
    assert bucket_sizes(48) == [1, 2, 4, 8, 16, 32, 48]
    with pytest.raises(ValueError):
        bucket_sizes(0)


@pytest.mark.parametrize("precise", [0, 1])
def test_concurrent_mixed_batches_match_jax_model(precise):
    """8 threads, mixed batch sizes over HTTP: every answer equals the
    JAX package's ``JaxModel`` on the same parameters within 1e-6 of its
    scale; the scheduler warmed one runner per bucket of the ladder and
    compiled nothing."""
    from veles_tpu.export.model import forward_fn as jax_forward_fn
    from veles_tpu.serving.scheduler import JaxModel
    jwf = _jax_workflow(precise)
    run, _ = JaxModel(jax_forward_fn(jwf.forwards),
                      [f.params for f in jwf.forwards],
                      (784,)).compile(64)
    want = numpy.asarray(run(X))
    server = InferenceServer({"mnist": _port_workflow(precise, jwf)},
                             max_batch=16, device="cpu")
    sched = server.registry.get("mnist").scheduler
    assert sched.buckets == [1, 2, 4, 8, 16]
    warm = sched.stats()
    assert warm["executables"] == 5 and warm["device"] == "cpu"
    assert warm["compiles"] == warm["cache_hits"] == 0
    sizes = (1, 2, 3, 5, 8)
    failures = []

    def client(i):
        offset = (i * 11) % 32
        for k in range(6):
            bs = sizes[(i + k) % len(sizes)]
            lo = (offset + k * 3) % (64 - bs)
            try:
                resp = _post(server.port,
                             {"input": X[lo:lo + bs].tolist()},
                             "/api/mnist")
                got = numpy.asarray(resp["output"], numpy.float32)
                assert got.shape == (bs, 10)
                assert _within(got, want[lo:lo + bs]), \
                    "row mismatch at client %d req %d" % (i, k)
                assert resp["result"] == [int(r) for r in
                                          want[lo:lo + bs].argmax(axis=1)]
            except Exception as e:  # noqa: BLE001 — surfaced below
                failures.append("client %d: %r" % (i, e))
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert not failures, failures
        stats = sched.stats()
        assert stats["executables"] == 5
        assert stats["post_warmup_compiles"] == 0
        snap = sched.metrics.snapshot()
        assert snap["requests"] == 48
        assert snap["batches"] >= 1
        assert snap["batch_fill"] is not None
    finally:
        server.stop()


@pytest.mark.parametrize("precise", [0, 1])
def test_row_answer_independent_of_bucket(precise):
    """Each row, padded into any bucket of the ladder beside other rows
    and zero padding, answers within 1e-6 of its scale of its own
    unpadded forward."""
    wf = _port_workflow(precise)
    sched = BucketScheduler(wf, max_batch=64, name="rows", device="cpu")
    try:
        alone = numpy.concatenate([sched.submit(X[i:i + 1]).result(60)
                                   for i in range(len(X))])
        for bucket in sched.buckets:
            for rows in {bucket, max(1, bucket - 1)}:
                for lo in range(0, len(X) - rows + 1, rows):
                    got = sched.submit(X[lo:lo + rows]).result(60)
                    assert _within(got, alone[lo:lo + rows]), \
                        (bucket, rows, lo)
        assert sched.stats()["executables"] == len(sched.buckets)
    finally:
        sched.close()


def test_queue_overflow_sheds_429_and_recovers():
    def slow_model(x):
        time.sleep(0.05)
        return x[:, :1] * 2.0

    server = InferenceServer(queue_limit=2, max_batch=1, device="cpu")
    server.registry.add("slow", slow_model, sample_shape=(4,))
    codes, bodies = [], []
    lock = threading.Lock()

    def client():
        try:
            _post(server.port, {"input": [[1.0, 2.0, 3.0, 4.0]]},
                  "/api/slow")
            with lock:
                codes.append(200)
        except urllib.error.HTTPError as e:
            with lock:
                codes.append(e.code)
                bodies.append((dict(e.headers), json.loads(e.read())))
    try:
        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert codes.count(200) >= 2
        assert 429 in codes
        assert set(codes) <= {200, 429}
        headers, body = bodies[0]
        assert "overloaded" in body["error"]
        assert headers.get("Retry-After") == "1"
        rejected = server.registry.get(
            "slow").scheduler.metrics.snapshot()["rejected"]
        assert rejected == codes.count(429)
        resp = _post(server.port, {"input": [[1.0, 2.0, 3.0, 4.0]]},
                     "/api/slow")
        assert resp["output"] == [[2.0]]
    finally:
        server.stop()


def test_registry_serves_two_models(mnist_wf):
    """One server, two named models: routed by /api/<name>, listed by
    /healthz, measured separately by /metrics; bare /api is the default
    (first-registered) model; removal takes a model out of routing."""
    server = InferenceServer({"mnist": mnist_wf}, max_batch=8,
                             device="cpu")
    server.registry.add("double", lambda x: x * 2.0, sample_shape=(3,))
    try:
        out = _post(server.port, {"input": [[1.0, 2.0, 3.0]]},
                    "/api/double")
        assert out["output"] == [[2.0, 4.0, 6.0]]
        resp = _post(server.port, {"input": numpy.zeros((2, 784)).tolist()},
                     "/api/mnist")
        assert numpy.asarray(resp["output"]).shape == (2, 10)
        resp2 = _post(server.port, {"input": numpy.zeros((1, 784)).tolist()})
        assert numpy.asarray(resp2["output"]).shape == (1, 10)
        health = json.loads(urllib.request.urlopen(
            server.url + "/healthz").read())
        assert health["status"] == "ok"
        assert sorted(health["models"]) == ["double", "mnist"]
        assert health["default_model"] == "mnist"
        metrics = json.loads(urllib.request.urlopen(
            server.url + "/metrics").read())
        assert metrics["mnist"]["requests"] == 2
        assert metrics["double"]["requests"] == 1
        assert metrics["double"]["latency"]["p99_ms"] is not None
        models = json.loads(urllib.request.urlopen(
            server.url + "/models").read())
        assert models["mnist"]["sample_shape"] == [784]
        assert models["mnist"]["device"] == "cpu"
        assert server.registry.remove("double")
        code, body = _post_err(server.port, {"input": [[1.0, 2.0, 3.0]]},
                               "/api/double")
        assert code == 404 and "unknown model" in body["error"]
    finally:
        server.stop()


def test_error_taxonomy_400_vs_404_vs_500(mnist_wf):
    def broken(x):
        raise RuntimeError("secret internal state: 0xdeadbeef")

    server = InferenceServer({"mnist": mnist_wf}, max_batch=4,
                             device="cpu")
    server.registry.add("broken", broken, sample_shape=(2,))
    try:
        req = urllib.request.Request(
            server.url + "/api/mnist", b"{nope",
            {"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req)
        assert err.value.code == 400
        assert "JSON" in json.loads(err.value.read())["error"]
        code, body = _post_err(server.port, {"x": [1]}, "/api/mnist")
        assert code == 400 and "input" in body["error"]
        code, body = _post_err(server.port, {"input": [[1, 2], [3]]},
                               "/api/mnist")
        assert code == 400
        code, body = _post_err(server.port, {"input": [[1.0, 2.0]]},
                               "/api/mnist")
        assert code == 400 and "shape" in body["error"]
        code, body = _post_err(server.port, {"input": [[1.0, 2.0]]},
                               "/api/nosuch")
        assert code == 404 and body["models"]
        code, body, headers = _post_err(server.port, {"input": [[1.0, 2.0]]},
                                        "/api/broken", with_headers=True)
        assert code == 500
        assert body["error"] == "internal inference error"
        assert body["id"]
        text = json.dumps(body)
        assert "secret internal state" not in text
        assert "Traceback" not in text
        assert "0xdeadbeef" not in text
        # a 500 is a flight anomaly of the request's timeline, closed
        # before the answer left (picked by the trace id the 500 carries:
        # a model-less timeline cannot stand in for it)
        from veles_tpu_torch.observability.flight import RECORDER
        tl = RECORDER.snapshot(trace_id=headers["X-Trace-Id"])[0]
        assert tl["meta"]["model"] == "broken"
        assert tl["status"] == "error_500"
        assert "error" in tl["anomalies"]
    finally:
        server.stop()


def test_500_timelines_close_before_the_answer_under_concurrency():
    """Many failing requests from several threads: each one's flight
    timeline is closed with ``error_500`` the moment its client has the
    answer (the server closes it before writing the response)."""
    from veles_tpu_torch.observability.flight import RECORDER

    def broken(x):
        time.sleep(0.002)
        raise RuntimeError("boom")

    server = InferenceServer(device="cpu", max_batch=4, workers=2)
    server.registry.add("broken", broken, sample_shape=(2,))
    seen, errors = [], []

    def client(i):
        try:
            for j in range(6):
                tid = "c8%02d%02d" % (i, j)
                try:
                    _post(server.port, {"input": [[1.0, 2.0]]},
                          "/api/broken", headers={"X-Trace-Id": tid})
                    errors.append("%s answered 200" % tid)
                except urllib.error.HTTPError as e:
                    # read the ring at once, before anything else runs
                    tl = RECORDER.snapshot(trace_id=tid)
                    seen.append((tid, e.code, tl[0] if tl else None))
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(repr(exc))

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        server.stop()
    assert not errors
    assert len(seen) == 48
    for tid, code, tl in seen:
        assert code == 500, tid
        assert tl is not None, tid
        assert tl["status"] == "error_500", (tid, tl["status"])
        assert "error" in tl["anomalies"], tid
        kinds = [e["kind"] for e in tl["events"]]
        assert "request.done" in kinds, tid


def test_graceful_drain_completes_inflight():
    def slowish(x):
        time.sleep(0.02)
        return x

    sched = BucketScheduler(slowish, max_batch=1, queue_limit=16,
                            sample_shape=(2,), name="drain", device="cpu")
    futures = [sched.submit(numpy.ones((1, 2), numpy.float32))
               for _ in range(6)]
    sched.close(drain=True)
    for f in futures:
        assert f.result(timeout=5).shape == (1, 2)
    with pytest.raises(Exception):
        sched.submit(numpy.ones((1, 2), numpy.float32))


def test_scheduler_overflow_is_typed():
    gate = threading.Event()

    def stuck(x):
        gate.wait(10)
        return x

    sched = BucketScheduler(stuck, max_batch=1, queue_limit=2,
                            sample_shape=(1,), name="of", device="cpu")
    try:
        fs = []
        with pytest.raises(SchedulerOverflow):
            for _ in range(6):
                fs.append(sched.submit(numpy.ones((1, 1), numpy.float32)))
        assert len(fs) == 2
        gate.set()
        for f in fs:
            f.result(timeout=5)
    finally:
        gate.set()
        sched.close(drain=True)


def test_multi_worker_dispatch_loop():
    def slowish(x):
        time.sleep(0.03)
        return x + 1.0

    sched = BucketScheduler(slowish, max_batch=2, queue_limit=32,
                            workers=2, sample_shape=(2,), name="mw",
                            device="cpu")
    try:
        assert sched.stats()["workers"] == 2
        futures = [sched.submit(numpy.full((1, 2), float(i), numpy.float32))
                   for i in range(8)]
        outs = [f.result(timeout=5) for f in futures]
        for i, out in enumerate(outs):
            assert numpy.allclose(out, i + 1.0)
    finally:
        sched.close(drain=True)


def test_http11_keepalive_connection_reuse(mnist_wf):
    server = InferenceServer({"mnist": mnist_wf}, max_batch=4,
                             device="cpu")
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port)
        body = json.dumps({"input": numpy.zeros((1, 784)).tolist()}).encode()
        for _ in range(5):
            conn.request("POST", "/api", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = json.loads(resp.read())
            assert resp.status == 200 and len(data["result"]) == 1
        conn.close()
    finally:
        server.stop()


def test_readyz_gates_on_warmup_ladder():
    """/readyz is 503 while no model exists, while a ladder warms and
    while draining; /healthz stays 200 "ok" throughout."""
    gate = threading.Event()

    class GatedModel(OpaqueModel):
        """Warms bucket 1 at once, blocks the tail on ``gate``."""

        def compile(self, bucket):
            if bucket > 1:
                gate.wait(10)
            return self._fn, None

    def ready_status(port):
        try:
            resp = urllib.request.urlopen(
                "http://127.0.0.1:%d/readyz" % port, timeout=5)
            return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    server = InferenceServer(device="cpu")
    try:
        status, body = ready_status(server.port)
        assert status == 503 and body["ready"] is False
        server.registry.add(
            "g", GatedModel(lambda x: x, sample_shape=(4,)),
            max_batch=4, background_warmup=True)
        status, body = ready_status(server.port)
        assert status == 503 and body["models"] == {"g": False}
        health = json.loads(urllib.request.urlopen(
            server.url + "/healthz").read())
        assert health["status"] == "ok"
        gate.set()
        assert server.registry.get("g").scheduler.join_warmup(10)
        status, body = ready_status(server.port)
        assert status == 200 and body["ready"] is True
        assert body["load"]["g"]["queue_depth"] == 0
        server.draining = True
        assert ready_status(server.port)[0] == 503
        server.draining = False
        assert ready_status(server.port)[0] == 200
    finally:
        gate.set()
        server.stop()


def test_a_bucket_that_fails_to_warm_fails_the_model():
    """A bucket whose warm run raises fails the model instead of
    dropping out of the ladder (on the card a dropped bucket would hide
    a kernel that fails at one row count); a model that warms keeps the
    whole power-of-two ladder."""
    class Picky(OpaqueModel):
        def compile(self, bucket):
            if bucket > 2:
                raise RuntimeError("no kernel for %d rows" % bucket)
            return self._fn, None

    with pytest.raises(RuntimeError, match="4 rows"):
        BucketScheduler(Picky(lambda x: x, sample_shape=(2,)),
                        max_batch=4, name="picky", device="cpu")
    sched = BucketScheduler(lambda x: x, max_batch=8, sample_shape=(2,),
                            name="whole", device="cpu")
    try:
        stats = sched.stats()
        assert stats["buckets"] == bucket_sizes(8) == [1, 2, 4, 8]
        assert stats["executables"] == 4
    finally:
        sched.close()


def test_retry_after_computed_from_backlog():
    gate = threading.Event()

    def held(x):
        gate.wait(10)
        return x

    sched = BucketScheduler(lambda x: x, max_batch=1, queue_limit=64,
                            sample_shape=(4,), name="ra", device="cpu")
    try:
        assert sched.retry_after_s() == 1
        for _ in range(6):
            sched.metrics.batch_latency.record(2.0)
        sched._depth = 10
        assert sched.retry_after_s() == 20
        sched._depth = 1000
        assert sched.retry_after_s() == 30
        sched._depth = 0
    finally:
        sched.close()

    server = InferenceServer(max_batch=1, queue_limit=3, device="cpu")
    server.registry.add("slow", held, sample_shape=(4,))
    entry = server.registry.get("slow")
    try:
        for _ in range(4):
            entry.scheduler.metrics.batch_latency.record(1.0)
        futures = [entry.scheduler.submit(numpy.ones((1, 4), numpy.float32))
                   for _ in range(3)]
        code, headers, body = None, None, None
        try:
            _post(server.port, {"input": [[1.0, 2.0, 3.0, 4.0]]},
                  "/api/slow")
        except urllib.error.HTTPError as e:
            code = e.code
            headers, body = dict(e.headers), json.loads(e.read())
        assert code == 429
        assert headers.get("Retry-After") == "3"
        assert body["retry_after_s"] == 3
        gate.set()
        for f in futures:
            f.result(timeout=10)
    finally:
        gate.set()
        server.stop()


def test_hot_swap_under_concurrent_traffic():
    """Registry hot-loads under load: six clients post back to back
    while the version flips v1 -> v2 -> v1 -> v2; each swap waits (by
    count, no clock) until the new version has answered.  Zero failed
    requests, every answer one version's, both versions seen, and the
    last version serves."""
    def v1(x):
        return x * 0 + 1.0

    def v2(x):
        return x * 0 + 2.0

    server = InferenceServer(max_batch=4, device="cpu")
    server.registry.add("hot", v1, sample_shape=(4,), version="v1")
    failures, answers = [], collections.Counter()
    lock = threading.Lock()
    stop = threading.Event()

    def client(i):
        while not stop.is_set():
            try:
                resp = _post(server.port, {"input": [[0.0] * 4]},
                             "/api/hot")
                row = resp["output"][0]
                with lock:
                    if row not in ([1.0] * 4, [2.0] * 4):
                        failures.append("torn read: %r" % (row,))
                    answers[row[0]] += 1
            except Exception as e:  # noqa: BLE001 — counted below
                with lock:
                    failures.append("client %d: %r" % (i, e))

    def wait_for(value, more):
        with lock:
            target = answers[value] + more
        end = time.monotonic() + 60
        while time.monotonic() < end:
            with lock:
                if answers[value] >= target:
                    return
            stop.wait(0.005)
        raise AssertionError("version %r never answered" % value)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(6)]
    try:
        for t in threads:
            t.start()
        wait_for(1.0, 5)
        for model, version, value in ((v2, "v2", 2.0), (v1, "v1", 1.0),
                                      (v2, "v2", 2.0)):
            server.registry.add("hot", model, sample_shape=(4,),
                                version=version)
            wait_for(value, 5)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
    try:
        assert not any(t.is_alive() for t in threads)
        assert not failures, failures[:5]
        assert set(answers) == {1.0, 2.0}
        resp = _post(server.port, {"input": [[0.0] * 4]}, "/api/hot")
        assert resp["output"][0] == [2.0] * 4
        assert server.registry.get("hot").version == "v2"
    finally:
        server.stop()


def test_admin_hot_load_endpoint_gated(mnist_package):
    from veles_tpu_torch.fleet import resolve_model_spec

    plain = InferenceServer(device="cpu")
    try:
        code, body = _post_err(plain.port,
                               {"name": "m", "model": "sleep:0.001:4"},
                               "/admin/models")
        assert code == 404
    finally:
        plain.stop()

    server = InferenceServer(enable_admin=True, device="cpu",
                             model_resolver=resolve_model_spec)
    try:
        out = _post(server.port,
                    {"name": "m", "model": "sleep:0.001:4",
                     "version": "v1"}, "/admin/models")
        assert out == {"model": "m", "version": "v1", "ready": True}
        resp = _post(server.port, {"input": [[1.0, 2.0, 3.0, 4.0]]},
                     "/api/m")
        assert resp["output"] == [[1.0, 2.0, 3.0, 4.0]]
        described = json.loads(urllib.request.urlopen(
            server.url + "/models").read())
        assert described["m"]["version"] == "v1"
        code, body = _post_err(server.port, {"name": "m"}, "/admin/models")
        assert code == 400
        # a package spec loads through the registry (it was refused
        # until packages were ported); a missing one fails the load only
        code, body = _post_err(server.port,
                               {"name": "p", "model": "/no/pkg.zip"},
                               "/admin/models")
        assert code == 500 and "hot-load failed" in body["error"]
        out = _post(server.port, {"name": "p", "model": mnist_package,
                                  "version": "pkg"}, "/admin/models")
        assert out == {"model": "p", "version": "pkg", "ready": True}
        resp = _post(server.port, {"input": X[:3].tolist()}, "/api/p")
        assert numpy.asarray(resp["output"]).shape == (3, 10)
    finally:
        server.stop()


def test_decode_and_classifier_routes_stay_apart(mnist_wf):
    """A decode model answers 400 on the classifier route and a
    classifier 400 on the generate route; one server hosts both."""
    from veles_tpu_torch.serving import ToyDecodeModel
    server = InferenceServer({"mnist": mnist_wf,
                              "toy": ToyDecodeModel(vocab=31,
                                                    device="cpu")},
                             max_batch=4, max_prompt_len=8,
                             max_new_tokens=4, device="cpu")
    try:
        code, body = _post_err(server.port, {"input": [[1.0]]}, "/api/toy")
        assert code == 400 and "generate" in body["error"]
        code, body = _post_err(server.port, {"prompt": [1, 2]},
                               "/api/mnist/generate")
        assert code == 400 and "not a decode model" in body["error"]
        out = _post(server.port, {"prompt": [1, 2], "max_new_tokens": 3},
                    "/api/toy/generate")
        assert out["tokens"] == ToyDecodeModel(
            vocab=31, device="cpu").generate_reference([1, 2], 3)
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(server.url + "/api/mnist/kv")
        assert err.value.code == 404
    finally:
        server.stop()


def test_unported_paths_refused_by_name(mnist_package, tmp_path):
    """Packages were refused naming ROADMAP queue A item 8 until they
    were ported: now a path and ``load_package`` serve one, a missing
    path is a FileNotFoundError.  A package holding ``ResizableAll2All``
    was refused naming item 9 until it was ported: now it serves (a
    linear All2All); one holding a unit whose structure a package does
    not record (``LSTM``) is refused saying so."""
    from veles_tpu_torch.serving import ModelRegistry
    with pytest.raises(FileNotFoundError):
        BucketScheduler("/no/pkg.zip", device="cpu")
    registry = ModelRegistry(device="cpu", max_batch=4)
    try:
        entry = registry.load_package("p", mnist_package)
        assert entry.scheduler.buckets == [1, 2, 4]
        assert entry.infer(X[:2])[1].shape == (2, 10)
        with pytest.raises(FileNotFoundError):
            registry.load_package("q", "/no/pkg.zip")
    finally:
        registry.close()
    with zipfile.ZipFile(mnist_package) as zf:
        files = {n: zf.read(n) for n in zf.namelist()}
    meta = json.loads(files["model.json"])

    def package_of(cls):
        meta["forwards"][0]["class"] = cls
        files["model.json"] = json.dumps(meta)
        path = str(tmp_path / ("%s.zip" % cls))
        with zipfile.ZipFile(path, "w") as zf:
            for name, data in files.items():
                zf.writestr(name, data)
        return path
    want = BucketScheduler(package_of("All2All"), device="cpu")
    got = BucketScheduler(package_of("ResizableAll2All"), device="cpu")
    try:
        out = got.infer(X[:2])
        assert out.shape == (2, 10)
        assert numpy.array_equal(out, want.infer(X[:2]))
    finally:
        got.close()
        want.close()
    with pytest.raises(NotImplementedError,
                       match="LSTM cannot be served: the JAX package "
                       "records no configuration"):
        BucketScheduler(package_of("LSTM"), device="cpu")


def test_cache_and_manifest_are_taken(mnist_wf, tmp_path):
    """``cache=`` / ``manifest=`` (a refusal until the build cache was
    ported): the scheduler records its warmed buckets in the manifest
    and a restart warms them first; on the CPU nothing is built."""
    from veles_tpu_torch.compilecache import CompileCache
    cache = CompileCache(str(tmp_path / "cc"))
    s = BucketScheduler(mnist_wf, max_batch=8, name="cached",
                        cache=cache, device="cpu")
    try:
        assert s.stats()["compiles"] == 0
        assert cache.manifest.buckets("cached") == [1, 2, 4, 8]
    finally:
        s.close()
    cache.manifest.forget("cached")
    cache.manifest.record("cached", 4)
    again = BucketScheduler(mnist_wf, max_batch=8, name="cached",
                            cache=cache, warmup=False, device="cpu")
    try:
        assert again._warmup_order() == [4, 1, 2, 8]
    finally:
        again.close()


# -- exported packages --------------------------------------------------------

def test_package_concurrent_mixed_batches_one_executable_per_bucket(
        jax_mnist, mnist_package):
    """test_serving.py's mixed-batch test on the package: 8 threads over
    HTTP, every answer the JAX ``JaxModel``'s on the same weights within
    1e-6 of its scale, one warm runner per bucket, nothing compiled, and
    no hand kernel counted on the CPU."""
    want = _jax_answers(jax_mnist, X)
    server = InferenceServer({"mnist": mnist_package}, max_batch=16,
                             device="cpu")
    sched = server.registry.get("mnist").scheduler
    assert sched.buckets == [1, 2, 4, 8, 16]
    warm = sched.stats()
    assert warm["executables"] == 5
    assert warm["compiles"] == warm["warmup_compiles"] == 0
    sizes = (1, 2, 3, 5, 8)
    failures = []

    def client(i):
        offset = (i * 11) % 32
        for k in range(6):
            bs = sizes[(i + k) % len(sizes)]
            lo = (offset + k * 3) % (64 - bs)
            try:
                resp = _post(server.port,
                             {"input": X[lo:lo + bs].tolist()},
                             "/api/mnist")
                got = numpy.asarray(resp["output"], numpy.float32)
                assert got.shape == (bs, 10)
                assert _within(got, want[lo:lo + bs])
                assert resp["result"] == [int(r) for r in
                                          want[lo:lo + bs].argmax(axis=1)]
            except Exception as e:  # noqa: BLE001 — surfaced below
                failures.append("client %d: %r" % (i, e))
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert not failures, failures
        stats = sched.stats()
        assert stats["post_warmup_compiles"] == 0
        assert stats["compiles"] == 0
        assert stats["jit_cache_size"] == 0
        assert set(stats["kernel_launches"].values()) == {0}
        snap = sched.metrics.snapshot()
        assert snap["requests"] == 48
        assert snap["batches"] >= 1
        assert snap["batch_fill"] is not None
    finally:
        server.stop()


def test_package_registry_serves_two_models(mnist_package):
    server = InferenceServer({"mnist": mnist_package}, max_batch=8,
                             device="cpu")
    server.registry.add("double", lambda x: x * 2.0, sample_shape=(3,))
    try:
        out = _post(server.port, {"input": [[1.0, 2.0, 3.0]]},
                    "/api/double")
        assert out["output"] == [[2.0, 4.0, 6.0]]
        resp = _post(server.port, {"input": numpy.zeros((2, 784)).tolist()},
                     "/api/mnist")
        assert numpy.asarray(resp["output"]).shape == (2, 10)
        resp2 = _post(server.port, {"input": numpy.zeros((1, 784)).tolist()})
        assert numpy.asarray(resp2["output"]).shape == (1, 10)
        health = json.loads(urllib.request.urlopen(
            server.url + "/healthz").read())
        assert sorted(health["models"]) == ["double", "mnist"]
        assert health["default_model"] == "mnist"
        metrics = json.loads(urllib.request.urlopen(
            server.url + "/metrics").read())
        assert metrics["mnist"]["requests"] == 2
        assert metrics["double"]["requests"] == 1
        assert metrics["mnist"]["kernel_launches"]["precise_matmul"] == 0
        models = json.loads(urllib.request.urlopen(
            server.url + "/models").read())
        assert models["mnist"]["sample_shape"] == [784]
        assert models["mnist"]["source"] == "str"
        assert server.registry.remove("double")
        code, body = _post_err(server.port, {"input": [[1.0, 2.0, 3.0]]},
                               "/api/double")
        assert code == 404 and "unknown model" in body["error"]
    finally:
        server.stop()


def test_package_error_taxonomy_400_vs_404_vs_500(mnist_package):
    def broken(x):
        raise RuntimeError("secret internal state: 0xdeadbeef")

    server = InferenceServer({"mnist": mnist_package}, max_batch=4,
                             device="cpu")
    server.registry.add("broken", broken, sample_shape=(2,))
    try:
        req = urllib.request.Request(
            server.url + "/api/mnist", b"{nope",
            {"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req)
        assert err.value.code == 400
        assert "JSON" in json.loads(err.value.read())["error"]
        code, body = _post_err(server.port, {"x": [1]}, "/api/mnist")
        assert code == 400 and "input" in body["error"]
        code, body = _post_err(server.port, {"input": [[1, 2], [3]]},
                               "/api/mnist")
        assert code == 400
        code, body = _post_err(server.port, {"input": [[1.0, 2.0]]},
                               "/api/mnist")
        assert code == 400 and "shape" in body["error"]
        code, body = _post_err(server.port, {"input": [[1.0, 2.0]]},
                               "/api/nosuch")
        assert code == 404 and body["models"]
        code, body = _post_err(server.port, {"input": [[1.0, 2.0]]},
                               "/api/broken")
        assert code == 500
        assert body["error"] == "internal inference error"
        text = json.dumps(body)
        assert "secret internal state" not in text
        assert "Traceback" not in text
    finally:
        server.stop()


def test_package_http11_keepalive_connection_reuse(mnist_package):
    server = InferenceServer({"mnist": mnist_package}, max_batch=4,
                             device="cpu")
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port)
        body = json.dumps(
            {"input": numpy.zeros((1, 784)).tolist()}).encode()
        for _ in range(5):
            conn.request("POST", "/api", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = json.loads(resp.read())
            assert resp.status == 200 and len(data["result"]) == 1
        conn.close()
    finally:
        server.stop()


def test_facade_any_batch_size_stays_warm(mnist_wf):
    """The RESTfulAPI facade routes through the bucketed scheduler: mixed
    client batch sizes land on the warm ladder and nothing is built
    after the warmup."""
    from veles_tpu_torch.restful_api import RESTfulAPI
    api = RESTfulAPI(mnist_wf, port=0, max_batch=8, device="cpu")
    try:
        warm = api.stats()["compiles"]
        for bs in (1, 3, 2, 5, 8, 4):
            resp = _post(api.port,
                         {"input": numpy.zeros((bs, 784)).tolist()})
            assert numpy.asarray(resp["output"]).shape == (bs, 10)
        stats = api.stats()
        assert stats["compiles"] == warm
        assert stats["post_warmup_compiles"] == 0
        assert stats["jit_cache_size"] == 0
        assert stats["executables"] == len(stats["buckets"]) == 4
        result, out = api.infer(numpy.zeros(784))
        assert out.shape == (1, 10)
    finally:
        api.stop()


@pytest.mark.parametrize("batch,max_batch", [(4, 16), (8, 8), (3, 16),
                                             (4, 2)])
def test_static_batch_package_ladder_equals_the_jax_scheduler(
        jax_mnist, tmp_path, batch, max_batch):
    """A static-batch package (``batch`` an int) serves the ladder the
    JAX scheduler keeps for the same package (it drops every bucket the
    artifact cannot take; the port states that ladder from the start),
    or fails to load as the JAX scheduler does when no bucket is left;
    its answers, short batches padded to the one bucket, are the JAX
    package's."""
    from veles_tpu.export import export_model as jax_export_model
    from veles_tpu.serving import BucketScheduler as JaxScheduler
    path = str(tmp_path / "static.zip")
    jax_export_model(jax_mnist, path, batch=batch)
    try:
        jax_sched = JaxScheduler(path, max_batch=max_batch, name="s")
    except ValueError:
        with pytest.raises(ValueError, match="ladder"):
            BucketScheduler(path, max_batch=max_batch, name="s",
                            device="cpu")
        return
    sched = BucketScheduler(path, max_batch=max_batch, name="s",
                            device="cpu")
    try:
        assert sched.buckets == jax_sched.buckets == [batch]
        assert sched.max_batch == jax_sched.max_batch == batch
        rows = X[:batch + 1]
        got = sched.infer(rows, timeout=60)
        want = jax_sched.infer(rows, timeout=60)
        assert got.shape == want.shape == (batch + 1, 10)
        assert numpy.abs(got - want).max() <= 1e-5
    finally:
        sched.close()
        jax_sched.close()


def test_kernel_launches_count_dispatched_batches_only():
    """``stats()["kernel_launches"]`` counts the wrappers' launches of
    the dispatched batches, not the warmup's (a stand-in forward bumps
    K4's counter as each launch would)."""
    import torch
    from veles_tpu_torch.serving.scheduler import TorchModel
    from veles_tpu_torch.znicz import gemm

    def fn(params, x):
        gemm.precise_matmul.launches += 2
        return x @ params["w"]

    model = TorchModel(fn, {"w": torch.ones(3, 2)}, (3,), device="cpu")
    sched = BucketScheduler(model, max_batch=4, name="count",
                            device="cpu")
    try:
        assert sched.stats()["kernel_launches"]["precise_matmul"] == 0
        for rows in (1, 3, 4, 2):
            sched.infer(numpy.ones((rows, 3), numpy.float32), timeout=60)
        batches = sched.metrics.snapshot()["batches"]
        assert batches == 4
        assert sched.stats()["kernel_launches"]["precise_matmul"] == \
            2 * batches
    finally:
        sched.close()
