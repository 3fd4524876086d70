"""The port's step profiler, serving trace links and metrics exposition.

Mirrors, on ``device="cpu"``:

- ``tests/test_observability.py::test_step_profiler_breakdown_and_registry``
  with the port's MNIST workflow: ``Workflow.attach_profiler`` splits
  every step into data-wait / host / device, counts steps and examples,
  reports 0 recompiles (eager PyTorch), emits ``train.step`` spans and
  the ``veles_training_*`` series, and ``detach`` unwraps;
- ``test_serving_request_batch_trace_links``: the request span's id
  reappears in the ``serving.batch`` span's links, and the answer
  echoes ``X-Trace-Id``;
- the serving half of
  ``test_status_server_metrics_endpoint_merges_training_and_serving``
  over the port's registry (its status server is not ported: ROADMAP
  queue A item 11): training and serving series in one valid
  Prometheus exposition, the derived quantile and fill gauges;
- ``tests/test_metrics_hygiene.py`` over the port's registry after a
  decode server, a classifier server and a fleet router ran: one
  namespace, no family declared twice, the serving, fleet and flight
  families present, each documented in ``docs/COMPONENTS.md`` (the JAX
  package's names).
"""

import contextlib
import json
import os
import re
import urllib.request

import numpy
import pytest

from veles_tpu_torch.backends import Device
from veles_tpu_torch.config import root
from veles_tpu_torch.logger import events
from veles_tpu_torch.observability.registry import REGISTRY
from veles_tpu_torch.prng import RandomGenerator
from veles_tpu_torch.znicz.samples import mnist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME_RE = re.compile(r"^veles_[a-z0-9_]+$")
SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
    r' (?:[0-9.eE+-]+|\+Inf|-Inf|NaN)$')


@contextlib.contextmanager
def tracing_to(path):
    """Enable JSONL tracing to ``path`` and reset the global EventLog
    afterwards."""
    root.common.trace.enabled = True
    root.common.trace.file = str(path)
    try:
        yield events
    finally:
        root.common.trace.enabled = False
        root.common.trace.file = None
        events.reset()


def _make_wf():
    from veles_tpu_torch import prng
    prng.get().seed(42)
    wf = mnist.create_workflow(
        loader={"minibatch_size": 100, "n_train": 300, "n_valid": 100,
                "prng": RandomGenerator().seed(3)},
        decision={"max_epochs": 2, "silent": True})
    wf.initialize(device=Device(backend="cpu"))
    return wf


def test_step_profiler_breakdown_and_registry(tmp_path):
    path = str(tmp_path / "prof.jsonl")
    wf = _make_wf()
    with tracing_to(path):
        prof = wf.attach_profiler()
        assert wf.profiler is prof
        wf.run()
    summary = prof.summary()
    # 2 epochs x (3 train + 1 valid) minibatches of 100
    assert summary["steps"] == 8
    assert summary["examples"] == 800
    assert summary["recompiles"] == 0            # eager: nothing compiles
    assert summary["host_s"] > 0
    assert set(summary["phase_pct"]) == {"data_wait", "host", "device"}
    assert abs(sum(summary["phase_pct"].values()) - 100) < 1.0
    assert summary["examples_per_sec"] > 0
    assert "device_peak_memory_bytes" not in summary     # the CPU
    spans = [json.loads(x) for x in open(path)]
    assert spans[0]["name"] == "trace_start"
    steps = [r for r in spans if r["name"] == "train.step"]
    assert len(steps) == 8
    assert all({"data_wait_ms", "host_ms", "device_ms", "examples"}
               <= set(r["args"]) for r in steps)
    assert sum(r["args"]["examples"] for r in steps) == 800
    text = REGISTRY.render_prometheus()
    assert "# TYPE veles_training_steps_total counter" in text
    assert "veles_training_step_phase_seconds_bucket" in text
    assert 'phase="device"' in text
    prof.detach()
    before = prof.steps
    wf.fused_step.run()
    assert prof.steps == before
    assert "run" not in wf.fused_step.__dict__
    assert "run" not in wf.loader.__dict__


def test_serving_request_batch_trace_links(tmp_path):
    from veles_tpu_torch.serving import InferenceServer
    path = str(tmp_path / "serve.jsonl")
    with tracing_to(path):
        server = InferenceServer({"echo": lambda x: x * 2.0},
                                 max_batch=8, sample_shape=(3,),
                                 device="cpu")
        try:
            req = urllib.request.Request(
                server.url + "/api/echo",
                json.dumps({"input": [[1.0, 2.0, 3.0]]}).encode(),
                {"Content-Type": "application/json",
                 "X-Trace-Id": "feedfacecafef00d"})
            resp = urllib.request.urlopen(req, timeout=30)
            assert resp.headers["X-Trace-Id"] == "feedfacecafef00d"
            assert json.loads(resp.read())["output"] == [[2.0, 4.0, 6.0]]
        finally:
            server.stop()
    records = [json.loads(x) for x in open(path)]
    reqs = [r for r in records if r["name"] == "serving.request"]
    batches = [r for r in records if r["name"] == "serving.batch"]
    assert reqs and batches
    assert reqs[0]["args"]["trace_id"] == "feedfacecafef00d"
    assert reqs[0]["args"]["status"] == 200
    links = [s for b in batches for s in b["args"].get("links", ())]
    assert reqs[0]["args"]["span"] in links


def test_registry_exposition_merges_training_and_serving():
    from veles_tpu_torch.serving.metrics import ServingMetrics
    wf = _make_wf()
    wf.attach_profiler()
    wf.run()
    sm = ServingMetrics("promtest")
    sm.record_request(4, 0.002)
    sm.record_reject()
    sm.record_batch(8, 6, 0.001, 2)
    text = REGISTRY.render_prometheus()
    assert 'veles_training_steps_total{workflow="MnistSimple"}' in text
    assert 'veles_serving_requests_total{model="promtest"} 1' in text
    assert 'veles_serving_rejected_total{model="promtest"} 1' in text
    assert 'veles_serving_request_seconds_bucket{model="promtest"' in text
    assert 'veles_serving_latency_quantile_ms{model="promtest",' \
        'quantile="p99"} 2' in text
    assert 'veles_serving_batch_fill_ratio{model="promtest"} 0.75' in text
    for line in text.strip().splitlines():
        if line.startswith("#"):
            assert line.startswith("# HELP ") or \
                line.startswith("# TYPE "), line
        else:
            assert SAMPLE_RE.match(line), line
    snap = REGISTRY.snapshot()
    assert snap["veles_serving_requests_total"]["type"] == "counter"


# -- metric-name hygiene -------------------------------------------------------

def _families(text):
    fams = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            fams.setdefault(name, []).append(kind)
    return fams


def _sample_families(text):
    out = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name = line.split("{", 1)[0].split(" ", 1)[0]
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                name = name[:-len(suffix)]
        out.add(name)
    return out


@pytest.fixture(scope="module")
def exposition():
    """The port's registry exposition with a decode server, a classifier
    server and a fleet router registered and exercised."""
    from veles_tpu_torch.fleet.router import FleetRouter
    from veles_tpu_torch.serving import InferenceServer
    from veles_tpu_torch.znicz.samples.flagship import FlagshipDecodeModel
    model = FlagshipDecodeModel(stages=2, experts=2, d=16, heads=2,
                                hidden=32, vocab=32, seed=0, device="cpu")
    srv = InferenceServer({"flag": model, "echo": lambda x: x},
                          max_batch=4, block_size=4, max_prompt_len=8,
                          max_new_tokens=8, sample_shape=(2,),
                          device="cpu")
    router = FleetRouter(port=0)
    try:
        for route, payload in (("flag/generate", {"prompt": [1, 2],
                                                  "max_new_tokens": 2}),
                               ("echo", {"input": [[1.0, 2.0]]})):
            req = urllib.request.Request(
                "%s/api/%s" % (srv.url, route),
                json.dumps(payload).encode(),
                {"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=30).read()
        text = REGISTRY.render_prometheus()
    finally:
        router.stop()
        srv.stop()
    return text


def test_every_family_matches_namespace(exposition):
    fams = _families(exposition)
    assert fams, "exposition carried no TYPE lines"
    bad = sorted(n for n in fams if not NAME_RE.match(n))
    assert not bad, "non-conforming metric names: %s" % bad
    stray = sorted(n for n in _sample_families(exposition)
                   if not NAME_RE.match(n))
    assert not stray, "non-conforming sample names: %s" % stray


def test_serving_and_flight_families_present(exposition):
    fams = _families(exposition)
    for expected in ("veles_serving_decode_tokens_total",
                     "veles_serving_requests_total",
                     "veles_fleet_dispatch_total",
                     "veles_flight_requests_total",
                     "veles_flight_events_total"):
        assert expected in fams, expected


def test_no_duplicate_registrations(exposition):
    dups = {n: kinds for n, kinds in _families(exposition).items()
            if len(kinds) > 1}
    assert not dups, "families declared more than once: %s" % dups


def test_every_scraped_family_is_documented(exposition):
    with open(os.path.join(ROOT, "docs", "COMPONENTS.md")) as f:
        documented = set(re.findall(r"`(veles_[a-z0-9_]+)`", f.read()))
    assert documented
    undocumented = sorted(set(_families(exposition)) - documented)
    assert not undocumented, undocumented


def test_registry_snapshot_serializes(exposition):
    """The JSON snapshot of the same registry (``REGISTRY.snapshot``,
    new in the port) serializes as is."""
    doc = json.loads(json.dumps(REGISTRY.snapshot()))
    assert numpy.isfinite(
        [s.get("value", 0.0) or 0.0
         for fam in doc.values() for s in fam["series"]]).all()
