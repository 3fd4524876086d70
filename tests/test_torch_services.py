"""The port's ``RESTfulAPI`` facade against the JAX package's, on the CPU.

Mirrors ``tests/test_services.py::test_rest_api_*``: a trained MNIST net
(trained by the JAX package, carried into the port by
``convert.workflow_params_from_jax``) served by both facades from the
live workflow and from its exported package (the port's own export);
each answer of the port equals the JAX facade's on the same input within
1e-6 of its scale, with the same classes.  The JAX package's other
service tests (downloader, shell, stream loader, publisher) wait for
ROADMAP queue A item 11.
"""

import json
import urllib.error
import urllib.request

import numpy
import pytest

TOL = 1e-6


@pytest.fixture(scope="module")
def trained():
    """(the JAX workflow, trained one epoch; the port's, its weights)."""
    from veles_tpu import prng as jax_prng
    from veles_tpu.backends import Device as JaxDevice
    from veles_tpu.prng import RandomGenerator as JaxRG
    from veles_tpu.znicz.samples import mnist as jax_mnist
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.convert import workflow_params_from_jax
    from veles_tpu_torch.prng import RandomGenerator
    from veles_tpu_torch.znicz.samples import mnist
    loader = {"minibatch_size": 100, "n_train": 300, "n_valid": 100}
    decision = {"max_epochs": 1, "silent": True}
    jax_prng.get().seed(42)
    jwf = jax_mnist.create_workflow(
        loader=dict(loader, prng=JaxRG().seed(3)), decision=decision)
    jwf.initialize(device=JaxDevice(backend="cpu"))
    jwf.run()
    prng.get().seed(42)
    wf = mnist.create_workflow(
        loader=dict(loader, prng=RandomGenerator().seed(3)),
        decision=decision)
    wf.initialize(device=Device(backend="cpu"))
    workflow_params_from_jax(
        wf, [{k: numpy.array(v) for k, v in f.host_params.items()}
             for f in jwf.forwards])
    return jwf, wf


def _apis(jax_model, model, **kwargs):
    from veles_tpu.restful_api import RESTfulAPI as JaxAPI
    from veles_tpu_torch.restful_api import RESTfulAPI
    jax_api = JaxAPI(jax_model, port=0, **kwargs)
    try:
        api = RESTfulAPI(model, port=0, device="cpu", **kwargs)
    except BaseException:
        jax_api.stop()
        raise
    return jax_api, api


def _post(port, payload):
    req = urllib.request.Request(
        "http://127.0.0.1:%d/api" % port, json.dumps(payload).encode(),
        {"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=60).read())


def _same(got, want):
    """The port's answer is the JAX facade's: classes equal, each output
    row within TOL of its scale."""
    assert got["result"] == want["result"]
    g, w = (numpy.asarray(r["output"], numpy.float32) for r in (got, want))
    assert g.shape == w.shape
    scale = numpy.abs(w).max(axis=-1, keepdims=True)
    assert (numpy.abs(g - w) <= TOL * scale).all()


def test_rest_api_live_workflow(trained):
    jwf, wf = trained
    jax_api, api = _apis(jwf, wf)
    try:
        x = numpy.asarray(wf.loader.original_data.map_read()[:3]).tolist()
        resp = _post(api.port, {"input": x})
        assert len(resp["result"]) == 3
        assert all(0 <= r < 10 for r in resp["result"])
        assert numpy.asarray(resp["output"]).shape == (3, 10)
        _same(resp, _post(jax_api.port, {"input": x}))
        # a malformed request is a JSON error, not a dropped connection
        bad = urllib.request.Request(
            "http://127.0.0.1:%d/api" % api.port, b"[1,2]",
            {"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad)
        assert err.value.code == 400
        assert "error" in json.loads(err.value.read())
    finally:
        api.stop()
        jax_api.stop()


def test_rest_api_evaluation_transform(trained):
    """A non-trivial ``evaluation_transform`` shapes the answer: the top
    2 classes with their probabilities, the JAX facade's."""
    def top2(out):
        e = numpy.exp(out - out.max(axis=1, keepdims=True))
        p = e / e.sum(axis=1, keepdims=True)
        idx = numpy.argsort(-p, axis=1)[:, :2]
        return [{"classes": row.tolist(),
                 "probs": p[i, row].round(4).tolist()}
                for i, row in enumerate(idx)]

    jwf, wf = trained
    jax_api, api = _apis(jwf, wf, evaluation_transform=top2)
    try:
        x = numpy.asarray(wf.loader.original_data.map_read()[:2]).tolist()
        resp = _post(api.port, {"input": x})
        assert len(resp["result"]) == 2
        for entry in resp["result"]:
            assert len(entry["classes"]) == 2
            assert entry["probs"][0] >= entry["probs"][1] > 0
        raw = numpy.asarray(resp["output"])
        assert raw.shape == (2, 10)
        for i, entry in enumerate(resp["result"]):
            assert entry["classes"][0] == int(raw[i].argmax())
        want = _post(jax_api.port, {"input": x})
        assert [e["classes"] for e in resp["result"]] == \
            [e["classes"] for e in want["result"]]
    finally:
        api.stop()
        jax_api.stop()


def test_rest_api_off_host_bind(trained):
    """``host`` is honoured: bound to every interface, it still answers
    on loopback (the default stays loopback-private)."""
    jwf, wf = trained
    jax_api, api = _apis(jwf, wf, host="0.0.0.0")
    try:
        assert api.host == "0.0.0.0"
        x = numpy.asarray(wf.loader.original_data.map_read()[:1]).tolist()
        resp = _post(api.port, {"input": x})
        assert len(resp["result"]) == 1
        _same(resp, _post(jax_api.port, {"input": x}))
    finally:
        api.stop()
        jax_api.stop()


def test_rest_api_from_package(trained, tmp_path):
    """The facade over a package path: the port's own export of the
    workflow and the JAX package's export of its twin answer alike,
    and a one-sample input is served as a batch of one."""
    from veles_tpu.export import export_model as jax_export_model
    from veles_tpu_torch.export import PackageLoader, export_model
    jwf, wf = trained
    path, jax_path = str(tmp_path / "pkg.zip"), str(tmp_path / "jax.zip")
    export_model(wf, path)
    jax_export_model(jwf, jax_path)
    jax_api, api = _apis(jax_path, path)
    try:
        x = numpy.asarray(wf.loader.original_data.map_read()[0]).tolist()
        resp = _post(api.port, {"input": x})
        assert len(resp["result"]) == 1   # the one-sample convenience
        _same(resp, _post(jax_api.port, {"input": x}))
        result, out = api.infer(numpy.asarray(x))
        assert out.shape == (1, 10) and result == resp["result"]
    finally:
        api.stop()
        jax_api.stop()
    loaded = _apis(jax_path, PackageLoader(jax_path))
    try:
        x = numpy.asarray(wf.loader.original_data.map_read()[:4]).tolist()
        _same(_post(loaded[1].port, {"input": x}),
              _post(loaded[0].port, {"input": x}))
    finally:
        loaded[1].stop()
        loaded[0].stop()
