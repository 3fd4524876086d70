"""REST inference endpoint: POST a sample, get the model's answer.

The port of ``veles_tpu/restful_api.py``: the one-model facade over
:class:`veles_tpu_torch.serving.InferenceServer`.  It keeps the
reference's constructor, the ``/api`` protocol and the
``evaluation_transform`` hook, and routes everything through the
bucketed dynamic-batching scheduler: any batch size lands on a warm
bucket, malformed payloads get 400, server faults a traceback-free
500, overload 429.

Protocol:
    POST /api  {"input": [[...sample...], ...]}
    -> {"result": [...], "output": [[...]]}

The model runs on the card (``device``, default the card, raising
without one; ``device="cpu"`` runs the kernels' plain versions).  New
deployments should use :class:`~veles_tpu_torch.serving.InferenceServer`
directly (several models, ``/metrics``, ``/healthz``); this class stays
the one-model one-liner.
"""

import numpy

from .serving import InferenceServer

__all__ = ["RESTfulAPI"]


class RESTfulAPI:
    """Serve a trained model over HTTP (single-model facade)."""

    def __init__(self, model, port=0, evaluation_transform=None,
                 host="127.0.0.1", device=None, **scheduler_kwargs):
        """``model``: a StandardWorkflow (live forwards), a
        ``PackageLoader`` or the path of a package zip.  ``host``: the
        bind address; the loopback default keeps the model private,
        "0.0.0.0" serves off-host.  Extra kwargs tune the scheduler
        (``max_batch``, ``queue_limit``, ``workers``)."""
        self.server = InferenceServer(port=port, host=host, device=device,
                                      **scheduler_kwargs)
        try:
            self.server.registry.add("default", model,
                                     transform=evaluation_transform)
        except BaseException:
            self.server.stop(drain=False)
            raise
        self.host = host
        self.port = self.server.port

    @property
    def url(self):
        return self.server.url

    def infer(self, batch):
        """In-process inference through the batched path the HTTP
        handlers use; -> the (result, output array) tuple."""
        batch = numpy.asarray(batch, numpy.float32)
        if batch.ndim == 1:
            batch = batch[None]
        return self.server.registry.get("default").infer(batch)

    def stats(self):
        """The scheduler's stats (buckets, queue depth, kernel
        launches)."""
        return self.server.registry.get("default").scheduler.stats()

    def stop(self):
        self.server.stop()
