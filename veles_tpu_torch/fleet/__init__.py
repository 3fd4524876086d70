"""veles_tpu_torch.fleet — serving fleet: router + replica lifecycle.

The port of ``veles_tpu/fleet``, the composition layer over
:mod:`veles_tpu_torch.serving`: N single-process serving replicas
(subprocesses on one host, or processes across hosts) behind one front
router, with zero-downtime rolling model updates.  Every replica runs
its models on the card unless the fleet is given ``device="cpu"``
(``--device cpu`` on the command lines), which the CPU tests use.

- :mod:`.router` — :class:`FleetRouter`: least-loaded dispatch on
  per-replica health/backpressure signals (queue depth, in-flight,
  KV occupancy), exactly-once retry of idempotent requests on a dead
  replica, merged ``/metrics`` ``/healthz`` ``/readyz`` ``/models``;
- :mod:`.supervisor` — :class:`ReplicaSupervisor`: replica spawn
  (the trace context, the flight-record and KV-tier directories
  planted in each replica's environment), crash respawn on the shared
  :class:`~veles_tpu_torch.distributed.RestartBackoff` policy, and
  :meth:`~ReplicaSupervisor.rolling_update`; :class:`Fleet` composes
  both;
- :mod:`.replica` — the replica process entry
  (``python -m veles_tpu_torch.fleet.replica``): a stock
  :class:`~veles_tpu_torch.serving.InferenceServer` with the admin
  hot-load endpoint on;
- :mod:`.chaos` — :class:`FaultPlan`: deterministic, scripted fault
  injection (refuse / black-hole / truncate / latency / SIGKILL /
  SIGSTOP) installed inside replica subprocesses via
  ``VELES_FAULT_PLAN`` — what the failover guarantees are tested
  against.

Quickstart::

    from veles_tpu_torch.fleet import Fleet
    fleet = Fleet({"m": "sleep:0.002:4",
                   "toy": "toydecode:vocab=64"}, replicas=2).start()
    # POST fleet.url + "/api/m" {"input": [[...]]}
    # POST fleet.url + "/api/toy/generate" {"prompt": [...]}
    fleet.rolling_update("m", "sleep:0.001:4", version="v2")
    fleet.stop()

or from the CLI: ``python -m veles_tpu_torch.fleet --model
m=sleep:0.002:4 --replicas 2`` (``--device cpu`` on a host without a
card; ``--cache-dir DIR`` shares a build cache across the replicas).
Exported packages (``NAME=pkg.zip``) wait for ROADMAP queue A item 8.
"""

from .chaos import FaultPlan
from .replica import resolve_model_spec
from .router import FleetRouter
from .supervisor import Fleet, ReplicaSupervisor

__all__ = ["FaultPlan", "Fleet", "FleetRouter", "ReplicaSupervisor",
           "resolve_model_spec"]
