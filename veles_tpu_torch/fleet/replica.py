"""One serving replica: a single-process InferenceServer under fleet
supervision.

The port of ``veles_tpu/fleet/replica.py``.  The replica is not a new
server: it is the port's
:class:`~veles_tpu_torch.serving.server.InferenceServer` (bucket and
decode schedulers, registry) started by ``python -m
veles_tpu_torch.fleet.replica`` with:

- the admin hot-load endpoint enabled (``POST /admin/models``), which is
  how the supervisor performs rolling model updates;
- an announce line on stdout, one JSON object ``{"fleet_replica":
  {"port": ..., "pid": ..., "replica": ...}}``, printed once the
  listener is bound and every ``--model`` is registered (readiness
  still gated on ``GET /readyz``).  The JAX replica announces before
  registering, so its ``/readyz`` answers 200 as soon as its first model
  is warm, and a router sends it requests for models still loading
  (404); here the first 200 means every model is served;
- the trace context, the flight-record directory and the KV-tier
  directory adopted from the environment (the supervisor plants them),
  so its spans join the fleet-wide trace;
- ``--device``: the card by default (raising without one), ``cpu`` for
  the tests.

Model specs (``--model NAME=SPEC``, repeatable):

- the path of an exported package zip (the production case,
  :mod:`veles_tpu_torch.export`): its forward chain is rebuilt from the
  port's units on ``--device``, so on the card its batches launch the
  hand kernels (K4 in the All2All family under ``precise_gemm``, K5 in
  LRN, K7 in attention); each scheduler's ``stats()`` counts them
  (``kernel_launches``, over ``GET /metrics``);
- ``sleep:SECONDS[:DIM]``: a deterministic device-bound STAND-IN model
  that sleeps ``SECONDS`` per sample ROW, then returns the input batch.
  Sleeping per row (not per call) means batching cannot amortize it: a
  replica's throughput is pinned at ``1/SECONDS`` rows/s, like a model
  whose cost is accelerator time.  Fleet tests measure scheduling
  (spread, failover, rollout) against it;
- ``toydecode:k=v,...``: the decode-path stand-in
  (:func:`~veles_tpu_torch.serving.toydecode.from_spec`), with a host
  oracle, on ``--device``.
"""

import argparse
import functools
import json
import os
import signal
import threading
import time


def resolve_model_spec(spec, device=None):
    """An admin/CLI model spec -> something ``registry.add`` accepts
    (a package path stays a path: the registry loads it on its
    device)."""
    if isinstance(spec, str) and spec.startswith("sleep:"):
        from ..serving.scheduler import OpaqueModel
        parts = spec.split(":")
        delay = float(parts[1])
        dim = int(parts[2]) if len(parts) > 2 else 4

        def fn(x, _delay=delay):
            time.sleep(_delay * x.shape[0])   # device-time-per-row twin
            return x

        return OpaqueModel(fn, sample_shape=(dim,))
    if isinstance(spec, str) and spec.startswith("toydecode"):
        # the decode-path stand-in: deterministic, KV-dependent, with
        # a host oracle — what migration and chaos drills generate
        # against
        from ..serving.toydecode import from_spec
        return from_spec(spec, device=device)
    return spec


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="veles_tpu_torch.fleet.replica",
        description="One fleet serving replica (an InferenceServer "
                    "with the admin hot-load endpoint on).")
    p.add_argument("--model", action="append", default=[],
                   metavar="NAME=SPEC", dest="models",
                   help="package zip path, sleep:SECONDS[:DIM] or "
                        "toydecode:k=v,... (repeatable)")
    p.add_argument("--port", type=int, default=0,
                   help="0 = pick a free port (announced on stdout)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--queue-limit", type=int, default=256)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="the models' device: the card by default, 'cpu' "
                        "for the host")
    p.add_argument("--replica-id", default=None,
                   help="stable id assigned by the supervisor")
    p.add_argument("--cache-dir", default=None,
                   help="persistent build cache dir (usually inherited "
                        "via VELES_COMPILE_CACHE_DIR)")
    p.add_argument("--kvtier-dir", default=None,
                   help="disk tier directory for the tiered KV cache "
                        "(usually inherited via VELES_KVTIER_DIR)")
    args = p.parse_args(argv)

    if args.cache_dir:
        from ..config import root
        root.common.compile_cache.dir = args.cache_dir
    if args.kvtier_dir:
        # resolved by DecodeScheduler's kvtier disk_dir=True path
        from ..kvtier import DIR_ENV
        os.environ[DIR_ENV] = args.kvtier_dir
    from ..observability import trace as _trace
    _trace.adopt_env()
    # flight recorder: adopt the supervisor's per-replica persist dir
    # and stamp timelines with this replica's stable id
    from ..observability.flight import configure_from_env
    configure_from_env(replica=args.replica_id)

    from ..serving import InferenceServer
    resolve = functools.partial(resolve_model_spec, device=args.device)
    server = InferenceServer(
        port=args.port, host=args.host, enable_admin=True,
        model_resolver=resolve, max_batch=args.max_batch,
        queue_limit=args.queue_limit, workers=args.workers,
        device=args.device)
    # scripted fault injection (VELES_FAULT_PLAN, planted by the
    # supervisor's fault_plans= knob); a clean environment is a no-op
    from .chaos import install_from_env
    install_from_env(server)
    try:
        for spec in args.models:
            name, _, model = spec.partition("=")
            if not model:
                model, name = name, os.path.splitext(
                    os.path.basename(name))[0]
            server.registry.add(name, resolve(model))
    except BaseException:
        server.stop(drain=False)
        raise
    # announce once every model is registered: a /readyz 200 then means
    # the whole command line is served, never a part of it
    print(json.dumps({"fleet_replica": {
        "port": server.port, "pid": os.getpid(),
        "replica": args.replica_id}}), flush=True)

    done = threading.Event()
    # SIGTERM = graceful drain (the supervisor's stop path); SIGKILL is
    # the crash being drilled and never reaches python
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    signal.signal(signal.SIGINT, lambda *_: done.set())
    done.wait()
    server.stop(drain=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
