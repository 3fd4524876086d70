"""CLI: stand up a serving fleet — ``python -m veles_tpu_torch.fleet``.

Example::

    python -m veles_tpu_torch.fleet --model mnist=mnist_pkg.zip \\
        --model toy=toydecode:vocab=64 --replicas 2 --port 8080

Every replica serves on the card; ``--device cpu`` runs them on the
host (tests).  Blocks until SIGINT, then drains replicas gracefully.
"""

import argparse
import signal
import threading


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="veles_tpu_torch.fleet",
        description="N serving replicas behind a least-loaded router "
                    "with rolling updates (see veles_tpu_torch.fleet).")
    p.add_argument("--model", action="append", default=[],
                   metavar="NAME=SPEC", dest="models", required=True,
                   help="package zip path, sleep:SECONDS[:DIM] or "
                        "toydecode:k=v,... (repeatable)")
    p.add_argument("--replicas", type=int, default=3)
    p.add_argument("--port", type=int, default=8080,
                   help="router port (replicas pick free ports)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--queue-limit", type=int, default=256)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="the replicas' device: the card by default, "
                        "'cpu' for the host")
    p.add_argument("--cache-dir", default=None,
                   help="persistent build cache shared by every replica "
                        "(a respawn builds no kernel)")
    p.add_argument("--seconds", type=float, default=None,
                   help="serve N seconds then drain and exit "
                        "(default: until SIGINT)")
    args = p.parse_args(argv)

    from . import Fleet
    models = {}
    for spec in args.models:
        name, _, model = spec.partition("=")
        models[name] = model or name
    fleet = Fleet(models, replicas=args.replicas,
                  router_port=args.port, host=args.host,
                  max_batch=args.max_batch,
                  queue_limit=args.queue_limit, workers=args.workers,
                  cache_dir=args.cache_dir, device=args.device)
    fleet.start()
    print("fleet: %d replicas ready behind %s (POST %s/api/<model>; "
          "GET %s/metrics)" % (args.replicas, fleet.url, fleet.url,
                               fleet.url))
    try:
        if args.seconds:
            threading.Event().wait(args.seconds)
        else:
            signal.sigwait({signal.SIGINT, signal.SIGTERM})
    except KeyboardInterrupt:
        pass
    finally:
        fleet.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
