"""Drive and inspect the persistent kernel/serving tuning store.

Usage::

    python -m veles_tpu_torch.autotune tune --dir DIR --site lrn \
        --ctx '{"rows": 387200, "c": 96, "n": 5}'      # measure + persist
    python -m veles_tpu_torch.autotune tune ... --batch  # one process
    python -m veles_tpu_torch.autotune list --dir DIR    # every record
    python -m veles_tpu_torch.autotune show --dir DIR --site lrn \
        --shape c96_n5
    python -m veles_tpu_torch.autotune verify --dir DIR  # re-validate all
    python -m veles_tpu_torch.autotune resolve --dir DIR --site lrn \
        --shape c96_n5 --default '{"impl": "kernel"}'
    python -m veles_tpu_torch.autotune ... --json        # machine output

The subcommands and exit codes of the JAX package's ``tools/autotune.py``.
``tune`` measures every declared candidate of a site in isolated fresh
subprocesses (a hard wall-clock cap per candidate, or with ``--batch``
one process and one cap for the site; correctness-gated against the
kernel's plain version or the serving oracle) and persists the winner
keyed by (site, shape class, environment) — the same store kernel call
sites resolve through.  Kernel sites run on the card unless ``--ctx``
says ``"device": "cpu"``.  ``verify`` is read-only (unlike dispatch,
which quarantines) and exits 1 when any record fails validation.
``resolve`` reports what a process with ``$VELES_AUTOTUNE_DIR=DIR``
would actually run.
"""

import argparse
import json
import os

from .space import SITES, site as get_site
from .store import TuningStore, environment_fingerprint


def _parse_json_arg(text, what):
    if not text:
        return {}
    try:
        value = json.loads(text)
    except ValueError as exc:
        raise SystemExit("bad %s JSON: %s" % (what, exc))
    if not isinstance(value, dict):
        raise SystemExit("%s must be a JSON object" % what)
    return value


def _record_line(key, record, reason):
    if record is None:
        return "  %-16s CORRUPT: %s" % (key[:16], reason)
    return ("  %-16s %-22s %-14s %7.2fx  %-6s %s  "
            "torch=%s device=%s" %
            (key[:16], record["site"], record["shape_class"],
             record.get("speedup", 0.0), record.get("gate", "?"),
             json.dumps(record["config"], sort_keys=True),
             record.get("torch", "?"), record.get("device_kind", "?")))


def cmd_tune(args):
    from .runner import tune_site
    store = TuningStore(args.dir)
    ctx = _parse_json_arg(args.ctx, "--ctx")
    sites = [args.site] if args.site else sorted(SITES)
    records, failed = [], []
    for name in sites:
        log_fn = None if args.json else print
        record = tune_site(name, ctx or None, store=store,
                           timeout=args.timeout, log_fn=log_fn,
                           batch=args.batch)
        if record is None:
            failed.append(name)
        else:
            records.append(record)
    if args.json:
        print(json.dumps({"tuned": records, "no_winner": failed},
                         indent=1, sort_keys=True))
    elif failed:
        print("no viable candidate for: %s (dispatch keeps the "
              "hand-picked defaults)" % ", ".join(failed))
    return 1 if failed and not records else 0


def cmd_list(args):
    store = TuningStore(args.dir)
    rows = store.records()
    if args.json:
        print(json.dumps(
            [{"key": k, "record": r, "error": reason}
             for k, r, reason in rows], indent=1, sort_keys=True))
        return 0
    print("tuning store %s (%d record(s); this process: %s)" %
          (store.directory, len(rows), environment_fingerprint()))
    for key, record, reason in rows:
        print(_record_line(key, record, reason))
    return 0


def cmd_show(args):
    store = TuningStore(args.dir)
    record = store.get(args.site, args.shape)
    if record is None:
        print("no record for (%s, %s) under this environment "
              "fingerprint — dispatch would use the hand-picked "
              "default" % (args.site, args.shape))
        return 1
    if args.json:
        print(json.dumps(record, indent=1, sort_keys=True))
        return 0
    print("%s/%s" % (record["site"], record["shape_class"]))
    print("  config:   %s" % json.dumps(record["config"],
                                        sort_keys=True))
    print("  default:  %s" % json.dumps(record["default"],
                                        sort_keys=True))
    print("  speedup:  %.3fx (gate %s)" %
          (record.get("speedup", 0.0), record.get("gate", "?")))
    if "baseline_s" in record:
        print("  measured: best %.6fs vs default %.6fs over %s "
              "candidate(s)" % (record.get("best_s", 0.0),
                                record.get("baseline_s", 0.0),
                                record.get("candidates_tried", "?")))
    print("  environ:  %s" % record["fingerprint"])
    return 0


def cmd_verify(args):
    store = TuningStore(args.dir)
    rows = store.records()
    bad = [(k, reason) for k, r, reason in rows if r is None]
    if args.json:
        print(json.dumps({"records": len(rows),
                          "corrupt": [{"key": k, "error": e}
                                      for k, e in bad]},
                         indent=1, sort_keys=True))
    else:
        print("%d record(s), %d corrupt" % (len(rows), len(bad)))
        for key, reason in bad:
            print("  CORRUPT %-16s %s" % (key[:16], reason))
    return 1 if bad else 0


def cmd_resolve(args):
    # what dispatch would hand the kernel in THIS process: used by the
    # bench roundtrip to prove a second process reloads the winner with
    # zero re-measurement
    from . import dispatch
    os.environ[dispatch.AUTOTUNE_DIR_ENV] = os.path.abspath(args.dir)
    dispatch.reset_default_stores()
    default = _parse_json_arg(args.default, "--default")
    if not default:
        default = dict(get_site(args.site).default)
    config, source = dispatch.resolve(args.site, args.shape,
                                      default=default)
    doc = {"site": args.site, "shape_class": args.shape,
           "config": config, "config_source": source}
    print(json.dumps(doc, sort_keys=True))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.autotune",
        description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, shape=False):
        p.add_argument("--dir", required=True,
                       help="tuning store directory")
        p.add_argument("--json", action="store_true",
                       help="emit JSON instead of text")
        if shape:
            p.add_argument("--site", required=True,
                           choices=sorted(SITES))
            p.add_argument("--shape", required=True,
                           help="shape class, e.g. c96_n5")

    p = sub.add_parser("tune", help="measure candidates, persist the "
                                    "gated winner")
    common(p)
    p.add_argument("--site", choices=sorted(SITES), default=None,
                   help="one site (default: every registered site)")
    p.add_argument("--ctx", default=None,
                   help="JSON measurement context (shapes); site "
                        "defaults when omitted")
    p.add_argument("--timeout", type=float, default=120.0,
                   help="hard wall-clock cap per candidate subprocess "
                        "(with --batch: per site)")
    p.add_argument("--batch", action="store_true",
                   help="measure a site's candidates in one isolated "
                        "process (one CUDA context) instead of one each")
    p.set_defaults(fn=cmd_tune)

    p = sub.add_parser("list", help="every record, corrupt included")
    common(p)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("show", help="one record with full provenance")
    common(p, shape=True)
    p.set_defaults(fn=cmd_show)

    p = sub.add_parser("verify", help="re-validate every record "
                                      "(read-only; exit 1 on corrupt)")
    common(p)
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("resolve", help="what dispatch hands the kernel "
                                       "for (site, shape)")
    common(p, shape=True)
    p.add_argument("--default", default=None,
                   help="JSON fallback config (default: the site's "
                        "declared default)")
    p.set_defaults(fn=cmd_resolve)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
