"""``python -m repro_torch.obs`` — summarize/diff bench runs, inspect traces.

    python -m repro_torch.obs summary BENCH_serving.json [...]
    python -m repro_torch.obs diff BENCH_a.json BENCH_b.json  # 1 if differ
    python -m repro_torch.obs trace TRACE.jsonl [--perfetto out.json]
    python -m repro_torch.obs dashboard TRACE.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.obs.bench import (
    diff_bench,
    format_diff,
    load_bench,
    summarize_bench,
)
from repro_torch.obs.dashboard import fleet_dashboard
from repro_torch.obs.trace import (TraceRecorder, kind_counts,
                                   perfetto_events)


def _cmd_summary(ns) -> int:
    for path in ns.files:
        print(summarize_bench(load_bench(path)))
    return 0


def _cmd_diff(ns) -> int:
    d = diff_bench(load_bench(ns.a), load_bench(ns.b))
    if ns.json:
        print(json.dumps(d, indent=1))
    else:
        print(format_diff(d))
    return 0 if d["identical"] else 1


def _cmd_trace(ns) -> int:
    recs = TraceRecorder.load_jsonl(ns.file)
    runs = sorted({r.run_id for r in recs})
    print(f"trace: {len(recs)} records · runs {', '.join(runs) or '-'}")
    for k, n in kind_counts(recs).items():
        print(f"  {k:<12} {n}")
    if ns.perfetto:
        with open(ns.perfetto, "w") as fh:
            json.dump({"traceEvents": perfetto_events(recs),
                       "displayTimeUnit": "ms"}, fh)
        print(f"wrote {ns.perfetto}")
    return 0


def _cmd_dashboard(ns) -> int:
    recs = TraceRecorder.load_jsonl(ns.file)
    run_id = recs[0].run_id if recs else ""
    print(fleet_dashboard(records=recs, run_id=run_id))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summary", help="summarize BENCH_*.json artifacts")
    s.add_argument("files", nargs="+")
    s.set_defaults(fn=_cmd_summary)

    d = sub.add_parser("diff", help="diff two BENCH_*.json artifacts")
    d.add_argument("a")
    d.add_argument("b")
    d.add_argument("--json", action="store_true")
    d.set_defaults(fn=_cmd_diff)

    t = sub.add_parser("trace", help="summarize a TRACE.jsonl")
    t.add_argument("file")
    t.add_argument("--perfetto", default=None,
                   help="also write a Perfetto/chrome trace json")
    t.set_defaults(fn=_cmd_trace)

    b = sub.add_parser("dashboard", help="text dashboard from a TRACE.jsonl")
    b.add_argument("file")
    b.set_defaults(fn=_cmd_dashboard)

    ns = ap.parse_args(argv)
    try:
        return ns.fn(ns)
    except BrokenPipeError:
        # stdout died mid-print (| head etc.) — exit quietly like any
        # well-behaved unix filter instead of tracebacking
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 141                     # 128 + SIGPIPE, the shell idiom


if __name__ == "__main__":
    sys.exit(main())
