"""fleet_dashboard: a plain-text operational report.

Renders whatever subset of the telemetry plane the caller hands it —
counter totals, the per-(stream, rung) SLO ledger, and trace kind
counts — into an aligned text block suitable for terminals and bench
notes.  Pure formatting: no device work, no file IO.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

from repro_torch.obs.ledger import SLOLedger
from repro_torch.obs.trace import TraceRecord, kind_counts


def _rule(title: str, width: int) -> str:
    pad = max(width - len(title) - 6, 2)
    return f"== {title} {'=' * pad}"


def _fmt(x: float) -> str:
    if isinstance(x, float) and math.isnan(x):
        return "-"
    return f"{x:.4g}" if isinstance(x, float) else str(x)


def fleet_dashboard(counters: Optional[dict] = None,
                    ledger: Optional[SLOLedger] = None,
                    records: Optional[Iterable[TraceRecord]] = None,
                    run_id: str = "", width: int = 72,
                    max_streams: int = 12) -> str:
    lines = [_rule(f"FLEET TELEMETRY{' · run ' + run_id if run_id else ''}",
                   width)]

    if counters:
        lines.append(_rule("counters", width))
        kw = max(len(k) for k in counters)
        for k, v in sorted(counters.items()):
            lines.append(f"  {k:<{kw}}  {v}")

    if ledger is not None:
        rows = ledger.report()
        lines.append(_rule(f"slo ledger · {len(rows)} (stream, rung) cells",
                           width))
        if rows:
            hdr = (f"  {'sid':<10}{'rung':<12}{'n':>6}{'p50':>9}{'p95':>9}"
                   f"{'p99':>9}{'flips':>8}{'rate':>8}")
            lines.append(hdr)
            shown = rows[:max_streams]
            for r in shown:
                lines.append(
                    f"  {r['sid']:<10}{r['rung']:<12}{r['n_latency']:>6}"
                    f"{_fmt(r['p50']):>9}{_fmt(r['p95']):>9}"
                    f"{_fmt(r['p99']):>9}"
                    f"{r['flipped']:>5}/{r['compared']:<3}"
                    f"{_fmt(r['flip_rate']):>7}")
            if len(rows) > len(shown):
                lines.append(f"  ... {len(rows) - len(shown)} more cells")
        fl, tot = ledger.flip_counts()
        lines.append(f"  fleet flip rate: {fl}/{tot}"
                     f" = {_fmt(fl / tot if tot else 0.0)}"
                     + (f" · slo violations: {ledger.slo_violations()}"
                        if ledger.slo_s is not None else ""))

    if records is not None:
        records = list(records)
        lines.append(_rule(f"trace · {len(records)} records", width))
        for k, n in kind_counts(records).items():
            lines.append(f"  {k:<12} {n}")

    return "\n".join(lines)
