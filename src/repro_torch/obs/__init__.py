"""repro_torch.obs — the fleet telemetry plane (DESIGN.md §15), the port
of the JAX package's ``obs/``.

Three planes behind one ``Telemetry`` facade:

* counters  — device-lazy ``tel_`` aux outputs + host panel
* trace     — typed ring buffer -> JSONL -> Perfetto trace_event
* ledger    — per-(stream, rung) latency percentiles + auth-flip rates

Plus the normalized BENCH schema (``bench_record``/``diff_bench``) and
the ``fleet_dashboard`` text report.  ``python -m repro_torch.obs``
exposes summary/diff/trace/dashboard on the command line.
"""

from repro_torch.obs.bench import (
    BENCH_SCHEMA,
    bench_record,
    diff_bench,
    format_diff,
    load_bench,
    summarize_bench,
    write_bench,
)
from repro_torch.obs.counters import (
    ALLOWED_DTYPES,
    CounterPanel,
    TEL_PREFIX,
    TELEMETRY_AUX,
    graph_counter,
    graph_counters,
    telemetry_decl,
)
from repro_torch.obs.dashboard import fleet_dashboard
from repro_torch.obs.ledger import SLOLedger, rung_key
from repro_torch.obs.telemetry import Telemetry, telemetry_on
from repro_torch.obs.trace import (
    TraceRecord,
    TraceRecorder,
    kind_counts,
    perfetto_events,
)

__all__ = [
    "ALLOWED_DTYPES",
    "BENCH_SCHEMA",
    "CounterPanel",
    "SLOLedger",
    "TEL_PREFIX",
    "TELEMETRY_AUX",
    "Telemetry",
    "TraceRecord",
    "TraceRecorder",
    "bench_record",
    "diff_bench",
    "fleet_dashboard",
    "format_diff",
    "graph_counter",
    "graph_counters",
    "kind_counts",
    "load_bench",
    "perfetto_events",
    "rung_key",
    "summarize_bench",
    "telemetry_decl",
    "telemetry_on",
    "write_bench",
]
