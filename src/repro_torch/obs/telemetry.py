"""The Telemetry facade handed to executors, sessions, and the server
(the JAX package's ``obs/telemetry.py``).

One object bundles the three planes — counters, trace, SLO ledger —
behind a single ``enabled`` switch.  Instrumented call sites hold an
``Optional[Telemetry]`` and gate on ``telemetry_on(tel)`` at
*construction* time wherever the instrumentation would change what runs
on the device, so disabled telemetry is not "cheap", it is *absent*: the
launch sequence and the outputs are those of an uninstrumented build.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.obs.counters import CounterPanel
from repro_torch.obs.ledger import SLOLedger
from repro_torch.obs.trace import TraceRecorder


class Telemetry:
    def __init__(self, enabled: bool = True, *, trace_capacity: int = 65536,
                 run_id: Optional[str] = None, slo_s: Optional[float] = None):
        self.enabled = bool(enabled)
        self.counters = CounterPanel(enabled=self.enabled)
        self.trace = TraceRecorder(capacity=trace_capacity, run_id=run_id)
        self.ledger = SLOLedger(slo_s=slo_s)

    @property
    def run_id(self) -> str:
        return self.trace.run_id

    def emit(self, *args, **kwargs) -> int:
        """Trace passthrough (no-op returning -1 when disabled)."""
        if not self.enabled:
            return -1
        return self.trace.emit(*args, **kwargs)

    # ---- checkpoint plumbing ----------------------------------------------
    def state_dict(self) -> dict:
        return {"run_id": self.run_id,
                "counters": self.counters.state_dict(),
                "ledger": self.ledger.state_dict(),
                "trace_next_eid": self.trace._next_eid}

    def load_state(self, state: dict) -> None:
        state = state or {}
        self.counters.load_state(state.get("counters", {}))
        self.ledger.load_state(state.get("ledger", {}))
        # a restored run keeps its own run_id (it IS a new run) but
        # remembers the ancestry for cross-run correlation
        self.trace.emit("ckpt", "restore",
                        parent_run=state.get("run_id", ""))


def telemetry_on(tel: Optional[Telemetry]) -> bool:
    """The one construction-time gate every instrumented site uses."""
    return tel is not None and tel.enabled
