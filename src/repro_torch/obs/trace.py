"""Span/event trace recorder: typed ring buffer -> JSONL -> Perfetto.

Every record carries the correlation keys that let a chaos drive be
reconstructed offline from the JSONL alone (DESIGN.md §15):

* ``run_id``  — one random id per recorder, stamped on every record;
* ``eid``     — monotonically increasing event id, unique per run;
* ``tick``    — the server tick index the event belongs to (-1 if n/a);
* ``sid``     — stream id ("" if fleet-wide).

Kinds used by the instrumented stack: ``tick`` (one span per server
tick), ``dispatch`` (one span per rung-group dispatch), ``link``
(one event per transmit, args carry attempts/lost/crc), ``chaos``
(injected device events), ``ladder`` (rung transitions), ``failover``
(re-shard over the healthy devices), ``shed`` (DRR shedding), ``ckpt``
(checkpoint/restore).  The set is open — the schema is the record
shape, not the kind vocabulary.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import uuid
from typing import Dict, Iterable, List, Optional


@dataclasses.dataclass(frozen=True)
class TraceRecord:
    eid: int
    run_id: str
    kind: str
    name: str
    t: float            # simulated seconds since run start
    dur: float          # span duration in simulated seconds (0 = instant)
    tick: int
    sid: str
    args: dict

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "TraceRecord":
        return cls(eid=int(d["eid"]), run_id=str(d["run_id"]),
                   kind=str(d["kind"]), name=str(d["name"]),
                   t=float(d["t"]), dur=float(d["dur"]),
                   tick=int(d["tick"]), sid=str(d["sid"]),
                   args=dict(d.get("args", {})))


class TraceRecorder:
    """Bounded ring buffer of TraceRecords.

    Appends are O(1) host work (no device interaction); the ring keeps
    the newest ``capacity`` records and counts what it overwrote so an
    export can state its own truncation instead of silently lying.
    """

    def __init__(self, capacity: int = 65536, run_id: Optional[str] = None):
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self._buf: collections.deque = collections.deque(maxlen=int(capacity))
        self._next_eid = 0
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._buf)

    def emit(self, kind: str, name: str, *, t: float = 0.0, dur: float = 0.0,
             tick: int = -1, sid: str = "", **args) -> int:
        rec = TraceRecord(eid=self._next_eid, run_id=self.run_id,
                          kind=str(kind), name=str(name), t=float(t),
                          dur=float(dur), tick=int(tick), sid=str(sid),
                          args=args)
        self._next_eid += 1
        if self._buf.maxlen and len(self._buf) == self._buf.maxlen:
            self.dropped += 1
        self._buf.append(rec)
        return rec.eid

    def records(self, kind: Optional[str] = None) -> List[TraceRecord]:
        if kind is None:
            return list(self._buf)
        return [r for r in self._buf if r.kind == kind]

    # ---- JSONL ------------------------------------------------------------
    def to_jsonl(self, path: str) -> int:
        """One JSON object per line; returns the number written."""
        recs = self.records()
        with open(path, "w") as fh:
            for r in recs:
                fh.write(json.dumps(r.to_json(), sort_keys=True) + "\n")
        return len(recs)

    @staticmethod
    def load_jsonl(path: str) -> List[TraceRecord]:
        out = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    out.append(TraceRecord.from_json(json.loads(line)))
        return out

    # ---- Perfetto / chrome://tracing --------------------------------------
    def export_perfetto(self, path: str) -> int:
        events = perfetto_events(self.records())
        with open(path, "w") as fh:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms",
                       "otherData": {"run_id": self.run_id,
                                     "dropped": self.dropped}}, fh)
        return len(events)


def perfetto_events(records: Iterable[TraceRecord]) -> List[dict]:
    """Convert TraceRecords to Chrome ``trace_event`` dicts.

    Spans (dur > 0) become complete events (``ph: "X"``); instants
    become ``ph: "i"``.  Simulated seconds map to microseconds; each
    kind gets its own tid lane so tick/dispatch/link/chaos stack
    visually, all under one pid per run.
    """
    lanes: Dict[str, int] = {}
    out = []
    for r in records:
        tid = lanes.setdefault(r.kind, len(lanes) + 1)
        ev = {"name": r.name, "cat": r.kind, "pid": 1, "tid": tid,
              "ts": r.t * 1e6,
              "args": {**r.args, "eid": r.eid, "tick": r.tick,
                       "sid": r.sid, "run_id": r.run_id}}
        if r.dur > 0:
            ev["ph"] = "X"
            ev["dur"] = r.dur * 1e6
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        out.append(ev)
    return out


def kind_counts(records: Iterable[TraceRecord]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for r in records:
        out[r.kind] = out.get(r.kind, 0) + 1
    return dict(sorted(out.items()))
