"""Per-stream SLO ledger: latency percentiles AND accuracy deltas (the
JAX package's ``obs/ledger.py``).

Closes the ROADMAP gap "per-stream accuracy SLOs alongside the latency
SLO": the degradation ladder trades accuracy implicitly; this ledger
measures it per stream, attributed to the rung that served each frame.

Accuracy is tracked as *auth flips vs the pinned full-fidelity path*:
callers observe the served auth decisions next to the reference
decisions the fused, unquantized executor would have produced for the
same frames.  The ledger never recomputes the reference itself — the
caller (benchmark, test, or server harness) owns which run is the
pinned oracle, the ledger just attributes deltas to (stream, rung).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np


def rung_key(rung) -> str:
    """Canonical string for a ladder rung: ``(cut, bits)`` tuples become
    ``"nn@16"`` / ``"vj@raw"``; the on-node fallback is ``"on_node"``;
    strings pass through."""
    if rung is None:
        return "none"
    if isinstance(rung, str):
        return rung
    cut, bits = rung
    if cut is None:
        return "local"
    if cut == "on_node":
        return "on_node"
    return f"{cut}@{'raw' if bits is None else bits}"


class SLOLedger:
    """Latency + accuracy ledger keyed by (stream id, rung)."""

    def __init__(self, slo_s: Optional[float] = None):
        self.slo_s = slo_s
        self._lat: Dict[Tuple[str, str], List[float]] = defaultdict(list)
        # (sid, rung) -> [flipped_units, compared_units]
        self._flip: Dict[Tuple[str, str], List[int]] = defaultdict(
            lambda: [0, 0])

    # ---- feeding ----------------------------------------------------------
    def observe_latency(self, sid: str, rung, latency_s: float) -> None:
        self._lat[(str(sid), rung_key(rung))].append(float(latency_s))

    def observe_auth(self, sid: str, rung, auth, ref_auth) -> None:
        """Attribute served-vs-reference auth mismatches to (sid, rung).

        ``auth`` / ``ref_auth`` are arraylike decision vectors for the
        same frames (or scalars).  A dropped frame (auth None) counts
        every reference unit as flipped — degradation that sheds a
        frame costs its full accuracy.
        """
        k = (str(sid), rung_key(rung))
        ref = np.asarray(ref_auth).reshape(-1)
        if auth is None:
            self._flip[k][0] += int(ref.size)
            self._flip[k][1] += int(ref.size)
            return
        got = np.asarray(auth).reshape(-1)
        self._flip[k][0] += int(np.sum(got != ref))
        self._flip[k][1] += int(ref.size)

    # ---- querying ---------------------------------------------------------
    def _select(self, table, sid, rung):
        rk = None if rung is None else rung_key(rung)
        for (s, r), v in table.items():
            if (sid is None or s == str(sid)) and (rk is None or r == rk):
                yield (s, r), v

    def latency_percentiles(self, sid=None, rung=None,
                            qs=(50, 95, 99)) -> Dict[str, float]:
        samples: List[float] = []
        for _, v in self._select(self._lat, sid, rung):
            samples.extend(v)
        if not samples:
            return {f"p{q}": float("nan") for q in qs}
        arr = np.asarray(samples)
        return {f"p{q}": float(np.percentile(arr, q)) for q in qs}

    def flip_counts(self, sid=None, rung=None) -> Tuple[int, int]:
        flipped = total = 0
        for _, (f, n) in self._select(self._flip, sid, rung):
            flipped += f
            total += n
        return flipped, total

    def flip_rate(self, sid=None, rung=None) -> float:
        flipped, total = self.flip_counts(sid, rung)
        return flipped / total if total else 0.0

    def slo_violations(self, sid=None) -> int:
        if self.slo_s is None:
            return 0
        return sum(1 for _, v in self._select(self._lat, sid, None)
                   for x in v if x > self.slo_s)

    def keys(self) -> List[Tuple[str, str]]:
        return sorted(set(self._lat) | set(self._flip))

    def report(self) -> List[dict]:
        """One row per (sid, rung): latency percentiles + flip stats."""
        rows = []
        for sid, rk in self.keys():
            lat = self._lat.get((sid, rk), [])
            f, n = self._flip.get((sid, rk), (0, 0))
            pct = ({f"p{q}": float(np.percentile(np.asarray(lat), q))
                    for q in (50, 95, 99)} if lat
                   else {"p50": float("nan"), "p95": float("nan"),
                         "p99": float("nan")})
            rows.append({"sid": sid, "rung": rk, "n_latency": len(lat),
                         **pct, "flipped": int(f), "compared": int(n),
                         "flip_rate": (f / n if n else 0.0)})
        return rows

    # ---- persistence (rides the server checkpoint extra) -------------------
    def state_dict(self) -> dict:
        return {
            "slo_s": self.slo_s,
            "lat": {f"{s}|{r}": v for (s, r), v in self._lat.items()},
            "flip": {f"{s}|{r}": list(v) for (s, r), v in self._flip.items()},
        }

    def load_state(self, state: dict) -> None:
        state = state or {}
        self.slo_s = state.get("slo_s", self.slo_s)
        self._lat = defaultdict(list)
        self._flip = defaultdict(lambda: [0, 0])
        for k, v in state.get("lat", {}).items():
            s, r = k.split("|", 1)
            self._lat[(s, r)] = [float(x) for x in v]
        for k, v in state.get("flip", {}).items():
            s, r = k.split("|", 1)
            self._flip[(s, r)] = [int(v[0]), int(v[1])]
