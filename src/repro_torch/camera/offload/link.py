"""Trace-driven offload-link simulator (paper §II-A's communication cost,
made executable) — the port's copy of the JAX package's numpy
``camera/offload/link.py``, less the fault models, which come with the
resilience runtime.

The cost model charges a cut-point payload ``bytes x joules_per_byte`` or
``bytes / bandwidth`` — a closed form with no queueing.  This simulator
replays *measured* per-frame payload byte traces from the live split
executors (``camera/offload/executors``) through a shared serial link and
produces what the closed form cannot: per-frame completion latency under
contention when N streams share one uplink (the WISPCam-fleet shape: many
energy-harvesting cameras, one RFID reader; the 16-camera rig: eight
pairs, one 25 GbE port), sustained-vs-offered throughput, and transmit
energy.

Two calibrated profiles anchor the paper's two regimes:

* :data:`BACKSCATTER` — RFID backscatter uplink (WISP-class).  EPC Gen2
  backscatter peaks at ~640 kbps; WISPCam-style duty-cycled harvesting
  sustains far less — we use 64 kbps (8 kB/s) with the §III calibrated
  transmit energy (``core.costmodel.RF_LINK``'s 83 nJ/B default; the
  controller swaps in the workload-calibrated value).
* :data:`ETH_25G_LINK` / :data:`ETH_400G_LINK` — the §IV wired uplinks.

``LinkProfile.scaled`` supports evaluating toy-resolution traces at a
paper-native operating point: scaling bandwidth by (toy pixels / native
pixels) is *exactly* equivalent to scaling the measured bytes up to
native resolution (payload bytes are linear in pixels at every cut).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """A serial offload link: bandwidth, per-message latency, energy."""

    name: str
    bytes_per_s: float
    latency_s: float = 0.0           # per-message propagation + framing
    joules_per_byte: float = 0.0

    def scaled(self, factor: float, name: str | None = None) -> "LinkProfile":
        """Bandwidth scaled by ``factor`` (see module docstring)."""
        if not (np.isfinite(factor) and factor > 0):
            raise ValueError(
                f"LinkProfile.scaled: factor must be a finite positive "
                f"number, got {factor!r} — a zero/negative bandwidth scale "
                "would make every transmit time undefined (to model an "
                "outage, model it as a fault, not as a dead link profile)")
        return dataclasses.replace(
            self, bytes_per_s=self.bytes_per_s * factor,
            name=name or f"{self.name}x{factor:g}")


BACKSCATTER = LinkProfile("rfid_backscatter", bytes_per_s=8e3,
                          latency_s=2e-3, joules_per_byte=83e-9)
ETH_25G_LINK = LinkProfile("eth_25g", bytes_per_s=25e9 / 8,
                           latency_s=5e-6, joules_per_byte=4e-9)
ETH_400G_LINK = LinkProfile("eth_400g", bytes_per_s=400e9 / 8,
                            latency_s=5e-6, joules_per_byte=4e-9)


@dataclasses.dataclass(frozen=True)
class LinkReport:
    """Result of replaying byte traces through one shared link."""

    link: str
    n_streams: int
    frame_period_s: float
    latency_s: np.ndarray            # (n_streams, n_frames) completion - arrival
    bytes_total: float
    joules: float
    utilization: float               # busy fraction of the makespan
    offered_bps: float               # offered load, bytes/s
    delivered_fps: float             # completed frames / makespan

    @property
    def mean_latency_s(self) -> float:
        return float(self.latency_s.mean()) if self.latency_s.size else 0.0

    @property
    def p99_latency_s(self) -> float:
        return (float(np.quantile(self.latency_s, 0.99))
                if self.latency_s.size else 0.0)

    @property
    def max_latency_s(self) -> float:
        return float(self.latency_s.max()) if self.latency_s.size else 0.0

    def realtime_fraction(self, deadline_s: float) -> float:
        """Fraction of frames delivered within ``deadline_s`` of capture."""
        if not self.latency_s.size:
            return 1.0
        return float((self.latency_s <= deadline_s).mean())


def simulate_shared_link(traces, link: LinkProfile, frame_period_s: float,
                         duty: float = 1.0, stagger: bool = True) -> LinkReport:
    """Replay per-frame payload traces from N streams over one shared link.

    ``traces``: (n_streams, n_frames) or (n_frames,) measured bytes per
    frame.  Stream s's frame i arrives at ``(i + phase_s) * period`` with
    ``period = frame_period_s / duty`` (``duty`` scales the source rate —
    the paper's duty-cycle knob); ``stagger`` offsets streams by
    ``period / n_streams`` so the fleet is not pathologically synchronized
    (set False to model a globally-triggered rig).  The link serves one
    message at a time, FIFO in arrival order — transmit time
    ``bytes / bytes_per_s`` after ``latency_s`` framing.

    Deterministic, trace-exact, O(total frames log total frames).
    """
    traces = np.atleast_2d(np.asarray(traces, np.float64))
    n_streams, n_frames = traces.shape
    if not (np.isfinite(frame_period_s) and frame_period_s >= 0):
        raise ValueError(
            f"simulate_shared_link: frame_period_s must be a finite "
            f"non-negative number of seconds, got {frame_period_s!r} — "
            "negative periods would make frames arrive in reverse time; "
            "to model a faster source rate, raise duty instead")
    if duty <= 0:
        raise ValueError(f"duty must be positive, got {duty}")
    period = frame_period_s / duty
    phase = (np.arange(n_streams) / n_streams if stagger
             else np.zeros(n_streams))
    arrive = (np.arange(n_frames)[None, :] + phase[:, None]) * period
    order = np.argsort(arrive, axis=None, kind="stable")
    flat_arrive = arrive.reshape(-1)[order]
    flat_bytes = traces.reshape(-1)[order]

    done = np.zeros_like(flat_arrive)
    busy = 0.0
    free_at = 0.0
    for i in range(flat_arrive.shape[0]):
        if flat_bytes[i] == 0.0:
            # nothing to send: a real node keys up no transmission, so a
            # quiet frame pays neither framing latency nor queue time
            done[i] = flat_arrive[i]
            continue
        start = max(flat_arrive[i], free_at)
        tx = link.latency_s + flat_bytes[i] / link.bytes_per_s
        free_at = start + tx
        busy += tx
        done[i] = free_at

    latency = np.empty_like(done)
    latency[order] = done - flat_arrive
    # done is completion per arrival-ordered message; a trailing zero-byte
    # frame completes at its arrival, so the makespan is the max, not the
    # last entry
    makespan = max(float(done.max()), 1e-12) if done.size else 1e-12
    total_bytes = float(traces.sum())
    offered_window = n_frames * period
    return LinkReport(
        link=link.name,
        n_streams=n_streams,
        frame_period_s=period,
        latency_s=latency.reshape(n_streams, n_frames),
        bytes_total=total_bytes,
        joules=total_bytes * link.joules_per_byte,
        utilization=min(busy / makespan, 1.0),
        offered_bps=total_bytes / offered_window if offered_window else 0.0,
        delivered_fps=done.size / makespan,
    )


def link_energy_w(bytes_per_unit: float, unit_rate_hz: float,
                  link: LinkProfile) -> float:
    """Average transmit watts — the cost model's ``comm_w`` term, from
    measured bytes (the closed-form cross-check of the simulator)."""
    return bytes_per_unit * unit_rate_hz * link.joules_per_byte
