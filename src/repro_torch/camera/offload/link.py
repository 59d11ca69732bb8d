"""Trace-driven offload-link simulator (paper §II-A's communication cost,
made executable) — the port's copy of the JAX package's numpy
``camera/offload/link.py``, fault models included.

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
                "outage, use FaultInjector, not a dead link profile)")
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


# ---------------------------------------------------------------------------
# Fault models (DESIGN.md §12)
# ---------------------------------------------------------------------------
#
# The simulator above is lossless and always powered — every number it
# gives is a best case.  The models below make the two real failure
# modes of the paper's regimes injectable and *deterministic under a
# seed*:
#
# * Gilbert–Elliott burst loss + timed outages on any LinkProfile — the
#   backscatter uplink drops bursts, the shared 25 GbE port browns out
#   under incast.
# * Harvested-energy brownout traces for BACKSCATTER-class nodes — a
#   WISP camera runs off a capacitor charged by RF harvest; when the
#   charge runs out mid-funnel the node dies and must recover.
#
# The models only *decide* fault outcomes; charging the retries' bytes,
# energy and queueing back into simulate_shared_link is the job of
# resilience.OffloadSession.


@dataclasses.dataclass(frozen=True)
class GilbertElliott:
    """Two-state Markov burst-loss channel (good <-> bad).

    Per transmit attempt, the chain sits in ``good`` (loss prob
    ``loss_good``) or ``bad`` (``loss_bad``) and transitions with
    ``p_gb`` / ``p_bg``.  The classic burst model: mean burst length is
    ``1 / p_bg`` attempts, and the stationary loss rate has the closed
    form checked by the hypothesis property suite.
    """

    p_gb: float = 0.05            # P(good -> bad) per attempt
    p_bg: float = 0.5             # P(bad -> good) per attempt
    loss_good: float = 0.0
    loss_bad: float = 1.0

    def __post_init__(self):
        for f in ("p_gb", "p_bg", "loss_good", "loss_bad"):
            v = getattr(self, f)
            if not (np.isfinite(v) and 0.0 <= v <= 1.0):
                raise ValueError(
                    f"GilbertElliott.{f} must be a probability in [0, 1], "
                    f"got {v!r}")

    @property
    def stationary_bad(self) -> float:
        """Stationary probability of the bad state."""
        denom = self.p_gb + self.p_bg
        return self.p_gb / denom if denom > 0 else 0.0

    @property
    def stationary_loss(self) -> float:
        """Analytic long-run loss rate (the property-test anchor)."""
        pi_b = self.stationary_bad
        return pi_b * self.loss_bad + (1.0 - pi_b) * self.loss_good

    @property
    def mean_burst_len(self) -> float:
        """Mean consecutive attempts spent in the bad state."""
        return 1.0 / self.p_bg if self.p_bg > 0 else float("inf")


@dataclasses.dataclass(frozen=True)
class BrownoutModel:
    """Harvested-energy power supply of a WISP-class node.

    The node draws ``load_w`` while computing/transmitting and harvests
    ``harvest_w`` continuously; ``storage_j`` is the usable capacitor
    energy between full charge and the brownout cutoff.  Active windows
    therefore last ``storage_j / (load_w - harvest_w)`` seconds and
    recharging from cutoff takes ``storage_j / harvest_w`` seconds —
    jittered per cycle by the injector's seeded RNG so fleets do not
    brown out in lockstep.
    """

    harvest_w: float = 15e-6      # WISP-scale RF harvest
    storage_j: float = 3e-3       # usable capacitor energy
    load_w: float = 200e-6        # active draw while the funnel runs
    jitter: float = 0.2           # +-fraction applied per cycle

    def __post_init__(self):
        for f in ("harvest_w", "storage_j", "load_w"):
            v = getattr(self, f)
            if not (np.isfinite(v) and v > 0):
                raise ValueError(
                    f"BrownoutModel.{f} must be finite and positive, "
                    f"got {v!r}")
        if self.load_w <= self.harvest_w:
            raise ValueError(
                f"BrownoutModel: load_w ({self.load_w}) must exceed "
                f"harvest_w ({self.harvest_w}) or the node never browns "
                "out — drop the model instead of degenerating it")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    @property
    def on_s(self) -> float:
        return self.storage_j / (self.load_w - self.harvest_w)

    @property
    def recharge_s(self) -> float:
        return self.storage_j / self.harvest_w


class FaultInjector:
    """Seeded, deterministic fault process for one offload session.

    Consulted by ``resilience.OffloadSession`` at two points:

    * :meth:`attempt` — per transmit attempt at simulated time ``t``:
      returns ``"ok"`` / ``"lost"`` / ``"corrupt"``.  Loss comes from
      the Gilbert–Elliott chain (advanced once per attempt) OR from a
      timed outage window; a lost-by-channel attempt is reported as
      ``corrupt`` with probability ``corrupt_fraction`` (the payload
      arrives but fails the integrity checksum — detected at the
      receiver rather than by sender timeout).
    * :meth:`power_window` — the node-power schedule from the brownout
      model: on/off windows over simulated time, jittered per cycle.

    Identical seeds + identical query sequences produce identical fault
    sequences (BENCH_resilience.json must reproduce bit-for-bit), and a
    fully-disabled injector is indistinguishable from no injector.
    """

    def __init__(self, *, loss: GilbertElliott | None = None,
                 outage_period_s: float | None = None,
                 outage_duty: float = 0.0,
                 brownout: BrownoutModel | None = None,
                 corrupt_fraction: float = 0.0, seed: int = 0):
        if outage_period_s is not None and outage_period_s <= 0:
            raise ValueError(
                f"outage_period_s must be positive, got {outage_period_s}")
        if not 0.0 <= outage_duty < 1.0:
            raise ValueError(
                f"outage_duty must be in [0, 1), got {outage_duty}")
        if not 0.0 <= corrupt_fraction <= 1.0:
            raise ValueError(
                f"corrupt_fraction must be in [0, 1], got {corrupt_fraction}")
        self.loss = loss
        self.outage_period_s = outage_period_s
        self.outage_duty = float(outage_duty)
        self.brownout = brownout
        self.corrupt_fraction = float(corrupt_fraction)
        self.seed = int(seed)
        self.reset()

    def reset(self):
        """Rewind to the seeded initial state (sweep determinism)."""
        self._rng = np.random.default_rng(self.seed)
        self._power_rng = np.random.default_rng(self.seed + 0x9E3779B9)
        self._bad = False                  # GE chain starts in good
        self._power_edges: list = []       # [on_end_0, off_end_0, on_end_1, ...]
        self.attempts = 0
        self.losses = 0

    # -- link faults ---------------------------------------------------------

    def outage_at(self, t: float) -> bool:
        """Is the link inside a scheduled outage window at time ``t``?

        Outages occupy the last ``outage_duty`` fraction of each period
        (deterministic in *time*, not in the attempt count — retries that
        back off past the window's end escape it, which is the behavior
        the exponential-backoff policy is for).
        """
        if not self.outage_period_s or self.outage_duty <= 0.0:
            return False
        phase = (t / self.outage_period_s) % 1.0
        return phase >= 1.0 - self.outage_duty

    def next_outage_end(self, t: float) -> float:
        """End time of the outage containing ``t`` (t if no outage)."""
        if not self.outage_at(t):
            return t
        period = self.outage_period_s
        return (np.floor(t / period) + 1.0) * period

    def attempt(self, t: float) -> str:
        """Outcome of one transmit attempt starting at time ``t``."""
        self.attempts += 1
        lost = self.outage_at(t)
        if self.loss is not None:
            # advance the chain exactly once per attempt, even during an
            # outage, so the fault sequence depends only on the attempt
            # index (determinism under congestion-shifted timings)
            p = self.loss.loss_bad if self._bad else self.loss.loss_good
            flip = self.loss.p_bg if self._bad else self.loss.p_gb
            chain_lost = self._rng.random() < p
            if self._rng.random() < flip:
                self._bad = not self._bad
            lost = lost or chain_lost
        if not lost:
            return "ok"
        self.losses += 1
        if self.corrupt_fraction and self._rng.random() < self.corrupt_fraction:
            return "corrupt"
        return "lost"

    @property
    def empirical_loss(self) -> float:
        """Observed loss fraction over every attempt so far."""
        return self.losses / self.attempts if self.attempts else 0.0

    # -- node power ----------------------------------------------------------

    def _extend_power_edges(self, until: float):
        bo = self.brownout
        t = self._power_edges[-1] if self._power_edges else 0.0
        while t <= until:
            j = bo.jitter
            on = bo.on_s * (1.0 + j * (2.0 * self._power_rng.random() - 1.0))
            off = bo.recharge_s * (1.0 + j * (2.0 * self._power_rng.random()
                                              - 1.0))
            self._power_edges.extend([t + on, t + on + off])
            t = t + on + off

    def power_window(self, t: float) -> tuple:
        """``(powered, boundary)`` for simulated time ``t``.

        ``powered`` is whether the node has energy at ``t``; ``boundary``
        is when that changes (the brownout instant if powered, the
        recovery instant if not).  Without a brownout model the node is
        always powered (boundary = +inf).
        """
        if self.brownout is None:
            return True, float("inf")
        self._extend_power_edges(t)
        i = int(np.searchsorted(np.asarray(self._power_edges), t,
                                side="right"))
        while i >= len(self._power_edges):
            self._extend_power_edges(self._power_edges[-1] + 1.0)
        # even index -> inside an on-window (next edge is the brownout)
        return i % 2 == 0, float(self._power_edges[i])
