"""Continuous streaming serving runtime (DESIGN.md §13, chaos plane §14),
the port of the JAX package's ``camera/serve/runtime.py``.

Serves N heterogeneous camera streams on one serving host — the WISPCam
fleet shape: thousands of harvested-energy cameras sharing one
backscatter uplink into a cloud that runs (part of) the §III funnel.
Streams register and leave dynamically; frames queue per stream; every
scheduler tick forms capacity-padded micro-batches and pushes them
through ONE dispatch per placement group:

* the scorer→big-model admission path is
  :func:`repro_torch.serve.engine.cascade_serve` — a chunk motion-energy scorer
  filters quiet chunks in front of the funnel ("Viola-Jones in front of
  the NN" at fleet scale), the compacting cascade bounds the big batch to
  a static capacity, and capacity-overflowed survivors come back as
  deterministic indices that the scheduler *re-queues* (never drops);
* local streams (``cut=None``) run through
  :meth:`FaceAuthExecutor.batch_step` — the funnel over the micro-batch's
  slot axis (one shard per device when the server's devices divide it);
* offloaded streams run the split executors' node/cloud halves over the
  slot axis (``encode_slots`` / ``decode_slots``), so per-chunk
  *measured* wire bytes come out of the same dispatch.

Each group's stack is built on the host and moved to the device in one
copy; its outputs come back in one copy (:func:`_host_copy`) and
completions hold numpy arrays, as the reference's do.  Nothing else in a
tick waits for the device.

The scorer threshold equals the funnel's own motion threshold, so a
filtered chunk's canonical quiet result is bit-identical to running the
funnel on it — filtering saves compute with zero semantic change (chunk
boundaries are batch boundaries, as everywhere else in the repo).

Admission control and per-stream cut selection close the two carried
ROADMAP items: measured per-tick byte traces replay through
``simulate_shared_link`` every ``link_window`` ticks, and each active
stream's sliding-window funnel stats drive a
``CutController.resolve_window`` re-solve with the link report's
``p99_latency_s`` as the deadline constraint — congestion rises, cuts
retreat toward fewer wire bytes.

**The §14 chaos plane** hardens all of the above against hostile fleets:

* every frame carries a per-stream sequence number; queues are *bounded*
  (``ServeConfig.max_queue_frames``) and overload sheds oldest-first,
  with every shed frame surfaced per-stream in the next
  :class:`TickReport` — never silently dropped;
* micro-batch slots are granted in **deficit-round-robin** order: each
  stream with an eligible chunk accrues one chunk-quantum of deficit per
  tick and spends it on service, so the cascade's keep-lowest-indices
  capacity drop implements fair rotation instead of
  first-registered-wins.  A continuously-backlogged stream is served at
  least once every ``ceil(R / capacity)`` ticks (R = backlogged streams
  on its rung) — the documented starvation bound;
* a :class:`~repro.camera.serve.chaos.ChaosEngine` injects per-stream
  link faults (each served offloaded chunk transits its stream's seeded
  ``FaultInjector`` with bounded retries, every attempt charged real
  uplink bytes) and scripted device-loss events — a local placement
  group sharded over the server's devices that loses one re-shards over
  the survivors within one tick (the single-device batch when they stop
  dividing it);
* each faulty offloaded stream carries a serve-driven
  ``DegradationLadder`` fed by fleet symptoms (delivery failures,
  retransmit fraction, deadline misses widened by the link report's
  p99): sustained faults walk the stream down to narrower codecs, the
  cheapest cut, finally all-on-node; ``recover_after`` clean deliveries
  walk it back up.  While a ladder holds a stream below rung 0 the
  windowed ``resolve_window`` skips it — the ladder has the wheel during
  an incident, the solver gets it back in the clean state;
* :meth:`StreamingServer.checkpoint` persists the full server state at a
  tick boundary through ``ckpt/checkpoint.py``, in the reference's layout
  (either package restores what the other wrote), and
  :meth:`StreamingServer.restore` rebuilds a server that resumes with no
  frame lost or double-served — :meth:`StreamingServer.seq_audit` proves
  the accounting.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.camera.motion import motion_score
from repro_torch.camera.offload.executors import FaceAuthOffloadExecutor
from repro_torch.camera.offload.link import BACKSCATTER, simulate_shared_link
from repro_torch.camera.offload.payloads import SESSION_SIDEBAND_BYTES
from repro_torch.camera.offload.resilience import (DegradationLadder,
                                                   DeliveryRecord)
from repro_torch.camera.serve.bytes_model import (FA_CUTS, fa_cut_bytes,
                                                  fa_decision_bytes,
                                                  fa_quiet_bytes)
from repro_torch.camera.serve.chaos import ChaosEngine, ChaosSpec
from repro_torch.ckpt.checkpoint import (latest_step, read_extra,
                                         restore_checkpoint, save_checkpoint)
from repro_torch.obs.ledger import rung_key
from repro_torch.obs.telemetry import telemetry_on
from repro_torch.serve.engine import cascade_serve

_RESULT_KEYS = ("motion", "n_windows", "n_auth", "scores", "window_id",
                "window_valid", "auth", "windows_dropped", "motion_dropped",
                "cascade_dropped")

# the resilience module's terminal rung, by value (see resilience.ON_NODE)
_ON_NODE = ("on_node", None)


class ServeError(ValueError):
    """Named serving-layer contract violation (DESIGN.md §14).

    Subclasses ``ValueError`` so callers that catch ``ValueError`` keep
    working; new callers catch the named family.
    """


class UnknownStreamError(ServeError):
    """An operation referenced a stream id the server does not know."""

    def __init__(self, sid, known):
        known = sorted(known)
        shown = ", ".join(repr(s) for s in known[:8])
        if len(known) > 8:
            shown += f", ... ({len(known)} total)"
        super().__init__(
            f"unknown stream {sid!r}; known streams: [{shown}]"
            if known else
            f"unknown stream {sid!r}; no streams are registered")
        self.sid = sid


class StreamDrainingError(ServeError):
    """The sid is still draining — re-register after the drain completes."""

    def __init__(self, sid, frames_left):
        super().__init__(
            f"stream {sid!r} is draining ({frames_left} frames still "
            "queued); re-registering now would clobber them — wait for "
            "the drain to complete")
        self.sid = sid
        self.frames_left = frames_left


def chunk_motion_scores(chunks, motion_factor):
    """Chunk motion energy — the cascade's cheap scorer.

    ``chunks`` is ``(n, chunk, h, w)``; returns the max intra-chunk
    transition score per chunk (``-inf`` for single-frame chunks, which
    can never clear a strictly-positive threshold).  The funnel's own
    ``motion_score``, so a filtered chunk is one the funnel's motion gate
    would pass no frame of.
    """
    if chunks.shape[1] < 2:
        return torch.full((chunks.shape[0],), -np.inf, dtype=torch.float32,
                          device=chunks.device)
    sc = motion_score(chunks[:, :-1], chunks[:, 1:], motion_factor)
    return sc.amax(dim=-1)


def _host_copy(tensors: dict) -> dict:
    """Device tensors -> numpy arrays in ONE device-to-host copy: every
    tensor's bytes are concatenated on the device, copied, and cut back
    into arrays of their dtypes and shapes on the host."""
    names = list(tensors)
    flat = [tensors[k].contiguous().reshape(-1).view(torch.uint8)
            for k in names]
    host = torch.cat(flat).cpu().numpy()
    out, o = {}, 0
    for k, b in zip(names, flat):
        t = tensors[k]
        dt = torch.empty(0, dtype=t.dtype).numpy().dtype
        out[k] = host[o:o + b.numel()].view(dt).reshape(tuple(t.shape))
        o += b.numel()
    return out


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Scheduler contract knobs (DESIGN.md §13/§14)."""

    chunk: int = 4              # frames per micro-batch slot
    capacity: int = 8           # micro-batch slots per placement group/tick
    slo_s: float = 0.5          # p99 micro-batch dispatch latency SLO (wall)
    tick_s: float = 1.0         # scheduler period (simulated seconds)
    max_queue_s: float = 6.0    # flush a partial chunk older than this
    resolve_every: int = 16     # served frames between per-stream re-solves
    link_window: int = 8        # ticks of byte traces per congestion report
    admit_util: float = 0.7     # uplink utilization ceiling at admission
    admit_headroom: float = 0.8 # admit only while link p99 <= headroom*slo
    admit_motion_frac: float = 0.5   # activity prior for undeclared streams
    admit_windows_per_frame: float = 2.0
    stats_window: int = 32      # chunks of funnel stats per stream window
    max_queue_frames: int = 64  # per-stream queue bound; overflow sheds
                                # oldest-first (0 disables the bound)


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    sid: str
    cut: str | None             # placement actually granted (may differ)
    bits: int | None
    reason: str
    predicted_bps: float = 0.0
    predicted_util: float = 0.0


@dataclasses.dataclass(frozen=True)
class Completion:
    """One chunk's delivery: per-frame leaves sliced to the real frames."""

    sid: str
    t: float
    n_frames: int
    kind: str                   # "served" | "quiet"
    result: dict                # FAExecResult fields, leading axis n_frames
    wire_bytes: float
    seqs: tuple = ()            # per-frame sequence numbers, len n_frames


@dataclasses.dataclass(frozen=True)
class ShedRecord:
    """Frames shed from one stream's bounded queue — surfaced, not silent."""

    sid: str
    seqs: tuple                 # shed frames' sequence numbers, oldest first
    arrivals: tuple             # their enqueue times


@dataclasses.dataclass(frozen=True)
class TickReport:
    t: float
    n_ready: int
    n_served: int
    n_quiet: int
    n_requeued: int
    batch_s: float              # wall clock of this tick's dispatches
    bytes_sent: float
    completions: tuple          # (Completion, ...)
    resolves_fired: int
    cut_changes: tuple          # ((sid, old_cut, new_cut), ...)
    shed: tuple = ()            # (ShedRecord, ...) since the last tick
    n_failed_tx: int = 0        # chunks whose delivery exhausted retries
    ladder_moves: tuple = ()    # ((sid, old_level, new_level), ...)
    device_events: tuple = ()   # (("kill"|"restore", device_index), ...)


@dataclasses.dataclass
class _Stream:
    sid: str
    fps: float
    cut: str | None
    bits: int | None
    t_join: float
    queue: deque                # (t_arrival, frame, seq) FIFO, seq ascending
    draining: bool = False
    frames_done: int = 0
    frames_since_resolve: int = 0
    resolves: int = 0
    requeues: int = 0
    declared_bps: float = 0.0
    seq_next: int = 0           # next sequence number to assign
    delivered_n: int = 0        # frames delivered in completions
    last_served_seq: int = -1   # highest seq ever delivered (monotone)
    shed_n: int = 0             # frames shed from the bounded queue
    tx_failures: int = 0        # chunk deliveries that exhausted retries
    deficit: float = 0.0        # DRR service credit, in frames
    order: int = 0              # registration rank (DRR tiebreak)
    ladder: object = None       # DegradationLadder | None (chaos plane)
    pending_shed: list = dataclasses.field(default_factory=list)
    stats: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=32))   # (n, motion, windows)
    trace: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=8))    # bytes per tick
    transitions: list = dataclasses.field(default_factory=list)

    @property
    def rung(self):
        """Effective placement: the ladder's rung while it holds the
        stream below rung 0 (``ON_NODE`` maps to the local group), the
        granted ``(cut, bits)`` otherwise."""
        if self.ladder is not None and self.ladder.level > 0:
            r = tuple(self.ladder.rung)
            return (None, None) if r == _ON_NODE else r
        return (self.cut, self.bits if self.cut is not None else None)

    def window_stats(self):
        """Sliding-window mean (motion_frames, valid_windows) per chunk."""
        rows = [r for r in self.stats if r[0] > 0]
        if not rows:
            return 0.0, 0.0
        n = len(rows)
        return (sum(r[1] for r in rows) / n, sum(r[2] for r in rows) / n)


@dataclasses.dataclass(frozen=True)
class _ReadyChunk:
    sid: str
    frames: np.ndarray          # (chunk, h, w) f32, padded with last frame
    arrivals: tuple             # simulated arrival times, len n_real
    seqs: tuple                 # per-frame sequence numbers, len n_real
    n_real: int


class StreamingServer:
    """Fleet-scale streaming front door over one :class:`FaceAuthExecutor`
    (its device: the card unless the executor was built on the CPU).

    ``base`` must be calibrated.  ``controller`` (a ``CutController``
    calibrated for the same base) enables windowed per-stream cut
    re-solves; without it, granted cuts are static.  ``link`` is the
    shared uplink every offloaded stream transmits on.  ``chaos`` (a
    :class:`~repro_torch.camera.serve.chaos.ChaosSpec` or
    ``ChaosEngine``) arms the §14 fault plane; None — or an inert spec —
    leaves every served output bit-identical to running without it.  ``telemetry``
    (a :class:`repro_torch.obs.Telemetry`) arms the §15 observability
    plane: per-tick spans, link/chaos/ladder/failover trace events, fleet
    counters, and the per-(stream, rung) SLO ledger; None or disabled
    changes nothing — not one host branch, not one launch.

    ``devices`` (torch devices, default the executor's) is the serving
    host's device list, the reference's ``jax.local_devices()``: the local
    placement group shards its slots over the healthy ones when they
    divide the batch, and ``kill_device`` / ``restore_device`` index it.
    A device listed twice stands for two (the CPU tests' fake hosts).
    """

    def __init__(self, base, *, link=None, controller=None,
                 config: ServeConfig = ServeConfig(), chaos=None,
                 telemetry=None, devices=None):
        self.base = base
        self.cfg = config
        self.link = link or BACKSCATTER
        self.controller = controller
        # §15 telemetry plane: None or disabled leaves every host code
        # path and every launch exactly as the uninstrumented runtime
        self.telemetry = telemetry
        self._tel_on = telemetry_on(telemetry)
        self.h, self.w = base.det.grid.h, base.det.grid.w
        self._streams: dict = {}
        self._group_steps: dict = {}
        self._offload_execs: dict = {}
        self._quiet_cache: dict = {}
        self.tick_count = 0
        self.frames_completed = 0
        self.batch_lat_s: list = []      # wall seconds per dispatching tick
        self.queue_delay_s: list = []    # simulated frame sojourn times
        self.last_link_report = None
        self.rejections: list = []
        self.total_enqueued = 0          # fleet seq-accounting counters:
        self.total_delivered = 0         # survive stream churn so the
        self.total_shed = 0              # audit holds across reaps
        self._order_counter = 0
        self._devices = ([torch.device(d) for d in devices]
                         if devices is not None else [base.device])
        if not self._devices:
            raise ServeError("devices must list at least one device")
        self._dead: set = set()          # dead device indices
        self._chaos = self._wrap_chaos(chaos)
        # scorer semantics == the funnel's motion gate: survive iff any
        # intra-chunk transition scores strictly above motion_threshold
        self._score_threshold = float(np.nextafter(
            np.float32(base.motion_threshold), np.float32(np.inf)))

    @staticmethod
    def _wrap_chaos(chaos):
        if chaos is None:
            return None
        if isinstance(chaos, ChaosEngine):
            return chaos
        if isinstance(chaos, ChaosSpec):
            return ChaosEngine(chaos)
        raise TypeError(
            f"chaos= wants a ChaosSpec or ChaosEngine, got "
            f"{type(chaos).__name__}")

    # -- registration / churn -------------------------------------------------

    def register(self, sid: str, *, fps: float = 1.0, cut: str | None = None,
                 bits: int | None = 8, t: float = 0.0,
                 motion_frac: float | None = None) -> AdmissionDecision:
        """Admit (or reject, or re-place) one new stream.

        Local streams (``cut=None``) are admitted against the compute
        budget; offloaded streams against the shared-uplink budget — if
        the requested cut does not fit, cheaper-byte cuts are tried before
        rejecting, so a stream may be granted a different placement than
        it asked for (congestion-aware placement at admission time).
        Under chaos, a faulty stream's predicted bps is inflated by its
        expected retransmission factor so retries are budgeted up front.
        """
        st = self._streams.get(sid)
        if st is not None:
            if st.draining:
                raise StreamDrainingError(sid, len(st.queue))
            raise ServeError(f"stream {sid!r} already registered")
        cfg = self.cfg
        if cut is None:
            projected = sum(s.fps for s in self._streams.values()
                            if s.cut is None) + fps
            budget = cfg.capacity * cfg.chunk / cfg.tick_s
            if projected > cfg.admit_headroom * budget:
                dec = AdmissionDecision(
                    False, sid, None, None,
                    f"compute: {projected:.1f} fps over "
                    f"{cfg.admit_headroom * budget:.1f} fps budget")
                self.rejections.append(dec)
                return dec
            self._admit(sid, fps, None, None, t, 0.0)
            return AdmissionDecision(True, sid, None, None, "admitted")

        if cut not in FA_CUTS:
            raise ServeError(f"cut {cut!r} not in {FA_CUTS}")
        frac = cfg.admit_motion_frac if motion_frac is None else motion_frac
        retx = self._chaos.retx_factor(sid) if self._chaos is not None else 1.0
        fleet_bps = sum(s.declared_bps for s in self._streams.values())
        p99 = (self.last_link_report.p99_latency_s
               if self.last_link_report is not None else 0.0)
        if p99 > cfg.admit_headroom * cfg.slo_s:
            dec = AdmissionDecision(
                False, sid, cut, bits,
                f"congestion: link p99 {p99:.3f}s over "
                f"{cfg.admit_headroom * cfg.slo_s:.3f}s headroom")
            self.rejections.append(dec)
            return dec
        candidates = [cut] + [c for c in FA_CUTS if c != cut]
        candidates.sort(key=lambda c: (c != cut,
                                       self._predict_bps(c, bits, fps, frac)))
        for c in candidates:
            bps = self._predict_bps(c, bits, fps, frac) * retx
            util = (fleet_bps + bps) / self.link.bytes_per_s
            if util <= cfg.admit_util:
                reason = ("admitted" if c == cut else
                          f"re-placed from {cut!r}: requested cut over "
                          f"{cfg.admit_util:.0%} uplink utilization")
                self._admit(sid, fps, c, bits, t, bps)
                return AdmissionDecision(True, sid, c, bits, reason, bps, util)
        bps = self._predict_bps(candidates[-1], bits, fps, frac) * retx
        dec = AdmissionDecision(
            False, sid, cut, bits,
            f"uplink: even cheapest cut exceeds {cfg.admit_util:.0%} "
            f"utilization ({fleet_bps:.0f}+{bps:.0f} B/s of "
            f"{self.link.bytes_per_s:.0f})", bps,
            (fleet_bps + bps) / self.link.bytes_per_s)
        self.rejections.append(dec)
        return dec

    def _predict_bps(self, cut, bits, fps, motion_frac):
        cfg = self.cfg
        chunk_b = fa_cut_bytes(
            cut, bits, frames=cfg.chunk, h=self.h, w=self.w,
            motion_frames=motion_frac * cfg.chunk,
            valid_windows=motion_frac * cfg.chunk
            * cfg.admit_windows_per_frame)
        return chunk_b / cfg.chunk * fps

    def _admit(self, sid, fps, cut, bits, t, bps):
        cfg = self.cfg
        st = _Stream(sid=sid, fps=fps, cut=cut,
                     bits=bits if cut is not None else None, t_join=t,
                     queue=deque(), declared_bps=bps,
                     order=self._order_counter)
        self._order_counter += 1
        st.stats = deque(maxlen=cfg.stats_window)
        st.trace = deque([0.0] * min(self.tick_count, cfg.link_window),
                         maxlen=cfg.link_window)
        st.ladder = self._build_ladder(sid, cut, bits)
        self._streams[sid] = st

    def unregister(self, sid: str) -> int:
        """Begin draining ``sid``; queued frames are still served.

        Returns the number of frames left in the queue — the stream object
        disappears once they have all completed (immediately when empty).
        """
        st = self._streams.get(sid)
        if st is None:
            raise UnknownStreamError(sid, self._streams)
        st.draining = True
        n = len(st.queue)
        if n == 0:
            del self._streams[sid]
        return n

    def enqueue(self, sid: str, frame, t: float) -> int:
        """Queue one frame; returns its per-stream sequence number.

        Validates the frame against the registered stream's geometry
        *here*, where the caller can still tell which stream misbehaved —
        not inside the next tick's fused dispatch.  When the bounded
        queue overflows, the *oldest* queued frames are shed (the stalest
        data is the least useful under overload) and surfaced in the next
        :class:`TickReport`'s ``shed`` records.
        """
        st = self._streams.get(sid)
        if st is None:
            raise UnknownStreamError(sid, self._streams)
        if st.draining:
            raise StreamDrainingError(sid, len(st.queue))
        try:
            arr = np.asarray(frame, np.float32)
        except (TypeError, ValueError) as e:
            raise ServeError(
                f"stream {sid!r}: frame is not float32-castable "
                f"({e})") from e
        if arr.shape != (self.h, self.w):
            raise ServeError(
                f"stream {sid!r}: frame shape {arr.shape} != registered "
                f"({self.h}, {self.w})")
        seq = st.seq_next
        st.seq_next += 1
        self.total_enqueued += 1
        st.queue.append((float(t), arr, seq))
        bound = self.cfg.max_queue_frames
        if bound and len(st.queue) > bound:
            a, _f, sq = st.queue.popleft()
            st.pending_shed.append((a, sq))
            st.shed_n += 1
            self.total_shed += 1
        return seq

    @property
    def streams(self):
        return dict(self._streams)

    # -- chaos plane: devices + ladders ---------------------------------------

    def _healthy(self) -> tuple:
        return tuple(d for i, d in enumerate(self._devices)
                     if i not in self._dead)

    def kill_device(self, idx: int):
        """Simulate losing device ``idx`` of the server's list — placement
        groups sharded over it re-shard onto the survivors at the next
        dispatch (the single-device batch when they stop dividing)."""
        if not 0 <= idx < len(self._devices):
            raise ServeError(
                f"device index {idx} out of range "
                f"[0, {len(self._devices)})")
        self._dead.add(int(idx))
        if not self._healthy():
            self._dead.discard(int(idx))
            raise ServeError(
                "cannot kill the last healthy device — the serving host "
                "needs at least one")
        if self._tel_on:
            self.telemetry.emit(
                "chaos", "device_kill", t=self.tick_count * self.cfg.tick_s,
                tick=self.tick_count, device=int(idx),
                healthy=len(self._healthy()))
            self.telemetry.counters.bump("serve.device_kills")

    def restore_device(self, idx: int):
        """Bring device ``idx`` back; groups re-shard to the wider set.

        Local closures stay cached per healthy-device set (``_group_step``
        selects by the *current* set every tick, so a stale entry is never
        dispatched), which makes flapping kill/restore cycles rebuild
        nothing.
        """
        self._dead.discard(int(idx))
        if self._tel_on:
            self.telemetry.emit(
                "chaos", "device_restore",
                t=self.tick_count * self.cfg.tick_s,
                tick=self.tick_count, device=int(idx),
                healthy=len(self._healthy()))
            self.telemetry.counters.bump("serve.device_restores")

    def _ladder_kwargs(self):
        cfg = self.cfg
        if self._chaos is not None:
            spec = self._chaos.spec
            return dict(window=spec.ladder_window,
                        max_retry_frac=spec.ladder_max_retry_frac,
                        deadline_s=cfg.slo_s,
                        recover_after=spec.ladder_recover_after)
        return dict(deadline_s=cfg.slo_s)

    def _make_ladder(self, rungs):
        return DegradationLadder(rungs, **self._ladder_kwargs())

    def _ladder_rungs(self, cut, bits):
        """Rung list below one granted placement: narrower codecs, the
        calibrated-cheapest cut (via the controller when it has
        measurements), then all-on-node."""
        widths = [bits] + [b for b in (8, 4) if bits is None or b < bits]
        if self.controller is not None and \
                getattr(self.controller, "measurements", None):
            try:
                return self.controller.degradation_rungs(
                    cut, bits_ladder=tuple(widths))
            except ValueError:
                pass
        return [(cut, b) for b in widths] + [_ON_NODE]

    def _build_ladder(self, sid, cut, bits):
        if self._chaos is None or cut is None:
            return None
        if not self._chaos.is_faulty(sid):
            return None
        return self._make_ladder(self._ladder_rungs(cut, bits))

    def _injector(self, sid):
        return None if self._chaos is None else self._chaos.injector_for(sid)

    def _transmit(self, inj, wire_b, t):
        """One chunk delivery through a stream's fault process.

        Returns ``(delivered, bytes_on_air, attempts, lost, corrupt)``.
        Every attempt re-ships payload + session sideband; exhausted
        retries mean the cloud never saw the chunk (the caller re-queues
        the frames — they are retried, not lost).
        """
        per = float(wire_b) + SESSION_SIDEBAND_BYTES
        max_att = 1 + self._chaos.spec.max_retries
        lost = corrupt = 0
        on_air = 0.0
        for att in range(1, max_att + 1):
            on_air += per
            outcome = inj.attempt(t)
            if outcome == "ok":
                return True, on_air, att, lost, corrupt
            if outcome == "corrupt":
                corrupt += 1
            else:
                lost += 1
        return False, on_air, max_att, lost, corrupt

    def _observe_ladder(self, st, moves, *, rung, delivered, attempts, lost,
                        corrupt, payload_b, on_air, latency_s):
        cut, bits = rung
        rec = DeliveryRecord(
            seq=st.frames_done, cut=cut, bits=bits, delivered=delivered,
            fallback=False, attempts=attempts, lost=lost, corrupt=corrupt,
            payload_bytes=payload_b, bytes_on_air=on_air, compute_s=0.0,
            latency_s=latency_s, energy_j=on_air * self.link.joules_per_byte,
            brownouts=0, restores=0, recovery_s=0.0)
        old = st.ladder.level
        st.ladder.observe(rec)
        if st.ladder.level != old:
            moves.append((st.sid, old, st.ladder.level))
            if self._tel_on:
                self.telemetry.emit(
                    "ladder",
                    "descend" if st.ladder.level > old else "recover",
                    t=self.tick_count * self.cfg.tick_s,
                    tick=self.tick_count, sid=st.sid, old_level=old,
                    new_level=st.ladder.level,
                    rung=rung_key(tuple(st.ladder.rung)))
                self.telemetry.counters.bump("serve.ladder_moves")

    # -- placement groups ------------------------------------------------------

    def _bucket(self, n: int) -> int:
        """Round a ready-count up to a multiple of ``capacity``.

        Dispatch batch shapes come from a small static set, as the
        reference's (whose every new shape is a compile): the same shapes
        give the same scheduling decisions in both packages.
        """
        cap = self.cfg.capacity
        return cap * max(1, -(-n // cap))

    def prewarm(self, rungs, *, max_ready: int | None = None,
                device_counts=()):
        """Run every placement group once ahead of the measured ticks.

        One zeros dispatch through the full scorer->cascade->group path
        per ``rung`` x shape bucket (buckets cover ``max_ready`` ready
        chunks, default one ``capacity``).  Zero chunks are motionless,
        so nothing is observed and no stats move; the dispatch builds the
        kernels and warms the allocator, as the reference's compiles.

        ``device_counts`` also runs the local group over degraded device
        prefixes (e.g. ``(3, 1)`` on a 4-device server whose chaos
        schedule kills the last device), building their closures.
        """
        cfg = self.cfg
        top = self._bucket(max_ready or cfg.capacity)
        widths = range(cfg.capacity, top + 1, cfg.capacity)
        healthy = self._healthy_idx()
        local_keys = [None if not self._dead else healthy]
        for n in device_counts:
            n = max(1, min(int(n), len(healthy)))
            local_keys.append(healthy[:n])
        steps = []
        for rung in rungs:
            if rung == (None, None):
                steps.extend(self._local_step_for(k) for k in local_keys)
            else:
                steps.append(self._group_step(rung))
        for step in steps:
            for b in widths:
                stack = torch.zeros((b, cfg.chunk, self.h, self.w),
                                    dtype=torch.float32,
                                    device=self.base.device)
                out = cascade_serve(self._scores, step, stack,
                                    threshold=self._score_threshold,
                                    capacity=cfg.capacity)
                _host_copy({"served": out[1]})

    def _healthy_idx(self) -> tuple:
        return tuple(i for i in range(len(self._devices))
                     if i not in self._dead)

    def _local_step_for(self, devices_key):
        """Local placement-group step over one healthy-device set.

        ``devices_key`` is None for "every device of the server" (no
        device lost) or a tuple of indices into the server's device
        list — the failover shape after kills.  Cached per key, so
        restoring a previously-seen set reuses its closure.
        """
        key = ((None, None), devices_key)
        step = self._group_steps.get(key)
        if step is not None:
            return step
        cap, chunk = self.cfg.capacity, self.cfg.chunk
        devs = (self._devices if devices_key is None
                else [self._devices[i] for i in devices_key])
        inner = self.base.batch_step(cap, chunk, devices=devs)
        ones = torch.ones((cap,), dtype=torch.bool, device=self.base.device)

        def step(chunks):
            out = dict(inner(chunks, ones))
            out["wire_b"] = torch.zeros((cap,), dtype=torch.float32,
                                        device=chunks.device)
            return out

        self._group_steps[key] = step
        return step

    def _group_step(self, rung):
        """Cached single-dispatch micro-batch closure for one placement."""
        cut, bits = rung
        if cut is None:
            return self._local_step_for(
                None if not self._dead else self._healthy_idx())
        key = (rung, None)
        step = self._group_steps.get(key)
        if step is not None:
            return step
        off = self._offload_execs.get(rung)
        if off is None:
            off = FaceAuthOffloadExecutor(self.base, cut, bits=bits)
            self._offload_execs[rung] = off
        shape = (self.cfg.chunk, self.h, self.w)

        def step(chunks):
            arrays, wire_b = off.encode_slots(chunks)
            out = dict(off.decode_slots(arrays, shape))
            out["wire_b"] = wire_b
            return out

        self._group_steps[key] = step
        return step

    def _scores(self, chunks):
        """Chunk motion energy — the cascade's cheap scorer."""
        return chunk_motion_scores(chunks, self.base.motion_factor)

    def _quiet_result(self, n):
        res = self._quiet_cache.get(n)
        if res is None:
            W = self.base.stages.window_capacity
            res = dict(
                motion=np.zeros(n, bool),
                n_windows=np.zeros(n, np.int32),
                n_auth=np.zeros(n, np.int32),
                scores=np.zeros((n, W), np.float32),
                window_id=np.full((n, W), -1, np.int32),
                window_valid=np.zeros((n, W), bool),
                auth=np.zeros((n, W), bool),
                windows_dropped=np.zeros(n, np.int32),
                motion_dropped=np.int32(0),
                cascade_dropped=np.zeros(n, np.int32))
            self._quiet_cache[n] = res
        return res

    # -- the tick --------------------------------------------------------------

    def _gather_ready(self, t):
        """Take at most one eligible chunk per stream, in DRR order.

        Deficit-round-robin slot grants: streams are visited by
        ``(-deficit, registration order)``; every visited-and-eligible
        stream accrues one chunk-quantum.  The ready order IS the
        dispatch stack order, so ``cascade_serve``'s deterministic
        keep-lowest-indices capacity drop serves the highest-deficit
        streams first — capacity-dropped streams keep their credit and
        outrank this tick's winners next tick.  With no contention every
        deficit stays zero and the order degenerates to registration
        order, bit for bit.
        """
        cfg = self.cfg
        ready = []
        for st in sorted(self._streams.values(),
                         key=lambda s: (-s.deficit, s.order)):
            q = st.queue
            if not q:
                continue
            full = len(q) >= cfg.chunk
            stale = (t - q[0][0]) >= cfg.max_queue_s
            if not (full or stale or st.draining):
                continue
            st.deficit += float(cfg.chunk)
            n_real = min(cfg.chunk, len(q))
            taken = [q.popleft() for _ in range(n_real)]
            frames = [f for _, f, _ in taken]
            while len(frames) < cfg.chunk:      # pad: repeated last frame is
                frames.append(frames[-1])       # motionless, hence quiet
            ready.append(_ReadyChunk(
                sid=st.sid, frames=np.stack(frames),
                arrivals=tuple(a for a, _, _ in taken),
                seqs=tuple(s for _, _, s in taken), n_real=n_real))
        return ready

    def _collect_shed(self):
        # canonical sorted-sid order — the same ordering seq_audit uses,
        # so shed records and audit rows line up row-for-row (dict
        # insertion order diverges from it once churn re-registers a
        # stream)
        shed = []
        for st in sorted(self._streams.values(), key=lambda s: s.sid):
            if st.pending_shed:
                shed.append(ShedRecord(
                    sid=st.sid,
                    seqs=tuple(sq for _, sq in st.pending_shed),
                    arrivals=tuple(a for a, _ in st.pending_shed)))
                st.pending_shed = []
        return tuple(shed)

    def _requeue(self, st, rc):
        for a, f, sq in zip(reversed(rc.arrivals),
                            reversed(rc.frames[:rc.n_real]),
                            reversed(rc.seqs)):
            st.queue.appendleft((a, f, sq))

    def tick(self, t: float) -> TickReport:
        """One scheduler period at simulated time ``t``."""
        cfg = self.cfg
        t0 = time.perf_counter()
        events = []
        if self._chaos is not None:
            for kind, idx in self._chaos.events_at(self.tick_count):
                (self.kill_device if kind == "kill"
                 else self.restore_device)(idx)
                events.append((kind, idx))
        if self._tel_on and events and any(
                s.cut is None for s in self._streams.values()):
            # the local placement group re-shards at this tick's dispatch
            self.telemetry.emit(
                "failover", "local_group_reshard", t=t,
                tick=self.tick_count,
                events=[list(e) for e in events],
                healthy=len(self._healthy()), dead=sorted(self._dead))
        shed = self._collect_shed()
        if self._tel_on:
            for sr in shed:
                self.telemetry.emit(
                    "shed", "queue_overflow", t=t, tick=self.tick_count,
                    sid=sr.sid, seq_lo=min(sr.seqs), seq_hi=max(sr.seqs),
                    n=len(sr.seqs))
                self.telemetry.counters.bump("serve.frames_shed",
                                             len(sr.seqs))
        ready = self._gather_ready(t)
        gathered = [self._streams[rc.sid] for rc in ready]
        groups: dict = {}
        for rc in ready:
            groups.setdefault(self._streams[rc.sid].rung, []).append(rc)

        p99_link = (self.last_link_report.p99_latency_s
                    if self.last_link_report is not None
                    else self.link.latency_s)
        completions, changes, moves = [], [], []
        tick_bytes = {sid: 0.0 for sid in self._streams}
        n_served = n_quiet = n_requeued = n_failed_tx = 0
        dispatched = False
        led_obs = []                     # (sid, rung, arrivals) per delivery
        for rung, rcs in groups.items():
            dispatched = True
            cut, bits = rung
            disp_t0 = time.perf_counter() if self._tel_on else 0.0
            # pad the request stack to a capacity-multiple bucket so both
            # the big model's (capacity, ...) batch and the scorer's see
            # tick-invariant shapes: zero chunks are motionless, score
            # below threshold, filtered before any compute.  The stack is
            # built on the host and crosses to the device in one copy.
            n = len(rcs)
            b = self._bucket(n)
            stack = np.zeros((b, cfg.chunk, self.h, self.w), np.float32)
            for i, rc in enumerate(rcs):
                stack[i] = rc.frames
            outputs, served, stats = cascade_serve(
                self._scores, self._group_step(rung),
                torch.from_numpy(stack).to(self.base.device),
                threshold=self._score_threshold, capacity=cfg.capacity)
            # every output of the group, one device-to-host copy
            out_np = _host_copy({**outputs, "_served": served,
                                 "_dropped": stats["dropped_capacity_idx"]})
            served = out_np.pop("_served")
            dropped = set(int(i) for i in out_np.pop("_dropped") if i >= 0)
            if self._tel_on:
                # harvest funnel tel_ aux (present when the base executor
                # is itself instrumented); out_np is already on the host,
                # so this adds no device sync
                for k in [k for k in out_np if k.startswith("tel_")]:
                    self.telemetry.counters.bump(
                        "exec." + k[4:], int(out_np.pop(k).sum()))

                self.telemetry.emit(
                    "dispatch", f"group:{rung_key(rung)}", t=t,
                    dur=time.perf_counter() - disp_t0,
                    tick=self.tick_count, n_chunks=n, bucket=b,
                    n_served=int(served.sum()),
                    n_capacity_dropped=len(dropped))
                self.telemetry.counters.bump("serve.dispatches")
            for i, rc in enumerate(rcs):
                st = self._streams[rc.sid]
                if i in dropped:                 # re-queue, oldest first
                    n_requeued += 1
                    st.requeues += 1
                    self._requeue(st, rc)
                    continue
                if served[i]:
                    n_served += 1
                    result = {k: (out_np[k][i] if out_np[k][i].ndim == 0
                                  else out_np[k][i][:rc.n_real])
                              for k in _RESULT_KEYS}
                    wire = float(out_np["wire_b"][i]) if cut else 0.0
                    kind = "served"
                    motion_n = int(result["motion"].sum())
                    windows_n = int(result["window_valid"].sum())
                else:                            # scorer-filtered: quiet
                    n_quiet += 1
                    q = self._quiet_result(cfg.chunk)
                    result = {k: (q[k] if np.ndim(q[k]) == 0
                                  else q[k][:rc.n_real]) for k in _RESULT_KEYS}
                    wire = (fa_quiet_bytes(cut, bits, frames=cfg.chunk,
                                           h=self.h, w=self.w)
                            if cut else 0.0)
                    kind = "quiet"
                    motion_n = windows_n = 0
                inj = self._injector(rc.sid)
                payload_b = wire
                if cut is not None and inj is not None:
                    # chaos plane: the chunk transits the stream's fault
                    # process; every attempt congests the shared uplink
                    ok, on_air, att, lost, corrupt = \
                        self._transmit(inj, wire, t)
                    lat = (t - rc.arrivals[0]) + p99_link
                    if self._tel_on:
                        self.telemetry.emit(
                            "link", "chunk_tx", t=t, tick=self.tick_count,
                            sid=rc.sid, delivered=bool(ok), attempts=att,
                            lost=lost, crc_fail=corrupt,
                            payload_b=payload_b, on_air_b=on_air,
                            seq_lo=rc.seqs[0], seq_hi=rc.seqs[-1],
                            fault_id=self._chaos.fault_id(rc.sid))
                        c = self.telemetry.counters
                        c.bump("serve.link_attempts", att)
                        c.bump("serve.link_lost", lost)
                        c.bump("serve.link_crc_fail", corrupt)
                        c.bump("serve.bytes_on_air", int(round(on_air)))
                    if st.ladder is not None:
                        self._observe_ladder(
                            st, moves, rung=rung, delivered=ok,
                            attempts=att, lost=lost, corrupt=corrupt,
                            payload_b=payload_b, on_air=on_air,
                            latency_s=lat)
                    tick_bytes[rc.sid] = tick_bytes.get(rc.sid, 0.0) + on_air
                    if not ok:
                        # the cloud never received the payload — retried
                        # next tick (possibly at a degraded rung), not lost
                        n_failed_tx += 1
                        st.tx_failures += 1
                        self._requeue(st, rc)
                        continue
                    wire = on_air
                elif cut is not None:
                    tick_bytes[rc.sid] = tick_bytes.get(rc.sid, 0.0) + wire
                elif (inj is not None and st.ladder is not None
                        and st.ladder.level > 0):
                    # ON_NODE rung: the decision beacon probes the channel
                    # so hysteresis recovery has a signal
                    beacon = fa_decision_bytes(rc.n_real)
                    ok_b, on_air, att, lost, corrupt = \
                        self._transmit(inj, beacon, t)
                    self._observe_ladder(
                        st, moves, rung=_ON_NODE, delivered=ok_b,
                        attempts=att, lost=lost, corrupt=corrupt,
                        payload_b=beacon, on_air=on_air, latency_s=0.0)
                    tick_bytes[rc.sid] = tick_bytes.get(rc.sid, 0.0) + on_air
                if (cut is not None and kind == "served"
                        and self.controller is not None):
                    # the byte model learns from the payload, never from
                    # retransmissions — faults must not skew predictions
                    self.controller.observe(cut, units=rc.n_real,
                                            wire_bytes=payload_b)
                st.stats.append((rc.n_real, motion_n, windows_n))
                st.frames_done += rc.n_real
                st.delivered_n += rc.n_real
                st.last_served_seq = max(st.last_served_seq, rc.seqs[-1])
                self.total_delivered += rc.n_real
                st.deficit = max(0.0, st.deficit - float(cfg.chunk))
                if st.cut is not None:
                    st.frames_since_resolve += rc.n_real
                if self._tel_on:
                    led_obs.append((rc.sid, rung, rc.arrivals))
                    c = self.telemetry.counters
                    c.bump("serve.frames_delivered", rc.n_real)
                    c.bump("serve.chunks_" + kind)
                completions.append(Completion(
                    sid=rc.sid, t=t, n_frames=rc.n_real, kind=kind,
                    result=result, wire_bytes=wire, seqs=rc.seqs))

        # DRR normalization: shift gathered deficits down by their min so
        # credits stay bounded (relative order — the only thing the grant
        # sort reads — is unchanged)
        if gathered:
            m = min(st.deficit for st in gathered)
            if m > 0.0:
                for st in gathered:
                    st.deficit -= m

        batch_s = time.perf_counter() - t0
        if dispatched:
            self.batch_lat_s.append(batch_s)
        # simulated frame sojourn: queue wait + this tick's dispatch
        # (at most one ready chunk per stream per tick, so sid identifies it)
        completed_sids = {c.sid for c in completions}
        for rc in ready:
            if rc.sid in completed_sids:
                self.queue_delay_s.extend(
                    (t + batch_s) - a for a in rc.arrivals)
        self.frames_completed += sum(c.n_frames for c in completions)
        if self._tel_on:
            for sid, rung, arrivals in led_obs:
                for a in arrivals:
                    self.telemetry.ledger.observe_latency(
                        sid, rung, (t + batch_s) - a)
            depths = [len(s.queue) for s in self._streams.values()]
            self.telemetry.emit(
                "tick", f"tick{self.tick_count}", t=t, dur=batch_s,
                tick=self.tick_count, n_streams=len(self._streams),
                n_ready=len(ready), n_served=n_served, n_quiet=n_quiet,
                n_requeued=n_requeued, n_failed_tx=n_failed_tx,
                queue_frames=int(sum(depths)),
                queue_max=int(max(depths, default=0)),
                deficit_max=float(max(
                    (s.deficit for s in self._streams.values()),
                    default=0.0)),
                bytes_sent=float(sum(tick_bytes.values())))
            c = self.telemetry.counters
            c.bump("serve.ticks")
            c.bump("serve.chunks_requeued", n_requeued)
            c.bump("serve.tx_failures", n_failed_tx)

        # byte traces + congestion report
        for sid, st in self._streams.items():
            st.trace.append(tick_bytes.get(sid, 0.0))
        self.tick_count += 1
        if (self.tick_count % cfg.link_window == 0
                and any(s.cut is not None for s in self._streams.values())):
            self._refresh_link_report()
        # refresh measured offered load for admission
        for st in self._streams.values():
            if st.cut is not None and st.trace:
                st.declared_bps = (sum(st.trace)
                                   / (len(st.trace) * cfg.tick_s))

        resolves = self._maybe_resolve(changes)
        if self._tel_on and resolves:
            self.telemetry.counters.bump("serve.resolves_fired", resolves)
            for sid, old_cut, new_cut in changes:
                self.telemetry.emit(
                    "dispatch", "cut_change", t=t, tick=self.tick_count,
                    sid=sid, old_cut=str(old_cut), new_cut=str(new_cut))
        self._reap_drained()
        return TickReport(
            t=t, n_ready=len(ready), n_served=n_served, n_quiet=n_quiet,
            n_requeued=n_requeued, batch_s=batch_s,
            bytes_sent=float(sum(tick_bytes.values())),
            completions=tuple(completions), resolves_fired=resolves,
            cut_changes=tuple(changes), shed=shed,
            n_failed_tx=n_failed_tx, ladder_moves=tuple(moves),
            device_events=tuple(events))

    def _refresh_link_report(self):
        cfg = self.cfg
        rows = [list(s.trace) for s in self._streams.values()
                if s.cut is not None and s.trace]
        if not rows:
            return
        width = max(len(r) for r in rows)
        mat = np.zeros((len(rows), width))
        for i, r in enumerate(rows):
            mat[i, width - len(r):] = r
        self.last_link_report = simulate_shared_link(
            mat, self.link, frame_period_s=cfg.tick_s)

    def _maybe_resolve(self, changes):
        """Windowed per-stream cut re-solves under the congestion deadline.

        Ladder-degraded streams are skipped — during an incident the
        ladder has the wheel; once it recovers to rung 0 the solver
        resumes, and a re-solve that changes the cut rebuilds the
        stream's rung list around the new placement.
        """
        cfg = self.cfg
        if self.controller is None:
            return 0
        fired = 0
        p99 = (self.last_link_report.p99_latency_s
               if self.last_link_report is not None else self.link.latency_s)
        for st in self._streams.values():
            if st.cut is None or st.frames_since_resolve < cfg.resolve_every:
                continue
            if st.ladder is not None and st.ladder.level > 0:
                continue
            m, v = st.window_stats()
            chunk_b = {c: fa_cut_bytes(c, st.bits, frames=cfg.chunk,
                                       h=self.h, w=self.w, motion_frames=m,
                                       valid_windows=v)
                       for c in FA_CUTS}
            cur = chunk_b[st.cut]
            lat = {c: max(self.link.latency_s,
                          p99 + (chunk_b[c] - cur) / self.link.bytes_per_s)
                   for c in FA_CUTS}
            sol = self.controller.resolve_window(
                deadline_s=cfg.slo_s, cut_latency_s=lat,
                predicted_bytes={c: chunk_b[c] / cfg.chunk for c in FA_CUTS})
            st.resolves += 1
            st.frames_since_resolve = 0
            fired += 1
            if sol.cut_after != st.cut:
                st.transitions.append((self.tick_count, st.cut,
                                       sol.cut_after))
                changes.append((st.sid, st.cut, sol.cut_after))
                st.cut = sol.cut_after
                if st.ladder is not None:
                    old = st.ladder
                    st.ladder = self._make_ladder(
                        self._ladder_rungs(st.cut, st.bits))
                    st.ladder.transitions = old.transitions
        return fired

    def _reap_drained(self):
        done = [sid for sid, st in self._streams.items()
                if st.draining and not st.queue]
        for sid in done:
            del self._streams[sid]

    # -- checkpoint / restore (DESIGN.md §14) ----------------------------------

    def checkpoint(self, ckpt_dir: str, step: int | None = None) -> str:
        """Persist the full server state at a tick boundary, in the
        reference's checkpoint layout.

        Queue contents go to the array tree (one leaf triple per stream:
        arrival times, frames, sequence numbers); every scalar — stream
        descriptors, ladder levels, DRR credits, seq counters, controller
        windows — rides the JSON ``extra``.  Call between ticks only: a
        mid-tick snapshot would double-serve in-flight chunks on restore.
        Wall-clock metric lists (``batch_lat_s``/``queue_delay_s``) are
        host measurements, not server state, and reset on restore.
        """
        tree = {"queues": {}}
        meta = {}
        for sid, st in self._streams.items():
            q = list(st.queue)
            tree["queues"][sid] = {
                "t": np.asarray([a for a, _, _ in q], np.float64),
                "f": (np.stack([f for _, f, _ in q])
                      if q else np.zeros((0, self.h, self.w), np.float32)),
                "seq": np.asarray([s for _, _, s in q], np.int64),
            }
            lad = None
            if st.ladder is not None:
                lad = {"level": st.ladder.level,
                       "clean": st.ladder._clean,
                       "rungs": [list(r) for r in st.ladder.rungs],
                       "transitions": [list(x)
                                       for x in st.ladder.transitions]}
            meta[sid] = {
                "fps": st.fps, "cut": st.cut, "bits": st.bits,
                "t_join": st.t_join, "draining": st.draining,
                "frames_done": st.frames_done,
                "frames_since_resolve": st.frames_since_resolve,
                "resolves": st.resolves, "requeues": st.requeues,
                "declared_bps": st.declared_bps, "seq_next": st.seq_next,
                "delivered_n": st.delivered_n,
                "last_served_seq": st.last_served_seq,
                "shed_n": st.shed_n, "tx_failures": st.tx_failures,
                "deficit": st.deficit, "order": st.order,
                "qlen": len(q),
                "pending_shed": [list(x) for x in st.pending_shed],
                "stats": [list(x) for x in st.stats],
                "trace": list(st.trace),
                "transitions": [list(x) for x in st.transitions],
                "ladder": lad,
            }
        ctl = None
        if self.controller is not None:
            ctl = {"resolves": self.controller.resolves,
                   "window_obs": {c: [list(row) for row in dq]
                                  for c, dq in
                                  self.controller._window_obs.items()}}
        extra = {
            "version": 1,
            "tick_count": self.tick_count,
            "frames_completed": self.frames_completed,
            "total_enqueued": self.total_enqueued,
            "total_delivered": self.total_delivered,
            "total_shed": self.total_shed,
            "order_counter": self._order_counter,
            "dead_devices": sorted(self._dead),
            "streams": meta,
            "controller": ctl,
        }
        if self._tel_on:
            # optional key: telemetry totals + ledger survive the restart
            # (checkpoints written without it restore fine — .get below)
            extra["telemetry"] = self.telemetry.state_dict()
            self.telemetry.emit(
                "ckpt", "checkpoint",
                t=self.tick_count * self.cfg.tick_s, tick=self.tick_count,
                step=int(self.tick_count if step is None else step))
        if step is None:
            step = self.tick_count
        return save_checkpoint(ckpt_dir, step, tree, extra=extra)

    @classmethod
    def restore(cls, ckpt_dir: str, base, *, link=None, controller=None,
                config: ServeConfig = ServeConfig(), chaos=None,
                telemetry=None, step: int | None = None,
                devices=None) -> "StreamingServer":
        """Rebuild a server from its newest (or ``step``'s) checkpoint.

        Resumes exactly where :meth:`checkpoint` left off: queued frames,
        seq counters, ladder levels, DRR credits, draining flags, dead
        devices, and the controller's sliding windows (written into the
        ``controller`` instance passed here).  Fault-injector RNG state is
        NOT part of server state — a restored fleet faults afresh from
        its seeds, which models an independent post-restart channel.
        Either package's server restores what the other wrote.
        """
        if step is None:
            step = latest_step(ckpt_dir)
            if step is None:
                raise ServeError(
                    f"no complete checkpoint under {ckpt_dir!r}")
        extra = read_extra(ckpt_dir, step)
        if extra.get("version") != 1:
            raise ServeError(
                f"unsupported server checkpoint version "
                f"{extra.get('version')!r}")
        srv = cls(base, link=link, controller=controller, config=config,
                  chaos=chaos, telemetry=telemetry, devices=devices)
        if srv._tel_on and extra.get("telemetry"):
            # counter totals + SLO ledger continue across the restart;
            # the trace starts a fresh run that records its ancestry
            srv.telemetry.load_state(extra["telemetry"])
        like = {"queues": {
            sid: {"t": np.zeros(m["qlen"], np.float64),
                  "f": np.zeros((m["qlen"], srv.h, srv.w), np.float32),
                  "seq": np.zeros(m["qlen"], np.int64)}
            for sid, m in extra["streams"].items()}}
        tree, _ = restore_checkpoint(ckpt_dir, step, like)

        srv.tick_count = int(extra["tick_count"])
        srv.frames_completed = int(extra["frames_completed"])
        srv.total_enqueued = int(extra["total_enqueued"])
        srv.total_delivered = int(extra["total_delivered"])
        srv.total_shed = int(extra["total_shed"])
        srv._order_counter = int(extra["order_counter"])
        srv._dead = {int(i) for i in extra["dead_devices"]
                     if i < len(srv._devices)}
        for sid, m in extra["streams"].items():
            q = tree["queues"][sid]
            ts = np.asarray(q["t"])
            fs = np.asarray(q["f"])
            sq = np.asarray(q["seq"])
            st = _Stream(
                sid=sid, fps=float(m["fps"]), cut=m["cut"],
                bits=m["bits"], t_join=float(m["t_join"]),
                queue=deque((float(ts[i]), np.asarray(fs[i], np.float32),
                             int(sq[i])) for i in range(len(ts))),
                draining=bool(m["draining"]),
                frames_done=int(m["frames_done"]),
                frames_since_resolve=int(m["frames_since_resolve"]),
                resolves=int(m["resolves"]), requeues=int(m["requeues"]),
                declared_bps=float(m["declared_bps"]),
                seq_next=int(m["seq_next"]),
                delivered_n=int(m["delivered_n"]),
                last_served_seq=int(m["last_served_seq"]),
                shed_n=int(m["shed_n"]), tx_failures=int(m["tx_failures"]),
                deficit=float(m["deficit"]), order=int(m["order"]))
            st.pending_shed = [tuple(x) for x in m["pending_shed"]]
            st.stats = deque((tuple(x) for x in m["stats"]),
                             maxlen=config.stats_window)
            st.trace = deque(m["trace"], maxlen=config.link_window)
            st.transitions = [tuple(x) for x in m["transitions"]]
            lad = m.get("ladder")
            if lad is not None:
                ladder = srv._make_ladder([tuple(r) for r in lad["rungs"]])
                ladder.level = int(lad["level"])
                ladder._clean = int(lad["clean"])
                ladder.transitions = [tuple(x) for x in lad["transitions"]]
                st.ladder = ladder
            srv._streams[sid] = st
        if controller is not None and extra.get("controller"):
            import collections as _c

            ctl = extra["controller"]
            controller.resolves = int(ctl["resolves"])
            controller._window_obs = {
                c: _c.deque((tuple(row) for row in rows),
                            maxlen=controller.window)
                for c, rows in ctl["window_obs"].items()}
        return srv

    def seq_audit(self) -> dict:
        """Prove the exactly-once frame accounting (DESIGN.md §14).

        Per live stream: assigned seqs partition into delivered + shed +
        queued; queued seqs are strictly ascending and strictly above the
        highest delivered seq (so nothing can be served twice).  Fleet
        totals use churn-surviving counters, so the identity holds across
        unregister/reap and across checkpoint/restore.
        """
        per = {}
        ok = True
        queued_total = 0
        # canonical sorted-sid order, matching _collect_shed
        for sid, st in sorted(self._streams.items()):
            seqs = [e[2] for e in st.queue]
            queued_total += len(seqs)
            ascending = all(a < b for a, b in zip(seqs, seqs[1:]))
            unserved = all(s > st.last_served_seq for s in seqs)
            balanced = st.seq_next == (st.delivered_n + st.shed_n
                                       + len(seqs))
            per[sid] = {"ok": ascending and unserved and balanced,
                        "assigned": st.seq_next,
                        "delivered": st.delivered_n, "shed": st.shed_n,
                        "queued": len(seqs),
                        "last_served_seq": st.last_served_seq}
            ok = ok and per[sid]["ok"]
        fleet = (self.total_enqueued
                 == self.total_delivered + self.total_shed + queued_total)
        return {"ok": bool(ok and fleet), "fleet_balanced": bool(fleet),
                "enqueued": self.total_enqueued,
                "delivered": self.total_delivered,
                "shed": self.total_shed, "queued": queued_total,
                "streams": per}

    # -- fleet metrics ---------------------------------------------------------

    def p99_batch_s(self) -> float:
        if not self.batch_lat_s:
            return 0.0
        return float(np.quantile(np.asarray(self.batch_lat_s), 0.99))

    def frames_served(self) -> int:
        return self.frames_completed

    def total_resolves(self) -> int:
        return 0 if self.controller is None else self.controller.resolves
