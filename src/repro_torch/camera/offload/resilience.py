"""Fault-tolerant offload sessions (DESIGN.md §12) — the port of the JAX
package's ``camera/offload/resilience.py``.

The split executors (``camera/offload/executors``) assume a lossless link
and uninterrupted power.  This module wraps them in a session layer that
survives the two real failure modes of the paper's regimes and *charges
what survival costs*:

* :class:`OffloadSession` — per-payload sequence numbers + integrity
  checksums in the session sideband (``payloads.SESSION_SIDEBAND``),
  sender timeout with bounded retry under exponential backoff.  Every
  retransmission is charged real link bytes and energy, and the full
  per-attempt byte trace re-enters ``simulate_shared_link`` so retries
  congest neighboring streams (:func:`fleet_link_report`).
* **Stage-boundary commit points** — when a harvested-energy brownout
  (``link.BrownoutModel`` via ``link.FaultInjector``) kills the node
  mid-funnel, the staged node runner restores the last committed stage
  state from a ``ckpt/checkpoint.py`` checkpoint and resumes the funnel
  there instead of recomputing from capture.
* :class:`DegradationLadder` — a sliding window of measured loss /
  latency drives graceful degradation: drop wire-codec bits (16→8→4),
  retreat to the measured-cheapest cut, finally fall back to all-on-node
  (ship only the decision).  Built from live calibration data by
  ``CutController.degradation_ladder``.

The fault process, the clock and every record are host-side numpy and
Python floats, drawn and summed in the reference's order, so the same
seeds and payload bytes give the reference's records.  The payloads stay
on the executor's device; on a card every delivered coded payload is
decoded by the ``wire_decode`` kernel.

The zero-fault path is pinned bit-exact: with no injector and no ladder
motion, ``send`` is exactly ``encode`` + ``decode_run`` of the underlying
split executor at every cut x bits.  The staged node runner runs the same
stage functions and encode as the executor's own node half
(``node_stages`` / ``encode_state``), with a commit point between stages.
"""

from __future__ import annotations

import collections
import dataclasses
import zlib

import numpy as np

import torch

from repro_torch.camera.offload.link import (
    BACKSCATTER,
    FaultInjector,
    LinkProfile,
    simulate_shared_link,
)
from repro_torch.camera.offload.payloads import (
    SESSION_SIDEBAND_BYTES,
    WirePayload,
)
from repro_torch.ckpt.checkpoint import (
    prune_old,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.obs.ledger import rung_key as _ledger_rung_key
from repro_torch.obs.telemetry import telemetry_on

# wire bytes of an all-on-node delivery: the paper's "ship the decision"
# terminal rung — per-frame auth bits plus one i32 count
_DECISION_BITS_PER_UNIT = 1.0 / 8.0
_I32_B = 4.0


def payload_checksum(payload: WirePayload) -> int:
    """Deterministic uint32 CRC over every on-wire array (key-ordered).

    The integrity word the session ships in its sideband; the receiver
    recomputes it before ``decode_run`` and NACKs on mismatch (modeled by
    the injector's ``corrupt`` outcome — detected here, not by sender
    timeout).  Equal payloads (dtype, shape and bytes of every array)
    give the JAX package's CRC.
    """
    crc = 0
    for k in sorted(payload.arrays):
        a = payload.arrays[k]
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        crc = zlib.crc32(k.encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return int(crc & 0xFFFFFFFF)


def session_sideband(seq: int, crc: int, attempt: int) -> dict:
    """The session-layer sideband, dtype-disciplined per C006."""
    return {"seq": np.uint32(seq), "crc": np.uint32(crc),
            "attempt": np.int32(attempt)}


# ---------------------------------------------------------------------------
# staged node execution with commit points
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stage:
    """One node-side funnel stage: ``fn(state) -> dict`` of new entries."""

    name: str
    fn: object


class StagedNodeRunner:
    """Stage-granular node half of a split executor.

    Composes the SAME stage functions the executor's own node half runs
    (its ``node_stages``: ``FunnelStages`` for the funnel,
    ``VRRigExecutor``'s pair_depth + pano_fn for the rig), with a commit
    point at every boundary — the granularity a brownout-recovering node
    actually needs.  ``encode(state)`` is the executor's ``encode_state``:
    the cut payload from the final state exactly as the fused node half
    packs it (same codec, same byte charging), with its decode contract.
    """

    def __init__(self, stages, encode):
        self.stages = tuple(stages)
        self.encode = encode


def staged_runner_for(ex) -> StagedNodeRunner:
    """The stage plan of a :class:`FaceAuthOffloadExecutor` or a
    :class:`VROffloadExecutor` at its cut."""
    from repro_torch.camera.offload.executors import (
        FaceAuthOffloadExecutor,
        VROffloadExecutor,
    )

    if not isinstance(ex, (FaceAuthOffloadExecutor, VROffloadExecutor)):
        raise TypeError(
            f"no staged node plan for {type(ex).__name__}; OffloadSession "
            "brownout recovery supports the registered offload executor "
            "families only")
    return StagedNodeRunner([Stage(name, fn) for name, fn in ex.node_stages()],
                            ex.encode_state)


def _stage_names(ex) -> tuple:
    """Node-side stage names at ``ex``'s cut (cost model)."""
    from repro_torch.camera.offload.executors import FaceAuthOffloadExecutor

    if isinstance(ex, FaceAuthOffloadExecutor):
        names = {"sensor": (), "motion": ("motion",),
                 "vj": ("motion", "detect", "gather"),
                 "nn": ("motion", "detect", "gather", "nn")}[ex.cut]
    else:
        names = {"capture": (), "depth": ("depth",),
                 "stitch": ("depth", "pano")}[ex.cut]
    return names + ("encode",)


# ---------------------------------------------------------------------------
# degradation ladder
# ---------------------------------------------------------------------------


ON_NODE = ("on_node", None)


class DegradationLadder:
    """Sliding-window policy over the session's measured loss/latency.

    ``rungs`` is an ordered list of ``(cut, bits)`` configurations, most
    capable first; the terminal rung may be :data:`ON_NODE` (compute the
    whole funnel on the node, ship only the decision).  The ladder steps
    DOWN one rung when the observation window shows sustained faults —
    a delivery failure (retries exhausted), a windowed retransmit
    fraction above ``max_retry_frac``, or (when ``deadline_s`` is set)
    most deliveries blowing the deadline — and steps back UP after
    ``recover_after`` consecutive clean first-attempt deliveries.  The
    asymmetry (fast down, slow up) is deliberate hysteresis: a brownout
    costs a frame, flapping costs the whole window.

    A ladder that never observes a fault never moves — the zero-fault
    path stays pinned to rung 0 (bit-exactness contract).
    """

    def __init__(self, rungs, *, window: int = 16,
                 max_retry_frac: float = 0.3, deadline_s: float | None = None,
                 recover_after: int = 24):
        rungs = [tuple(r) for r in rungs]
        if not rungs:
            raise ValueError("DegradationLadder needs at least one rung")
        if len(set(rungs)) != len(rungs):
            raise ValueError(f"duplicate ladder rungs: {rungs}")
        self.rungs = rungs
        self.window = int(window)
        self.max_retry_frac = float(max_retry_frac)
        self.deadline_s = deadline_s
        self.recover_after = int(recover_after)
        self.level = 0
        self.transitions: list = []       # (seq, old_level, new_level)
        self._hist: collections.deque = collections.deque(maxlen=window)
        self._clean = 0

    @property
    def rung(self) -> tuple:
        return self.rungs[self.level]

    def _move(self, seq, new_level):
        new_level = max(0, min(new_level, len(self.rungs) - 1))
        if new_level != self.level:
            self.transitions.append((seq, self.level, new_level))
            self.level = new_level
            self._hist.clear()
            self._clean = 0

    def observe(self, record: "DeliveryRecord"):
        """Feed one delivery record; may move the ladder for the NEXT send."""
        self._hist.append(record)
        if not record.delivered or record.fallback:
            self._move(record.seq, self.level + 1)
            return
        attempts = sum(r.attempts for r in self._hist)
        retrans = sum(r.attempts - 1 for r in self._hist)
        retry_frac = retrans / attempts if attempts else 0.0
        late = (sum(1 for r in self._hist
                    if self.deadline_s is not None
                    and r.latency_s > self.deadline_s)
                / max(len(self._hist), 1))
        if len(self._hist) >= self.window and (
                retry_frac > self.max_retry_frac or late > 0.5):
            self._move(record.seq, self.level + 1)
            return
        if record.attempts == 1:
            self._clean += 1
            if self._clean >= self.recover_after and self.level > 0:
                self._move(record.seq, self.level - 1)
        else:
            self._clean = 0


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeliveryRecord:
    """Everything one payload's delivery cost (simulated time/bytes/energy)."""

    seq: int
    cut: str
    bits: int | None
    delivered: bool
    fallback: bool               # delivered via the all-on-node rung
    attempts: int                # transmissions put on the air
    lost: int                    # sender-timeout losses
    corrupt: int                 # receiver checksum failures (NACKed)
    payload_bytes: float         # one transmission's bytes (incl. sideband)
    bytes_on_air: float          # total across every attempt
    compute_s: float             # node-side stage time (simulated)
    latency_s: float             # capture -> delivery, incl. backoff/recovery
    energy_j: float              # node compute + every tx attempt
    brownouts: int               # node power losses during compute
    restores: int                # checkpoint restores (commit-point resumes)
    recovery_s: float            # time spent dark + restoring

    @property
    def retransmit_overhead(self) -> float:
        """Extra on-air bytes over a single clean transmission (fraction)."""
        return (self.bytes_on_air / self.payload_bytes - 1.0
                if self.payload_bytes else 0.0)


class OffloadSession:
    """Reliable delivery wrapper around one split executor.

    ``make_executor(cut, bits)`` builds the underlying split
    executor; a fixed-configuration session passes ``executor=`` instead.
    ``send(*inputs)`` runs the node half (staged, with commit points,
    when a brownout model is present), frames the payload with the
    session sideband (seq/crc/attempt — ``payloads.SESSION_SIDEBAND``),
    transmits it through the injector's fault process with bounded
    exponential-backoff retry, and runs the cloud half on delivery.
    Returns ``(result, DeliveryRecord)``; ``result`` is None only when
    retries exhaust with no on-node fallback (the receiver sees the gap
    via the sequence numbers).

    Every attempt is charged real bytes and energy, and
    :meth:`attempt_trace` exposes the per-send on-air byte totals for
    re-entry into ``simulate_shared_link`` (see :func:`fleet_link_report`)
    so retries congest neighboring streams.

    With ``injector=None`` (or a fully-disabled injector) and a ladder
    that never moves, outputs are bit-exact with the wrapped executor —
    the pinning contract.

    ``telemetry=`` (any object with ``enabled``, ``counters.bump``,
    ``emit`` and ``ledger.observe_latency``) makes the session a
    §15 trace/counter source: every send is charged to per-attempt
    counters (``offload.attempts`` / ``offload.retries`` /
    ``offload.crc_fail`` / ``offload.bytes_on_air`` ...), emits one
    ``link`` span, and feeds the per-stream SLO ledger under ``sid=``.
    Telemetry observes the DeliveryRecord after the fact — it never
    perturbs the fault process, the clock, or the payload bytes.
    """

    def __init__(self, executor=None, *, make_executor=None, cut=None,
                 bits=None, link: LinkProfile = BACKSCATTER,
                 injector: FaultInjector | None = None,
                 ladder: DegradationLadder | None = None,
                 max_retries: int = 4, timeout_s: float | None = None,
                 backoff_s: float | None = None, ckpt_dir: str | None = None,
                 stage_cost_s=0.02, node_active_w: float = 200e-6,
                 on_node_fn=None, keep_ckpts: int = 8,
                 telemetry=None, sid: str = ""):
        if executor is None and make_executor is None:
            raise ValueError("pass executor= or make_executor=")
        if executor is not None:
            cut, bits = executor.cut, executor.bits
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self._make = make_executor
        self._execs: dict = {}
        if executor is not None:
            self._execs[(executor.cut, executor.bits)] = executor
        self.cut, self.bits = cut, bits
        self.link = link
        self.injector = injector
        self.ladder = ladder
        self.max_retries = int(max_retries)
        self.timeout_s = timeout_s
        self.backoff_s = backoff_s
        self.ckpt_dir = ckpt_dir
        self.stage_cost_s = stage_cost_s
        self.node_active_w = float(node_active_w)
        self.on_node_fn = on_node_fn
        self.keep_ckpts = int(keep_ckpts)
        self.telemetry = telemetry
        self.sid = str(sid)
        self._tel_on = telemetry_on(telemetry)
        self._runners: dict = {}
        self.now = 0.0                     # simulated session clock
        self.records: list = []
        self.stage_started: dict = {}      # staged-runner executions begun
        self.stage_completed: dict = {}    # ... and completed (no brownout)
        self.received: list = []           # (seq, crc, attempt) at receiver
        self._received_seqs: set = set()
        self.duplicates = 0

    # -- helpers -------------------------------------------------------------

    def _executor(self, rung):
        ex = self._execs.get(rung)
        if ex is None:
            if self._make is None:
                raise ValueError(
                    f"session has no executor for rung {rung} and no "
                    "make_executor factory — pass make_executor= to let "
                    "the ladder change configuration")
            ex = self._make(*rung)
            self._execs[rung] = ex
        return ex

    def _stage_cost(self, name: str) -> float:
        if isinstance(self.stage_cost_s, dict):
            return float(self.stage_cost_s.get(name, 0.0))
        return float(self.stage_cost_s)

    def seq_gaps(self) -> list:
        """Sequence numbers the receiver never saw (undelivered payloads)."""
        if not self._received_seqs:
            return [r.seq for r in self.records]
        hi = max(self._received_seqs)
        return [s for s in range(hi + 1) if s not in self._received_seqs]

    def attempt_trace(self) -> np.ndarray:
        """Per-send total on-air bytes — the link-simulator re-entry trace.

        Retransmissions inflate the entry for their send, so replaying
        this trace through ``simulate_shared_link`` makes retries queue
        against (and delay) neighboring streams' frames.
        """
        return np.array([r.bytes_on_air for r in self.records], np.float64)

    @property
    def energy_j(self) -> float:
        return float(sum(r.energy_j for r in self.records))

    @property
    def bytes_on_air(self) -> float:
        return float(sum(r.bytes_on_air for r in self.records))

    # -- node side (staged, commit points, brownout recovery) ----------------

    def _node_payload(self, ex, inputs):
        """Run the node half; returns (payload, compute_s, brownouts,
        restores, recovery_s).

        Fast path (no brownout model): the executor's own single-dispatch
        ``encode`` — bit-exact.  With a brownout model: the staged
        runner with a commit point at every stage boundary.
        """
        inj = self.injector
        if inj is None or inj.brownout is None:
            total_cost = sum(self._stage_cost(n) for n in _stage_names(ex))
            self.now += total_cost
            return ex.encode(*inputs), total_cost, 0, 0, 0.0
        return self._staged_node(ex, inputs)

    def _staged_node(self, ex, inputs):
        if self.ckpt_dir is None:
            raise ValueError(
                "brownout recovery needs ckpt_dir= for its stage-boundary "
                "commit points (the node's nonvolatile store)")
        runner = self._runners.get((ex.cut, ex.bits))
        if runner is None:
            runner = staged_runner_for(ex)
            self._runners[(ex.cut, ex.bits)] = runner
        inj = self.injector
        seq = len(self.records)
        state = ex.node_inputs(*inputs)
        # commit 0: capture itself goes to the nonvolatile store, so a
        # brownout in the FIRST stage resumes from stored capture data,
        # never from a re-capture
        base_step = seq * 16
        save_checkpoint(self.ckpt_dir, base_step, state,
                        extra={"stage": "capture", "seq": seq})
        committed, committed_step = dict(state), base_step
        compute_s = recovery_s = 0.0
        brownouts = restores = 0

        def run_guarded(name, apply_fn):
            """Run one stage under the node-power schedule."""
            nonlocal compute_s, brownouts, restores, recovery_s, state
            cost = self._stage_cost(name)
            for _try in range(64):
                powered, boundary = inj.power_window(self.now)
                if not powered:
                    recovery_s += boundary - self.now
                    self.now = boundary
                    continue
                if self.now + cost <= boundary:
                    self.stage_started[name] = \
                        self.stage_started.get(name, 0) + 1
                    out = apply_fn()
                    self.stage_completed[name] = \
                        self.stage_completed.get(name, 0) + 1
                    self.now += cost
                    compute_s += cost
                    return out
                # brownout mid-stage: this stage's work is lost; the node
                # draws power until the lights go out, recharges, restores
                # the last commit and re-enters HERE — never at capture
                self.stage_started[name] = \
                    self.stage_started.get(name, 0) + 1
                brownouts += 1
                compute_s += boundary - self.now
                recovery_s += boundary - self.now
                self.now = boundary
                restored, _extra = restore_checkpoint(
                    self.ckpt_dir, committed_step, committed)
                state = dict(restored)
                restores += 1
            raise RuntimeError(
                f"stage {name!r} (cost {cost}s) cannot complete inside any "
                "harvested on-window — shrink the stage cost or grow "
                "BrownoutModel.storage_j")

        for i, stg in enumerate(runner.stages):
            new = run_guarded(stg.name, lambda stg=stg: stg.fn(state))
            # NB: two statements — run_guarded may rebind `state` to a
            # restored checkpoint, and state.update(run_guarded(...)) would
            # resolve the bound method against the abandoned dict
            state.update(new)
            step = base_step + 1 + i
            save_checkpoint(self.ckpt_dir, step, state,
                            extra={"stage": stg.name, "seq": seq})
            committed, committed_step = dict(state), step
        arrays, wire_b, meta = run_guarded("encode",
                                           lambda: runner.encode(state))
        prune_old(self.ckpt_dir, keep=self.keep_ckpts)
        payload = WirePayload(cut=ex.cut, bits=ex.bits, arrays=arrays,
                              meta=meta, wire_b=wire_b)
        return payload, compute_s, brownouts, restores, recovery_s

    # -- transmission --------------------------------------------------------

    def _transmit(self, nbytes: float) -> tuple:
        """Push one framed payload through the fault process.

        Returns ``(delivered, attempts, lost, corrupt, bytes_on_air,
        tx_energy_j, final_attempt)``.  Every attempt — delivered or not —
        is charged full bytes and energy; losses pay the sender timeout,
        corruptions pay the NACK round trip, and retries back off
        exponentially (which is also how a transmit escapes an outage
        window).
        """
        link, inj = self.link, self.injector
        tx_s = link.latency_s + nbytes / link.bytes_per_s
        timeout = self.timeout_s if self.timeout_s is not None \
            else tx_s + 4.0 * link.latency_s
        backoff0 = self.backoff_s if self.backoff_s is not None else tx_s
        attempts = lost = corrupt = 0
        bytes_on_air = 0.0
        while True:
            attempts += 1
            outcome = inj.attempt(self.now) if inj is not None else "ok"
            bytes_on_air += nbytes
            if outcome == "ok":
                self.now += tx_s
                break
            if outcome == "corrupt":
                corrupt += 1
                self.now += tx_s + link.latency_s     # NACK round trip
            else:
                lost += 1
                self.now += tx_s + timeout            # ack never comes
            if attempts > self.max_retries:
                return (False, attempts, lost, corrupt, bytes_on_air,
                        bytes_on_air * link.joules_per_byte, attempts)
            self.now += backoff0 * (2.0 ** (attempts - 1))
        return (True, attempts, lost, corrupt, bytes_on_air,
                bytes_on_air * link.joules_per_byte, attempts)

    # -- the send loop -------------------------------------------------------

    def send(self, *inputs):
        """Deliver one frame batch; returns ``(result, DeliveryRecord)``."""
        seq = len(self.records)
        t0 = self.now
        rung = self.ladder.rung if self.ladder is not None \
            else (self.cut, self.bits)
        fallback = False
        if rung == ON_NODE:
            result, payload, compute_s, brownouts, restores, recovery_s = \
                self._run_on_node(inputs)
            nbytes = self._decision_bytes(inputs) + SESSION_SIDEBAND_BYTES
            crc = 0
            fallback = True
            cut, bits = ON_NODE
        else:
            ex = self._executor(rung)
            cut, bits = rung
            payload, compute_s, brownouts, restores, recovery_s = \
                self._node_payload(ex, inputs)
            crc = payload_checksum(payload)
            nbytes = payload.nbytes() + SESSION_SIDEBAND_BYTES
            result = None

        delivered, attempts, lost, corrupt, on_air, tx_j, att = \
            self._transmit(nbytes)

        if delivered:
            self._receive(seq, crc, att)
            if not fallback:
                if payload_checksum(payload) != crc:   # integrity contract
                    raise AssertionError("checksum drift on clean delivery")
                result = self._executor(rung).decode_run(payload)
        elif not fallback and self.on_node_fn is not None:
            # retries exhausted: degrade THIS payload to the terminal rung
            # (compute on node, ship the tiny decision) rather than drop it
            result, _p, c2, b2, r2, rec2 = self._run_on_node(inputs)
            compute_s += c2
            brownouts += b2
            restores += r2
            recovery_s += rec2
            nb2 = self._decision_bytes(inputs) + SESSION_SIDEBAND_BYTES
            d2, a2, l2, cr2, oa2, j2, att2 = self._transmit(nb2)
            attempts += a2
            lost += l2
            corrupt += cr2
            on_air += oa2
            tx_j += j2
            delivered, fallback = d2, True
            if d2:
                self._receive(seq, 0, att2)

        rec = DeliveryRecord(
            seq=seq, cut=cut, bits=bits, delivered=delivered,
            fallback=fallback, attempts=attempts, lost=lost, corrupt=corrupt,
            payload_bytes=nbytes, bytes_on_air=on_air, compute_s=compute_s,
            latency_s=self.now - t0,
            energy_j=tx_j + compute_s * self.node_active_w,
            brownouts=brownouts, restores=restores, recovery_s=recovery_s)
        self.records.append(rec)
        if self._tel_on:
            self._record_delivery(rec, t0)
        if self.ladder is not None:
            n_tr = len(self.ladder.transitions)
            self.ladder.observe(rec)
            if self._tel_on and len(self.ladder.transitions) > n_tr:
                _s, old, new = self.ladder.transitions[-1]
                self.telemetry.emit(
                    "ladder", "descend" if new > old else "recover",
                    t=self.now, sid=self.sid, seq=rec.seq,
                    old_level=old, new_level=new,
                    rung=_ledger_rung_key(self.ladder.rung))
                self.telemetry.counters.bump("offload.ladder_moves")
        return (result if delivered else None), rec

    def _record_delivery(self, rec: DeliveryRecord, t0: float) -> None:
        """Per-attempt accounting + one link trace span per send (§15)."""
        tel = self.telemetry
        c = tel.counters
        c.bump("offload.sends")
        c.bump("offload.attempts", rec.attempts)
        c.bump("offload.retries", rec.attempts - 1)
        c.bump("offload.lost", rec.lost)
        c.bump("offload.crc_fail", rec.corrupt)
        c.bump("offload.bytes_on_air", int(round(rec.bytes_on_air)))
        c.bump("offload.delivered" if rec.delivered else "offload.dropped")
        if rec.fallback:
            c.bump("offload.fallbacks")
        if rec.brownouts:
            c.bump("offload.brownouts", rec.brownouts)
        if rec.restores:
            c.bump("offload.restores", rec.restores)
        rung = "on_node" if rec.fallback else (rec.cut, rec.bits)
        tel.emit(
            "link", f"send[{_ledger_rung_key(rung)}]", t=t0,
            dur=rec.latency_s, sid=self.sid, seq=rec.seq,
            delivered=rec.delivered, fallback=rec.fallback,
            attempts=rec.attempts, lost=rec.lost, crc_fail=rec.corrupt,
            payload_b=rec.payload_bytes, on_air_b=rec.bytes_on_air,
            brownouts=rec.brownouts, restores=rec.restores,
            energy_j=rec.energy_j)
        tel.ledger.observe_latency(self.sid, rung, rec.latency_s)

    def _receive(self, seq, crc, attempt):
        if seq in self._received_seqs:
            self.duplicates += 1
            return
        self._received_seqs.add(seq)
        self.received.append(session_sideband(seq, crc, attempt))

    def _run_on_node(self, inputs):
        if self.on_node_fn is None:
            raise ValueError(
                "ladder reached the on_node rung but the session has no "
                "on_node_fn — pass one (e.g. the fused base executor) or "
                "drop the ON_NODE rung")
        compute = sum(self._stage_cost(n)
                      for n in ("motion", "detect", "gather", "nn", "encode"))
        brownouts = restores = 0
        recovery = 0.0
        inj = self.injector
        if inj is not None and inj.brownout is not None:
            # on-node still runs on harvested power; wait out dark windows
            for _ in range(32):
                powered, boundary = inj.power_window(self.now)
                if powered and self.now + compute <= boundary:
                    break
                recovery += boundary - self.now
                self.now = boundary
                if powered:
                    brownouts += 1
        result = self.on_node_fn(*inputs)
        self.now += compute
        return result, None, compute, brownouts, restores, recovery

    def _decision_bytes(self, inputs) -> float:
        n_units = int(inputs[0].shape[0])
        return n_units * _DECISION_BITS_PER_UNIT + _I32_B


def fleet_link_report(sessions, link: LinkProfile, frame_period_s: float,
                      **kw):
    """Replay N sessions' on-air traces through ONE shared link.

    The congestion view of resilience: each session's trace already
    includes every retransmission, so a faulty stream's retries queue
    against its neighbors' frames — the p99 the closed-form model (and
    the fault-free sweep) cannot see.
    """
    traces = [s.attempt_trace() for s in sessions]
    n = min(len(t) for t in traces)
    if n == 0:
        raise ValueError("fleet_link_report: a session has no sends yet")
    return simulate_shared_link(
        np.stack([t[:n] for t in traces]), link, frame_period_s, **kw)
