"""§III frame-to-auth executor (the port of the JAX package's
``camera/pipelines.py``: ``FAExecResult``, ``FunnelStages`` and
``FaceAuthExecutor``).

The funnel runs in this order, on one device, with fixed shapes from
batch to batch once calibrated:

1. motion gate — frame-difference scores; motion frames are compacted
   stably to a prefix of ``frame_capacity`` frames;
2. fused detection — ``FusedDetector``: one integral-image launch, one
   Haar-stage launch per cascade stage, over every compacted frame;
3. window gather — up to ``window_capacity`` detected windows per frame,
   nearest-resampled to 20x20 (integer-exact replica of
   ``viola_jones.extract_windows``); overflow is dropped and counted;
4. int8 NN tail — both layers, the quantizers and the LUT sigmoid in one
   launch of the int8 NN kernel, with static scales.

Every stage takes a leading stream dimension: :meth:`run_streams` runs S
camera feeds as one batch (the reference's vmap), and ``__call__`` is the
S = 1 case.  :meth:`FaceAuthExecutor.batch_step` is the serving runtime's
micro-batch step over the same funnel, sharded over a list of devices
where the reference pmaps.  With ``telemetry=`` enabled the funnel also
returns the reference's ``tel_`` counters, computed on the device from
its outputs and folded into the telemetry panel without a host sync.

The module also holds the §III pipeline as a ``core.pipeline.Pipeline``
of work descriptors with its calibrated cost profiles (``fa_pipeline``,
``fa_profiles``, ``calibrate_fa``), which the offload cut controller
scores against measurement, and the §IV VR rig: its work descriptors
(``VRWorkloadStats``, ``vr_pipeline``, ``vr_profiles``) and its executor
``VRRigExecutor`` (BSSA depth of every camera pair, then the stereo
panorama).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.camera.bssa import bssa_depth
from repro_torch.camera.face_nn import make_sigmoid_lut
from repro_torch.camera.motion import motion_mask, motion_score
from repro_torch.camera.stitch import stereo_panorama
from repro_torch.camera.viola_jones import BASE, FusedDetector
from repro_torch.core.costmodel import (
    ARM_A9,
    IMAGE_SENSOR,
    MOTION_ASIC,
    NN_ASIC,
    VJ_ASIC,
    ZYNQ_FPGA,
    HardwareProfile,
)
from repro_torch.core.pipeline import Block, BlockKind, Pipeline
from repro_torch.device import resolve_device
from repro_torch.kernels.quant_matmul.ops import (
    nn_forward_quantized,
    quantize_nn,
)
from repro_torch.obs.counters import graph_counter, graph_counters
from repro_torch.obs.telemetry import telemetry_on


@dataclasses.dataclass
class FAExecResult:
    """One stream's funnel output, every tensor in source-frame order.

    Leading axis B = frames in the batch (a leading S axis from
    :meth:`FaceAuthExecutor.run_streams`).  ``window_id`` indexes the
    detector's ``grid.positions``; slots beyond a frame's detections carry
    ``window_id == -1`` / ``window_valid == False`` / ``scores == 0``.
    """

    motion: torch.Tensor            # (B,) bool — passed motion detection
    n_windows: torch.Tensor         # (B,) int32 exact detection count
    n_auth: torch.Tensor            # (B,) int32 authenticated windows
    scores: torch.Tensor            # (B, W) f32 NN scores
    window_id: torch.Tensor         # (B, W) int32 grid position id, -1 = padding
    window_valid: torch.Tensor      # (B, W) bool
    auth: torch.Tensor              # (B, W) bool score > threshold
    windows_dropped: torch.Tensor   # (B,) int32 detections beyond capacity
    motion_dropped: torch.Tensor    # () int32 motion frames beyond capacity
    cascade_dropped: torch.Tensor   # (B,) int32 detector-internal drops

    def total_dropped(self) -> int:
        """Sum of every drop counter — 0 means the funnel was lossless."""
        return int(self.motion_dropped.sum() + self.windows_dropped.sum()
                   + self.cascade_dropped.sum())


@dataclasses.dataclass(frozen=True)
class FunnelStages:
    """The funnel's stage functions, every tensor with a leading stream
    axis S; rebuilt by :meth:`FaceAuthExecutor._rebuild`."""

    motion: object     # frames -> (mframes, fidx, fvalid, motion, motion_dropped)
    detect: object     # (mframes, fvalid) -> (dmask, n_win_m, casc_drop_m)
    gather: object     # (mframes, dmask, n_win_m) -> (patches, wsel, wvalid, win_dropped_m)
    nn: object         # (patches, wvalid) -> (s, auth, n_auth_m)
    scatter: object    # source-frame-order result dict
    window_capacity: int


class FaceAuthExecutor:
    """The §III hot path: motion -> Viola-Jones -> 400-8-1 NN on one
    device, through the integral-image, Haar-stage and int8 NN kernels
    on a card.  Arguments are the reference's, less its JAX-only options
    (``use_pallas``, ``interpret``, ``stream_parallel``), plus ``device``
    (the card when None)."""

    def __init__(self, cascade, nn, h: int, w: int, *, lut=None,
                 lut_meta=None, scale_factor: float = 1.25,
                 step: float = 0.025, adaptive: bool = True,
                 strictness: float = 0.0, capacities=None,
                 motion_threshold: float = 0.004, motion_factor: int = 8,
                 frame_capacity: int | None = None,
                 window_capacity: int = 64, bits: int = 8,
                 auth_threshold: float = 0.5, device=None, telemetry=None):
        self.device = resolve_device(device)
        # §15 telemetry: when enabled the funnel returns tel_ int32
        # counters beside its outputs; disabled runs today's funnel
        self.telemetry = telemetry
        self._tel_on = telemetry_on(telemetry)
        if lut is None:
            lut, lut_meta = make_sigmoid_lut(device=self.device)
        elif lut_meta is None:
            raise ValueError("pass lut_meta alongside an explicit lut")
        self.lut = torch.as_tensor(lut, dtype=torch.float32,
                                   device=self.device)
        self.lut_meta = lut_meta
        self.det = FusedDetector(
            cascade, h, w, scale_factor=scale_factor, step=step,
            adaptive=adaptive, strictness=strictness, capacities=capacities,
            device=self.device)
        self._pos = torch.as_tensor(
            np.asarray(self.det.grid.positions, np.int64).reshape(-1, 3),
            device=self.device)                                  # (n, 3)
        self.nn = nn
        self.qnn = quantize_nn(nn, bits=bits, device=self.device)
        self.motion_threshold = float(motion_threshold)
        self.motion_factor = int(motion_factor)
        self.frame_capacity = frame_capacity
        self.window_capacity = int(window_capacity)
        self.auth_threshold = float(auth_threshold)
        self._rebuild()

    # -- the funnel ----------------------------------------------------------

    def _rebuild(self):
        dev = self.device
        det, qnn, lut, meta = self.det, self.qnn, self.lut, self.lut_meta
        pos = self._pos
        W = int(self.window_capacity)
        fcap = self.frame_capacity
        thr, factor = self.motion_threshold, self.motion_factor
        auth_thr = self.auth_threshold

        def stage_motion(frames):
            """-- 1. motion gating + frame compaction to capacity M ------"""
            S, B = frames.shape[:2]
            M = B if fcap is None else max(1, min(int(fcap), B))
            msc = motion_score(frames[:, :-1], frames[:, 1:], factor)
            motion = torch.cat([torch.zeros((S, 1), dtype=torch.bool,
                                            device=dev), msc > thr], dim=1)
            order = torch.argsort((~motion).to(torch.int8), dim=1,
                                  stable=True)
            fidx = order[:, :M]
            fvalid = torch.gather(motion, 1, fidx)
            motion_dropped = (motion.sum(dim=1) - M).clamp(min=0).to(
                torch.int32)
            mframes = frames[torch.arange(S, device=dev)[:, None], fidx]
            return mframes, fidx, fvalid, motion, motion_dropped

        def stage_detect(mframes, fvalid):
            """-- 2. fused VJ front-end, masked by the motion gate; its
            internal capacity drops on motion frames surface too --------"""
            S, M, h, w = mframes.shape
            dmask, _surv, ddrop = det.apply(mframes.reshape(S * M, h, w))
            dmask = dmask.reshape(S, M, -1) & fvalid[..., None]
            casc_drop_m = torch.where(
                fvalid, ddrop.reshape(S, M, -1).sum(dim=-1),
                torch.zeros_like(fvalid, dtype=ddrop.dtype)).to(torch.int32)
            n_win_m = dmask.sum(dim=-1).to(torch.int32)
            return dmask, n_win_m, casc_drop_m

        def stage_gather(mframes, dmask, n_win_m):
            """-- 3. capacity-padded window gather + 20x20 resample ------

            Survivors are ranked by prefix count and scattered into W
            slots; overflow and dead windows go to a discard slot W that
            is sliced off (its duplicate writes are the only
            order-dependent ones)."""
            S, M, n = dmask.shape
            h, w = mframes.shape[-2:]
            col = torch.arange(n, device=dev).expand(S, M, n)
            rank = torch.cumsum(dmask.to(torch.int64), dim=-1) - 1
            slot = torch.where(dmask & (rank < W), rank,
                               torch.full_like(rank, W))
            wsel = torch.zeros((S, M, W + 1), dtype=torch.int64,
                               device=dev).scatter_(-1, slot, col)[..., :W]
            wvalid = (torch.arange(W, device=dev)
                      < n_win_m.clamp(max=W)[..., None])
            win_dropped_m = (n_win_m - W).clamp(min=0)
            wpos = pos[wsel]                                   # (S, M, W, 3)
            wy, wx, ww = wpos[..., 0], wpos[..., 1], wpos[..., 2]
            t = torch.arange(BASE, device=dev)
            # integer-exact replica of extract_windows' nearest resample:
            # (arange(20) * win // 20).clip(0, win - 1)
            off = torch.minimum(t * ww[..., None] // BASE,
                                ww[..., None] - 1)             # (S, M, W, 20)
            rows = (wy[..., None] + off).clamp(0, h - 1)
            cols = (wx[..., None] + off).clamp(0, w - 1)
            si = torch.arange(S, device=dev).reshape(S, 1, 1, 1, 1)
            mi = torch.arange(M, device=dev).reshape(1, M, 1, 1, 1)
            patches = mframes[si, mi, rows[..., :, None], cols[..., None, :]]
            return patches, wsel, wvalid, win_dropped_m

        def stage_nn(patches, wvalid):
            """-- 4. int8 NN tail (one launch of the NN kernel) -----------"""
            S, M, Wc = patches.shape[:3]
            x = patches.reshape(S * M * Wc, BASE * BASE)
            s = nn_forward_quantized(qnn, x, lut, meta).reshape(S, M, Wc)
            s = torch.where(wvalid, s, torch.zeros_like(s))
            auth = wvalid & (s > auth_thr)
            n_auth_m = auth.sum(dim=-1).to(torch.int32)
            return s, auth, n_auth_m

        def stage_scatter(B, fidx, motion, motion_dropped, n_win_m,
                          casc_drop_m, wsel, wvalid, win_dropped_m, s, auth,
                          n_auth_m):
            """-- back to source-frame order -----------------------------"""
            S = fidx.shape[0]
            si = torch.arange(S, device=dev)[:, None]

            def put(fill, vals):
                out = torch.full((S, B) + tuple(vals.shape[2:]), fill,
                                 dtype=vals.dtype, device=dev)
                out[si, fidx] = vals
                return out

            wid = torch.where(wvalid, wsel, torch.full_like(wsel, -1))
            return dict(
                motion=motion,
                n_windows=put(0, n_win_m),
                n_auth=put(0, n_auth_m),
                scores=put(0.0, s),
                window_id=put(-1, wid.to(torch.int32)),
                window_valid=put(False, wvalid),
                auth=put(False, auth),
                windows_dropped=put(0, win_dropped_m.to(torch.int32)),
                motion_dropped=motion_dropped,
                cascade_dropped=put(0, casc_drop_m),
            )

        self.stages = FunnelStages(
            motion=stage_motion, detect=stage_detect, gather=stage_gather,
            nn=stage_nn, scatter=stage_scatter, window_capacity=W)
        # batch_step closures and device replicas capture the capacities
        self._batch_steps = {}   # (n_streams, chunk, devices) -> step
        self._replicas = {}      # str(device) -> executor on that device

    def _funnel(self, frames: torch.Tensor) -> dict:
        """(S, B, h, w) f32 on the executor's device -> result dict with a
        leading S axis; with telemetry on, also the (S,) ``tel_``
        counters of each stream (TELEMETRY_AUX["face_auth.funnel"])."""
        st = self.stages
        B = frames.shape[1]
        mframes, fidx, fvalid, motion, motion_dropped = st.motion(frames)
        dmask, n_win_m, casc_drop_m = st.detect(mframes, fvalid)
        patches, wsel, wvalid, win_dropped_m = st.gather(
            mframes, dmask, n_win_m)
        s, auth, n_auth_m = st.nn(patches, wvalid)
        out = st.scatter(B, fidx, motion, motion_dropped, n_win_m,
                         casc_drop_m, wsel, wvalid, win_dropped_m, s, auth,
                         n_auth_m)
        if self._tel_on:
            out.update(graph_counters(
                windows=out["n_windows"].sum(dim=1),
                auth=out["n_auth"].sum(dim=1),
                motion_dropped=out["motion_dropped"],
                cascade_dropped=out["cascade_dropped"].sum(dim=1)))
        return out

    def _frames(self, frames) -> torch.Tensor:
        return torch.as_tensor(frames, dtype=torch.float32,
                               device=self.device)

    # -- calibration ---------------------------------------------------------

    def calibrate(self, frames, margin: float = 2.0, quantum: int = 32,
                  frame_margin: float = 1.25):
        """Measure the funnel on calibration frames and set every capacity
        from it: the detector's cascade capacities, the motion-frame
        capacity and the per-frame window capacity.  Returns
        (frame_capacity, window_capacity, cascade_capacities)."""
        frames = self._frames(frames)
        mask, _ = motion_mask(frames, self.motion_threshold,
                              self.motion_factor)
        midx = torch.nonzero(mask).flatten()
        max_w = 1
        if len(midx):
            self.det.calibrate(frames[midx[:4]])
            dets, _stats = self.det.detect(frames[midx])
            max_w = max((len(d) for d in dets), default=1)
        fcap = int(math.ceil(len(midx) * frame_margin))
        self.frame_capacity = int(min(len(frames),
                                      max(4, (fcap + 3) // 4 * 4)))
        wcap = (int(math.ceil(max_w * margin)) // quantum + 1) * quantum
        self.window_capacity = int(min(self.det.n_windows,
                                       max(quantum, wcap)))
        self._rebuild()
        return (self.frame_capacity, self.window_capacity,
                list(self.det.capacities))

    # -- execution -----------------------------------------------------------

    def _harvest(self, out: dict) -> dict:
        """Fold the ``tel_`` counters of a funnel result into the panel
        as device tensors (no host sync) and return the real outputs."""
        if self._tel_on:
            out = self.telemetry.counters.consume(out, prefix="fa.")
        return out

    def __call__(self, frames) -> FAExecResult:
        """One stream: (B, h, w) frames -> :class:`FAExecResult`."""
        out = self._harvest(self._funnel(self._frames(frames)[None]))
        return FAExecResult(**{k: v[0] for k, v in out.items()})

    def run_streams(self, frames) -> FAExecResult:
        """S independent feeds: (S, B, h, w) -> FAExecResult with a leading
        S axis, all streams in one batch on one device."""
        return FAExecResult(**self._harvest(
            self._funnel(self._frames(frames))))

    def _replica(self, device: torch.device) -> "FaceAuthExecutor":
        """This executor with its constants copied to ``device`` (itself
        on its own device); cached until the next :meth:`calibrate`."""
        if device == self.device:
            return self
        rep = self._replicas.get(str(device))
        if rep is None:
            rep = copy.copy(self)
            rep.device = device
            rep.det = copy.copy(self.det)
            rep.det.device = device
            rep.det._build()
            rep._pos = self._pos.to(device)
            rep.lut = self.lut.to(device)
            q = self.qnn
            rep.qnn = dataclasses.replace(
                q, w1_q=q.w1_q.to(device), b1=q.b1.to(device),
                w2_q=q.w2_q.to(device), b2=q.b2.to(device))
            rep._rebuild()
            self._replicas[str(device)] = rep
        return rep

    def batch_step(self, n_streams: int, chunk: int, devices=None):
        """Capacity-padded micro-batch step for the serving runtime
        (DESIGN.md §13).

        Returns ``step(frames, valid) -> dict`` where ``frames`` is
        ``(n_streams, chunk, h, w)`` and ``valid`` is ``(n_streams,)``
        bool; the result dict has the :class:`FAExecResult` fields with a
        leading ``n_streams`` axis (``motion_dropped`` becomes
        ``(n_streams,)``), plus the ``tel_`` counters per slot when
        telemetry is on.  Invalid slots carry the canonical quiet result —
        ``motion`` False, ``window_id`` -1, everything else zero — what the
        funnel gives a motionless chunk.

        ``devices`` is a list of torch devices (the executor's own when
        None).  When more than one is given and their count divides
        ``n_streams``, the slots are cut into one shard per device, each
        run on its device with the executor's constants copied there, and
        the results gathered on the executor's device (the reference's
        pmap); otherwise the whole batch runs on the executor's device.
        An empty list raises.  Closures are cached per ``(n_streams,
        chunk, device set)`` and invalidated by :meth:`calibrate`.
        """
        if devices is not None:
            devices = tuple(torch.device(d) for d in devices)
            if not devices:
                raise ValueError("batch_step: devices must be non-empty "
                                 "when given — a group with zero devices "
                                 "cannot serve")
        shard = (devices is not None and len(devices) > 1
                 and n_streams % len(devices) == 0)
        if not shard:
            devices = None      # the single-device batch, whatever list
        key = (int(n_streams), int(chunk),
               None if devices is None else tuple(map(str, devices)))
        cached = self._batch_steps.get(key)
        if cached is not None:
            return cached
        home = self.device
        runs = ([(self, slice(None))] if devices is None else
                [(self._replica(d), slice(i * (n_streams // len(devices)),
                                          (i + 1) * (n_streams
                                                     // len(devices))))
                 for i, d in enumerate(devices)])

        def step(frames, valid):
            self._check_step_args(frames, valid, n_streams, chunk)
            frames = torch.as_tensor(frames, dtype=torch.float32)
            valid = torch.as_tensor(valid, dtype=torch.bool, device=home)
            parts = [ex._funnel(frames[sl].to(ex.device)) for ex, sl in runs]
            out = (parts[0] if len(parts) == 1 else
                   {k: torch.cat([p[k].to(home) for p in parts])
                    for k in parts[0]})

            def quiet(name, a):
                keep = valid.reshape(valid.shape + (1,) * (a.dim() - 1))
                fill = torch.full_like(a, -1 if name == "window_id" else 0)
                return torch.where(keep, a, fill)

            return {k: quiet(k, v) for k, v in out.items()}

        self._batch_steps[key] = step
        return step

    @staticmethod
    def _check_step_args(frames, valid, n_streams, chunk):
        if tuple(frames.shape[:2]) != (n_streams, chunk):
            raise ValueError(
                f"batch_step closure is shape-bound: expected frames "
                f"({n_streams}, {chunk}, h, w), got {tuple(frames.shape)} — "
                "request a new closure via batch_step() instead of reusing "
                "one across micro-batch geometries")
        if tuple(valid.shape) != (n_streams,):
            raise ValueError(
                f"valid must be ({n_streams},) bool, got "
                f"{tuple(valid.shape)}")


# ---------------------------------------------------------------------------
# §III face authentication pipeline (WISPCam: 176x144 @ 1 FPS)
# ---------------------------------------------------------------------------

FRAME_H, FRAME_W = 144, 176
FRAME_BYTES = FRAME_H * FRAME_W          # 8-bit pixels
WINDOW_PIXELS = 400                      # 20x20 window to the NN
NN_MACS = 400 * 8 + 8                    # 400-8-1 topology


@dataclasses.dataclass(frozen=True)
class FAWorkloadStats:
    """Funnel statistics measured on the (synthetic) security workload.

    Paper §III-D: 62 frames -> 12 pass motion -> 40 windows to the NN
    (≈3.33 windows per motion frame), ~7.9k scan positions per frame at
    fine parameters.
    """

    n_frames: int = 62
    motion_frames: int = 12
    windows_to_nn: int = 40
    scan_windows_per_frame: float = 7900.0
    vj_stage_evals_per_frame: float = 11000.0   # masked-cascade measurement hook

    @property
    def motion_sel(self) -> float:
        return self.motion_frames / self.n_frames

    @property
    def windows_per_motion_frame(self) -> float:
        return self.windows_to_nn / self.motion_frames

    @property
    def nn_windows_per_second(self) -> float:     # at 1 FPS source rate
        return self.windows_to_nn / self.n_frames


def fa_pipeline(stats: FAWorkloadStats) -> Pipeline:
    """Block pipeline of Fig. 2.  Work is per *source frame* (1 FPS); the
    selectivity chain scales downstream blocks exactly like the paper's
    duty-cycling argument."""
    wpf = stats.windows_per_motion_frame
    blocks = (
        Block("sensor", flops=0.0, bytes_in=0.0, bytes_out=FRAME_BYTES,
              kind=BlockKind.SOURCE),
        Block("motion", flops=3 * FRAME_BYTES, bytes_in=FRAME_BYTES,
              bytes_out=FRAME_BYTES, kind=BlockKind.OPTIONAL,
              selectivity=stats.motion_sel),
        # VJ on a motion-passed frame: integral image + cascade stages;
        # output = detected windows (de-integral-ized 20x20 crops).
        # selectivity = fraction of motion frames with >=1 detection (every
        # motion frame in the measured workload); bytes_out = windows per
        # surviving frame — the 40-windows/62-s payload the paper charges.
        Block("vj", flops=2 * FRAME_BYTES + 9 * stats.vj_stage_evals_per_frame,
              bytes_in=FRAME_BYTES,
              bytes_out=wpf * WINDOW_PIXELS, kind=BlockKind.OPTIONAL,
              selectivity=1.0),
        Block("nn", flops=2 * NN_MACS * wpf, bytes_in=wpf * WINDOW_PIXELS,
              bytes_out=1.0 / 8.0,       # 1-bit decision
              requires=("vj",)),         # NN input = FD's 20x20 windows
    )
    return Pipeline("face_auth", blocks)


def fa_profiles() -> dict:
    return {"sensor": IMAGE_SENSOR, "motion": MOTION_ASIC,
            "vj": VJ_ASIC, "nn": NN_ASIC}


# -- calibration --------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FACalibration:
    rf_joules_per_byte: float
    nn_effective_w: float         # leakage+duty effective power of the NN block
    base_compute_w: float         # sensor+motion+vj through-VJ compute power

    def rf_link(self) -> HardwareProfile:
        return HardwareProfile(name="rf_link",
                               joules_per_byte=self.rf_joules_per_byte)

    def nn_profile(self) -> HardwareProfile:
        # the calibrated value IS the block's average power (leakage-dominated
        # + duty-scaled dynamic); both rails set so duty drops out
        return dataclasses.replace(
            NN_ASIC, p_active_w=self.nn_effective_w,
            p_leak_w=self.nn_effective_w)


def calibrate_fa(stats: FAWorkloadStats,
                 sensor_w: float = IMAGE_SENSOR.p_active_w,
                 motion_w: float = MOTION_ASIC.p_active_w,
                 vj_eff_w: float = VJ_ASIC.p_leak_w,
                 plus_pct: float = 0.28,
                 crossover: float = 2.68) -> FACalibration:
    """Solve the two paper constraints for (e_c, P_nn_eff).

    Let C = compute power through VJ, B = bytes/s after VJ.  Then
      (1)  C + P_nn + e_c*B_nn = (1 + plus_pct) * (C + e_c*B)
      (2)  P_nn = crossover * e_c * (B - B_nn)              [tie at k*e_c]
    With B_nn ~ 0:  e_c*B = C * plus_pct / (crossover - 1 - plus_pct)
                    P_nn  = crossover * e_c * B.
    """
    C = sensor_w + motion_w + vj_eff_w
    B = stats.nn_windows_per_second * WINDOW_PIXELS      # bytes/s after VJ
    # Post-NN uplink traffic: one 1-bit authentication decision per source
    # frame at the 1 FPS source rate = 1/8 byte/s.  This tiny residual is
    # what keeps the crossover equation (2) exactly solvable rather than
    # assuming B_nn = 0; it feeds the e_c denominator below.
    B_nn = 1.0 / 8.0
    ec_B = C * plus_pct / (crossover - 1.0 - plus_pct)
    e_c = ec_B / (B - B_nn * crossover / (crossover - 1.0 - plus_pct))
    p_nn = crossover * e_c * (B - B_nn)
    return FACalibration(rf_joules_per_byte=e_c, nn_effective_w=p_nn,
                         base_compute_w=C)


# ---------------------------------------------------------------------------
# §IV VR pipeline (16x 4K cameras @ 30 FPS target)
# ---------------------------------------------------------------------------

VR_CAMS = 16
VR_W, VR_H = 3840, 2160                   # 4K per camera
VR_FPS_TARGET = 30.0


@dataclasses.dataclass(frozen=True)
class VRWorkloadStats:
    """Per-frame work for the 2-camera pipeline slice of Fig. 13 (x8 pairs
    gives the 16-camera rig; the paper plots 2 of 16 cameras)."""

    grid_sigma: int = 16                  # pixels per grid vertex
    disp_range: int = 32
    refine_iters: int = 8

    @property
    def pixels(self) -> float:
        return 2 * VR_W * VR_H            # a camera pair

    def grid_vertices(self) -> float:
        gy = VR_H / self.grid_sigma
        gx = VR_W / self.grid_sigma
        return gy * gx * 17.0             # 16 intensity bins + 1

    def rough_flops(self) -> float:       # SAD block matching
        return self.pixels / 2 * self.disp_range * 8

    def refine_flops(self) -> float:      # iterated 3-axis [1,2,1] blurs, v+w
        return self.grid_vertices() * self.refine_iters * 3 * 4 * 2


def vr_pipeline(stats: VRWorkloadStats) -> Pipeline:
    """B1 capture -> B2 ISP/rectify -> B3 grid construction (data expands)
    -> B4 depth refinement (dominant) -> B5 stitch/compose.  Bytes from
    Fig. 13's shape: biggest intermediate into the depth block; small depth
    maps after."""
    px = stats.pixels
    raw = px * 1.0                         # 8-bit Bayer off the sensor
    rgb = px * 3.0
    grid = stats.grid_vertices() * 8.0     # f32 (value, weight) per vertex
    depth = px / 2 * 2.0                   # 16-bit depth map per pair
    # stitch output = encoded stereo panorama slice (the paper's only
    # uploadable intermediate; video-rate panoramas ship compressed)
    pano = 2 * 8192 * 4096 * 3.0 / 8 / 50.0
    blocks = (
        Block("capture", flops=0.0, bytes_in=0.0, bytes_out=raw,
              kind=BlockKind.SOURCE),
        Block("isp", flops=20 * px, bytes_in=raw, bytes_out=rgb),
        # grid construction = splatting (cheap, bandwidth-ish); the rough
        # disparity estimate belongs to the stereo solve itself and moves
        # with it onto the accelerator
        Block("grid", flops=2 * px, bytes_in=rgb, bytes_out=rgb + grid),
        Block("depth",
              flops=stats.rough_flops() / 16 + stats.refine_flops() * 420,
              bytes_in=rgb + grid, bytes_out=depth),
        Block("stitch", flops=2 * px, bytes_in=depth + rgb, bytes_out=pano),
    )
    return Pipeline("vr_video", blocks)


def vr_profiles(depth_device: HardwareProfile) -> dict:
    """depth_device is the knob (CPU/GPU/FPGA); Fig. 14's passing "FPGA"
    configuration uses the Table II production target (VIRTEX_FPGA)."""
    return {"capture": IMAGE_SENSOR, "isp": ZYNQ_FPGA, "grid": ARM_A9,
            "depth": depth_device, "stitch": ARM_A9}


class VRRigExecutor:
    """The §IV hot path: BSSA depth of every camera pair (rough disparity
    through the integral-image kernel -> splat -> ``refine_grid`` through
    the bilateral-blur kernel -> slice), then the stereo panorama (batched
    cylindrical warp + one scatter-add feather blend).

    The pairs are the leading batch axis on one device: one integral-image
    launch per hypothesis chunk and one blur launch per refinement step
    cover the whole rig.  Arguments are the reference's, less its JAX-only
    options (``use_pallas``, ``interpret``, ``rig_parallel``), plus
    ``device`` (the card when None).  With ``telemetry=`` enabled, each
    rig frame adds its pairs and views to the ``vr.pairs`` / ``vr.views``
    counters as device tensors.
    """

    def __init__(self, spec, max_disp: int = 32, n_iters: int = 8,
                 ipd_px: float = 6.0, device=None, telemetry=None):
        self.device = resolve_device(device)
        self.telemetry = telemetry
        self._tel_on = telemetry_on(telemetry)
        self.spec = spec
        self.max_disp = max_disp
        self.n_iters = n_iters
        self.ipd_px = ipd_px
        # the handles the split executors compose (camera/offload)
        self.pair_depth = functools.partial(
            bssa_depth, spec=spec, max_disp=max_disp, n_iters=n_iters)
        self.pano_fn = functools.partial(stereo_panorama, ipd_px=ipd_px)

    def _views(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def depth_maps(self, lefts, rights) -> torch.Tensor:
        """(n_pairs, h, w) x2 -> (n_pairs, h, w) refined depth."""
        depths = self.pair_depth(self._views(lefts), self._views(rights))
        if self._tel_on:
            self.telemetry.counters.add("vr.pairs", graph_counter(
                depths.shape[0], device=depths.device))
        return depths

    def panorama(self, lefts, rights, depths):
        """(left_pano, right_pano) from per-pair views + depth maps."""
        lefts = self._views(lefts)
        pano = self.pano_fn(lefts, self._views(rights), self._views(depths))
        if self._tel_on:
            self.telemetry.counters.add("vr.views", graph_counter(
                2 * lefts.shape[0], device=lefts.device))
        return pano

    def __call__(self, lefts, rights):
        """Full rig frame: returns (left_pano, right_pano, depths)."""
        lefts, rights = self._views(lefts), self._views(rights)
        depths = self.depth_maps(lefts, rights)
        left_pano, right_pano = self.panorama(lefts, rights, depths)
        return left_pano, right_pano, depths
