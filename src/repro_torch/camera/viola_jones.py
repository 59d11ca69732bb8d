"""Viola-Jones face detection, inference surface (paper §III-B).

The port of the JAX package's ``camera/viola_jones.py`` minus training:
Haar features and their corner-tap decomposition, the scan pyramid, the
gather tables, and the frame-resident fused detector
(:class:`FusedDetector`): one integral image of each frame and of its
square (one launch of the integral-image kernel for the batch), per-window
variance normalizers, and a compacting cascade whose every stage is one
launch of the Haar-stage kernel over all frames.  Scaled-feature
semantics as in the reference: the features are scaled to the window, not
the window resampled.

Geometry (``HaarFeature``, ``scale_feature``, ``scan_positions``,
``build_scan_grid``, ``build_gather_tables``) is plain Python and numpy,
identical to the reference's.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.camera.integral import frame_integral
from repro_torch.core.cascade import (
    Stage as CoreStage,
    capacities_from_counts,
    compacting_cascade,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.haar_frontend.ops import haar_stage_scores

BASE = 20    # canonical window resolution (matches the NN input 20x20)
CORNER_SLOTS = 8     # max corner taps per feature (3-rect decomposition)


# ---------------------------------------------------------------------------
# Haar features on the canonical 20x20 window
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HaarFeature:
    """Two/three-rectangle feature, coordinates in the canonical window."""
    kind: int            # 0: 2-rect horiz, 1: 2-rect vert, 2: 3-rect horiz, 3: 3-rect vert
    y: int
    x: int
    h: int
    w: int


def make_feature_pool(seed: int = 0, n: int = 400) -> list:
    rng = np.random.default_rng(seed)
    pool = []
    while len(pool) < n:
        kind = int(rng.integers(0, 4))
        nsplit = 2 if kind < 2 else 3
        if kind in (0, 2):   # horizontal split: w divisible
            w = max(nsplit, (int(rng.integers(nsplit, BASE // 2 + 1)) // nsplit) * nsplit)
            h = int(rng.integers(2, BASE // 2 + 1))
        else:
            h = max(nsplit, (int(rng.integers(nsplit, BASE // 2 + 1)) // nsplit) * nsplit)
            w = int(rng.integers(2, BASE // 2 + 1))
        y = int(rng.integers(0, BASE - h + 1))
        x = int(rng.integers(0, BASE - w + 1))
        pool.append(HaarFeature(kind, y, x, h, w))
    return pool


def scale_feature(f: HaarFeature, win: int) -> HaarFeature:
    """Scale a canonical-20x20 feature to a ``win`` x ``win`` window,
    keeping the 2-/3-way split exact and the rectangle inside the window.
    The identity at ``win == BASE``."""
    s = win / BASE
    if f.kind == 0:
        part = max(1, int(round(f.w / 2 * s)))
        w, h = 2 * part, max(1, int(round(f.h * s)))
    elif f.kind == 1:
        part = max(1, int(round(f.h / 2 * s)))
        h, w = 2 * part, max(1, int(round(f.w * s)))
    elif f.kind == 2:
        part = max(1, int(round(f.w / 3 * s)))
        w, h = 3 * part, max(1, int(round(f.h * s)))
    else:
        part = max(1, int(round(f.h / 3 * s)))
        h, w = 3 * part, max(1, int(round(f.w * s)))
    wq = 2 if f.kind == 0 else (3 if f.kind == 2 else 1)
    hq = 2 if f.kind == 1 else (3 if f.kind == 3 else 1)
    while w > win:
        w -= wq
    while h > win:
        h -= hq
    y = min(max(int(round(f.y * s)), 0), win - h)
    x = min(max(int(round(f.x * s)), 0), win - w)
    return HaarFeature(f.kind, y, x, h, w)


def feature_corners(f: HaarFeature):
    """Corner-tap decomposition: [(dy, dx, weight), ...], <= 8 taps, so
    response = sum_k weight_k * ii[y0 + dy_k, x0 + dx_k]."""
    y, x, h, w = f.y, f.x, f.h, f.w
    if f.kind == 0:      # left - right
        hw = w // 2
        return [(y, x, 1.0), (y + h, x, -1.0),
                (y, x + hw, -2.0), (y + h, x + hw, 2.0),
                (y, x + w, 1.0), (y + h, x + w, -1.0)]
    if f.kind == 1:      # top - bottom
        hh = h // 2
        return [(y, x, 1.0), (y, x + w, -1.0),
                (y + hh, x, -2.0), (y + hh, x + w, 2.0),
                (y + h, x, 1.0), (y + h, x + w, -1.0)]
    if f.kind == 2:      # sides - 2*middle, horizontal thirds
        w3 = w // 3
        return [(y, x, 1.0), (y, x + w3, -3.0),
                (y, x + 2 * w3, 3.0), (y, x + w, -1.0),
                (y + h, x, -1.0), (y + h, x + w3, 3.0),
                (y + h, x + 2 * w3, -3.0), (y + h, x + w, 1.0)]
    h3 = h // 3          # sides - 2*middle, vertical thirds
    return [(y, x, 1.0), (y + h3, x, -3.0),
            (y + 2 * h3, x, 3.0), (y + h, x, -1.0),
            (y, x + w, -1.0), (y + h3, x + w, 3.0),
            (y + 2 * h3, x + w, -3.0), (y + h, x + w, 1.0)]


# ---------------------------------------------------------------------------
# The trained cascade (10 stages x 33 weak classifiers, Table I)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cascade:
    feats: list                     # selected HaarFeatures, flat
    thresholds: np.ndarray          # (n_weak,) decision-stump thresholds
    polarity: np.ndarray            # (n_weak,) +-1
    alphas: np.ndarray              # (n_weak,) AdaBoost weights
    stage_sizes: list               # weak-classifier count per stage
    stage_thresholds: np.ndarray    # (n_stages,) stage pass thresholds

    @property
    def n_stages(self):
        return len(self.stage_sizes)


# ---------------------------------------------------------------------------
# Window scanning (Fig. 4a): scale pyramid + (adaptive) step
# ---------------------------------------------------------------------------


def scan_positions(h: int, w: int, scale_factor: float = 1.25,
                   step: float = 0.025, adaptive: bool = True,
                   min_window: int = BASE):
    """(y, x, win) scanning positions, scale-major.  ``adaptive`` step is
    max(2, round(step * window)) pixels; otherwise ``int(step)`` pixels."""
    out = []
    win = float(min_window)
    while win <= min(h, w):
        iw = int(round(win))
        s = max(2, int(round(step * iw))) if adaptive else max(1, int(step))
        for y in range(0, h - iw + 1, s):
            for x in range(0, w - iw + 1, s):
                out.append((y, x, iw))
        win *= scale_factor
    return out


def extract_windows(frame: np.ndarray, positions) -> np.ndarray:
    """Resample each scanning window to the canonical 20x20 (nearest)."""
    out = np.empty((len(positions), BASE, BASE), np.float32)
    for i, (y, x, win) in enumerate(positions):
        patch = frame[y:y + win, x:x + win]
        yy = (np.arange(BASE) * win // BASE).clip(0, win - 1)
        xx = (np.arange(BASE) * win // BASE).clip(0, win - 1)
        out[i] = patch[np.ix_(yy, xx)]
    return out


# ---------------------------------------------------------------------------
# Frame-resident fused front-end: one integral image, gathered Haar
# features, compacting cascade
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScanGrid:
    """Scan geometry for one (frame shape, scan parameters) pair: every
    (y, x, win) position, its flat base index into the zero-padded
    (h+1, w+1) integral image, and its pyramid-scale id."""

    h: int
    w: int
    positions: tuple
    scales: tuple                # distinct window sizes, pyramid order
    bases: np.ndarray            # (n,) int32: y * (w + 1) + x
    scale_id: np.ndarray         # (n,) int32 index into ``scales``


@functools.lru_cache(maxsize=32)
def build_scan_grid(h: int, w: int, scale_factor: float = 1.25,
                    step: float = 0.025, adaptive: bool = True) -> ScanGrid:
    pos = scan_positions(h, w, scale_factor, step, adaptive)
    scales, sid = [], []
    for (_y, _x, win) in pos:
        if not scales or scales[-1] != win:
            scales.append(win)
        sid.append(len(scales) - 1)
    bases = np.array([y * (w + 1) + x for (y, x, _win) in pos], np.int32)
    return ScanGrid(h, w, tuple(pos), tuple(scales), bases,
                    np.array(sid, np.int32))


@dataclasses.dataclass(frozen=True)
class GatherTables:
    """Per-(cascade, grid) corner-tap tables: each weak classifier as <= 8
    integral-image taps, scaled per pyramid level and flattened to
    base-relative offsets."""

    offsets: np.ndarray          # (n_scales, n_weak, CORNER_SLOTS) int32
    weights: np.ndarray          # (n_weak, CORNER_SLOTS) f32, 0-padded
    norm_offsets: np.ndarray     # (n_scales, 4) int32 window-sum taps
    areas: np.ndarray            # (n_scales,) f32 win^2
    thresholds: np.ndarray       # (n_weak,) stump params
    polarity: np.ndarray
    alphas: np.ndarray
    stage_sizes: tuple
    stage_thresholds: np.ndarray


def build_gather_tables(cascade: Cascade, grid: ScanGrid) -> GatherTables:
    stride = grid.w + 1
    n_weak = len(cascade.feats)
    offsets = np.zeros((len(grid.scales), n_weak, CORNER_SLOTS), np.int32)
    weights = np.zeros((n_weak, CORNER_SLOTS), np.float32)
    for k, f in enumerate(cascade.feats):
        for c, (_dy, _dx, wv) in enumerate(feature_corners(f)):
            weights[k, c] = wv     # weight pattern is scale-invariant
    for s, win in enumerate(grid.scales):
        for k, f in enumerate(cascade.feats):
            for c, (dy, dx, _wv) in enumerate(
                    feature_corners(scale_feature(f, win))):
                offsets[s, k, c] = dy * stride + dx
    norm_offsets = np.array(
        [[win * stride + win, win, win * stride, 0] for win in grid.scales],
        np.int32)
    areas = np.array([float(win * win) for win in grid.scales], np.float32)
    return GatherTables(
        offsets, weights, norm_offsets, areas,
        np.asarray(cascade.thresholds, np.float32),
        np.asarray(cascade.polarity, np.float32),
        np.asarray(cascade.alphas, np.float32),
        tuple(cascade.stage_sizes),
        np.asarray(cascade.stage_thresholds, np.float32))


class FusedDetector:
    """Frame-resident fused detection front-end.

    Each frame is touched once: the integral image of the frames and of
    their squares comes from one launch of the integral-image kernel;
    every window at every scale is then described by (base, scale id,
    1 / (sd * area)) and each cascade stage is one launch of the Haar-stage
    kernel over all frames' compacted windows.  After :meth:`calibrate`
    stage i only computes on a capacity-bounded survivor prefix.
    """

    def __init__(self, cascade: Cascade, h: int, w: int, *,
                 scale_factor: float = 1.25, step: float = 0.025,
                 adaptive: bool = True, strictness: float = 0.0,
                 capacities=None, device=None):
        self.device = resolve_device(device)
        self.cascade = cascade
        # window bases ride through the compacted item triple as float32,
        # which is exact only below 2^24
        if (h + 1) * (w + 1) >= 2 ** 24:
            raise ValueError(f"frame {h}x{w} too large for f32-exact "
                             "window indices (needs (h+1)*(w+1) < 2^24)")
        self.grid = build_scan_grid(h, w, scale_factor, step, adaptive)
        self.tables = build_gather_tables(cascade, self.grid)
        self.n_windows = len(self.grid.positions)
        self.n_stages = len(self.tables.stage_sizes)
        self.strictness = float(strictness)
        self.capacities = (list(capacities) if capacities is not None
                           else [self.n_windows] * self.n_stages)
        self._build()

    def _build(self):
        """Device copies of the scan grid and, per stage, contiguous slices
        of the gather tables (what one Haar-stage launch reads)."""
        t, dev = self.tables, self.device

        def on(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        self._bases = on(self.grid.bases, torch.int64)
        self._sids = on(self.grid.scale_id, torch.int64)
        self._norm_offsets = on(t.norm_offsets, torch.int64)
        self._areas = on(t.areas, torch.float32)
        self.stage_tables = []
        o = 0
        for sz in t.stage_sizes:
            lo, hi = o, o + sz
            self.stage_tables.append((
                on(t.offsets[:, lo:hi], torch.int32),
                on(t.weights[lo:hi], torch.float32),
                on(t.thresholds[lo:hi], torch.float32),
                on(t.polarity[lo:hi], torch.float32),
                on(t.alphas[lo:hi], torch.float32)))
            o = hi
        self.stage_thresholds = [float(v) + self.strictness
                                 for v in t.stage_thresholds]

    # -- the fused core -----------------------------------------------------

    def integrals(self, frames: torch.Tensor):
        """(B, h, w) f32 -> flat integral images of the frames and of their
        squares, each (B, L): one kernel launch for both."""
        B = frames.shape[0]
        ii = frame_integral(torch.cat([frames, frames * frames]))
        flat = ii.reshape(2 * B, -1)
        return flat[:B], flat[B:]

    def items(self, ii: torch.Tensor, ii2: torch.Tensor) -> torch.Tensor:
        """Per-window item triples (B, n, 3) f32: (base, scale id,
        1 / (sd * area)), the variance normalizer from the ii / ii^2 pair."""
        sids = self._sids
        nidx = self._bases[:, None] + self._norm_offsets[sids]    # (n, 4)
        t1 = ii[:, nidx]                                          # (B, n, 4)
        t2 = ii2[:, nidx]
        # the corner weights are (1, -1, -1, 1), summed in order
        s1 = ((t1[..., 0] - t1[..., 1]) - t1[..., 2]) + t1[..., 3]
        s2 = ((t2[..., 0] - t2[..., 1]) - t2[..., 2]) + t2[..., 3]
        area = self._areas[sids]
        mu = s1 / area
        var = s2 / area - mu * mu
        sd = torch.sqrt(var.clamp(min=1e-6))
        inv = torch.reciprocal(sd * area)
        B, n = inv.shape
        return torch.stack([self._bases.to(torch.float32).expand(B, n),
                            sids.to(torch.float32).expand(B, n), inv], dim=-1)

    def stages(self, ii: torch.Tensor):
        """The cascade stages over the frames whose flat tables are ``ii``."""
        def stage_fn(tables):
            return lambda it: haar_stage_scores(ii, it, *tables)
        return [CoreStage(stage_fn(tab), thr, f"vj{si}")
                for si, (tab, thr) in enumerate(zip(self.stage_tables,
                                                    self.stage_thresholds))]

    def apply(self, frames: torch.Tensor, capacities=None):
        """(B, h, w) f32 on the detector's device -> (mask (B, n_windows)
        bool, n_survivors (B, n_stages) int32, dropped (B, n_stages) int32)."""
        caps = self.capacities if capacities is None else list(capacities)
        frames = frames.to(torch.float32)
        ii, ii2 = self.integrals(frames)
        res = compacting_cascade(self.stages(ii), self.items(ii, ii2), caps)
        return res.mask, res.n_survivors, res.dropped

    # -- capacity calibration ----------------------------------------------

    def calibrate(self, frames, margin: float = 2.0, quantum: int = 128):
        """Measure per-stage survivor counts on calibration frames with full
        capacities (the masked oracle) and set the compacting capacities
        from them."""
        frames = self._frames(frames)
        if frames.shape[0] == 0:
            return self.capacities            # nothing to measure; keep as-is
        _, surv, _ = self.apply(frames, [self.n_windows] * self.n_stages)
        counts = surv.max(dim=0).values.cpu().numpy()
        self.capacities = capacities_from_counts(
            self.n_windows, counts, margin=margin, quantum=quantum)
        return self.capacities

    # -- detection ----------------------------------------------------------

    def _frames(self, frames) -> torch.Tensor:
        frames = torch.as_tensor(frames, dtype=torch.float32,
                                 device=self.device)
        return frames[None] if frames.dim() == 2 else frames

    def __call__(self, frames):
        """(B, h, w) -> (mask (B, n_windows), n_survivors (B, n_stages),
        dropped (B, n_stages)) as tensors on the detector's device."""
        return self.apply(self._frames(frames))

    def detect(self, frames):
        """Batched detection: (detections per frame — lists of (y, x, win)
        — and stats, as the reference's ``FusedDetector.detect``)."""
        frames = self._frames(frames)
        mask, surv, dropped = (a.cpu().numpy() for a in self(frames))
        pos = self.grid.positions
        dets = [[pos[i] for i in np.where(m)[0]] for m in mask]
        entering = np.concatenate(
            [np.full((len(frames), 1), self.n_windows, np.int64),
             surv[:, :-1].astype(np.int64)], axis=1)
        stats = {
            "n_windows": self.n_windows,
            "n_invocations": self.n_windows * len(frames),
            "stage_evals": int(entering.sum()),
            "static_stage_evals": len(frames) * int(np.sum(self.capacities)),
            "n_survivors": surv,
            "dropped": int(dropped.sum()),
            "capacities": list(self.capacities),
        }
        return dets, stats


def detect_faces_batch(cascade: Cascade, frames, scale_factor=1.25,
                       step=0.025, adaptive=True, strictness: float = 0.0,
                       capacities="auto", device=None):
    """Fused, batched detection over (B, h, w) frames.

    ``capacities="auto"`` calibrates on the first (up to 4) frames;
    ``None`` keeps full capacities (the masked oracle); a list is used
    as-is.  Returns (dets_per_frame, stats) as :meth:`FusedDetector.detect`.
    """
    frames = np.asarray(frames, np.float32)
    if frames.ndim == 2:
        frames = frames[None]
    if frames.shape[0] == 0:
        return [], {"n_windows": 0, "n_invocations": 0, "stage_evals": 0,
                    "static_stage_evals": 0,
                    "n_survivors": np.zeros((0, 0), np.int32),
                    "dropped": 0, "capacities": []}
    auto = isinstance(capacities, str) and capacities == "auto"
    h, w = frames.shape[-2:]
    det = FusedDetector(cascade, h, w, scale_factor=scale_factor, step=step,
                        adaptive=adaptive, strictness=strictness,
                        capacities=None if auto else capacities,
                        device=device)
    if auto:
        det.calibrate(frames[: min(4, len(frames))])
    return det.detect(frames)

