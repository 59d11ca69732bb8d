"""Viola-Jones face detection (paper §III-B): Haar features, AdaBoost
cascade training, scanning.

The port of the JAX package's ``camera/viola_jones.py``: Haar features and
their corner-tap decomposition, the feature evaluation on each window's
integral image (:func:`eval_features`, :func:`eval_features_scaled`), the
AdaBoost cascade training (:func:`train_cascade`) with hard-negative
bootstrapping (:func:`harvest_hard_negatives`), the cascade on canonical
windows (:func:`cascade_apply`), the golden per-window detector
(:func:`detect_faces`), the scan pyramid, the gather tables, and the
frame-resident fused detector (:class:`FusedDetector`): one integral image
of each frame and of its square (one launch of the integral-image kernel
for the batch), per-window variance normalizers, and a compacting cascade
whose every stage is one launch of the Haar-stage kernel over all frames.
Scaled-feature semantics as in the reference: the features are scaled to
the window, not the window resampled.

The feature evaluation takes its tables from the integral-image kernel
(its plain version on the CPU, which the kernel equals bit for bit), so
the card and the CPU give the same features, and follows the reference's
arithmetic in its order.  The stump search of :func:`train_cascade` runs
on the host in numpy float64, as the reference's does, on the feature
matrix copied there once.

Geometry (``HaarFeature``, ``scale_feature``, ``scan_positions``,
``build_scan_grid``, ``build_gather_tables``) is plain Python and numpy,
identical to the reference's.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.camera.integral import frame_integral, window_sum
from repro_torch.core.cascade import (
    Stage as CoreStage,
    capacities_from_counts,
    compacting_cascade,
)
from repro_torch.core.reduction import sqrt_rn
from repro_torch.device import as_tensor, resolve_device
from repro_torch.kernels.haar_frontend.ops import haar_stage_scores
from repro_torch.kernels.haar_frontend.ref import _sign
from repro_torch.kernels.integral_image.ops import integral_image

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


def _rects(f: HaarFeature):
    """The rectangles (y, x, h, w) the reference's ``_haar_response``
    sums: two for a 2-rect feature, three for a 3-rect one."""
    if f.kind == 0:
        hw = f.w // 2
        return [(f.y, f.x, f.h, hw), (f.y, f.x + hw, f.h, hw)]
    if f.kind == 1:
        hh = f.h // 2
        return [(f.y, f.x, hh, f.w), (f.y + hh, f.x, hh, f.w)]
    if f.kind == 2:
        w3 = f.w // 3
        return [(f.y, f.x + k * w3, f.h, w3) for k in range(3)]
    h3 = f.h // 3
    return [(f.y + k * h3, f.x, h3, f.w) for k in range(3)]


def _haar_response(ii: torch.Tensor, feats: list) -> torch.Tensor:
    """Raw (unnormalized) responses (n, n_feats) of ``feats`` on the
    tables ``ii`` (n, s+1, s+1), by rectangle sums in the reference's
    order: a window sum is ((A - B) - C) + D over its corners (y+h, x+w),
    (y, x+w), (y+h, x), (y, x); a 2-rect feature is r0 - r1, a 3-rect one
    (r0 + r2) - 2 r1.  One gather for all features."""
    stride = ii.shape[-1]
    idx = np.zeros((len(feats), 3, 4), np.int64)
    three = np.zeros(len(feats), bool)
    for k, f in enumerate(feats):
        rects = _rects(f)
        three[k] = len(rects) == 3
        for r, (y, x, h, w) in enumerate(rects):
            idx[k, r] = ((y + h) * stride + x + w, y * stride + x + w,
                         (y + h) * stride + x, y * stride + x)
    dev = ii.device
    t = ii.reshape(ii.shape[0], -1)[:, torch.as_tensor(idx.reshape(-1),
                                                       device=dev)]
    t = t.reshape(ii.shape[0], len(feats), 3, 4)
    r = ((t[..., 0] - t[..., 1]) - t[..., 2]) + t[..., 3]
    return torch.where(torch.as_tensor(three, device=dev),
                       (r[..., 0] + r[..., 2]) - 2 * r[..., 1],
                       r[..., 0] - r[..., 1])


def _features(patches, win: int, feats: list, device) -> torch.Tensor:
    """Variance-normalized responses of features already at ``win``.

    The tables of the patches and of their squares come from one launch of
    the integral-image kernel.  The standard deviation is a float64 square
    root rounded once to float32: the correctly rounded float32 root, as
    the reference's (PyTorch's float32 ``sqrt`` on the CPU is not
    correctly rounded; one window in 800 of the face set differs)."""
    p = as_tensor(patches, device).to(torch.float32).reshape(-1, win, win)
    n = p.shape[0]
    tables = integral_image(torch.cat([p, p * p]))
    ii, sq = tables[:n], tables[n:]
    # a tensor divisor: CUDA turns division by a host scalar into a
    # multiply by its reciprocal, which rounds otherwise
    area = torch.tensor(float(win * win), device=p.device)
    mu = window_sum(ii, 0, 0, win, win) / area
    var = window_sum(sq, 0, 0, win, win) / area - mu * mu
    sd = torch.sqrt(var.clamp(min=1e-6).double()).float()
    return _haar_response(ii, feats) / (sd * win * win)[:, None]


def eval_features(windows, feats: list, *, device=None) -> torch.Tensor:
    """windows (n, 20, 20) -> (n, n_feats) Haar responses, variance
    normalized, on the windows' device (a tensor) or ``device`` (the card
    when None)."""
    return _features(windows, BASE, feats, device)


def eval_features_scaled(patches, win: int, feats: list, *,
                         device=None) -> torch.Tensor:
    """Native-resolution windows (n, win, win) -> (n, n_feats) responses
    with the canonical features scaled to the window.  At ``win == BASE``
    this is :func:`eval_features`."""
    return _features(patches, win, [scale_feature(f, win) for f in feats],
                     device)


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


def train_cascade(X, y, pool: list, n_stages: int = 10, per_stage: int = 33,
                  stage_recall: float = 0.995, seed: int = 0, *,
                  device=None) -> Cascade:
    """AdaBoost decision stumps per stage; stage thresholds set to hit
    ``stage_recall`` on training positives (the classic VJ construction).
    The features are evaluated on ``device`` (the card when None) and
    copied to the host once; the boosting runs there (:func:`_boost`)."""
    X = np.asarray(X, np.float32)
    F = eval_features(X.reshape(-1, BASE, BASE), pool, device=device)
    return _boost(F.cpu().numpy(), np.asarray(y), pool, n_stages, per_stage,
                  stage_recall, seed)


def _boost(F: np.ndarray, y: np.ndarray, pool: list, n_stages: int = 10,
           per_stage: int = 33, stage_recall: float = 0.995,
           seed: int = 0) -> Cascade:
    """The reference's stump search and stage loop on a float32 feature
    matrix F (n, n_pool), in numpy float64 with its draws and its sort."""
    rng = np.random.default_rng(seed)
    yb = y.astype(np.float64) * 2 - 1

    active = np.ones(len(F), bool)                   # survivors so far
    feats, thresholds, polarity, alphas = [], [], [], []
    stage_sizes, stage_thrs = [], []

    for _ in range(n_stages):
        idx = np.where(active)[0]
        if len(idx) < 10 or (y[idx] == 1).sum() < 5 or (y[idx] == 0).sum() < 2:
            break
        Xi, yi = F[idx], yb[idx]
        w = np.ones(len(idx)) / len(idx)
        stage_score = np.zeros(len(idx))
        stage_feats = []
        for _k in range(per_stage):
            # best stump over a random subsample of the pool
            cand = rng.choice(len(pool), size=min(80, len(pool)), replace=False)
            best = None
            for ci in cand:
                vals = Xi[:, ci]
                order = np.argsort(vals)
                sv, sy, sw = vals[order], yi[order], w[order]
                cum_pos = np.cumsum(sw * (sy > 0))
                cum_neg = np.cumsum(sw * (sy < 0))
                tot_pos, tot_neg = cum_pos[-1], cum_neg[-1]
                # polarity +1: predict + if val > thr
                err_p = cum_pos + (tot_neg - cum_neg)
                err_m = cum_neg + (tot_pos - cum_pos)
                i_p, i_m = np.argmin(err_p), np.argmin(err_m)
                if err_p[i_p] <= err_m[i_m]:
                    err, i_thr, pol = err_p[i_p], i_p, 1.0
                else:
                    err, i_thr, pol = err_m[i_m], i_m, -1.0
                thr = sv[min(i_thr, len(sv) - 1)]
                if best is None or err < best[0]:
                    best = (err, ci, thr, pol)
            err, ci, thr, pol = best
            err = min(max(err, 1e-10), 1 - 1e-10)
            alpha = 0.5 * np.log((1 - err) / err)
            pred = pol * np.sign(Xi[:, ci] - thr)
            pred[pred == 0] = 1
            w = w * np.exp(-alpha * yi * pred)
            w /= w.sum()
            stage_score += alpha * pred
            feats.append(pool[ci])
            thresholds.append(thr)
            polarity.append(pol)
            alphas.append(alpha)
            stage_feats.append(ci)
        # stage threshold for target recall on positives
        pos_scores = np.sort(stage_score[yi > 0])
        k = max(0, int((1 - stage_recall) * len(pos_scores)) - 1)
        thr_stage = pos_scores[k] - 1e-9 if len(pos_scores) else 0.0
        stage_thrs.append(thr_stage)
        stage_sizes.append(len(stage_feats))
        active[idx] = stage_score >= thr_stage

    return Cascade(feats, np.array(thresholds), np.array(polarity),
                   np.array(alphas), stage_sizes, np.array(stage_thrs))


def _run_stages(cascade: Cascade, F: torch.Tensor, strictness: float = 0.0):
    """Stump votes and the masked stage loop on features F (n, n_weak).

    Returns (accepted (n,) bool, stage_evals (n,) int32: the stages a
    data-dependent implementation evaluates per window, which the energy
    model charges), on F's device."""
    def on(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=F.device)

    pred = on(cascade.polarity) * _sign(F - on(cascade.thresholds))
    pred = torch.where(pred == 0, torch.ones_like(pred), pred)
    weighted = on(cascade.alphas) * pred

    alive = torch.ones(F.shape[0], dtype=torch.bool, device=F.device)
    evals = torch.zeros(F.shape[0], dtype=torch.int32, device=F.device)
    off = 0
    for si, size in enumerate(cascade.stage_sizes):
        evals = evals + alive.to(torch.int32)
        # a sequential sum, as XLA's for stages of up to 20 stumps and the
        # Haar-stage kernel's (torch.sum associates otherwise)
        score = torch.zeros_like(alive, dtype=torch.float32)
        for k in range(off, off + size):
            score = score + weighted[:, k]
        alive = alive & (score >= float(cascade.stage_thresholds[si])
                         + strictness)
        off += size
    return alive, evals


def cascade_apply(cascade: Cascade, windows, *, device=None):
    """Run the cascade on canonical (n, 20, 20) windows (training scale):
    (accepted, stage_evals) as :func:`_run_stages`."""
    return _run_stages(cascade, eval_features(windows, cascade.feats,
                                              device=device))


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


def detect_faces(cascade: Cascade, frame, scale_factor=1.25, step=0.025,
                 adaptive=True, strictness: float = 0.0, chunk: int = 1024,
                 *, device=None):
    """Full-frame detection, the slow golden oracle: (detections,
    n_invocations, n_stage_evals).  Every scanning window is cut out at
    native resolution, gets its own integral image, and is scored by
    :func:`eval_features_scaled` and :func:`_run_stages` in scale-major
    chunks on ``device`` (the card when None).  :class:`FusedDetector`
    computes the same function from one frame-level integral image."""
    device = resolve_device(device)
    frame = np.asarray(frame, np.float32)
    pos = scan_positions(frame.shape[0], frame.shape[1], scale_factor, step,
                         adaptive)
    if not pos:
        return [], 0, 0
    dets, total_evals = [], 0
    i = 0
    while i < len(pos):                 # scan order is scale-major
        win = pos[i][2]
        j = i
        while j < len(pos) and pos[j][2] == win:
            j += 1
        for c0 in range(i, j, chunk):
            group = pos[c0:min(c0 + chunk, j)]
            patches = np.stack([frame[y:y + win, x:x + win]
                                for (y, x, _w) in group])
            F = eval_features_scaled(patches, win, cascade.feats,
                                     device=device)
            alive, evals = _run_stages(cascade, F, strictness)
            dets.extend(group[k] for k in np.where(alive.cpu().numpy())[0])
            total_evals += int(evals.sum())
        i = j
    return dets, len(pos), total_evals


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
        # correctly rounded (the CPU's float32 root is not), as XLA's
        sd = sqrt_rn(var.clamp(min=1e-6))
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


def harvest_hard_negatives(frames, truth, n: int = 1500, seed: int = 0):
    """Bootstrap negatives from scene windows away from true faces (the
    classic cascade-training trick): up to 10 frames drawn by
    ``np.random.default_rng(seed)``, ``n // 10`` windows of a coarse scan
    each, those within 15 pixels of a true face left out.  Returns float32
    (m, 400) canonical windows, as the reference's."""
    rng = np.random.default_rng(seed)
    neg = []
    idxs = rng.choice(len(frames), min(10, len(frames)), replace=False)
    per = max(1, n // len(idxs))
    for i in idxs:
        pos = scan_positions(frames[i].shape[0], frames[i].shape[1], 1.6,
                             0.08, True)
        take = rng.choice(len(pos), min(per, len(pos)), replace=False)
        wins = extract_windows(frames[i], [pos[j] for j in take])
        for w, (yy, xx, _sz) in zip(wins, [pos[j] for j in take]):
            near = any(abs(yy - fy) < 15 and abs(xx - fx) < 15
                       for (fy, fx, _s) in truth[i]["faces"])
            if not near:
                neg.append(w.reshape(-1))
    return np.stack(neg).astype(np.float32)
