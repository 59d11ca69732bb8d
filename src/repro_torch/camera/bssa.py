"""Bilateral-space stereo (BSSA), paper §IV-A/B, after Barron et al. [4]
— the port of the JAX package's ``camera/bssa.py``.

Per camera pair (Fig. 10/12):

1. **Rough disparity**: winner-take-all SAD block matching over a
   disparity range, the cost volume's box sums through the
   integral-image kernel.
2. **Splat**: pixels go to their nearest bilateral-grid vertex
   (y/s, x/s, intensity/s_r), disparity and weight summed there.
3. **Refine**: iterated [1,2,1] blurs of the value and weight grids, the
   block the paper's FPGA accelerates; through the bilateral-blur kernel.
   Float32 throughout: the paper found >= 32-bit float necessary.
4. **Slice**: trilinear sampling of the refined grid at each pixel.

Every function takes leading batch axes before (h, w): the rig's camera
pairs are one tensor (the reference vmaps a per-pair function).  A tensor
stays on its device; anything else goes to the card.
:func:`rough_disparity_ref`, :func:`refine` and :func:`bssa_depth_ref` are
the plain oracles; :func:`ms_ssim` is the quality metric (Fig. 11b).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.camera.integral import frame_integral
from repro_torch.core.reduction import div_const
from repro_torch.device import as_tensor
from repro_torch.kernels.bilateral_blur.ops import refine_grid
from repro_torch.kernels.bilateral_blur.ref import blur_121

__all__ = ["GridSpec", "blur_121", "bssa_depth", "bssa_depth_ref",
           "cost_volume", "ms_ssim", "refine", "rough_disparity",
           "rough_disparity_ref", "slice_grid", "splat"]


# ---------------------------------------------------------------------------
# Rough disparity (block matching)
# ---------------------------------------------------------------------------
#
# Disparity convention (the reference's): hypothesis d aligns left[y, x]
# with right[y, x - d], so a pair generated as right[x] = left[x + d] is
# recovered exactly.


def _sad_volume(L: torch.Tensor, R: torch.Tensor, ds: torch.Tensor,
                patch: int) -> torch.Tensor:
    """(B, h, w) x2 and (k,) shifts -> (B, k, h, w) f32 SADs of the
    patch x patch box, edges replicated; all B*k box-sum tables in one
    integral-image call.  Each table is summed on its own, so a
    hypothesis's SADs do not depend on the others in the call."""
    B, h, w = L.shape
    k = ds.shape[0]
    pad = patch // 2
    # shifted right views: rs[b, d, y, x] = right[b, y, max(x - d, 0)]
    xs = (torch.arange(w, device=L.device)[None, :] - ds[:, None]).clamp(
        0, w - 1)
    rs = torch.gather(R[:, None].expand(B, k, h, w), 3,
                      xs[None, :, None, :].expand(B, k, h, w))
    # each stage is 2 GB at 8 pairs of 4K: free it before the next
    diff = (L[:, None] - rs).abs()
    del rs
    dp = F.pad(diff, (pad, pad, pad, pad), mode="replicate")
    del diff
    ii = frame_integral(dp.reshape(B * k, h + 2 * pad, w + 2 * pad))
    del dp
    sad = (ii[:, patch:, patch:] - ii[:, :-patch, patch:]
           - ii[:, patch:, :-patch] + ii[:, :-patch, :-patch])
    return sad[:, :h, :w].reshape(B, k, h, w)


def cost_volume(left, right, max_disp: int = 16,
                patch: int = 5) -> torch.Tensor:
    """(h, w) x2 -> (max_disp + 1, h, w) f32: the SADs that
    :func:`rough_disparity` minimises, every hypothesis at once."""
    left = as_tensor(left, dtype=torch.float32)
    right = as_tensor(right, left.device, torch.float32)
    ds = torch.arange(max_disp + 1, device=left.device)
    return _sad_volume(left[None], right[None], ds, patch)[0]


def rough_disparity(left, right, max_disp: int = 16, patch: int = 5, *,
                    hypothesis_chunk: int = 8) -> torch.Tensor:
    """Winner-take-all SAD block matching, (..., h, w) f32 -> (..., h, w) f32.

    The hypothesis axis is cut into chunks of ``hypothesis_chunk``; every
    pair and every hypothesis of a chunk go through one integral-image
    launch, and a running minimum with a strict ``<`` combines the chunks,
    so the first winner is kept as in a single argmin over all hypotheses.
    The ragged last chunk is clamped to ``max_disp``: its duplicates give
    the same SADs and lose the strict comparison.
    """
    left = as_tensor(left, dtype=torch.float32)
    right = as_tensor(right, left.device, torch.float32)
    lead = left.shape[:-2]
    h, w = left.shape[-2:]
    L = left.reshape(-1, h, w)
    R = right.reshape(-1, h, w)
    n_hyp = max_disp + 1
    chunk = min(hypothesis_chunk, n_hyp)
    best = torch.full(L.shape, math.inf, device=L.device)
    bestd = torch.zeros(L.shape, dtype=torch.int64, device=L.device)
    for c in range(-(-n_hyp // chunk)):
        ds = (c * chunk + torch.arange(chunk, device=L.device)).clamp(
            max=max_disp)
        sad = _sad_volume(L, R, ds, patch)
        cmin = sad.amin(dim=1)
        carg = sad.argmin(dim=1)          # the first minimum
        better = cmin < best
        best = torch.where(better, cmin, best)
        bestd = torch.where(better, ds[carg], bestd)
    return bestd.to(torch.float32).reshape(*lead, h, w)


def rough_disparity_ref(left, right, max_disp: int = 16,
                        patch: int = 5) -> torch.Tensor:
    """Per-hypothesis loop oracle (the reference's seed loop: roll, fill
    the first columns, one box-sum table per hypothesis, one argmin)."""
    left = as_tensor(left, dtype=torch.float32)
    right = as_tensor(right, left.device, torch.float32)
    h, w = left.shape[-2:]
    pad = patch // 2
    costs = []
    for d in range(max_disp + 1):
        rs = torch.roll(right, d, dims=-1)
        if d:
            rs[..., :d] = right[..., :1]
        diff = (left - rs).abs()
        dp = F.pad(diff.reshape(-1, h, w), (pad, pad, pad, pad),
                   mode="replicate")
        ii = frame_integral(dp).reshape(*left.shape[:-2], h + 2 * pad + 1,
                                        w + 2 * pad + 1)
        sad = (ii[..., patch:, patch:] - ii[..., :-patch, patch:]
               - ii[..., patch:, :-patch] + ii[..., :-patch, :-patch])
        costs.append(sad[..., :h, :w])
    return torch.stack(costs).argmin(dim=0).to(torch.float32)


# ---------------------------------------------------------------------------
# Bilateral grid
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GridSpec:
    sigma_spatial: int          # pixels per grid vertex (paper sweeps 4..64)
    sigma_range: float = 16.0   # intensity bins (on [0,255] scale)

    def dims(self, h: int, w: int):
        gy = int(np.ceil(h / self.sigma_spatial)) + 1
        gx = int(np.ceil(w / self.sigma_spatial)) + 1
        gr = int(np.ceil(256.0 / self.sigma_range)) + 1
        return gy, gx, gr


def _grid_coords(img: torch.Tensor, spec: GridSpec):
    """Grid coordinates of every pixel: cy, cx of shape (h*w,) and cr of
    shape (..., h*w).  Divisions by a constant are the reciprocal
    multiplies of the reference's jitted executor (``div_const``); for a
    power-of-two sigma the two forms agree."""
    h, w = img.shape[-2:]
    yy, xx = torch.meshgrid(torch.arange(h, device=img.device),
                            torch.arange(w, device=img.device),
                            indexing="ij")
    cy = div_const(yy.reshape(-1).to(torch.float32), spec.sigma_spatial)
    cx = div_const(xx.reshape(-1).to(torch.float32), spec.sigma_spatial)
    cr = div_const(img * 255.0, spec.sigma_range)
    return cy, cx, cr.reshape(*img.shape[:-2], h * w)


def splat(img, values, spec: GridSpec):
    """Accumulate (value, weight) at each pixel's nearest grid vertex:
    (..., h, w) x2 -> (grid_val, grid_wt), each (..., gy, gx, gr).

    On the main path the values are integer disparities (at most 32) and
    the weights ones, and a vertex gathers at most a few hundred pixels:
    every float32 partial sum is an integer below 2^24, exact in any
    order, so ``index_add_`` (atomics on the card) gives the same grids
    on the card, on the CPU and in the reference.
    """
    img = as_tensor(img, dtype=torch.float32)
    values = as_tensor(values, img.device, torch.float32)
    lead = img.shape[:-2]
    h, w = img.shape[-2:]
    gy, gx, gr = spec.dims(h, w)
    cy, cx, cr = _grid_coords(img, spec)
    # clip in float, then cast (as the reference)
    iy = torch.round(cy).clamp(0, gy - 1).to(torch.int64)
    ix = torch.round(cx).clamp(0, gx - 1).to(torch.int64)
    ir = torch.round(cr).clamp(0, gr - 1).to(torch.int64)
    n = gy * gx * gr
    flat = ((iy * gx + ix) * gr + ir).reshape(-1, h * w)
    flat = flat + n * torch.arange(flat.shape[0], device=img.device)[:, None]
    flat = flat.reshape(-1)
    total = flat.shape[0] // (h * w) * n
    v = torch.zeros(total, device=img.device).index_add_(
        0, flat, values.reshape(-1))
    wt = torch.zeros(total, device=img.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.float32))
    return v.reshape(*lead, gy, gx, gr), wt.reshape(*lead, gy, gx, gr)


def refine(grid_val, grid_wt, n_iters: int = 8):
    """Iterated bilateral-space smoothing, the plain oracle: both grids
    blurred ``n_iters`` times with :func:`blur_121`."""
    for _ in range(n_iters):
        grid_val, grid_wt = blur_121(grid_val), blur_121(grid_wt)
    return grid_val, grid_wt


def slice_grid(grid_val, grid_wt, img, spec: GridSpec) -> torch.Tensor:
    """Trilinear sampling of the refined grid at each pixel's coordinates:
    (..., gy, gx, gr) x2 and (..., h, w) -> (..., h, w).

    Each product and sum is rounded on its own; the reference's jitted
    executor lets XLA fuse ``num += wv * v`` into an FMA, so the two differ
    by float32 rounding of the sums (the tests state the tolerance)."""
    img = as_tensor(img, dtype=torch.float32)
    h, w = img.shape[-2:]
    gy, gx, gr = grid_val.shape[-3:]
    cy, cx, cr = _grid_coords(img, spec)
    y0 = torch.floor(cy).clamp(0, gy - 2).to(torch.int64)
    x0 = torch.floor(cx).clamp(0, gx - 2).to(torch.int64)
    r0 = torch.floor(cr).clamp(0, gr - 2).to(torch.int64)
    fy = (cy - y0).clamp(0, 1)
    fx = (cx - x0).clamp(0, 1)
    fr = (cr - r0).clamp(0, 1)
    B = cr.reshape(-1, h * w).shape[0]
    gv = grid_val.reshape(B, -1)
    gw = grid_wt.reshape(B, -1)
    r0 = r0.reshape(B, h * w)
    fr = fr.reshape(B, h * w)

    num = torch.zeros((B, h * w), device=img.device)
    den = torch.zeros((B, h * w), device=img.device)
    for dy in (0, 1):
        for dx in (0, 1):
            for dr in (0, 1):
                wv = ((fy if dy else 1 - fy) * (fx if dx else 1 - fx)
                      * (fr if dr else 1 - fr))
                flat = ((y0 + dy) * gx + (x0 + dx)) * gr + (r0 + dr)
                num = num + wv * torch.gather(gv, 1, flat)
                den = den + wv * torch.gather(gw, 1, flat)
    out = num / torch.maximum(den, den.new_tensor(1e-6))
    return out.reshape(img.shape)


def bssa_depth(left, right, spec: GridSpec, max_disp: int = 16,
               n_iters: int = 8) -> torch.Tensor:
    """Full BSSA, (..., h, w) x2 -> (..., h, w): rough disparity (through
    the integral-image kernel on a card) -> splat -> ``refine_grid``
    (the bilateral-blur kernel on a card) -> slice."""
    rough = rough_disparity(left, right, max_disp)
    gv, gw = splat(left, rough, spec)
    gv, gw = refine_grid(gv, gw, n_iters)
    return slice_grid(gv, gw, left, spec)


def bssa_depth_ref(left, right, spec: GridSpec, max_disp: int = 16,
                   n_iters: int = 8) -> torch.Tensor:
    """Plain oracle: loop rough disparity -> splat -> :func:`refine` ->
    slice."""
    rough = rough_disparity_ref(left, right, max_disp)
    gv, gw = splat(left, rough, spec)
    gv, gw = refine(gv, gw, n_iters)
    return slice_grid(gv, gw, left, spec)


# ---------------------------------------------------------------------------
# MS-SSIM (paper's quality metric, Fig. 11b) — [42]
# ---------------------------------------------------------------------------


def _ssim(a: torch.Tensor, b: torch.Tensor, win: int = 8):
    """Mean SSIM with box windows (adequate for relative comparisons)."""
    def box(x):
        ii = F.pad(torch.cumsum(torch.cumsum(x, 0), 1), (1, 0, 1, 0))
        s = (ii[win:, win:] - ii[:-win, win:] - ii[win:, :-win]
             + ii[:-win, :-win])
        return s / (win * win)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_a, mu_b = box(a), box(b)
    va = box(a * a) - mu_a ** 2
    vb = box(b * b) - mu_b ** 2
    cov = box(a * b) - mu_a * mu_b
    ssim = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))
    return ssim.mean()


def ms_ssim(a, b, levels: int = 3) -> float:
    """Multi-scale SSIM: geometric mean of SSIM over dyadic downsamples."""
    a = as_tensor(a, dtype=torch.float32)
    b = as_tensor(b, a.device, torch.float32)
    total = 1.0
    for _ in range(levels):
        total = total * float(_ssim(a, b).clamp(1e-4, 1.0)) ** (1.0 / levels)
        h, w = a.shape
        a = a[:h // 2 * 2, :w // 2 * 2].reshape(h // 2, 2, w // 2, 2).mean(
            (1, 3))
        b = b[:h // 2 * 2, :w // 2 * 2].reshape(h // 2, 2, w // 2, 2).mean(
            (1, 3))
    return float(total)
