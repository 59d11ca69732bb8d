"""Panorama composition (paper Fig. 10 B5): project + feather-blend — the
port of the JAX package's ``camera/stitch.py``.

The stitch block is computationally marginal next to BSSA (§IV-C) but its
output size is what makes offload feasible: it is the pipeline's last
data-reduction step.  Every stage is batched over the view axis: the warp
is one gather over (..., h, w), the blend one scatter-add into the canvas.

The warp's source-pixel maps depend only on (h, w, f).  They are computed
once per shape in float64 on the host and cached, so the card and the CPU
gather the same pixels.  The reference computes them in float32 with its
backend's own ``tan`` and ``cos``; the truncated source index can then
differ from the port's where a coordinate lies within float32 rounding of
an integer (or of the valid range's border).  :func:`warp_coords` returns
the float64 coordinates, so a comparison can tell those pixels apart.
A tensor stays on its device; anything else goes to the card.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.reduction import div_const
from repro_torch.device import as_tensor


@functools.lru_cache(maxsize=None)
def warp_coords(h: int, w: int, f: float):
    """Float64 source coordinates (x_src, y_src), each (h, w), of the
    cylindrical projection with focal length ``f`` (pixels)."""
    yc, xc = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    theta = (xs - xc) / f
    hh = (ys - yc) / f
    x_src = f * np.tan(theta) + xc
    y_src = hh * f / np.cos(theta) + yc
    x_src.setflags(write=False)
    y_src.setflags(write=False)
    return x_src, y_src


@functools.lru_cache(maxsize=None)
def warp_maps(h: int, w: int, f: float, device):
    """(flat source index (h*w,) int64, valid (h*w,) bool) on ``device``,
    computed once per shape and device."""
    x_src, y_src = warp_coords(h, w, float(f))
    # clamp in float before the int cast (tan/cos blow up near the
    # cylinder's edge); same values wherever ``valid``
    x0 = np.clip(x_src, 0, w - 1).astype(np.int64)
    y0 = np.clip(y_src, 0, h - 1).astype(np.int64)
    valid = (x_src >= 0) & (x_src < w) & (y_src >= 0) & (y_src < h)
    return (torch.as_tensor((y0 * w + x0).reshape(-1), device=device),
            torch.as_tensor(valid.reshape(-1), device=device))


def cylindrical_warp(img, f: float) -> torch.Tensor:
    """Project (..., h, w) image(s) onto a cylinder of focal length f
    (pixels); leading axes are carried through the gather."""
    img = as_tensor(img)
    h, w = img.shape[-2:]
    src, valid = warp_maps(h, w, f, img.device)
    out = img.reshape(*img.shape[:-2], h * w)[..., src]
    return torch.where(valid, out, 0.0).reshape(img.shape)


def _linspace01(n: int, device=None):
    """``jnp.linspace(0, 1, n)`` and ``jnp.linspace(1, 0, n)`` as the
    reference's jitted executor computes them: ``step = i * f32(1/(n-1))``
    for i < n-1, then ``step`` / ``1 - step``, and the end point."""
    if n <= 1:
        return (torch.zeros(n, device=device), torch.ones(n, device=device))
    step = div_const(torch.arange(n - 1, dtype=torch.float32,
                                  device=device), n - 1)
    return (torch.cat([step, torch.ones(1, device=device)]),
            torch.cat([1 - step, torch.zeros(1, device=device)]))


def feather_ramp(w: int, overlap: int, device=None) -> torch.Tensor:
    """Per-tile blend weight profile: linear up / flat / linear down.

    Adjacent tiles overlap by ``overlap`` columns; there the falling ramp
    of tile i and the rising ramp of tile i+1 sum to 1 (seam continuity).
    The rising ramp is ``jnp.linspace(0, 1, overlap)`` bit for bit.  The
    falling one is ``1 - step``; XLA computes it with an FMA in its
    vectorised loop and without one in the loop's tail, so the two can
    differ by one float32 ulp at some columns (``tests/test_torch_vr.py``
    holds the bound)."""
    up, down = _linspace01(overlap, device)
    return torch.cat([up, torch.ones(w - 2 * overlap, device=device), down])


def feather_blend(tiles, overlap: int) -> torch.Tensor:
    """Blend horizontally-adjacent warped tiles with linear feathering.

    tiles: (n, h, w); adjacent tiles share ``overlap`` columns.  One
    scatter-add builds the canvas and one the weight row.  A canvas column
    gathers at most two terms, and a float32 sum of two terms onto zero is
    the same in either order, so the canvas is exact in any order."""
    tiles = as_tensor(tiles, dtype=torch.float32)
    n, h, w = tiles.shape
    step = w - overlap
    total_w = step * (n - 1) + w
    ramp = feather_ramp(w, overlap, tiles.device)
    cols = ((torch.arange(n, device=tiles.device) * step)[:, None]
            + torch.arange(w, device=tiles.device)[None, :]).reshape(-1)
    weighted = (tiles * ramp).permute(1, 0, 2).reshape(h, n * w)
    canvas = torch.zeros((h, total_w), device=tiles.device).index_add_(
        1, cols, weighted)
    weight = torch.zeros(total_w, device=tiles.device).index_add_(
        0, cols, ramp.repeat(n))
    return canvas / torch.maximum(weight, weight.new_tensor(1e-6))


def stitch_ring(views, focal: Optional[float] = None,
                overlap_frac: float = 0.15) -> torch.Tensor:
    """Stitch a ring of camera views (n, h, w) into a panorama strip: one
    batched warp, one batched blend."""
    views = as_tensor(views)
    h, w = views.shape[-2:]
    f = focal or 0.8 * w
    warped = cylindrical_warp(views, f)
    return feather_blend(warped, int(w * overlap_frac))


def stereo_panorama(left_views, right_views, depths, ipd_px: float = 6.0):
    """The stereo pair of panoramas: right-eye views are re-projected by a
    disparity proportional to inverse depth (view synthesis lite), one
    batched gather."""
    left_views = as_tensor(left_views)
    right_views = as_tensor(right_views, left_views.device)
    depths = as_tensor(depths, left_views.device)      # (n, h, w)
    w = right_views.shape[-1]
    dmax = torch.maximum(depths.amax(dim=(-2, -1), keepdim=True),
                         depths.new_tensor(1e-6))
    # clamp the disparity in float before casting
    shift = (ipd_px * depths / dmax).clamp(0, w - 1).to(torch.int64)
    xs = (torch.arange(w, device=depths.device) - shift).clamp(0, w - 1)
    shifted = torch.gather(right_views, -1, xs)
    return stitch_ring(left_views), stitch_ring(shifted)
