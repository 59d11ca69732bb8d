"""Wrapper of the CUDA bilateral-grid blur kernel
(``csrc/bilateral_blur.cu``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "bilateral_blur"
SOURCE = "src/repro_torch/csrc/bilateral_blur.cu"
REPLACES = "src/repro/kernels/bilateral_blur/kernel.py:53"
# the largest interior tile, in vertices; the steps of one launch (and its
# halo) and the bytes of shared memory a block may have, which the source's
# kMaxSteps and kSmemLimit check
TILE_Y, TILE_X, MAX_STEPS, SMEM_LIMIT = 34, 32, 8, 232_448

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.bind("repro_bilateral_blur",
                          [p, p, p, p, i, i, i, i, i, i, i, i, i, p])
    return _fn


def tile_shape(gy: int, gx: int, gr: int, n_steps: int, max_y: int = TILE_Y,
               max_x: int = TILE_X):
    """The tiles of a launch: equal tiles of at most max_y x max_x
    vertices, halved until the tile and its n_steps halo fit in shared
    memory.  Returns (ty, tx, the staged row's stride in floats, padded to
    gr modulo 32 banks, shared bytes a block)."""
    def cdiv(a, b):
        return -(-a // b)

    while True:
        ty, tx = cdiv(gy, cdiv(gy, max_y)), cdiv(gx, cdiv(gx, max_x))
        sy, sx = min(gy, ty + 2 * n_steps), min(gx, tx + 2 * n_steps)
        rs = sx * gr + (gr - sx * gr) % 32      # rs = gr modulo 32 banks
        if 4 * sy * rs <= SMEM_LIMIT:
            return ty, tx, rs, 4 * sy * rs
        if (max_y, max_x) == (1, 1):
            raise ValueError(f"{gr} bins do not fit in shared memory")
        if max_y >= max_x:
            max_y = cdiv(max_y, 2)
        else:
            max_x = cdiv(max_x, 2)


def bilateral_blur_cuda(val: torch.Tensor, wt: torch.Tensor,
                        n_steps: int = 1):
    """(P, gy, gx, gr) f32 CUDA x2 -> ``n_steps`` blur steps of both grids,
    one launch for every ``MAX_STEPS`` steps (``n_steps = 0``: copies)."""
    dev = val.device
    if dev.type != "cuda":
        raise ValueError("bilateral_blur_cuda needs CUDA tensors")
    _build.require(val, "val", torch.float32, 4, dev)
    _build.require(wt, "wt", torch.float32, 4, dev)
    if wt.shape != val.shape:
        raise ValueError(f"wt {tuple(wt.shape)} != val {tuple(val.shape)}")
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    P, gy, gx, gr = val.shape
    if val.numel() == 0 or n_steps == 0:
        return val.clone(), wt.clone()
    while n_steps > 0:
        steps = min(n_steps, MAX_STEPS)
        ty, tx, rs, smem = tile_shape(gy, gx, gr, steps)
        val_out, wt_out = torch.empty_like(val), torch.empty_like(wt)
        rc = _kernel()(_build.ptr(val), _build.ptr(wt), _build.ptr(val_out),
                       _build.ptr(wt_out), P, gy, gx, gr, steps, ty, tx, rs,
                       smem, _build.stream_of(val))
        _build.check(rc, NAME)
        _build.launches[NAME] += 1
        val, wt, n_steps = val_out, wt_out, n_steps - steps
    return val, wt
