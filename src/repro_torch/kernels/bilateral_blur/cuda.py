"""Wrapper of the CUDA bilateral-grid blur kernel
(``csrc/bilateral_blur.cu``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "bilateral_blur"
SOURCE = "src/repro_torch/csrc/bilateral_blur.cu"
REPLACES = "src/repro/kernels/bilateral_blur/kernel.py:53"

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.bind("repro_bilateral_blur", [p, p, p, p, i, i, i, i, p])
    return _fn


def bilateral_blur_cuda(val: torch.Tensor, wt: torch.Tensor):
    """(P, gy, gx, gr) f32 CUDA x2 -> one blur step of both grids, one
    launch."""
    dev = val.device
    if dev.type != "cuda":
        raise ValueError("bilateral_blur_cuda needs CUDA tensors")
    _build.require(val, "val", torch.float32, 4, dev)
    _build.require(wt, "wt", torch.float32, 4, dev)
    if wt.shape != val.shape:
        raise ValueError(f"wt {tuple(wt.shape)} != val {tuple(val.shape)}")
    P, gy, gx, gr = val.shape
    val_out, wt_out = torch.empty_like(val), torch.empty_like(wt)
    if val.numel() == 0:
        return val_out, wt_out
    rc = _kernel()(_build.ptr(val), _build.ptr(wt), _build.ptr(val_out),
                   _build.ptr(wt_out), P, gy, gx, gr, _build.stream_of(val))
    _build.check(rc, NAME)
    _build.launches[NAME] += 1
    return val_out, wt_out
