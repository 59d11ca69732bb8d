"""Wrapper of the CUDA integral-image kernel (``csrc/integral_image.cu``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "integral_image"
SOURCE = "src/repro_torch/csrc/integral_image.cu"
REPLACES = "src/repro/kernels/integral_image/kernel.py:42"
STRIP_ROWS = 64          # rows per strip: RS in csrc/integral_image.cu

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.bind("repro_integral_image",
                          [p, p, i, i, i, p, ctypes.c_longlong, p])
    return _fn


def integral_image_cuda(img: torch.Tensor) -> torch.Tensor:
    """(n, h, w) f32 CUDA -> (n, h+1, w+1) f32, one launch for the batch.

    The kernel's ticket and per-strip progress counters are an int32
    scratch allocated here (the C entry point zeroes it)."""
    _build.require(img, "img", torch.float32, 3, img.device)
    if img.device.type != "cuda":
        raise ValueError("integral_image_cuda needs a CUDA tensor")
    n, h, w = img.shape
    out = torch.empty((n, h + 1, w + 1), dtype=torch.float32,
                      device=img.device)
    if img.numel() == 0:
        return out.zero_()
    scratch = torch.empty(1 + n * -(-h // STRIP_ROWS), dtype=torch.int32,
                          device=img.device)
    rc = _kernel()(_build.ptr(img), _build.ptr(out), n, h, w,
                   _build.ptr(scratch), scratch.numel(),
                   _build.stream_of(img))
    _build.check(rc, NAME)
    _build.launches[NAME] += 1
    return out
