"""Wrapper of the CUDA WKV kernel (``csrc/rwkv_scan.cu``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "rwkv_wkv"
SOURCE = "src/repro_torch/csrc/rwkv_scan.cu"
REPLACES = "src/repro/kernels/rwkv_scan/kernel.py:85"
HEAD = 64

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.bind("repro_rwkv_wkv", [p, p, p, p, p, p, p, i, i, i, i,
                                             i, p])
    return _fn


def rwkv_wkv_cuda(r, k, v, w, u):
    """The WKV recurrence from the zero state, one launch of the chunked
    kernel.  r/k/w: (B, T, H, 64), v: (B, T, H, 64), u: (H, 64), float32
    CUDA, contiguous and 16-byte aligned ->
    (out (B, T, H, 64), final state (B, H, 64, 64))."""
    dev = r.device
    if dev.type != "cuda":
        raise ValueError("rwkv_wkv_cuda needs CUDA tensors")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _build.require(t, name, torch.float32, 4, dev)
    _build.require(u, "u", torch.float32, 2, dev)
    B, T, H, K = r.shape
    if K != HEAD or k.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"r/k/w must be (B, T, H, {HEAD}), got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(w.shape)}")
    if v.shape != (B, T, H, HEAD) or u.shape != (H, HEAD):
        raise ValueError(f"v {tuple(v.shape)} / u {tuple(u.shape)} do not "
                         f"match r {tuple(r.shape)}")
    if any(t.data_ptr() % 16 for t in (r, k, v, w)):
        raise ValueError("r/k/v/w must start 16-byte aligned (the kernel "
                         "copies 16-byte pieces)")
    out = torch.empty_like(v)
    state = torch.empty((B, H, HEAD, HEAD), device=dev)
    if B * H == 0:
        return out, state
    rc = _kernel()(_build.ptr(r), _build.ptr(k), _build.ptr(v), _build.ptr(w),
                   _build.ptr(u), _build.ptr(out), _build.ptr(state), B, T, H,
                   HEAD, HEAD, _build.stream_of(r))
    _build.check(rc, NAME)
    _build.launches[NAME] += 1
    return out, state
