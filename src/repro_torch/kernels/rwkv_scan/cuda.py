"""Wrappers of the CUDA WKV kernels: the recurrence (``csrc/rwkv_scan.cu``)
and its backward (``csrc/rwkv_scan_bwd.cu``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "rwkv_wkv"
BWD_NAME = "rwkv_wkv_bwd"
SOURCE = "src/repro_torch/csrc/rwkv_scan.cu"
BWD_SOURCE = "src/repro_torch/csrc/rwkv_scan_bwd.cu"
REPLACES = "src/repro/kernels/rwkv_scan/kernel.py:85"
HEAD = 64
BWD_CHUNK = 16      # csrc/rwkv_scan_bwd.cu kChunk: steps between stored states

_fn = None
_bwd_fn = None


def _kernel():
    global _fn
    if _fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.bind("repro_rwkv_wkv", [p, p, p, p, p, p, p, i, i, i, i,
                                             i, p])
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _bwd_fn = _build.bind("repro_rwkv_wkv_bwd", [p] * 13 + [i] * 5 + [p])
    return _bwd_fn


def _check_inputs(r, k, v, w, u, extra=()):
    dev = r.device
    if dev.type != "cuda":
        raise ValueError("the WKV kernels need CUDA tensors")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), *extra):
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
    for name, t in extra:
        if t.shape != v.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match v "
                             f"{tuple(v.shape)}")
    if any(t.data_ptr() % 16 for t in (r, k, v, w, *(t for _n, t in extra))):
        raise ValueError("r/k/v/w must start 16-byte aligned (the kernels "
                         "copy 16-byte pieces)")
    return B, T, H


def rwkv_wkv_bwd_cuda(r, k, v, w, u, dout):
    """The backward of :func:`rwkv_wkv_cuda` for a zero cotangent of the
    final state, one launch (the chunked backward on clusters of four CTAs
    a head, then the sum of du over b).  r/k/v/w/dout: (B, T, H, 64), u:
    (H, 64), float32 CUDA, contiguous and 16-byte aligned -> (dr, dk, dv,
    dw (B, T, H, 64), du (H, 64)).  Takes B * H * ceil(T / 16) * 16 KB of
    scratch for the states at chunk starts, which the kernel's first pass
    writes and its second reads."""
    B, T, H = _check_inputs(r, k, v, w, u, (("dout", dout),))
    grads = [torch.empty_like(r) for _ in range(4)]
    du = torch.empty_like(u)
    if B * H == 0:
        return (*grads, du.zero_())
    ckpt = torch.empty((B * H * max(-(-T // BWD_CHUNK), 1), HEAD, HEAD),
                       device=r.device)
    du_part = torch.empty((B, H, HEAD), device=r.device)
    rc = _bwd_kernel()(*(_build.ptr(t) for t in (r, k, v, w, u, dout, ckpt,
                                                 du_part, *grads, du)),
                       B, T, H, HEAD, HEAD, _build.stream_of(r))
    _build.check(rc, BWD_NAME)
    _build.launches[BWD_NAME] += 1
    return (*grads, du)


def rwkv_wkv_cuda(r, k, v, w, u):
    """The WKV recurrence from the zero state, one launch of the chunked
    kernel.  r/k/w: (B, T, H, 64), v: (B, T, H, 64), u: (H, 64), float32
    CUDA, contiguous and 16-byte aligned ->
    (out (B, T, H, 64), final state (B, H, 64, 64))."""
    B, T, H = _check_inputs(r, k, v, w, u)
    out = torch.empty_like(v)
    state = torch.empty((B, H, HEAD, HEAD), device=r.device)
    if B * H == 0:
        return out, state
    rc = _kernel()(_build.ptr(r), _build.ptr(k), _build.ptr(v), _build.ptr(w),
                   _build.ptr(u), _build.ptr(out), _build.ptr(state), B, T, H,
                   HEAD, HEAD, _build.stream_of(r))
    _build.check(rc, NAME)
    _build.launches[NAME] += 1
    return out, state
