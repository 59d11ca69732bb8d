"""Wrapper of the CUDA flash-attention kernels (``csrc/flash_attention.cu``):
one C entry point that launches the ``wgmma`` + TMA kernel for bf16 and
the float32 CUDA-core kernel for float32."""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NAME = "flash_attention"
SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel.py:87"
HEAD_DIMS = (64, 128)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.bind("repro_flash_attention",
                          [p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float,
                           i, p])
    return _fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window=None, scale=None) -> torch.Tensor:
    """Causal attention, one launch.  q: (b, s, H, d), k/v: (b, t, KV, d)
    CUDA, bf16 or float32, KV | H, d in ``HEAD_DIMS`` -> (b, s, H, d) in
    q's dtype."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes bf16 or "
                        "float32")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, q.dtype, 4, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, s, H, d = q.shape
    t, KV = k.shape[1], k.shape[2]
    if k.shape != (b, t, KV, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv "
                         "heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} not built; have {HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    o = torch.empty_like(q)
    if o.numel() == 0 or t == 0:
        return o.zero_()
    rc = _kernel()(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
                   _DTYPE_CODE[q.dtype], b, s, t, H, KV, d,
                   ctypes.c_float(scale), 0 if window is None else window,
                   _build.stream_of(q))
    _build.check(rc, NAME)
    _build.launches[NAME] += 1
    return o
