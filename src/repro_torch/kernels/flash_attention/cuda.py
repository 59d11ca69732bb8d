"""Wrappers of the CUDA flash-attention kernels.

``csrc/flash_attention.cu`` (the forward): one C entry point that launches
the ``wgmma`` + TMA kernel for bf16 and the float32 CUDA-core kernel for
float32, and writes each row's log-sum-exp when asked.  Both are built for
the (query-key width, value width) pairs of ``PAIRS``: (64, 64),
(128, 128) and MLA's (192, 128).
``csrc/flash_attention_bwd.cu`` (its backward): one C entry point that
launches the dq kernel, then the dkdv kernel, for either dtype: the
``wgmma`` + TMA pair for bf16, the 3xTF32 ``mma.sync`` pair for float32,
built for the same pairs (``BWD_PAIRS``), MLA's at tiles of its own."""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NAME = "flash_attention"
BWD_NAME = "flash_attention_bwd"
SOURCE = "src/repro_torch/csrc/flash_attention.cu"
BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel.py:87"
# (d, dv) pairs of q / k and v / o widths that the kernels are built for,
# the forward and the backward alike
PAIRS = ((64, 64), (128, 128), (192, 128))
BWD_PAIRS = PAIRS

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_bwd_fn = None
_scratch_fn = None


def _kernel():
    global _fn
    if _fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.bind("repro_flash_attention",
                          [p, p, p, p, p, i, i, i, i, i, i, i, i,
                           ctypes.c_float, i, p])
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _bwd_fn = _build.bind("repro_flash_attention_bwd",
                              [p] * 10 + [i] * 8 + [ctypes.c_float, i, p])
    return _bwd_fn


def _scratch_floats(b, H, s):
    """The floats of the scratch the backward's C call needs, as the C
    library reports them."""
    global _scratch_fn
    if _scratch_fn is None:
        i = ctypes.c_int
        _scratch_fn = _build.bind("repro_flash_attention_bwd_scratch",
                                  [i, i, i], ctypes.c_longlong)
    return _scratch_fn(b, H, s)


def _check_inputs(q, k, v, window, extra=()):
    """The checks both wrappers make, the shapes first; returns (b, s, H,
    d, dv, t, KV)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4:
            raise ValueError(f"{name} must have 4 dims, got "
                             f"{tuple(x.shape)}")
    b, s, H, d = q.shape
    t, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape != (b, t, KV, d) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv "
                         "heads")
    if (d, dv) not in PAIRS:
        raise ValueError(f"head sizes (d {d}, dv {dv}) not built; have "
                         f"{PAIRS}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("the flash-attention kernels need CUDA tensors")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q has dtype {q.dtype}; the kernels take bf16 or "
                        "float32")
    for name, x in (("q", q), ("k", k), ("v", v), *extra):
        _build.require(x, name, q.dtype, 4, dev)
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return b, s, H, d, dv, t, KV


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window=None, scale=None, return_lse=False):
    """Causal attention, one launch.  q: (b, s, H, d), k: (b, t, KV, d),
    v: (b, t, KV, dv) CUDA, bf16 or float32, KV | H, (d, dv) in ``PAIRS``
    -> (b, s, H, dv) in q's dtype; with ``return_lse`` also each row's
    log-sum-exp of its scaled logits, (b, H, s) float32, which the
    backward reads (the output is the same bits either way)."""
    b, s, H, d, dv, t, KV = _check_inputs(q, k, v, window)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    o = q.new_empty((b, s, H, dv))
    lse = (torch.empty((b, H, s), device=q.device, dtype=torch.float32)
           if return_lse else None)
    if o.numel() == 0 or t == 0:
        o.zero_()
        return (o, lse.fill_(-math.inf)) if return_lse else o
    rc = _kernel()(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
                   None if lse is None else _build.ptr(lse),
                   _DTYPE_CODE[q.dtype], b, s, t, H, KV, d, dv,
                   ctypes.c_float(scale), 0 if window is None else window,
                   _build.stream_of(q))
    _build.check(rc, NAME)
    _build.launches[NAME] += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd_cuda(q, k, v, o, dout, lse, *, window=None,
                             scale=None):
    """The backward of :func:`flash_attention_cuda`, one launch of the
    dq and dkdv kernels.  q: (b, s, H, d), k: (b, t, KV, d), v: (b, t, KV,
    dv), o, dout: (b, s, H, dv), all CUDA in one dtype (bf16 or float32),
    lse: (b, H, s) float32 from the forward -> (dq, dk, dv) in q's dtype.
    Built for ``BWD_PAIRS``: any other (d, dv) raises a ``ValueError``."""
    if q.dim() == 4 and v.dim() == 4:       # before the device: o has v's width
        want = (*q.shape[:3], v.shape[3])
        if o.shape != want or dout.shape != want:
            raise ValueError(f"o {tuple(o.shape)} / dout {tuple(dout.shape)} "
                             f"do not match {want}")
    b, s, H, d, dv_, t, KV = _check_inputs(q, k, v, window,
                                           (("o", o), ("dout", dout)))
    _build.require(lse, "lse", torch.float32, 3, q.device)
    if lse.shape != (b, H, s):
        raise ValueError(f"lse {tuple(lse.shape)}, expected {(b, H, s)}")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or t == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    scratch = torch.empty(_scratch_floats(b, H, s), device=q.device,
                          dtype=torch.float32)
    rc = _bwd_kernel()(*(_build.ptr(x) for x in (q, k, v, o, dout, lse,
                                                  scratch, dq, dk, dv)),
                       _DTYPE_CODE[q.dtype], b, s, t, H, KV, d, dv_,
                       ctypes.c_float(scale), 0 if window is None else window,
                       _build.stream_of(q))
    _build.check(rc, BWD_NAME)
    _build.launches[BWD_NAME] += 1
    return dq, dk, dv
