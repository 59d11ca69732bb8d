"""Wrapper of the CUDA int8 GEMM kernel (``csrc/quant_matmul.cu``)."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

NAME = "quant_matmul"
SOURCE = "src/repro_torch/csrc/quant_matmul.cu"
REPLACES = "src/repro/kernels/quant_matmul/kernel.py:55"

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _fn = _build.bind("repro_quant_matmul",
                          [p, p, p, p, i, i, i, i, f, i, f, f, p, p])
    return _fn


def quant_matmul_cuda(x_q, w_q, lut, *, scale: float, bias=None,
                      apply_lut: bool = True, lut_lo: float = -8.0,
                      lut_hi: float = 8.0) -> torch.Tensor:
    """Argument contract of ``ref.quant_matmul_ref``, on one CUDA device."""
    dev = x_q.device
    if dev.type != "cuda":
        raise ValueError("quant_matmul_cuda needs CUDA tensors")
    _build.require(x_q, "x_q", torch.int8, 2, dev)
    _build.require(w_q, "w_q", torch.int8, 2, dev)
    _build.require(lut, "lut", torch.float32, 1, dev)
    m, k = x_q.shape
    if w_q.shape[0] != k:
        raise ValueError(f"x_q {tuple(x_q.shape)} and w_q "
                         f"{tuple(w_q.shape)} do not chain")
    n = w_q.shape[1]
    if bias is not None:
        _build.require(bias, "bias", torch.float32, 1, dev)
        if bias.shape[0] != n:
            raise ValueError(f"bias has {bias.shape[0]} entries, need {n}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    rc = _kernel()(
        _build.ptr(x_q), _build.ptr(w_q),
        None if bias is None else _build.ptr(bias), _build.ptr(lut),
        lut.shape[0], m, k, n, float(np.float32(scale)), int(apply_lut),
        float(np.float32(lut_lo)), float(np.float32(lut_hi - lut_lo)),
        _build.ptr(out), _build.stream_of(x_q))
    _build.check(rc, NAME)
    _build.launches[NAME] += 1
    return out
