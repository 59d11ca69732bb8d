"""Plain PyTorch versions of the int8 kernels (``csrc/quant_matmul.cu``):
:func:`quant_matmul_ref`, the GEMM (exact integer product, then the
reference's epilogue step for step), and :func:`nn_forward_ref`, the
400-8-1 NN as two GEMMs with the input and hidden quantizers between them
(what the NN kernel does in one launch).

There is no int32 matmul on CUDA, so the product runs in float64, which is
exact here: every partial sum is an integer of magnitude at most
k * 127^2, far below 2^53.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.reduction import div_const


def lut_index(y: torch.Tensor, lo: float, hi: float, entries: int) -> torch.Tensor:
    """Clipped, truncated LUT index of ``y`` (the reference's
    ``(y - lo) / (hi - lo) * (entries - 1)``).  The divisor is a tensor on
    ``y``'s device: PyTorch's CUDA division by a CPU scalar would multiply
    by its reciprocal instead."""
    span = torch.tensor(np.float32(hi - lo), device=y.device)
    t = (y - lo) / span * (entries - 1)
    return t.clamp(0, entries - 1).to(torch.int64)


def quant_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, lut: torch.Tensor,
                     *, scale: float, bias=None, apply_lut: bool = True,
                     lut_lo: float = -8.0, lut_hi: float = 8.0) -> torch.Tensor:
    """(m, k) int8 x (k, n) int8 -> (m, n) f32.

    ``scale`` is the float32 rescale ``f32(scale_x * scale_w)``; ``bias``
    (n,) f32 is added after it, then the LUT is applied when asked."""
    acc = x_q.to(torch.float64) @ w_q.to(torch.float64)
    y = acc.to(torch.float32) * torch.tensor(np.float32(scale),
                                             device=x_q.device)
    if bias is not None:
        y = y + bias.to(torch.float32)[None, :]
    if apply_lut:
        y = lut[lut_index(y, lut_lo, lut_hi, lut.shape[0])]
    return y


def quantize_static(x: torch.Tensor, scale: float, qmax: int) -> torch.Tensor:
    """round(x / scale) clipped to +-qmax, as int8 (``div_const``: the
    reference's jitted division by a constant)."""
    return torch.round(div_const(x, scale)).clamp(-qmax, qmax).to(torch.int8)


def nn_forward_ref(x, w1_q, b1, w2_q, b2, lut, *, scale_x: float,
                   scale_w1: float, scale_h: float, scale_w2: float,
                   qmax: int, lut_lo: float, lut_hi: float) -> torch.Tensor:
    """(m, n_in) f32 -> (m,) f32: quantize x, layer 1 (rescale, bias, LUT),
    requantize h, layer 2 (rescale, bias, LUT), as the JAX package's
    jitted ``nn_forward_quantized``."""
    def layer(h_q, w_q, bias, scale_in, scale_w):
        return quant_matmul_ref(
            h_q, w_q, lut, scale=float(np.float32(scale_in * scale_w)),
            bias=bias, apply_lut=True, lut_lo=lut_lo, lut_hi=lut_hi)

    h = layer(quantize_static(x, scale_x, qmax), w1_q, b1, scale_x, scale_w1)
    y = layer(quantize_static(h, scale_h, qmax), w2_q, b2, scale_h, scale_w2)
    return y[:, 0]
