"""Plain PyTorch version of the int8 GEMM kernel: exact integer product,
then the reference's epilogue step for step (``csrc/quant_matmul.cu``).

There is no int32 matmul on CUDA, so the product runs in float64, which is
exact here: every partial sum is an integer of magnitude at most
k * 127^2, far below 2^53.
"""

from __future__ import annotations

import numpy as np
import torch


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
