"""Quantization primitives of the JAX package's ``core/reduction.py``.

What the face-auth NN, the offload wire codec and AdamW need so far:
:func:`quantize_blocks` and, over it, :func:`quantize_bits`,
:func:`quantize_int8` and :func:`dequantize_int8`
(without the reference's stochastic-rounding ``key``, which comes with
training).

Division by a constant follows the reference as XLA compiles it: inside
``jit`` (where the reference's executor runs) XLA rewrites ``x / c`` for a
compile-time constant ``c`` into ``x * float32(1 / float32(c))``, which can
round a tie the other way than a true division.  :func:`div_const` is that
rewrite, and every place where the reference divides by a Python number
uses it, so the port gives the executor's bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c``, computed as XLA computes it under
    ``jit``: a float32 multiply by the float32 reciprocal of ``c``."""
    return x * float(np.float32(1.0) / np.float32(c))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA computes it.  On
    the card PyTorch's float32 root is correctly rounded; on the CPU it is
    not, so there the float64 root is rounded once."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def flat_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """x flattened and zero-padded to (ceil(n/block), block)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block)


def quantize_blocks(blocks: torch.Tensor, qmax: int):
    """Symmetric absmax quantization of each row of ``blocks``: (q, scales)
    with q rounded half to even and clamped to [-qmax, qmax] (still in the
    input dtype) and scales (n_blocks, 1); an all-zero block gets scale 1.
    The one quantizer of the port: :func:`quantize_int8`,
    :func:`quantize_bits` and the wire codec's plain version call it."""
    scale = div_const(blocks.abs().amax(dim=1, keepdim=True), qmax)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return torch.round(blocks / scale).clamp(-qmax, qmax), scale


def quantize_int8(x: torch.Tensor, block: int = 256):
    """Block-scaled symmetric int8 quantization: (q, scales) with q int8
    of shape (ceil(n/block), block) and scales f32 (ceil(n/block), 1),
    one per flat block; an all-zero block gets scale 1."""
    q, scale = quantize_blocks(flat_blocks(x, block), 127)
    return q.to(torch.int8), scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` back to ``shape``."""
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape).to(dtype)


def quantize_bits(x: torch.Tensor, bits: int, block: int = 256) -> torch.Tensor:
    """General b-bit symmetric fake-quantizer, per flat block of ``block``."""
    q, scale = quantize_blocks(flat_blocks(x, block), 2 ** (bits - 1) - 1)
    deq = (q * scale).reshape(-1)[:x.numel()].reshape(x.shape)
    return deq.to(x.dtype)
