"""Quantization primitives of the JAX package's ``core/reduction.py``.

Only what the face-auth NN needs so far: :func:`quantize_bits`.

Division by a constant follows the reference as XLA compiles it: inside
``jit`` (where the reference's executor runs) XLA rewrites ``x / c`` for a
compile-time constant ``c`` into ``x * float32(1 / float32(c))``, which can
round a tie the other way than a true division.  :func:`div_const` is that
rewrite, and every place where the reference divides by a Python number
uses it, so the port gives the executor's bits.
"""

from __future__ import annotations

import numpy as np
import torch


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c``, computed as XLA computes it under
    ``jit``: a float32 multiply by the float32 reciprocal of ``c``."""
    return x * float(np.float32(1.0) / np.float32(c))


def quantize_bits(x: torch.Tensor, bits: int, block: int = 256) -> torch.Tensor:
    """General b-bit symmetric fake-quantizer, per flat block of ``block``."""
    qmax = 2 ** (bits - 1) - 1
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = div_const(blocks.abs().amax(dim=1, keepdim=True), qmax)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round(blocks / scale).clamp(-qmax, qmax)
    deq = (q * scale).reshape(-1)[:n].reshape(x.shape)
    return deq.to(x.dtype)
