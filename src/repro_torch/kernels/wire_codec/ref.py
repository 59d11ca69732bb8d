"""Plain PyTorch version of the wire codec: block-scaled quantize and
bit-pack for cut-point payloads.

Quantization is ``core.reduction.quantize_blocks``, as for
``quantize_int8``: flat blocks, symmetric absmax / qmax scale, scale 1 for
an all-zero block, round half to even.  The scale is
``absmax * float32(1/qmax)`` (``div_const``), as the JAX package's jitted
codec computes it; the per-value ``x / scale`` is a true division.
Packing layouts:

  bits=8   one int8 byte per value                  (n_blocks, block)
  bits=4   two values per byte, low nibble first    (n_blocks, block // 2)
  bits=16  little-endian int16 as two int8 bytes    (n_blocks, block * 2)

Scales are f32, one per block: (n_blocks, 1).  ``csrc/wire_codec.cu``
computes the same function and is held bit-equal to this file on the
card.
"""

from __future__ import annotations

import torch

from repro_torch.core.reduction import quantize_blocks


def qmax_of(bits: int) -> int:
    if bits not in (4, 8, 16):
        raise ValueError(f"wire codec supports 4/8/16 bits, got {bits}")
    return 2 ** (bits - 1) - 1


def quantize_blocks_ref(blocks: torch.Tensor, bits: int):
    """(n_blocks, block) f32 -> (q int32, scales f32 (n_blocks, 1))."""
    q, scale = quantize_blocks(blocks, qmax_of(bits))
    return q.to(torch.int32), scale.to(torch.float32)


def pack_ref(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantized int32 values (n_blocks, block) -> packed int8 bytes."""
    nb = q.shape[0]
    if bits == 8:
        return q.to(torch.int8)
    if bits == 4:
        pair = (q & 0xF).reshape(nb, -1, 2)
        return (pair[:, :, 0] | (pair[:, :, 1] << 4)).to(torch.int8)
    lo = q & 0xFF
    hi = (q >> 8) & 0xFF
    return torch.stack([lo, hi], dim=-1).reshape(nb, -1).to(torch.int8)


def unpack_ref(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Packed int8 bytes -> quantized int32 values (n_blocks, block)."""
    nb = packed.shape[0]
    if bits == 8:
        return packed.to(torch.int32)
    p = packed.to(torch.int32) & 0xFF
    if bits == 4:
        lo = p & 0xF
        hi = (p >> 4) & 0xF
        lo = lo - ((lo & 0x8) << 1)          # sign-extend the nibble
        hi = hi - ((hi & 0x8) << 1)
        return torch.stack([lo, hi], dim=-1).reshape(nb, -1)
    b = p.reshape(nb, -1, 2)
    v = b[:, :, 0] | (b[:, :, 1] << 8)
    return v - ((v & 0x8000) << 1)           # sign-extend 16 bits


def wire_encode_ref(blocks: torch.Tensor, *, bits: int = 8):
    """(n_blocks, block) f32 -> (packed int8, scales (n_blocks, 1) f32)."""
    q, scale = quantize_blocks_ref(blocks, bits)
    return pack_ref(q, bits), scale


def wire_decode_ref(packed: torch.Tensor, scales: torch.Tensor, *,
                    bits: int = 8) -> torch.Tensor:
    """(packed, scales) -> (n_blocks, block) f32 dequantized blocks."""
    return unpack_ref(packed, bits).to(torch.float32) * scales
