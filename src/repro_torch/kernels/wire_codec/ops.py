"""Wire-codec entry points and wire-size accounting (paper §III-A).

The codec turns a cut-point payload tensor into what crosses the offload
link: block-scaled intN bytes plus one f32 scale per block.  An int8 wire
payload dequantizes to exactly
``dequantize_int8(*quantize_int8(x))`` (``core.reduction``).

A CUDA tensor goes to the hand-written kernels at 4, 8 and 16 bits, a CPU
tensor to the plain version; there is no fallback between them.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.reduction import div_const, flat_blocks
from repro_torch.device import as_tensor
from repro_torch.kernels.wire_codec.cuda import (
    wire_decode_cuda,
    wire_encode_cuda,
)
from repro_torch.kernels.wire_codec.ref import (
    wire_decode_ref,
    wire_encode_ref,
)

BLOCK = 256                      # default flat block (quantize_int8's)
SCALE_BYTES = 4                  # one f32 scale per block


def wire_encode(x, *, bits: int = 8, block: int = BLOCK, device=None):
    """Payload tensor (any shape, f32-castable) -> (packed, scales).

    packed: (n_blocks, block * bits // 8) int8 wire bytes.
    scales: (n_blocks, 1) f32, one per flat block of ``block`` values.
    A tensor stays on its device; anything else goes to ``device`` (the
    card when None).
    """
    blocks = flat_blocks(as_tensor(x, device).to(torch.float32),
                         block).contiguous()
    if blocks.device.type == "cuda":
        return wire_encode_cuda(blocks, bits)
    return wire_encode_ref(blocks, bits=bits)


def wire_decode(packed, scales, shape, *, bits: int = 8,
                block: int = BLOCK) -> torch.Tensor:
    """(packed, scales) -> f32 tensor of ``shape`` on their device."""
    if packed.device.type == "cuda":
        blocks = wire_decode_cuda(packed.contiguous(), scales.contiguous(),
                                  bits)
    else:
        blocks = wire_decode_ref(packed, scales, bits=bits)
    return blocks.reshape(-1)[:math.prod(shape)].reshape(shape)


def wire_roundtrip(x, *, bits: int = 8, block: int = BLOCK, device=None):
    """encode-then-decode — the codec's end-to-end distortion operator."""
    x = as_tensor(x, device)
    packed, scales = wire_encode(x, bits=bits, block=block)
    return wire_decode(packed, scales, tuple(x.shape), bits=bits,
                       block=block)


# ---------------------------------------------------------------------------
# Wire-size accounting
# ---------------------------------------------------------------------------


def wire_bytes(n_values: int, bits: int | None, *, block: int = BLOCK,
               value_bytes: float = 4.0) -> float:
    """Wire bytes for ``n_values`` payload values at ``bits`` width.

    ``bits=None`` means raw passthrough at ``value_bytes`` per value (f32
    runtime representation = 4).  Quantized payloads pay bits/8 per value
    plus one f32 scale per (partial) block.
    """
    if n_values <= 0:
        return 0.0
    if bits is None:
        return float(n_values) * value_bytes
    return (n_values * bits / 8.0
            + math.ceil(n_values / block) * SCALE_BYTES)


def wire_bytes_dynamic(n_values: torch.Tensor, bits: int | None, *,
                       block: int = BLOCK,
                       value_bytes: float = 4.0) -> torch.Tensor:
    """``wire_bytes`` of a device scalar, in float32 on its device, with
    the JAX package's jitted arithmetic (``n / block`` as a reciprocal
    multiply).  The offload executors charge only valid (non-padding)
    payload elements with it, without a host round trip."""
    n = n_values.clamp(min=0).to(torch.float32)
    if bits is None:
        return n * value_bytes
    return n * (bits / 8.0) + torch.ceil(div_const(n, block)) * SCALE_BYTES
