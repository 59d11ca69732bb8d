"""Wrappers of the CUDA wire-codec kernels (``csrc/wire_codec.cu``)."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wire_codec.ref import qmax_of

SOURCE = "src/repro_torch/csrc/wire_codec.cu"
REPLACES = {"wire_encode": "src/repro/kernels/wire_codec/kernel.py:52",
            "wire_decode": "src/repro/kernels/wire_codec/kernel.py:75"}

VEC_BLOCK = 256                  # the payload block of the vector kernels
_ALIGN = 16                      # their 16-byte loads and stores

_fns: dict = {}


def _kernel(name):
    if name not in _fns:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        argtypes = {"repro_wire_encode": [p, p, p, i, i, i, f, f, p],
                    "repro_wire_decode": [p, p, p, i, i, i, i, p]}[name]
        _fns[name] = _build.bind(name, argtypes)
    return _fns[name]


def _check_bits(bits: int, block: int):
    qmax_of(bits)
    if block <= 0 or (bits == 4 and block % 2):
        raise ValueError(f"block {block} cannot be packed at {bits} bits")


def wire_encode_cuda(blocks: torch.Tensor, bits: int):
    """(n_blocks, block) f32 CUDA -> (packed int8 (n_blocks,
    block*bits/8), scales f32 (n_blocks, 1)), one launch."""
    dev = blocks.device
    if dev.type != "cuda":
        raise ValueError("wire_encode_cuda needs a CUDA tensor")
    _build.require(blocks, "blocks", torch.float32, 2, dev)
    nb, block = blocks.shape
    _check_bits(bits, block)
    qmax = qmax_of(bits)
    packed = torch.empty((nb, block * bits // 8), dtype=torch.int8,
                         device=dev)
    scales = torch.empty((nb, 1), dtype=torch.float32, device=dev)
    if nb == 0:
        return packed, scales
    inv_qmax = float(np.float32(1.0) / np.float32(qmax))
    rc = _kernel("repro_wire_encode")(
        _build.ptr(blocks), _build.ptr(packed), _build.ptr(scales), nb,
        block, bits, float(qmax), inv_qmax, _build.stream_of(blocks))
    _build.check(rc, "wire_encode")
    _build.launches["wire_encode"] += 1
    return packed, scales


def decode_route(block: int, packed_ptr: int, out_ptr: int) -> str:
    """Which decode kernel a launch takes: ``"vector"`` (a warp per
    payload block, ``wire_decode_vec_kernel``) for 256-value blocks whose
    packed bytes and output both start on 16 bytes, else ``"scalar"``
    (``wire_decode_kernel``, a thread per packed byte)."""
    aligned = packed_ptr % _ALIGN == 0 and out_ptr % _ALIGN == 0
    return "vector" if block == VEC_BLOCK and aligned else "scalar"


def wire_decode_cuda(packed: torch.Tensor, scales: torch.Tensor,
                     bits: int) -> torch.Tensor:
    """(packed int8, scales f32 (n_blocks, 1)) CUDA -> (n_blocks, block)
    f32, one launch of the kernel ``decode_route`` picks."""
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError("wire_decode_cuda needs CUDA tensors")
    _build.require(packed, "packed", torch.int8, 2, dev)
    _build.require(scales, "scales", torch.float32, 2, dev)
    nb, width = packed.shape
    if tuple(scales.shape) != (nb, 1):
        raise ValueError(f"scales {tuple(scales.shape)} for {nb} blocks")
    qmax_of(bits)
    if (width * 8) % bits:
        raise ValueError(f"{width} bytes do not hold whole {bits}-bit values")
    block = width * 8 // bits
    out = torch.empty((nb, block), dtype=torch.float32, device=dev)
    if nb == 0:
        return out
    vec = decode_route(block, packed.data_ptr(), out.data_ptr()) == "vector"
    rc = _kernel("repro_wire_decode")(
        _build.ptr(packed), _build.ptr(scales), _build.ptr(out), nb, block,
        bits, int(vec), _build.stream_of(packed))
    _build.check(rc, "wire_decode")
    _build.launches["wire_decode"] += 1
    return out
