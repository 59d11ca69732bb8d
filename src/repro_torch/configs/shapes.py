"""The LM entries of the JAX package's ``configs/shapes.py``: the assigned
input-shape sets and the two sequence kernels' cases."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq: int
    batch: int
    mode: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

KERNEL_SHAPES = {
    "flash_attention": [
        {"case": "train_4k", "bh": 8, "s": 4096, "d": 128,
         "block_q": 256, "block_k": 256},
        {"case": "prefill_32k", "bh": 8, "s": 32_768, "d": 128,
         "block_q": 256, "block_k": 256},
    ],
    "rwkv_scan": [
        {"case": "train_4k", "bh": 8, "T": 4096, "K": 64, "V": 64,
         "chunk": 32},
    ],
}
