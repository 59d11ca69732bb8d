"""Plain PyTorch version of the integral-image kernel.

Same association as ``csrc/integral_image.cu``: a sequential float32
prefix along each row, then a sequential prefix down each column, so the
kernel and this version agree exactly on one card.  ``torch.cumsum`` is
not used: on the CPU it accumulates float32 in float64, and on CUDA it
scans in another order.
"""

from __future__ import annotations

import torch


def integral_image_ref(img: torch.Tensor) -> torch.Tensor:
    """(n, h, w) f32 -> (n, h+1, w+1) f32 with a zero top row and left
    column: out[:, i, j] = sum(img[:, :i, :j])."""
    n, h, w = img.shape
    out = img.new_zeros((n, h + 1, w + 1), dtype=torch.float32)
    body = out[:, 1:, 1:]
    body.copy_(img)
    for j in range(1, w):
        body[:, :, j] += body[:, :, j - 1]
    for i in range(1, h):
        body[:, i, :] += body[:, i - 1, :]
    return out
