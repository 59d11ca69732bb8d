"""Batched integral image with the camera zero-pad convention.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version; there is no fallback between them.
"""

from __future__ import annotations

import torch

from repro_torch.device import as_tensor
from repro_torch.kernels.integral_image.cuda import integral_image_cuda
from repro_torch.kernels.integral_image.ref import integral_image_ref


def integral_image(img, *, device=None) -> torch.Tensor:
    """img: (..., h, w) -> (..., h+1, w+1) f32, ii[..., 0, :] = ii[..., :, 0] = 0.

    A tensor stays on its device; anything else goes to ``device``
    (the card when None)."""
    img = as_tensor(img, device).to(torch.float32)
    lead = img.shape[:-2]
    h, w = img.shape[-2:]
    flat = img.reshape(-1, h, w).contiguous()
    if flat.device.type == "cuda":
        ii = integral_image_cuda(flat)
    else:
        ii = integral_image_ref(flat)
    return ii.reshape(*lead, h + 1, w + 1)
