"""Integral image (summed-area table) and the window-sum helpers.

The port of the JAX package's ``camera/integral.py``.  There the jnp
cumsum is the oracle and a Pallas kernel the TPU path; here
:func:`frame_integral` is the integral-image kernel's entry point (the
hand-written CUDA kernel on a card, its plain version on the CPU), and
:func:`integral_image` is ``torch.cumsum`` for small host-side uses.
"""

from __future__ import annotations

import torch

from repro_torch.device import as_tensor
from repro_torch.kernels.integral_image.ops import integral_image as _kernel


def integral_image(img) -> torch.Tensor:
    """(..., h, w) -> summed-area table, zero-padded at top/left:
    ii[..., i, j] = sum(img[..., :i, :j]), shape (..., h+1, w+1)."""
    img = as_tensor(img)
    ii = torch.cumsum(torch.cumsum(img, dim=-2), dim=-1)
    return torch.nn.functional.pad(ii, (1, 0, 1, 0))


def window_sum(ii: torch.Tensor, y0, x0, h, w) -> torch.Tensor:
    """Rectangle sum via 4 corner lookups.  y0/x0 may be tensors (broadcast)."""
    return (ii[..., y0 + h, x0 + w] - ii[..., y0, x0 + w]
            - ii[..., y0 + h, x0] + ii[..., y0, x0])


def frame_integral(img, *, device=None) -> torch.Tensor:
    """Frame-level integral, (..., h, w) -> (..., h+1, w+1), through the
    integral-image kernel (one launch for the whole batch on a card)."""
    return _kernel(img, device=device)


def streaming_integral_rows(img) -> torch.Tensor:
    """Row-at-a-time formulation of the paper's hardware unit: the carry
    is the last completed integral row; each pixel row is prefix-summed
    and added to it."""
    img = as_tensor(img)
    h, w = img.shape[-2:]
    last = img.new_zeros(img.shape[:-2] + (w,))
    rows = []
    for i in range(h):
        last = torch.cumsum(img[..., i, :], dim=-1) + last
        rows.append(last)
    ii = torch.stack(rows, dim=-2)
    return torch.nn.functional.pad(ii, (1, 0, 1, 0))
