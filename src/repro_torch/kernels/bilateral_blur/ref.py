"""Plain PyTorch version of the bilateral-grid blur kernel.

:func:`blur_121` is the separable [1,2,1]/4 blur of the JAX package's
``camera/bssa.py`` (``blur_121``) over the last three axes (gy, gx, gr),
in that order, with edge replication; any leading axes are batch axes.
Each axis pass is ``(0.25*lo + 0.5*g) + 0.25*hi`` in float32, the
reference's association.  The products by 0.25 and 0.5 are exact, so an
FMA that XLA may form under ``jit`` gives the same sums: this version, the
CUDA kernel (``csrc/bilateral_blur.cu``) and the reference agree bit for
bit.
"""

from __future__ import annotations

import torch


def _blur_axis(g: torch.Tensor, axis: int) -> torch.Tensor:
    n = g.shape[axis]
    lo = torch.cat([g.narrow(axis, 0, 1), g.narrow(axis, 0, n - 1)], axis)
    hi = torch.cat([g.narrow(axis, 1, n - 1), g.narrow(axis, n - 1, 1)],
                   axis)
    return (0.25 * lo + 0.5 * g) + 0.25 * hi


def blur_121(grid: torch.Tensor) -> torch.Tensor:
    """(..., gy, gx, gr) f32 -> one [1,2,1]^3 blur step of the grid."""
    for axis in (-3, -2, -1):
        grid = _blur_axis(grid, axis)
    return grid


def blur_ref(val: torch.Tensor, wt: torch.Tensor):
    """One blur step of the value and the weight grid."""
    return blur_121(val), blur_121(wt)
