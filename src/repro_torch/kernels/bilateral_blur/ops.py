"""``n_iters`` steps of the bilateral-grid blur (the BSSA refinement loop
the paper's FPGA accelerates).

A CUDA tensor goes to the hand-written kernel (one launch for up to 8
steps of both grids and every pair: one launch per refinement at the
rig's ``n_iters = 8``), a CPU tensor to the plain version, one step at a
time; there is no fallback between them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bilateral_blur.cuda import bilateral_blur_cuda
from repro_torch.kernels.bilateral_blur.ref import blur_ref


def refine_grid(val: torch.Tensor, wt: torch.Tensor, n_iters: int = 8):
    """val/wt: (..., gy, gx, gr) f32 -> the pair after ``n_iters`` blur
    steps (the contract of ``camera.bssa.refine``)."""
    if val.shape != wt.shape:
        raise ValueError(f"val {tuple(val.shape)} != wt {tuple(wt.shape)}")
    shape = val.shape
    val = val.to(torch.float32).reshape(-1, *shape[-3:]).contiguous()
    wt = wt.to(torch.float32).reshape(-1, *shape[-3:]).contiguous()
    if val.device.type == "cuda":
        val, wt = bilateral_blur_cuda(val, wt, n_iters)
    else:
        for _ in range(n_iters):
            val, wt = blur_ref(val, wt)
    return val.reshape(shape), wt.reshape(shape)
