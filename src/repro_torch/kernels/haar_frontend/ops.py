"""Device dispatch for one Haar cascade stage: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to the plain version."""

from __future__ import annotations

import torch

from repro_torch.device import as_tensor
from repro_torch.kernels.haar_frontend.cuda import haar_stage_cuda
from repro_torch.kernels.haar_frontend.ref import haar_stage_ref


def haar_stage_scores(ii, items, offsets, weights, thresholds, polarity,
                      alphas, *, device=None) -> torch.Tensor:
    """One cascade stage's AdaBoost scores, (rows, cap) f32.  See
    ``ref.haar_stage_ref`` for the argument contract.  A tensor ``ii``
    keeps its device; anything else goes to ``device`` (the card when
    None), and every other argument follows ``ii``."""
    ii = as_tensor(ii, device, torch.float32).contiguous()
    dev = ii.device

    def on(t, dtype):
        return torch.as_tensor(t, dtype=dtype, device=dev).contiguous()

    args = (ii, on(items, torch.float32), on(offsets, torch.int32),
            on(weights, torch.float32), on(thresholds, torch.float32),
            on(polarity, torch.float32), on(alphas, torch.float32))
    if dev.type == "cuda":
        return haar_stage_cuda(*args)
    return haar_stage_ref(*args)
