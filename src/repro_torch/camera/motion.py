"""Motion detection — the funnel's first data-reduction block (paper §II-A):
mean absolute frame difference on a coarse grid, thresholded.  The port
of the JAX package's ``camera/motion.py``."""

from __future__ import annotations

import torch

from repro_torch.device import as_tensor


def downsample(frame: torch.Tensor, factor: int = 8) -> torch.Tensor:
    h, w = frame.shape[-2:]
    h2, w2 = h // factor * factor, w // factor * factor
    f = frame[..., :h2, :w2]
    f = f.reshape(*f.shape[:-2], h2 // factor, factor, w2 // factor, factor)
    return f.mean(dim=(-3, -1))


def motion_score(prev: torch.Tensor, cur: torch.Tensor,
                 factor: int = 8) -> torch.Tensor:
    """Mean |delta| on a coarse grid; one score per frame (batched over
    leading dims)."""
    dp = downsample(prev, factor)
    dc = downsample(cur, factor)
    return (dc - dp).abs().mean(dim=(-2, -1))


def motion_mask(frames, threshold: float = 0.01, factor: int = 8, *,
                device=None):
    """frames: (n, h, w).  Returns ((n,) bool passed motion detection,
    (n-1,) scores).  Frame 0 never passes (no reference)."""
    frames = as_tensor(frames, device, torch.float32)
    scores = motion_score(frames[:-1], frames[1:], factor)
    first = torch.zeros((1,), dtype=torch.bool, device=frames.device)
    return torch.cat([first, scores > threshold]), scores
