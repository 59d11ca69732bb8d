"""Device selection: the card by default, the CPU only when asked for."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card raises —
    the port never falls back to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path")
    return device


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """A tensor keeps its device unless ``device`` is given; anything else
    (numpy arrays, lists) goes to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor) and device is None:
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


def to_numpy(a) -> np.ndarray:
    """A host numpy copy of a tensor (any device) or array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
