"""Wrapper of the CUDA Haar-stage kernel (``csrc/haar_stage.cu``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "haar_stage"
SOURCE = "src/repro_torch/csrc/haar_stage.cu"
REPLACES = "src/repro/kernels/haar_frontend/kernel.py:49"
CORNER_SLOTS = 8

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.bind("repro_haar_stage",
                          [p, i, p, i, i, p, i, p, p, p, p, i, p, p])
    return _fn


def haar_stage_cuda(ii, items, offsets, weights, thresholds, polarity,
                    alphas) -> torch.Tensor:
    """Argument contract of ``ref.haar_stage_ref``; int32 offsets and f32
    everything else, contiguous, on one CUDA device."""
    dev = ii.device
    if dev.type != "cuda":
        raise ValueError("haar_stage_cuda needs CUDA tensors")
    _build.require(ii, "ii", torch.float32, 2, dev)
    _build.require(items, "items", torch.float32, 3, dev)
    _build.require(offsets, "offsets", torch.int32, 3, dev)
    _build.require(weights, "weights", torch.float32, 2, dev)
    rows, L = ii.shape
    n_scales, sz, K = offsets.shape
    if K != CORNER_SLOTS or tuple(weights.shape) != (sz, K):
        raise ValueError(f"offsets {tuple(offsets.shape)} / weights "
                         f"{tuple(weights.shape)}: need (S, sz, 8) / (sz, 8)")
    for name, t in (("thresholds", thresholds), ("polarity", polarity),
                    ("alphas", alphas)):
        _build.require(t, name, torch.float32, 1, dev)
        if t.shape[0] != sz:
            raise ValueError(f"{name} has {t.shape[0]} entries, need {sz}")
    if items.shape[0] != rows or items.shape[2] != 3:
        raise ValueError(f"items {tuple(items.shape)} do not match ii "
                         f"{tuple(ii.shape)}")
    cap = items.shape[1]
    out = torch.empty((rows, cap), dtype=torch.float32, device=dev)
    if rows == 0 or cap == 0:
        return out
    rc = _kernel()(_build.ptr(ii), L, _build.ptr(items), rows, cap,
                   _build.ptr(offsets), n_scales, _build.ptr(weights),
                   _build.ptr(thresholds), _build.ptr(polarity),
                   _build.ptr(alphas), sz, _build.ptr(out),
                   _build.stream_of(ii))
    _build.check(rc, NAME)
    _build.launches[NAME] += 1
    return out
