"""Warm-then-average wall-clock measurement that waits for the card.

PyTorch returns from a CUDA call before the card has done the work, so
:func:`block` synchronises the device of every CUDA tensor in a result —
plain tensors, dataclasses (``WirePayload``, ``FAExecResult``), dicts,
lists and tuples, nested — before the clock is read.  On CPU tensors it
does nothing.
"""

from __future__ import annotations

import dataclasses
import time

import torch


def _cuda_devices(out, found: set):
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        _cuda_devices(vars(out), found)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def block(out):
    """Wait until the work producing every CUDA tensor in ``out`` is done."""
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)


def timed(fn, *args, reps: int = 3):
    """(seconds_per_rep, last_output): one warm call, then ``reps`` timed
    calls, waiting for the device at the end."""
    out = fn(*args)
    block(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    block(out)
    return (time.perf_counter() - t0) / reps, out
