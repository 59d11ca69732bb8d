"""AdamW with a float32 master copy (the JAX package's
``train/optimizer.py`` on one card).

The state mirrors the parameters: a float32 master copy and the two
moments, one tensor per parameter in a dict keyed by name, in the order the
caller gives (the model's ``Model.named_leaves``: the reference's leaf
order).  The arithmetic follows the reference's, in its order, as XLA
compiles it under ``jit``:

* a division by a Python number is a multiply by its float32 reciprocal
  (``core.reduction.div_const``), and XLA folds ``c1 * x / c2`` into
  ``x * (c1 * (1 / c2))``; a division by a traced value (``m / b1c``, the
  clip scale) is a true division by a tensor;
* XLA fuses ``b1 * m + (1 - b1) * g``, the second moment's update and
  the cosine schedule's ``lr_min + c * (1 + cos)`` into FMAs (one
  rounding), and so does the port (:func:`fma`): the moments then equal
  jitted JAX's bit for bit;
* the schedule's cosine is the float64 cosine rounded once (XLA's float32
  cosine is its own polynomial: this form is off by an ulp at 5 of 901
  decay steps, ``torch.cos`` at 24);
* ``b1 ** step`` is the float64 power rounded once to float32: ``1 -`` it
  equals jitted JAX's at every step from 1 to 1000 for b = 0.9 and 0.95,
  where ``torch.pow`` in float32 is an ulp off at some;
* square roots are correctly rounded (``core.reduction.sqrt_rn``:
  PyTorch's float32 root on the CPU is not);
* the update is ``p - lr * (mh / (sqrt(vh) + eps) + wd * p)`` on the
  master copy, then cast to the parameter dtype (not
  ``torch.optim.AdamW``'s order).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.reduction import div_const, sqrt_rn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 200
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor        # scalar int32
    master: dict              # float32 copy of the parameters
    mu: dict                  # first moment, float32
    nu: dict                  # second moment, float32


def init_opt_state(params: dict) -> OptState:
    """Zero moments and a float32 master copy of ``params`` (name ->
    tensor), on the parameters' device."""
    first = next(iter(params.values()))
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        master={n: p.detach().to(torch.float32, copy=True)
                for n, p in params.items()},
        mu={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()},
        nu={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()})


def _f32(x: float) -> float:
    """A Python number as the float32 constant XLA makes of it."""
    return float(np.float32(x))


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` in float32 rounded once, as XLA's fused multiply-add:
    the product of two float32 values is exact in float64, so only the
    float64 sum rounds before the float32 result (the two roundings differ
    from one only within 2^-29 of a float32 tie)."""
    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) else x
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to lr_min, float32."""
    step = step.to(torch.float32)
    warm = step * _f32(np.float32(cfg.lr_peak)
                       * (np.float32(1) / np.float32(max(cfg.warmup_steps,
                                                         1))))
    frac = torch.clamp(div_const(step - cfg.warmup_steps,
                                 max(cfg.decay_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = torch.cos((_f32(math.pi) * frac).double()).to(torch.float32)
    decay = fma(_f32(0.5 * (cfg.lr_peak - cfg.lr_min)), 1 + cos,
                _f32(cfg.lr_min))
    return torch.where(step < cfg.warmup_steps, warm, decay)


def _sum_squares(leaves) -> torch.Tensor:
    total = None
    for g in leaves:
        s = g.to(torch.float32).square().sum()
        total = s if total is None else total + s
    return total


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every leaf, leaves summed in
    the dict's order."""
    return sqrt_rn(_sum_squares(tree.values()))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(_f32(max_norm) / (norm + _f32(1e-9)), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, float32;
    the norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g.to(torch.float32) * scale for n, g in grads.items()}, norm


def bias_correction(b: float, step: torch.Tensor) -> torch.Tensor:
    """1 - b ** step in float32, the power in float64 rounded once."""
    power = torch.pow(torch.tensor(_f32(b), dtype=torch.float64,
                                   device=step.device), step.double())
    return 1 - power.to(torch.float32)


# elements of a leaf's flattened view that one pass of the update takes:
# the float64 FMA emulation's temporaries are then 512 MiB each, where a
# whole (8, 6144, 16384) expert leaf would make ~24 GiB of them at once
SLICE = 1 << 26


def adamw_update(cfg: AdamWConfig, grads: dict, state: OptState,
                 param_dtype=torch.bfloat16, out: dict | None = None):
    """One AdamW step.  Returns (new parameters in ``param_dtype``, new
    state, metrics {"grad_norm", "lr"}); dicts keyed as ``grads``.

    Unlike the reference, which returns new arrays, this updates the
    state's master copy and moments in place and empties ``grads`` as it
    goes, one leaf at a time and each leaf in slices of SLICE elements of
    its flattened view, each operation rounding as the reference's does:
    at full width the old and new states would not both fit on the card,
    nor a large leaf's float64 temporaries.  The update is elementwise
    with the same scalars for every slice, so the slices give the bits of
    the whole-leaf update.  The moments equal jitted JAX's bit for bit;
    the parameters are within an ulp (XLA fuses the update's last
    operations in a way this does not reproduce at about 1 in 400
    entries).  With ``out`` (name -> parameter tensor) the new parameters
    are written into those tensors."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)     # clip_by_global_norm, a
                                                  # leaf at a time below
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = bias_correction(cfg.b1, step)
    b2c = bias_correction(cfg.b2, step)
    b1, b2 = _f32(cfg.b1), _f32(cfg.b2)
    c1, c2 = _f32(1 - cfg.b1), _f32(1 - cfg.b2)
    eps, wd = _f32(cfg.eps), _f32(cfg.weight_decay)

    new_params = {}
    for n in list(grads):
        grad = grads.pop(n).reshape(-1)
        p = state.master[n]
        flat = [t.view(-1) for t in (state.mu[n], state.nu[n], p)]
        dst = None if out is None else out[n].view(-1)
        for i in range(0, grad.numel(), SLICE):
            g = grad[i:i + SLICE].to(torch.float32) * scale
            m, v, ps = (t[i:i + SLICE] for t in flat)
            m.copy_(fma(b1, m, c1 * g))                 # b1 m + (1 - b1) g
            v.copy_(fma(b2, v, c2 * g.square()))        # b2 v + (1 - b2) g^2
            del g
            u = (m / b1c).div_(sqrt_rn(v / b2c).add_(eps))  # mh / (sqrt(vh)
                                                            #      + eps)
            u.add_(wd * ps).mul_(lr)
            ps.sub_(u)                                  # p - lr (u + wd p)
            del u
            if dst is not None:
                dst[i:i + SLICE].copy_(ps)
        del grad
        new_params[n] = p.to(param_dtype) if out is None else out[n]
    new_state = OptState(step=step, master=state.master, mu=state.mu,
                         nu=state.nu)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
