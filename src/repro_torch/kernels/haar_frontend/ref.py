"""Plain PyTorch version of the Haar-stage kernel.

One cascade stage over compacted window items, batched over frames, with
the kernel's arithmetic step for step: taps summed in slot order, stumps
summed in stump order, no fused multiply-add (``csrc/haar_stage.cu``).
The JAX package's ``haar_stage_scores_ref`` sums the same terms with XLA
reductions, so the two agree exactly where XLA also sums in order (fewer
than 32 stumps on the CPU) and to float32 rounding otherwise.
"""

from __future__ import annotations

import torch


def _clamp_index(v: torch.Tensor, top: int) -> torch.Tensor:
    # fmax/fmin as the kernel's fmaxf/fminf: a NaN lands on 0
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    return v.fmax(zero).fmin(zero + top).to(torch.int64)


def item_indices(items: torch.Tensor, L: int, n_scales: int):
    """(base, sid) int64 from the float item triple, clamped in float
    before the cast (the JAX package's viola_jones.py:586-589)."""
    return (_clamp_index(items[..., 0], L - 1),
            _clamp_index(items[..., 1], n_scales - 1))


def _sign(d: torch.Tensor) -> torch.Tensor:
    # jnp.sign: NaN stays NaN (torch.sign maps it to 0)
    one = torch.ones_like(d)
    return torch.where(d > 0, one, torch.where(d < 0, -one, d))


def haar_stage_ref(ii: torch.Tensor, items: torch.Tensor,
                   offsets: torch.Tensor, weights: torch.Tensor,
                   thresholds: torch.Tensor, polarity: torch.Tensor,
                   alphas: torch.Tensor) -> torch.Tensor:
    """Stage score per item.

    ii:        (rows, L) flattened zero-padded frame integral images.
    items:     (rows, cap, 3) f32 (window base, scale id, 1 / (sd * area)).
    offsets:   (n_scales, sz, K) int corner taps per scale.
    weights:   (sz, K) f32 corner weights (0 in padded slots).
    thresholds, polarity, alphas: (sz,) f32 decision-stump parameters.

    Returns (rows, cap) f32, the AdaBoost stage score.
    """
    rows, L = ii.shape
    n_scales, sz, K = offsets.shape
    base, sid = item_indices(items, L, n_scales)
    inv = items[..., 2]
    score = torch.zeros_like(inv)
    for k in range(sz):
        resp = torch.zeros_like(inv)
        for c in range(K):
            idx = (base + offsets[:, k, c].to(torch.int64)[sid]).clamp(0, L - 1)
            resp = resp + torch.gather(ii, 1, idx) * weights[k, c]
        resp = resp * inv
        vote = polarity[k] * _sign(resp - thresholds[k])
        vote = torch.where(vote == 0, torch.ones_like(vote), vote)
        score = score + vote * alphas[k]
    return score
