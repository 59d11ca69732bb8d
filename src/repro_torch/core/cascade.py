"""Progressive filtering cascades (paper §III, Fig. 2 & 4b).

The port of the JAX package's ``core/cascade.py``: a masked cascade (the
oracle: every stage on every item) and a compacting cascade (after each
stage, survivors move stably to the front and the next stage runs on a
capacity-bounded prefix; survivors beyond capacity are dropped and
counted).  Capacities keep shapes fixed from batch to batch, so a
calibrated funnel launches the same kernels at the same sizes every time.

Items come as ``(rows, batch, ...)``: every row is an independent cascade
(the reference vmaps over frames; here the frames are the rows of one
batched launch per stage).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Stage:
    """One cascade stage.

    fn:        items (rows, batch, ...) -> scores (rows, batch) float.
               Items with score >= threshold survive.
    threshold: survival threshold.
    name:      for reporting.
    """

    fn: Callable
    threshold: float
    name: str = "stage"


@dataclasses.dataclass
class CascadeResult:
    mask: torch.Tensor          # (rows, batch) bool — survived every stage
    scores: torch.Tensor        # (rows, n_stages, batch) raw scores (-inf if dead)
    n_survivors: torch.Tensor   # (rows, n_stages) int32 survivor counts
    dropped: torch.Tensor       # (rows, n_stages) int32 capacity drops


def masked_cascade(stages: Sequence[Stage],
                   items: torch.Tensor) -> CascadeResult:
    """Exact cascade semantics via masking; every stage on every item of
    ``items`` (rows, batch, ...)."""
    R, batch = items.shape[:2]
    mask = torch.ones((R, batch), dtype=torch.bool, device=items.device)
    all_scores, counts = [], []
    for st in stages:
        scores = st.fn(items)
        scores = torch.where(mask, scores, torch.full_like(scores, -math.inf))
        mask = mask & (scores >= st.threshold)
        all_scores.append(scores)
        counts.append(mask.sum(dim=1).to(torch.int32))
    return CascadeResult(
        mask=mask, scores=torch.stack(all_scores, dim=1),
        n_survivors=torch.stack(counts, dim=1),
        dropped=torch.zeros((R, len(stages)), dtype=torch.int32,
                            device=items.device))


def _compact(items: torch.Tensor, mask: torch.Tensor, capacity: int):
    """Stable-move survivors to the front of each row; return (compacted,
    perm, kept_mask), each cut to ``capacity``.  Non-survivors fill the
    tail and stay masked off."""
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    perm = order[:, :capacity]
    idx = perm.reshape(perm.shape + (1,) * (items.dim() - 2))
    compacted = torch.gather(items, 1, idx.expand(
        perm.shape + tuple(items.shape[2:])))
    return compacted, perm, torch.gather(mask, 1, perm)


def compacting_cascade(stages: Sequence[Stage], items: torch.Tensor,
                       capacities: Sequence[int]) -> CascadeResult:
    """Cascade with survivor compaction to fixed-size batches.

    ``items`` is (rows, batch, ...); ``capacities[i]`` bounds the items
    stage ``i`` processes per row, and ``capacities[0]`` must equal the
    batch.  Masks and scores come back in the original index space."""
    if len(capacities) != len(stages):
        raise ValueError("need one capacity per stage")
    R, batch = items.shape[:2]
    if capacities[0] != batch:
        raise ValueError("capacities[0] must equal the input batch")
    dev = items.device
    cur_items = items
    cur_idx = torch.arange(batch, device=dev).expand(R, batch)
    cur_mask = torch.ones((R, batch), dtype=torch.bool, device=dev)
    full_mask = cur_mask
    all_scores, counts, drops = [], [], []
    for i, st in enumerate(stages):
        cap = capacities[i]
        if cur_items.shape[1] != cap:
            n_live = cur_mask.sum(dim=1)
            dropped = (n_live - cap).clamp(min=0).to(torch.int32)
            cur_items, perm, cur_mask = _compact(cur_items, cur_mask, cap)
            cur_idx = torch.gather(cur_idx, 1, perm)
        else:
            dropped = torch.zeros((R,), dtype=torch.int32, device=dev)
        scores = st.fn(cur_items)
        scores = torch.where(cur_mask, scores,
                             torch.full_like(scores, -math.inf))
        cur_mask = cur_mask & (scores >= st.threshold)
        # back to the original index space; items dropped by capacity are
        # no longer carried and read back as dead
        full_scores = torch.full((R, batch), -math.inf, dtype=scores.dtype,
                                 device=dev).scatter(1, cur_idx, scores)
        full_mask = torch.zeros((R, batch), dtype=torch.bool,
                                device=dev).scatter(1, cur_idx, cur_mask)
        all_scores.append(full_scores)
        counts.append(cur_mask.sum(dim=1).to(torch.int32))
        drops.append(dropped)
    return CascadeResult(
        mask=full_mask, scores=torch.stack(all_scores, dim=1),
        n_survivors=torch.stack(counts, dim=1),
        dropped=torch.stack(drops, dim=1))


def capacities_from_counts(batch: int, survivor_counts: Sequence[int],
                           margin: float = 1.5, quantum: int = 128) -> list:
    """Compacting capacities from *measured* per-stage survivor counts:
    stage ``i + 1`` bounds the survivors of stage ``i`` times ``margin``,
    rounded up to ``quantum``.  Stage 0 always gets the full batch."""
    caps = [int(batch)]
    for c in list(survivor_counts)[:-1]:
        cap = (int(math.ceil(float(c) * margin)) // quantum + 1) * quantum
        caps.append(int(min(batch, max(quantum, cap))))
    return caps


def compaction_work(stage_costs: Sequence[float], batch: int,
                    capacities: Sequence[int] | None = None) -> tuple:
    """(masked_total, compacted_total) unit-work for one cascade pass."""
    masked = float(batch) * float(sum(stage_costs))
    if capacities is None:
        return masked, masked
    compacted = float(sum(float(c) * float(f)
                          for c, f in zip(capacities, stage_costs)))
    return masked, compacted


def cascade_flops(stage_flops: Sequence[float], selectivities: Sequence[float],
                  capacities: Sequence[float] | None = None) -> float:
    """Expected per-item FLOPs of a cascade: stage i costs
    ``stage_flops[i] * prod(selectivities[:i])``, clipped by capacities
    when given."""
    total = 0.0
    frac = 1.0
    for i, f in enumerate(stage_flops):
        eff = frac
        if capacities is not None:
            eff = min(eff, capacities[i])
        total += f * eff
        frac *= selectivities[i]
    return total
