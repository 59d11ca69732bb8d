"""Offload placement solver (the paper's configuration search, §III-D,
§IV-C) — the port's copy of :func:`solve_cut` from the JAX package's
``core/placement.py``.

The paper hand-enumerates pipeline configurations — which optional blocks
to include and where to cut the pipeline for offload — and evaluates each
with the computation-communication cost model.  :func:`solve_cut` is the
exhaustive optimum over (optional-block subset x cut point) for a linear
pipeline, in either cost regime; the paper's spaces are tiny (<= 2^3 x 5),
so exhaustive search *is* the exact algorithm.

:func:`solve_sharding` is the pod-scale analogue (the same file's
sharding-plan solver): it scores candidate sharding plans for an (arch x
shape x mesh) cell with the three-term roofline model and returns the
argmin.  Candidates are scored analytically (:func:`estimate_plan`), so
plans rank without running anything; its float arithmetic is the
reference's, term by term in the same order.

The unifying view: a sharding plan decides which bytes cross which
interconnect tier, exactly as the cut point decides which bytes cross the
RF link.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Mapping, Sequence

from repro_torch.core.costmodel import (
    HardwareProfile,
    Roofline,
    energy_cost,
    throughput_cost,
)
from repro_torch.core.pipeline import Pipeline


# ---------------------------------------------------------------------------
# Linear-pipeline cut solver (camera regime)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CutSolution:
    pipeline: Pipeline                  # configured pipeline (optionals chosen)
    cut_after: str
    report: object                      # EnergyReport | ThroughputReport
    objective: float                    # watts (energy) or -fps (throughput)
    all_reports: tuple                  # every configuration evaluated


def _cut_candidates(pipeline: Pipeline):
    # A cut is legal after any block except we never cut "before the source".
    return [b.name for b in pipeline.blocks]


def solve_cut(
    pipeline: Pipeline,
    profiles: Mapping[str, HardwareProfile],
    link: HardwareProfile,
    regime: str = "energy",
    unit_rate_hz: float = 1.0,
    duties: Mapping[str, float] | None = None,
    target_fps: float = 30.0,
) -> CutSolution:
    """Exact optimum over optional-block subsets x cut points.

    regime="energy": minimize total watts (paper §III).
    regime="throughput": maximize end-to-end FPS; ties broken toward fewer
    on-node blocks (paper §IV: offload as early as bandwidth allows).
    """
    if regime not in ("energy", "throughput"):
        raise ValueError(regime)

    reports = []
    best = None
    opts = pipeline.optional_names
    for r in range(len(opts) + 1):
        for subset in itertools.combinations(opts, r):
            cfg = pipeline.configure(subset)
            for cut in _cut_candidates(cfg):
                # structural dependencies: every on-node block's `requires`
                # must be satisfied by the included optional set
                cut_i = cfg.index(cut)
                if any(set(b.requires) - set(subset)
                       for b in cfg.blocks[: cut_i + 1]):
                    continue
                name = f"{'+'.join(subset) or 'none'}|cut={cut}"
                if regime == "energy":
                    rep = energy_cost(
                        cfg, profiles, link, cut,
                        unit_rate_hz=unit_rate_hz, duties=duties,
                        config_name=name,
                    )
                    obj = rep.total_w
                else:
                    rep = throughput_cost(cfg, profiles, link, cut, config_name=name)
                    obj = -rep.fps
                reports.append(rep)
                # tie-break toward fewer on-node blocks ("offload as early
                # as bandwidth allows"): the *configured* pipeline's cut
                # index is the on-node block count — the unconfigured
                # index would mis-order configs once optionals are dropped
                key = (obj, cut_i)
                if best is None or key < best[0]:
                    best = (key, cfg, cut, rep)

    _, cfg, cut, rep = best
    return CutSolution(
        pipeline=cfg,
        cut_after=cut,
        report=rep,
        objective=rep.total_w if regime == "energy" else -rep.fps,
        all_reports=tuple(reports),
    )


# ---------------------------------------------------------------------------
# Sharding-plan solver (pod regime)
# ---------------------------------------------------------------------------
#
# A *plan* assigns parallelism ways to mesh axes.  estimate_plan() computes
# the roofline terms of a transformer step under a plan analytically:
# per-layer matmul FLOPs, HBM traffic for weights/activations (with FSDP
# all-gathers), and the collective bytes implied by each parallelism
# choice.  The formulas are standard (Megatron/MaxText-style napkin math):
# they only need to be *relatively* accurate to rank plans.


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """A candidate parallelism assignment for one (arch x shape x mesh)
    cell."""

    name: str
    data: int = 1          # pure data-parallel ways (batch sharding)
    fsdp: int = 1          # ZeRO param/optimizer sharding (over data axis)
    tensor: int = 1        # TP ways (heads / mlp / vocab)
    expert: int = 1        # EP ways (MoE experts)
    sequence: int = 1      # context/sequence parallel ways
    pod: int = 1           # outer DP over pods
    grad_compress: bool = False   # int8 pod-axis gradient all-reduce

    @property
    def n_chips(self) -> int:
        # EP reuses the tensor axis (experts shard over 'model'), so it does
        # not multiply the chip count.
        return self.data * self.fsdp * self.tensor * self.sequence * self.pod

    def describe(self) -> str:
        parts = [f"{k}={v}" for k, v in (
            ("dp", self.data), ("fsdp", self.fsdp), ("tp", self.tensor),
            ("ep", self.expert), ("sp", self.sequence), ("pod", self.pod))
            if v != 1]
        if self.grad_compress:
            parts.append("int8-podAR")
        return f"{self.name}({', '.join(parts) or 'replicated'})"


@dataclasses.dataclass(frozen=True)
class PlanScore:
    plan: ShardingPlan
    roofline: Roofline
    feasible: bool
    why_infeasible: str = ""


def estimate_plan(
    plan: ShardingPlan,
    *,
    name: str,
    params: float,                 # total parameter count
    active_params: float,          # per-token active params (MoE-aware)
    layer_flops: float,            # total fwd FLOPs for the step's tokens
    train: bool,
    tokens: int,                   # tokens in the step (batch*seq)
    d_model: int,
    seq: int,
    batch: int,
    n_experts: int = 1,
    top_k: int = 1,
    n_layers: int = 1,
    dtype_bytes: int = 2,
    hbm_gib: float = 16.0,
) -> PlanScore:
    """Analytic three-term roofline for a plan (the reference's defaults:
    ``Roofline``'s chip and link profiles).

    Standard napkin math:
      fwd flops ~= 2 * active_params * tokens ; train ~= 3x fwd (+remat ~4x).
      HBM bytes ~= params_bytes_resident + activation traffic.
      collectives:
        TP:   2 all-reduces of activations per layer (attn-out + mlp-out),
              ring cost ~ 2*(t-1)/t * bytes each.
        FSDP: all-gather params once per step (+reduce-scatter grads in train).
        DP/pod: all-reduce grads (2x params bytes, /compress factor).
        EP:   2 all-to-alls of top_k-expanded tokens per MoE layer.
        SP:   all-gather of KV (or ring permute) per attn layer.
    """
    chips = plan.n_chips
    why = ""

    mult = 3.0 if train else 1.0
    hlo_flops = layer_flops * mult
    if train:
        hlo_flops *= 4.0 / 3.0  # full remat recompute of fwd

    param_bytes = params * dtype_bytes
    # Parameter residency per chip: sharded by tp * fsdp * ep(expert slice).
    ep_ways = max(plan.expert, 1)
    ep_shard = ep_ways if n_experts > 1 else 1
    shard_ways = (plan.tensor * plan.fsdp * ep_ways if n_experts > 1
                  else plan.tensor * plan.fsdp)
    resident = param_bytes / shard_ways
    # Optimizer state (f32 master + 2 moments) in training, ZeRO-sharded.
    opt_bytes = (params * 12 / (plan.fsdp * plan.tensor * ep_shard) if train
                 else 0.0)
    data_ways = plan.data * plan.fsdp * plan.pod * plan.sequence
    act_bytes = tokens * d_model * dtype_bytes * n_layers / data_ways
    if train:
        act_bytes *= 2  # saved boundary activations (full remat in layers)
    per_chip_hbm = resident + opt_bytes + act_bytes
    feasible = per_chip_hbm < hbm_gib * 2**30
    if not feasible:
        why = f"per-chip HBM {per_chip_hbm/2**30:.1f} GiB > {hbm_gib} GiB"

    # HBM traffic: read params (x2 for train: grads write), activations stream.
    hbm_traffic = ((param_bytes / (plan.tensor * ep_shard))
                   * (4 if train else 1))
    hbm_traffic += act_bytes * (8 if train else 2)
    # global = per-chip * chips over the data-like axes
    hbm_global = hbm_traffic * max(data_ways, 1)

    # Collectives (global bytes on the wire).
    coll = 0.0
    tok_local = tokens / data_ways
    act_layer = tok_local * d_model * dtype_bytes
    t = plan.tensor
    if t > 1:
        coll += (n_layers * 2 * 2 * (t - 1) / t * act_layer * chips / t
                 * (3 if train else 1))
    f = plan.fsdp
    if f > 1:
        # all-gather forward (+ backward), reduce-scatter of the gradients
        coll += (param_bytes / plan.tensor * (f - 1) / f
                 * (3 if train else 1) * f)
    dp = plan.data * plan.pod
    if train and dp > 1:
        grad_bytes = 2 * (params * 4) * (dp - 1) / dp / plan.fsdp
        if plan.grad_compress:
            grad_bytes /= 4.0   # int8 + scales over the pod axis
        coll += grad_bytes
    if n_experts > 1 and plan.expert > 1:
        # two all-to-alls (dispatch + combine) per MoE layer of top_k-
        # expanded tokens
        coll += (n_layers * 2 * top_k * act_layer * (plan.expert - 1)
                 / plan.expert * chips / plan.expert * (3 if train else 1))
    if plan.sequence > 1:
        coll += (n_layers * 2 * act_layer * (plan.sequence - 1)
                 * (3 if train else 1))

    rl = Roofline(
        name=f"{name}|{plan.describe()}",
        flops=hlo_flops,
        hbm_bytes=hbm_global,
        collective_bytes=coll,
        n_chips=chips,
        model_flops=(6.0 if train else 2.0) * active_params * tokens,
    )
    return PlanScore(plan=plan, roofline=rl, feasible=feasible,
                     why_infeasible=why)


def solve_sharding(
    candidates: Sequence[ShardingPlan],
    estimator: Callable[[ShardingPlan], PlanScore],
) -> PlanScore:
    """Pick the feasible plan with the lowest dominant roofline term (all
    plans when none is feasible).

    This is `solve_cut` at pod scale: enumerate configurations, score with
    the comp-comm model, take the argmin.
    """
    scores = [estimator(p) for p in candidates]
    feas = [s for s in scores if s.feasible]
    pool = feas or scores
    return min(pool, key=lambda s: s.roofline.step_s)


def rank_sharding(
    candidates: Sequence[ShardingPlan],
    estimator: Callable[[ShardingPlan], PlanScore],
) -> list:
    """Every plan's score, feasible plans first, each part by step_s."""
    scores = [estimator(p) for p in candidates]
    return sorted(scores, key=lambda s: (not s.feasible, s.roofline.step_s))
