"""Offload placement solver (the paper's configuration search, §III-D,
§IV-C) — the port's copy of :func:`solve_cut` from the JAX package's
``core/placement.py``.

The paper hand-enumerates pipeline configurations — which optional blocks
to include and where to cut the pipeline for offload — and evaluates each
with the computation-communication cost model.  :func:`solve_cut` is the
exhaustive optimum over (optional-block subset x cut point) for a linear
pipeline, in either cost regime; the paper's spaces are tiny (<= 2^3 x 5),
so exhaustive search *is* the exact algorithm.  The sharding-plan solver
comes with the LM slice.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping

from repro_torch.core.costmodel import (
    HardwareProfile,
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
