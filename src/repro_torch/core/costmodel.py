"""Computation–communication cost model (paper §II-A, §III-D, §IV-C) —
the port's copy of the JAX package's pure-Python ``core/costmodel.py``:
the two camera regimes and the pod-scale three-term roofline.

The paper evaluates every pipeline configuration under one of two regimes:

* **Energy regime** (face authentication, §III): the node is
  power-constrained; the cost of a configuration is the *sum* of the
  average power of every on-node block plus the power to transmit the
  cut-point payload.  "We assume the energy cost of computing in the cloud
  as free ... but the cost to get data to the cloud is not."

* **Throughput regime** (VR video, §IV): the pipeline is pipelined across
  frames; the cost of a configuration is the *bottleneck* — the minimum
  over blocks of per-block throughput, and the offload link's throughput on
  the cut-point payload.  Real-time iff both clear 30 FPS.

Both regimes consume the same inputs: a ``Pipeline`` of work descriptors
(``core.pipeline``) and per-block ``HardwareProfile``s.  The same
machinery scores sharding plans through the three-term roofline model
(``Roofline``): compute, memory and collective seconds per step on a mesh
of chips (``core.placement.estimate_plan``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from repro_torch.core.pipeline import Block, Pipeline

# ---------------------------------------------------------------------------
# Hardware profiles
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """A device (or link) that can host a block (or a cut-point payload).

    Energy-regime fields
    --------------------
    p_active_w:     power while actively processing (W).
    p_leak_w:       standby power while idle but powered (W).  The paper's
                    sub-threshold analysis (Fig. 6) makes leakage a
                    first-class term; it is what makes the in-camera NN a
                    *bad* deal at low duty cycle (§III-D) and a *good* deal
                    once window traffic amortizes it (the 8 MP result).
    joules_per_byte: transmit energy for link profiles (J/B).

    Throughput-regime fields
    ------------------------
    flops_per_s:    sustained arithmetic rate.
    mem_bw:         bytes/s to the block's working memory.
    link_bw:        bytes/s for link profiles.
    """

    name: str
    # throughput regime
    flops_per_s: float = 0.0
    mem_bw: float = 0.0
    link_bw: float = 0.0
    # energy regime
    p_active_w: float = 0.0
    p_leak_w: float = 0.0
    joules_per_byte: float = 0.0

    def time_for(self, block: Block) -> float:
        """Seconds to process one unit of ``block`` (throughput regime).

        max(compute, memory) — the block-level roofline.  Profiles with only
        one rate defined use that rate alone.
        """
        terms = []
        if self.flops_per_s:
            terms.append(block.flops / self.flops_per_s)
        if self.mem_bw:
            terms.append((block.bytes_in + block.bytes_out) / self.mem_bw)
        if not terms:
            raise ValueError(f"profile {self.name} has no throughput rates")
        return max(terms)

    def power_for(self, block: Block, duty: float) -> float:
        """Average watts to run ``block`` at duty cycle ``duty`` (energy regime)."""
        duty = min(max(duty, 0.0), 1.0)
        return self.p_leak_w + duty * max(self.p_active_w - self.p_leak_w, 0.0)


# -- The pod model ----------------------------------------------------------
# The reference's chip and pod-to-pod link, with its values and its role:
# the defaults of ``Roofline`` and the profiles its plan search scores.

TPU_V5E = HardwareProfile(
    name="tpu_v5e",
    flops_per_s=197e12,
    mem_bw=819e9,
    link_bw=50e9,
)

POD_LINK = HardwareProfile(name="pod_link", link_bw=12.5e9)

# The port's card, an H100 SXM: bf16 dense tensor-core rate and HBM3 rate,
# the figures the kernel rows' bounds use.  It has no link rate; a
# ``Roofline`` made with ``chip=H100_SXM`` keeps the default link.
H100_SXM = HardwareProfile(name="h100_sxm", flops_per_s=989e12,
                           mem_bw=3.35e12)


# -- Paper §III profiles (Table I + calibration) -----------------------------
# Absolute powers for sensor/motion and the RF joules-per-byte are not
# printed in the paper text; ``camera.pipelines.calibrate_fa`` calibrates
# them so that the paper's *stated* claims hold exactly: +28% total power
# when adding the NN in-camera, cost-crossover at 2.68x comm energy.
# Table I values (337 uW VJ, 393 uW NN, 181 uW MSP430, 27.9 MHz) are used
# verbatim.

MSP430 = HardwareProfile(
    name="openmsp430",
    flops_per_s=27.9e6 / 8.0,   # 16-bit MAC in ~8 cycles w/ HW multiplier
    p_active_w=181e-6,
    p_leak_w=2e-6,
)

VJ_ASIC = HardwareProfile(
    name="vj_asic",
    flops_per_s=27.9e6 * 2,     # streaming: ~2 ops/cycle (accumulate + compare)
    p_active_w=337e-6,
    p_leak_w=67e-6,             # always-powered frame-buffer SRAM share
)

NN_ASIC = HardwareProfile(
    name="nn_asic",
    flops_per_s=27.9e6 * 16,    # 8 PEs x MAC = 16 ops/cycle
    p_active_w=393e-6,
    p_leak_w=53e-6,             # calibrated: weight SRAM leakage (see §III-D fit)
)

IMAGE_SENSOR = HardwareProfile(
    name="image_sensor", p_active_w=25e-6, p_leak_w=25e-6,  # always-on capture
)

MOTION_ASIC = HardwareProfile(
    name="motion_asic", p_active_w=15e-6, p_leak_w=15e-6,   # always-on frame diff
)

# RF offload link; joules_per_byte is overwritten by calibration.
RF_LINK = HardwareProfile(name="rf_link", joules_per_byte=83e-9)

# -- Paper §IV profiles (throughput regime) ----------------------------------
# Sustained rates on the BSSA workload, anchored to the paper's relative
# claims: the Zynq eval FPGA beats the tuned-Halide CPU baseline by 10x
# (§IV-C "up to 10x"); a compute unit = 18 DSPs = an 8-MAC f32 cascade at
# 125 MHz (2 flops/MAC).  The Fig. 14 "FPGA" row is the production target
# (Table II: Virtex UltraScale+, 682 units) — the Zynq is the 2-camera
# eval vehicle.
_FPGA_UNIT_FLOPS = 8 * 2 * 125e6              # one compute unit
ARM_A9 = HardwareProfile(name="arm_cortex_a9", flops_per_s=2.4e9, mem_bw=4e9)
QUADRO_GPU = HardwareProfile(name="quadro_k2200", flops_per_s=8e9, mem_bw=80e9)
ZYNQ_FPGA = HardwareProfile(
    name="zynq7020_fpga", flops_per_s=12 * _FPGA_UNIT_FLOPS, mem_bw=8e9,
)
VIRTEX_FPGA = HardwareProfile(
    name="virtex_us_fpga", flops_per_s=682 * _FPGA_UNIT_FLOPS, mem_bw=64e9,
)
ETH_25G = HardwareProfile(name="eth_25g", link_bw=25e9 / 8)
ETH_400G = HardwareProfile(name="eth_400g", link_bw=400e9 / 8)


# ---------------------------------------------------------------------------
# Energy regime (paper §III)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    """Cost of one pipeline configuration in the energy regime."""

    config_name: str
    compute_w: float                 # sum of on-node block powers
    comm_w: float                    # transmit power for cut payload
    per_block_w: tuple               # ((name, watts), ...) cumulative detail
    cut_after: str

    @property
    def total_w(self) -> float:
        return self.compute_w + self.comm_w


def energy_cost(
    pipeline: Pipeline,
    profiles: Mapping[str, HardwareProfile],
    link: HardwareProfile,
    cut_after: str,
    unit_rate_hz: float = 1.0,
    duties: Mapping[str, float] | None = None,
    config_name: str | None = None,
) -> EnergyReport:
    """Total average power of a configuration (paper Fig. 8 / Fig. 9).

    ``pipeline`` must already be ``configure()``d (optional blocks chosen).
    ``cut_after`` names the last on-node block; its (selectivity-scaled)
    output is the offload payload.  ``unit_rate_hz`` is the source rate
    (1 FPS for WISPCam).  ``duties`` optionally overrides per-block duty
    cycles; by default duty = time_for(block) * effective unit rate.
    """
    duties = dict(duties or {})
    cut_idx = pipeline.index(cut_after)
    eff = pipeline.effective_blocks()

    per_block = []
    compute_w = 0.0
    for i, blk in enumerate(eff[: cut_idx + 1]):
        prof = profiles[blk.name]
        if blk.name in duties:
            duty = duties[blk.name]
        elif prof.flops_per_s or prof.mem_bw:
            duty = prof.time_for(blk) * unit_rate_hz
        else:
            duty = 1.0  # always-on blocks (sensor, motion comparator)
        w = prof.power_for(blk, duty)
        compute_w += w
        per_block.append((blk.name, w))

    payload = pipeline.cut_payload_bytes(cut_idx) * unit_rate_hz
    comm_w = payload * link.joules_per_byte
    return EnergyReport(
        config_name=config_name or f"{pipeline.name}|cut={cut_after}",
        compute_w=compute_w,
        comm_w=comm_w,
        per_block_w=tuple(per_block),
        cut_after=cut_after,
    )


# ---------------------------------------------------------------------------
# Throughput regime (paper §IV)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ThroughputReport:
    """Cost of one configuration in the throughput regime (paper Fig. 14)."""

    config_name: str
    compute_fps: float               # bottleneck over on-node blocks
    comm_fps: float                  # link rate / cut payload
    per_block_fps: tuple
    cut_after: str

    @property
    def fps(self) -> float:
        return min(self.compute_fps, self.comm_fps)

    def realtime(self, target_fps: float = 30.0) -> bool:
        """Paper: real-time iff *both* compute and comm clear the target."""
        return self.compute_fps >= target_fps and self.comm_fps >= target_fps


def throughput_cost(
    pipeline: Pipeline,
    profiles: Mapping[str, HardwareProfile],
    link: HardwareProfile,
    cut_after: str,
    config_name: str | None = None,
) -> ThroughputReport:
    """Bottleneck throughput of a configuration (paper §IV-C methodology).

    "Because this processing flow can be pipelined across frames ... the
    total cost of the system [is] dominated by the lowest-throughput block."
    """
    cut_idx = pipeline.index(cut_after)
    eff = pipeline.effective_blocks()
    per_block = []
    compute_fps = math.inf
    for blk in eff[: cut_idx + 1]:
        prof = profiles[blk.name]
        if not (prof.flops_per_s or prof.mem_bw):
            continue  # source blocks: rate set by the sensor, not a bound here
        t = prof.time_for(blk)
        fps = (1.0 / t) if t > 0 else math.inf
        per_block.append((blk.name, fps))
        compute_fps = min(compute_fps, fps)
    payload = pipeline.cut_payload_bytes(cut_idx)
    comm_fps = link.link_bw / payload if payload else math.inf
    return ThroughputReport(
        config_name=config_name or f"{pipeline.name}|cut={cut_after}",
        compute_fps=compute_fps,
        comm_fps=comm_fps,
        per_block_fps=tuple(per_block),
        cut_after=cut_after,
    )


# ---------------------------------------------------------------------------
# Roofline — the throughput regime at pod scale
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Three-term roofline for one (arch x shape x mesh) cell.

    compute_s    = flops / (chips * peak_FLOP/s)
    memory_s     = hbm_bytes / (chips * HBM_bw)
    collective_s = collective_bytes / (chips * link_bw)

    ``flops``, ``hbm_bytes`` and ``collective_bytes`` are global
    (whole-program) quantities; ``core.placement.estimate_plan`` makes
    them analytically.
    """

    name: str
    flops: float
    hbm_bytes: float
    collective_bytes: float
    n_chips: int
    model_flops: float = 0.0            # 6*N*D (or 6*N_active*D for MoE)
    ideal_bytes: float = 0.0            # structural minimum HBM traffic
    chip: HardwareProfile = TPU_V5E
    link: HardwareProfile = TPU_V5E

    @property
    def compute_s(self) -> float:
        return self.flops / (self.n_chips * self.chip.flops_per_s)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.n_chips * self.chip.mem_bw)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.n_chips * self.link.link_bw)

    @property
    def step_s(self) -> float:
        """Optimistic overlapped step time: the dominant term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flop_fraction(self) -> float:
        """model_flops / flops — catches remat / redundant compute."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def ideal_s(self) -> float:
        """Unavoidable step time: max of the pure-model-FLOP time and the
        structural-minimum HBM time (params + caches + boundary
        activations).  Decode steps are memory-bound by construction —
        judging them against a FLOP-only ideal reports 0% for every
        possible implementation; the bytes term fixes the denominator."""
        t_flops = (self.model_flops / (self.n_chips * self.chip.flops_per_s)
                   if self.model_flops else 0.0)
        t_bytes = (self.ideal_bytes / (self.n_chips * self.chip.mem_bw)
                   if self.ideal_bytes else 0.0)
        return max(t_flops, t_bytes)

    @property
    def roofline_fraction(self) -> float:
        """ideal_s / step_s."""
        ideal = self.ideal_s
        return ideal / self.step_s if (ideal and self.step_s) else 0.0

    def row(self) -> dict:
        return {
            "name": self.name,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops": self.flops,
            "useful_flop_fraction": self.useful_flop_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def format_roofline_table(rows: Sequence[Roofline]) -> str:
    hdr = (
        f"{'cell':<38s} {'compute_s':>11s} {'memory_s':>11s} "
        f"{'collect_s':>11s} {'dominant':>10s} {'useful%':>8s} "
        f"{'roofline%':>9s}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.name:<38s} {r.compute_s:>11.4e} {r.memory_s:>11.4e} "
            f"{r.collective_s:>11.4e} {r.dominant:>10s} "
            f"{100*r.useful_flop_fraction:>7.1f}% "
            f"{100*r.roofline_fraction:>8.1f}%"
        )
    return "\n".join(lines)
