"""In-camera processing pipelines (paper Fig. 1), generalized — the port's
copy of the JAX package's pure-Python ``core/pipeline.py``.

The paper decomposes a camera application into a linear pipeline of
functional blocks ``B_1 .. B_n``.  Each block has a computation cost and
each block *boundary* has a communication cost (the cost of shipping that
intermediate off the node).  Blocks are either *core* (required for
correctness: the NN authenticator, the BSSA depth solver) or *optional*
(data reducers that only exist to make everything downstream cheaper:
motion detection, Viola-Jones).

Costs are stored as *work descriptors* (flops, bytes in/out, working-set
bytes), never as seconds or joules — converting work into cost is the job
of a ``HardwareProfile`` (``repro_torch.core.costmodel``), which is what
lets one pipeline be evaluated on an MSP430 or a 65 nm ASIC.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Iterable, Sequence


class BlockKind(enum.Enum):
    """Paper §II-A: core blocks are essential; optional blocks only filter."""

    CORE = "core"
    OPTIONAL = "optional"
    # Source blocks produce data (the image sensor); they cannot be offloaded
    # and have no upstream edge.
    SOURCE = "source"


@dataclasses.dataclass(frozen=True)
class Block:
    """One functional block ``B_i`` of an in-camera pipeline.

    Attributes
    ----------
    name:            human-readable id (``"motion"``, ``"vj"``, ``"nn"``,
                     ``"attn[12]"`` ...).
    flops:           arithmetic work to process one unit of input (one frame
                     for camera pipelines, one step-batch for LM pipelines).
    bytes_in:        size of the block's input for one unit.
    bytes_out:       size of the block's output for one unit.  ``bytes_out``
                     of ``B_i`` is the communication payload if the pipeline
                     is cut after ``B_i``.
    kind:            core / optional / source.
    selectivity:     expected fraction of input *units* that survive the
                     block (paper: motion passes 12/62 frames = 0.19; VJ
                     passes 40 windows of ~7.9k = 0.005).  Downstream blocks
                     only pay for surviving units; this is exactly how the
                     paper's optional blocks buy their keep.
    working_set:     bytes the block needs resident while running (paper:
                     the 1 kB two-row integral buffer vs the 57 kB frame
                     buffer).  Used for VMEM/SRAM feasibility checks.
    sram_kib:        on-chip memory of the paper's ASIC implementation, kept
                     for the faithful reproduction tables (0 if n/a).
    meta:            free-form tag dict (layer index, shard axes, ...).
    """

    name: str
    flops: float
    bytes_in: float
    bytes_out: float
    kind: BlockKind = BlockKind.CORE
    selectivity: float = 1.0
    working_set: float = 0.0
    requires: tuple = ()              # optional blocks this block needs on-node
                                      # (paper: the NN ASIC consumes VJ's 20x20
                                      # windows over CSI2 — running it in-camera
                                      # without FD is not a wirable config)
    meta: tuple = ()

    def scaled(self, unit_fraction: float) -> "Block":
        """Return a copy with work scaled by the fraction of units reaching it."""
        return dataclasses.replace(
            self,
            flops=self.flops * unit_fraction,
            bytes_in=self.bytes_in * unit_fraction,
            bytes_out=self.bytes_out * unit_fraction,
        )

    @property
    def arithmetic_intensity(self) -> float:
        denom = self.bytes_in + self.bytes_out
        return self.flops / denom if denom else math.inf


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """A linear pipeline ``B_1 -> B_2 -> ... -> B_n`` (paper Fig. 1).

    ``blocks[0]`` is normally a SOURCE block (the sensor).  The pipeline is
    *configurable*: optional blocks may be dropped, and the pipeline may be
    *cut* after any block, offloading the remainder.  Enumerating those
    configurations is ``core.placement``'s job; this class only holds
    structure and provides the effective (selectivity-scaled) view.
    """

    name: str
    blocks: tuple

    def __post_init__(self):
        object.__setattr__(self, "blocks", tuple(self.blocks))
        names = [b.name for b in self.blocks]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate block names in pipeline {self.name}: {names}")

    # -- structure ----------------------------------------------------------
    def __iter__(self):
        return iter(self.blocks)

    def __len__(self):
        return len(self.blocks)

    def block(self, name: str) -> Block:
        for b in self.blocks:
            if b.name == name:
                return b
        raise KeyError(name)

    def index(self, name: str) -> int:
        for i, b in enumerate(self.blocks):
            if b.name == name:
                return i
        raise KeyError(name)

    @property
    def optional_names(self) -> tuple:
        return tuple(b.name for b in self.blocks if b.kind is BlockKind.OPTIONAL)

    # -- configuration ------------------------------------------------------
    def configure(self, include_optional: Iterable[str] = ()) -> "Pipeline":
        """Drop optional blocks not listed in ``include_optional``.

        Core and source blocks are always kept.  This mirrors the paper's
        configuration space in Fig. 8 (e.g. "motion+FD, offload NN" is
        ``configure({"motion", "vj"})`` cut after ``vj``).
        """
        keep = set(include_optional)
        unknown = keep - set(self.optional_names)
        if unknown:
            raise KeyError(f"not optional blocks of {self.name}: {sorted(unknown)}")
        blocks = tuple(
            b for b in self.blocks
            if b.kind is not BlockKind.OPTIONAL or b.name in keep
        )
        return Pipeline(self.name, blocks)

    def effective_blocks(self) -> tuple:
        """Blocks with work scaled by cumulative upstream selectivity.

        Paper §III-D: "The computation power is the sum of power at that
        block and the processing blocks preceding it" — but a filter that
        passes 19% of frames means every later block only runs on 19% of
        units.  We propagate the product of upstream selectivities.
        """
        out = []
        frac = 1.0
        for b in self.blocks:
            out.append(b.scaled(frac))
            frac *= b.selectivity
        return tuple(out)

    def cut_payload_bytes(self, cut_after: int) -> float:
        """Bytes/unit crossing the offload link when cut after index ``cut_after``.

        ``bytes_out`` is per *surviving* unit, so the payload includes the
        block's own selectivity (a filter that passes 20% of frames only
        transmits those 20%).  ``cut_after = len-1`` means fully on-node —
        the final block's (tiny) output still ships (the paper's NN still
        transmits its 1-bit answer).
        """
        eff = self.effective_blocks()
        i = cut_after if cut_after >= 0 else 0
        return eff[i].bytes_out * self.blocks[i].selectivity

    def total_flops(self, upto: int | None = None) -> float:
        eff = self.effective_blocks()[: None if upto is None else upto + 1]
        return sum(b.flops for b in eff)

    def describe(self) -> str:
        lines = [f"Pipeline {self.name}:"]
        for b in self.effective_blocks():
            lines.append(
                f"  {b.name:>14s} [{b.kind.value:8s}] flops={b.flops:.3e} "
                f"in={b.bytes_in:.3e}B out={b.bytes_out:.3e}B sel={b.selectivity:.3g}"
            )
        return "\n".join(lines)


def linear_pipeline(name: str, specs: Sequence[dict]) -> Pipeline:
    """Convenience constructor from a list of dicts."""
    blocks = []
    for s in specs:
        s = dict(s)
        kind = s.pop("kind", "core")
        blocks.append(Block(kind=BlockKind(kind), **s))
    return Pipeline(name, tuple(blocks))
