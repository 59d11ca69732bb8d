"""Typed wire payloads for offload cut points (DESIGN.md §10).

A :class:`WirePayload` is everything that crosses the offload link when a
pipeline is cut: the codec-packed (or raw) tensors, the integer/boolean
sideband (indices, counts, drop counters), and two byte accountings:

* ``wire_bytes`` — the **measured** bytes a real variable-length transmit
  would put on the air: only *valid* (non-capacity-padding) payload
  elements are charged, at the codec bit-width plus one f32 scale per
  block; index/count sideband at 4 B per valid entry; booleans at 1 bit.
  The node half computes it on the device as a float32 scalar, so it is
  data-dependent while every shape stays static.
* ``capacity_bytes`` — the static padded size of the tensors actually held
  in memory (the capacity-padding contract's worst case).  The gap
  between the two is exactly what compaction buys on the wire.

Payload tensors stay capacity-padded; the node halves zero every invalid
slot before encoding, so the codec packs padding as exact zeros (a zero
quantizes to zero, and a padding slot can never inflate a block scale
shared with valid data) and the padding is never charged.
"""

from __future__ import annotations

import dataclasses

import torch

# Session-layer sideband the resilience runtime staples onto every wire
# payload: a monotone sequence number, an integrity checksum over the
# payload bytes, and the retransmit-attempt counter, each charged at 4 B
# per transmission attempt.  Declared here so that both executor families
# share one spec.
SESSION_SIDEBAND = (("seq", "uint32"), ("crc", "uint32"),
                    ("attempt", "int32"))
SESSION_SIDEBAND_NAMES = tuple(n for n, _ in SESSION_SIDEBAND)
SESSION_SIDEBAND_BYTES = 4.0 * len(SESSION_SIDEBAND)


def static_array_bytes(a: torch.Tensor) -> float:
    """Static wire size of one tensor: bools at 1 bit, else itemsize.

    Reads only shape and dtype — never copies a device tensor to the host
    (this runs inside the controller's timed calibration)."""
    if a.dtype == torch.bool:
        return a.numel() / 8.0
    return float(a.numel() * a.element_size())


@dataclasses.dataclass(frozen=True)
class PayloadSchema:
    """Declared wire contract for one cut.

    Every tensor a node half may put on the wire is declared here:
    ``codec`` fields go through the wire codec (f32 raw at ``bits=None``,
    packed + scales otherwise) and are charged per valid element at codec
    width; ``i32`` sideband fields are charged at 4 B per valid entry;
    ``bools`` ship bit-packed at 1/8 B.  ``session`` declares the
    session-layer sideband the resilience runtime adds per transmission.
    """

    codec: tuple = ()
    i32: tuple = ()
    bools: tuple = ()
    session: tuple = ()

    def declared(self, bits) -> set:
        """Full expected key set of the node half's ``arrays`` dict."""
        out = set(self.i32) | set(self.bools) | set(self.codec)
        if bits is not None:
            out |= {f + "_scales" for f in self.codec}
        return out


@dataclasses.dataclass
class WirePayload:
    """One cut's wire payload (the node half's output).

    ``arrays`` holds every on-wire tensor (packed codec bytes + scales
    under ``<field>``/``<field>_scales``, plus sideband).  ``meta`` holds
    the static decode contract (the source frames' shape).
    """

    cut: str
    bits: int | None              # codec width; None = raw f32 passthrough
    arrays: dict
    meta: dict
    wire_b: torch.Tensor          # () f32 — measured (valid-element) bytes

    def nbytes(self) -> float:
        """Measured wire bytes for this batch (valid elements only)."""
        return float(self.wire_b)

    def capacity_bytes(self) -> float:
        """Static padded wire size (every slot shipped, none elided)."""
        return sum(static_array_bytes(a) for a in self.arrays.values())
