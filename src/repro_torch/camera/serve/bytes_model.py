"""Per-cut wire-byte predictor for the streaming runtime (DESIGN.md §13),
the port of the JAX package's ``camera/serve/bytes_model.py``.

The offload executors charge valid-element bytes on the device
(``FaceAuthOffloadExecutor.encode_slot_state``); the serving scheduler
additionally needs the same accounting as a host-side *prediction*:
"given this stream's measured funnel stats, what would cut ``c`` put on
the wire?" —
that feeds admission control and the windowed re-solve without executing
every candidate cut.  The formulas here mirror the node half term for term
(codec payload + i32/bool sideband at the executors' ``_I32_B``/``_BOOL_B``
rates), so a prediction evaluated at a chunk's *measured* stats equals the
bytes the split executor actually charged.
"""

from __future__ import annotations

from repro_torch.camera.offload.payloads import SESSION_SIDEBAND_BYTES
from repro_torch.kernels.wire_codec.ops import wire_bytes

_I32_B = 4.0          # index / count sideband bytes per valid entry
_BOOL_B = 1.0 / 8.0   # booleans ship bit-packed

FA_CUTS = ("sensor", "motion", "vj", "nn")


def fa_cut_bytes(cut: str, bits: int | None, *, frames: int, h: int, w: int,
                 motion_frames: float = 0.0, valid_windows: float = 0.0,
                 block: int = 256) -> float:
    """Predicted wire bytes for one ``frames``-frame chunk at ``cut``.

    ``motion_frames`` / ``valid_windows`` are the chunk's (expected) funnel
    stats; zero for both gives the quiet-chunk floor — at every cut past
    the sensor that is a few sideband bytes, while the sensor cut still
    ships every pixel (the paper's early-reduction argument, visible to
    the admission controller).
    """
    if cut not in FA_CUTS:
        raise ValueError(f"cut {cut!r} not in {FA_CUTS}")
    if frames <= 0:
        return 0.0
    m = max(float(motion_frames), 0.0)
    v = max(float(valid_windows), 0.0)

    def codec(n_values: float) -> float:
        return wire_bytes(int(round(n_values)), bits, block=block)

    if cut == "sensor":
        return codec(frames * h * w)
    side = _I32_B * m + _BOOL_B * frames + _I32_B      # fidx+motion+drop
    if cut == "motion":
        return codec(m * h * w) + side
    side += _I32_B * 3 * m                             # n_win/win_drop/casc
    if cut == "vj":
        return codec(v * 20 * 20) + _I32_B * v + side
    return codec(v) + _BOOL_B * v + _I32_B * v + side  # nn: scores+auth+wsel


def fa_quiet_bytes(cut: str, bits: int | None, *, frames: int, h: int,
                   w: int, block: int = 256) -> float:
    """Bytes a chunk with no motion still costs at ``cut``."""
    return fa_cut_bytes(cut, bits, frames=frames, h=h, w=w,
                        motion_frames=0.0, valid_windows=0.0, block=block)


def fa_attempt_bytes(wire_b: float, attempts: int = 1) -> float:
    """On-air bytes of ``attempts`` chaos-plane transmissions of one
    payload (DESIGN.md §14).

    Every attempt — delivered or not — re-ships the payload plus the §12
    session sideband (seq/crc/attempt), so retries congest the shared
    uplink exactly like ``OffloadSession`` retries do.
    """
    if attempts < 0:
        raise ValueError(f"attempts must be >= 0, got {attempts}")
    return float(attempts) * (float(wire_b) + SESSION_SIDEBAND_BYTES)


def fa_decision_bytes(frames: int) -> float:
    """Wire bytes of the all-on-node terminal rung's decision beacon.

    Mirrors ``resilience``'s decision accounting: one packed auth bit per
    frame plus one i32 count — what a ladder-bottomed stream still ships
    so the fleet monitor can tell "degraded but alive" from "dead".
    """
    return max(int(frames), 0) * _BOOL_B + _I32_B
