"""Fleet chaos plane for the streaming runtime (DESIGN.md §14), the port
of the JAX package's ``camera/serve/chaos.py``.

The resilience layer's fault machinery protects one
:class:`OffloadSession`; this module lifts the same models to the fleet
layer so a whole :class:`~repro_torch.camera.serve.StreamingServer` can
be chaos-tested:

* **Per-stream fault processes** — every registered stream gets its own
  seeded :class:`~repro_torch.camera.offload.link.FaultInjector` (derived
  deterministically from ``(spec.seed, sid)``), so a fleet sweep is
  reproducible bit-for-bit while streams fault *independently* — the
  WISPCam regime, where each camera sees its own channel.
* **Device-loss events** — a scripted schedule of ``kill`` / ``restore``
  events against the serving host's local devices.  The server applies
  them at tick boundaries; a placement group sharded over the devices
  that loses one re-shards over the survivors (the single-device batch
  when they stop dividing it) within one tick.
* **Client brownouts** — ``spec.brownout`` gates each faulty stream's
  *feed* through the injector's jittered power schedule
  (:meth:`ChaosEngine.node_powered`): a harvested-energy camera that is
  dark enqueues nothing.  Server-side brownout is different — the server
  process dies and comes back — and is driven by the harness through
  ``StreamingServer.checkpoint`` / ``StreamingServer.restore``.

The engine only *decides* fault outcomes and event schedules; charging
retry bytes, moving per-stream ladders, and re-sharding groups is the
server's job (``serve/runtime.py``).  An engine whose spec carries no
fault models is inert: ``injector_for`` returns None for every stream
and the served outputs are bit-identical to running without chaos (the
zero-fault pin in BENCH_serving_chaos).
"""

from __future__ import annotations

import dataclasses
import zlib

from repro_torch.camera.offload.link import (BrownoutModel, FaultInjector,
                                       GilbertElliott)

_EVENT_KINDS = ("kill", "restore")


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Declarative fleet fault plan (all knobs optional — empty = inert).

    ``loss`` is a Gilbert–Elliott *template*: every faulty stream runs its
    own chain instance with a derived seed.  ``faulty_fraction`` selects
    which streams fault at all (deterministic per sid, not random per
    run).  ``device_events`` is ``((tick, kind, device_index), ...)`` with
    kind ``"kill"`` or ``"restore"``, applied when the server's tick
    counter *reaches* ``tick``.  Ladder knobs shape the per-stream
    :class:`~repro_torch.camera.offload.resilience.DegradationLadder` the
    server builds for chaos-enabled streams — the window is deliberately
    short and recovery deliberately shorter than the session's default
    (a serve tick aggregates a whole chunk, so symptoms arrive slower
    than per-payload sends).
    """

    loss: GilbertElliott | None = None
    corrupt_fraction: float = 0.0
    brownout: BrownoutModel | None = None
    faulty_fraction: float = 1.0
    max_retries: int = 3
    device_events: tuple = ()
    ladder_window: int = 8
    ladder_max_retry_frac: float = 0.3
    ladder_recover_after: int = 6
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.faulty_fraction <= 1.0:
            raise ValueError(
                f"faulty_fraction must be in [0, 1], got "
                f"{self.faulty_fraction!r}")
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        for ev in self.device_events:
            if len(ev) != 3 or ev[1] not in _EVENT_KINDS:
                raise ValueError(
                    f"device_events entries are (tick, 'kill'|'restore', "
                    f"device_index), got {ev!r}")
            if int(ev[0]) < 0 or int(ev[2]) < 0:
                raise ValueError(f"negative tick/device in event {ev!r}")

    @property
    def has_stream_faults(self) -> bool:
        return (self.loss is not None or self.brownout is not None
                or self.corrupt_fraction > 0.0)


class ChaosEngine:
    """Seeded fault oracle one :class:`StreamingServer` consults.

    Injectors are created lazily per sid and cached — identical spec +
    identical sid set + identical query order reproduce identical fault
    sequences (the sweep-determinism contract BENCH_serving_chaos pins).
    """

    def __init__(self, spec: ChaosSpec = ChaosSpec()):
        if not isinstance(spec, ChaosSpec):
            raise TypeError(
                f"ChaosEngine wants a ChaosSpec, got {type(spec).__name__}")
        self.spec = spec
        self._injectors: dict = {}

    # -- per-stream fault processes ------------------------------------------

    @staticmethod
    def _salt(sid: str) -> int:
        return zlib.crc32(sid.encode("utf-8")) & 0xFFFFFFFF

    def is_faulty(self, sid: str) -> bool:
        """Does ``sid`` get a fault process at all?  Deterministic in the
        sid (a hash bucket against ``faulty_fraction``), not sampled per
        run — re-registering the same fleet faults the same streams."""
        if not self.spec.has_stream_faults:
            return False
        frac = self.spec.faulty_fraction
        if frac >= 1.0:
            return True
        if frac <= 0.0:
            return False
        return (self._salt(sid) % 10_000) < frac * 10_000

    def injector_for(self, sid: str) -> FaultInjector | None:
        """The stream's own injector (cached), or None for clean streams."""
        if not self.is_faulty(sid):
            return None
        inj = self._injectors.get(sid)
        if inj is None:
            inj = FaultInjector(
                loss=self.spec.loss, brownout=self.spec.brownout,
                corrupt_fraction=self.spec.corrupt_fraction,
                seed=(self.spec.seed * 0x1_0000_0001 + self._salt(sid))
                % (2 ** 63))
            self._injectors[sid] = inj
        return inj

    def fault_id(self, sid: str) -> int:
        """Stable correlation id of ``sid``'s fault process (its derived
        injector seed; 0 for clean streams).  The §15 trace stamps this
        on every link event so a recorded drive can be joined back to
        the exact seeded chaos trajectory offline."""
        if not self.is_faulty(sid):
            return 0
        return (self.spec.seed * 0x1_0000_0001 + self._salt(sid)) % (2 ** 63)

    def node_powered(self, sid: str, t: float) -> bool:
        """Client-side brownout gate: is ``sid``'s camera powered at ``t``?

        Harness-facing — a dark node enqueues nothing (the frames were
        never captured; they are not "lost frames" in the seq audit).
        """
        inj = self.injector_for(sid)
        if inj is None or inj.brownout is None:
            return True
        return inj.power_window(t)[0]

    def retx_factor(self, sid: str) -> float:
        """Expected transmissions per delivery under the loss template.

        Admission control inflates a faulty stream's predicted bps by
        this factor so chaos-era retries are budgeted, not discovered.
        """
        if self.spec.loss is None or not self.is_faulty(sid):
            return 1.0
        p = min(self.spec.loss.stationary_loss, 0.9)
        return 1.0 / (1.0 - p)

    # -- device-loss schedule -------------------------------------------------

    def events_at(self, tick: int) -> list:
        """``(kind, device_index)`` events scheduled for this tick."""
        return [(kind, int(idx))
                for (tk, kind, idx) in self.spec.device_events
                if int(tk) == int(tick)]
