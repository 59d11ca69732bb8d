"""Executable offload runtime of the port (DESIGN.md §10).

Splits the live §III executor at any legal cut point into a node half and
a cloud half with a typed, codec-compressed wire payload between them;
replays measured payload traces through a link simulator; and closes the
loop from measured executors back into ``core.placement.solve_cut`` via
the cut controller; the §IV rig splits the same way
(``VROffloadExecutor``).  The resilience layer (DESIGN.md §12) wraps the
split executors in fault-tolerant sessions: seeded burst-loss, outage and
brownout injection, checksummed retransmission charged at real link cost,
commit-point brownout recovery, and a measured graceful-degradation
ladder.
"""

from repro_torch.camera.offload.controller import (
    ControllerReport,
    CutController,
    CutMeasurement,
)
from repro_torch.camera.offload.executors import (
    FaceAuthOffloadExecutor,
    VROffloadExecutor,
)
from repro_torch.camera.offload.link import (
    BACKSCATTER,
    ETH_25G_LINK,
    ETH_400G_LINK,
    BrownoutModel,
    FaultInjector,
    GilbertElliott,
    LinkProfile,
    LinkReport,
    link_energy_w,
    simulate_shared_link,
)
from repro_torch.camera.offload.payloads import (
    SESSION_SIDEBAND,
    PayloadSchema,
    WirePayload,
    static_array_bytes,
)
from repro_torch.camera.offload.resilience import (
    ON_NODE,
    DegradationLadder,
    DeliveryRecord,
    OffloadSession,
    fleet_link_report,
    payload_checksum,
)

__all__ = [
    "BACKSCATTER",
    "BrownoutModel",
    "ControllerReport",
    "CutController",
    "CutMeasurement",
    "DegradationLadder",
    "DeliveryRecord",
    "ETH_25G_LINK",
    "ETH_400G_LINK",
    "FaceAuthOffloadExecutor",
    "FaultInjector",
    "GilbertElliott",
    "LinkProfile",
    "LinkReport",
    "ON_NODE",
    "OffloadSession",
    "PayloadSchema",
    "SESSION_SIDEBAND",
    "VROffloadExecutor",
    "WirePayload",
    "fleet_link_report",
    "link_energy_w",
    "payload_checksum",
    "simulate_shared_link",
    "static_array_bytes",
]
