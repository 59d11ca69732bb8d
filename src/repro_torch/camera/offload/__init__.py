"""Executable offload runtime of the port (DESIGN.md §10).

Splits the live §III executor at any legal cut point into a node half and
a cloud half with a typed, codec-compressed wire payload between them;
replays measured payload traces through a link simulator; and closes the
loop from measured executors back into ``core.placement.solve_cut`` via
the cut controller; the §IV rig splits the same way
(``VROffloadExecutor``).  The resilience layer comes with a later slice.
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

__all__ = [
    "BACKSCATTER",
    "ControllerReport",
    "CutController",
    "CutMeasurement",
    "ETH_25G_LINK",
    "ETH_400G_LINK",
    "FaceAuthOffloadExecutor",
    "LinkProfile",
    "LinkReport",
    "PayloadSchema",
    "SESSION_SIDEBAND",
    "VROffloadExecutor",
    "WirePayload",
    "link_energy_w",
    "simulate_shared_link",
    "static_array_bytes",
]
