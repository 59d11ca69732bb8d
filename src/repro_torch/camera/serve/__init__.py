"""Fleet-scale streaming serving runtime (DESIGN.md §13, chaos plane §14),
the port of the JAX package's ``camera/serve``.

The continuous front door over the §III executors: dynamic stream churn,
per-stream frame queues, capacity-padded micro-batches under a latency
SLO via the ``cascade_serve`` admission path, measured-byte congestion
monitoring through ``simulate_shared_link``, and sliding-window
per-stream cut re-solves via ``CutController.resolve_window``.

The §14 chaos plane hardens it against hostile fleets: per-stream fault
injection with retry-charged bytes, scripted device loss with re-sharding
over the surviving devices, deficit-round-robin fair shedding over
bounded queues, serve-driven degradation ladders, and checkpoint/restore
of the full server state with exactly-once frame accounting.
"""

from repro_torch.camera.serve.bytes_model import (FA_CUTS,
                                                  fa_attempt_bytes,
                                                  fa_cut_bytes,
                                                  fa_decision_bytes,
                                                  fa_quiet_bytes)
from repro_torch.camera.serve.chaos import ChaosEngine, ChaosSpec
from repro_torch.camera.serve.runtime import (AdmissionDecision,
                                              Completion, ServeConfig,
                                              ServeError, ShedRecord,
                                              StreamDrainingError,
                                              StreamingServer, TickReport,
                                              UnknownStreamError,
                                              chunk_motion_scores)

__all__ = [
    "AdmissionDecision",
    "ChaosEngine",
    "ChaosSpec",
    "Completion",
    "FA_CUTS",
    "ServeConfig",
    "ServeError",
    "ShedRecord",
    "StreamDrainingError",
    "StreamingServer",
    "TickReport",
    "UnknownStreamError",
    "chunk_motion_scores",
    "fa_attempt_bytes",
    "fa_cut_bytes",
    "fa_decision_bytes",
    "fa_quiet_bytes",
]
