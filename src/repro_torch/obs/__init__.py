"""The port's share of the observability layer (the JAX package's
``obs/``): the ladder-rung key and the telemetry gate that the offload
resilience layer uses.  The counters, trace, SLO ledger and ``Telemetry``
facade come with the serving slice; until then a session takes any object
with their interface (``enabled``, ``counters.bump``, ``emit``,
``ledger.observe_latency``), such as the JAX package's ``Telemetry``."""

from repro_torch.obs.ledger import rung_key
from repro_torch.obs.telemetry import telemetry_on

__all__ = ["rung_key", "telemetry_on"]
