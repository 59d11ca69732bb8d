"""The telemetry gate (the JAX package's ``obs/telemetry.py``).

Instrumented call sites hold an optional telemetry object and decide once,
at construction, whether to account to it; disabled telemetry is absent,
not cheap.  The ``Telemetry`` facade comes with the serving slice.
"""

from __future__ import annotations


def telemetry_on(tel) -> bool:
    """The one construction-time gate every instrumented site uses."""
    return tel is not None and tel.enabled
