"""Device-lazy counters: ``tel_`` aux outputs of the funnel + a host panel
(the JAX package's ``obs/counters.py``).

The telemetry plane's hot-path contract (DESIGN.md §15):

* **Counters are int32/uint32 outputs of the same launch sequence.**  A
  stage that counts something returns a ``tel_``-prefixed int32/uint32
  tensor beside its real outputs, computed on the device from those
  outputs: no extra pass over the data, no host callback.
* **Zero host syncs on the hot path.**  ``CounterPanel.add`` keeps the
  running total as a device tensor; nothing calls ``int()`` (which would
  wait for the device) until ``totals()`` at export time.
* **Disabled => bit-identical.**  Instrumented call sites gate the
  counters at construction, so a disabled executor runs the launch
  sequence of an uninstrumented one and returns bit-identical outputs.

``TELEMETRY_AUX`` is the reference's declaration registry, kept as data:
which ``tel_`` counters each executor target emits, every one
int32/uint32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

TEL_PREFIX = "tel_"
ALLOWED_DTYPES = ("int32", "uint32")

# target stem -> ((counter, dtype), ...); stems are target names with the
# "[...]" parameterization stripped (see ``telemetry_decl``).  An empty
# tuple declares a target that emits no counters on purpose.
TELEMETRY_AUX: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "face_auth.funnel": (
        ("windows", "int32"), ("auth", "int32"),
        ("motion_dropped", "int32"), ("cascade_dropped", "int32"),
    ),
    "vr_rig.depth": (("pairs", "int32"),),
    "vr_rig.panorama": (("views", "int32"),),
    # the offload halves emit no tel_ aux: their bytes accounting is the
    # charged ``wire_b`` output, and per-attempt counters live at the
    # OffloadSession host layer — telemetry never rides the payload
    "fa_offload.node": (),
    "fa_offload.cloud": (),
    "vr_offload.node": (),
    "vr_offload.cloud": (),
    # batch_step runs the instrumented funnel, inheriting its aux
    "serve.batch_step": (
        ("windows", "int32"), ("auth", "int32"),
        ("motion_dropped", "int32"), ("cascade_dropped", "int32"),
    ),
    "serve.group_step": (),
    "serve.group_step_degraded": (),
    "serve.restore_rescore": (),
    "serve.cascade_admit": (),
    "quant.nn_forward": (),
    "codec.roundtrip": (),
}


def telemetry_decl(target_name: str):
    """Resolve a target name to its TELEMETRY_AUX declaration.

    ``fa_offload[nn,8].node`` -> ``fa_offload.node``;
    ``serve.batch_step[3x4]`` -> ``serve.batch_step``;
    ``face_auth.funnel`` -> itself.  None when undeclared, a (possibly
    empty) tuple otherwise.
    """
    stem = target_name.split("[", 1)[0]
    if "]." in target_name:
        stem = stem + "." + target_name.rsplit("].", 1)[1]
    return TELEMETRY_AUX.get(stem)


def _dtype(dtype: str) -> torch.dtype:
    if dtype not in ALLOWED_DTYPES:
        raise ValueError(
            f"telemetry counter dtype must be one of {ALLOWED_DTYPES}, "
            f"got {dtype!r}")
    return getattr(torch, dtype)


def graph_counter(value, dtype: str = "int32", device=None):
    """``value`` as a telemetry counter: a tensor of int32 or uint32 (the
    only legal counter dtypes), on the value's device when it is a tensor,
    else on ``device`` (the CPU when None).  A tensor keeps its shape, so
    a per-stream count stays one counter per stream."""
    dt = _dtype(dtype)
    if isinstance(value, torch.Tensor):
        return value.to(dt)
    # a fill on the device, not a copy from the host (which can wait
    # for the device's queue)
    return torch.full((), value, dtype=dt, device=device)


def graph_counters(_dtypes: Optional[Dict[str, str]] = None, **values):
    """Build a ``{tel_name: counter}`` aux dict."""
    dtypes = _dtypes or {}
    return {TEL_PREFIX + name: graph_counter(v, dtypes.get(name, "int32"))
            for name, v in values.items()}


class CounterPanel:
    """Host-side accumulator for counters (device-lazy + plain ints).

    ``add`` folds device tensors into a running device sum (queued on the
    device, never waits); ``bump`` adds host integers.  ``totals`` is the
    only method that brings device values to the host.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._dev: Dict[str, torch.Tensor] = {}
        self._host: Dict[str, int] = {}

    def bump(self, name: str, n: int = 1) -> None:
        if not self.enabled:
            return
        self._host[name] = self._host.get(name, 0) + int(n)

    def add(self, name: str, value) -> None:
        """Accumulate a device tensor (summed over all its entries)
        without a host sync."""
        if not self.enabled:
            return
        value = torch.as_tensor(value).sum(dtype=torch.int64)
        cur = self._dev.get(name)
        self._dev[name] = value if cur is None else cur + value

    def consume(self, out: dict, prefix: str = "") -> dict:
        """Pop ``tel_*`` keys out of a result dict into the panel
        (device-lazy), returning the cleaned dict."""
        if not any(k.startswith(TEL_PREFIX) for k in out):
            return out
        clean = {}
        for k, v in out.items():
            if k.startswith(TEL_PREFIX):
                if self.enabled:
                    self.add(prefix + k[len(TEL_PREFIX):], v)
            else:
                clean[k] = v
        return clean

    def totals(self) -> Dict[str, int]:
        """Every counter as a plain int (the one sync point — call at
        export/report time, never per tick)."""
        out = dict(self._host)
        for name, v in self._dev.items():
            out[name] = out.get(name, 0) + int(v)
        return dict(sorted(out.items()))

    def state_dict(self) -> Dict[str, int]:
        return self.totals()

    def load_state(self, state: Dict[str, int]) -> None:
        self._dev = {}
        self._host = {str(k): int(v) for k, v in (state or {}).items()}

    def merge(self, other: "CounterPanel") -> None:
        for name, v in other.totals().items():
            self.bump(name, v)
