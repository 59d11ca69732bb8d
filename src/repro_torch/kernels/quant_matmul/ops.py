"""The int8 GEMM entry points and the 400-8-1 face-auth NN on them
(paper §III-A).

* :func:`quant_matmul` quantizes float operands per call (data-dependent
  scales), so the rescale and the LUT run after the kernel;
* :func:`quant_matmul_static` is the ASIC path: pre-quantized operands
  with calibrated scales, bias and the LUT sigmoid inside the kernel;
* :func:`nn_forward_quantized` is the whole 400-8-1 NN, quantizers
  included: one launch of the NN kernel on the card, two GEMMs with the
  quantizers between them on the CPU.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version.  LUT indexing is driven by the ``(lo, hi, entries)`` meta of
``camera.face_nn.make_sigmoid_lut`` everywhere.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.reduction import div_const
from repro_torch.device import as_tensor, resolve_device, to_numpy
from repro_torch.kernels.quant_matmul.cuda import (
    NNArgs,
    quant_matmul_cuda,
    quant_nn_cuda,
)
from repro_torch.kernels.quant_matmul.ref import (
    lut_index,
    nn_forward_ref,
    quant_matmul_ref,
    quantize_static,
)


def _meta_or_default(lut, meta):
    """(lo, hi, entries) — default is make_sigmoid_lut's default range."""
    if meta is None:
        return (-8.0, 8.0, int(lut.shape[0]))
    lo, hi, entries = meta
    if int(entries) != int(lut.shape[0]):
        raise ValueError(f"lut has {lut.shape[0]} entries, meta says {entries}")
    return (float(lo), float(hi), int(entries))


def _gemm(x_q, w_q, lut, **kw):
    if x_q.device.type == "cuda":
        return quant_matmul_cuda(x_q, w_q, lut, **kw)
    return quant_matmul_ref(x_q, w_q, lut, **kw)


def symmetric_quantize(x: torch.Tensor, bits: int = 8):
    """Per-tensor symmetric quantization: (int8 values, f32 scale)."""
    qmax = 2 ** (bits - 1) - 1
    scale = div_const(x.abs().max().clamp(min=1e-12), qmax)
    q = torch.round(x / scale).clamp(-qmax, qmax).to(torch.int8)
    return q, scale


def quant_matmul(x, w, lut, *, meta=None, apply_lut=True, device=None):
    """f32 in, int8 compute; the data-dependent rescale and the optional
    LUT run after the kernel."""
    x = as_tensor(x, device, torch.float32)
    w = as_tensor(w, None, torch.float32).to(x.device)
    lut = torch.as_tensor(lut, dtype=torch.float32, device=x.device)
    lo, hi, entries = _meta_or_default(lut, meta)
    x_q, sx = symmetric_quantize(x)
    w_q, sw = symmetric_quantize(w)
    out = _gemm(x_q.contiguous(), w_q.contiguous(), lut, scale=1.0,
                apply_lut=False)
    y = out * (sx * sw)
    if apply_lut:
        y = lut[lut_index(y, lo, hi, entries)]
    return y


def quant_matmul_static(x_q, w_q, lut, *, scale_x: float, scale_w: float,
                        bias=None, meta=None, apply_lut=True, device=None):
    """Pre-quantized operands with calibrated scales; rescale
    (``f32(scale_x * scale_w)``), bias and LUT inside the kernel."""
    x_q = as_tensor(x_q, device, torch.int8).contiguous()
    dev = x_q.device
    w_q = torch.as_tensor(w_q, dtype=torch.int8, device=dev).contiguous()
    lut = torch.as_tensor(lut, dtype=torch.float32, device=dev).contiguous()
    lo, hi, _entries = _meta_or_default(lut, meta)
    if bias is not None:
        bias = torch.as_tensor(bias, dtype=torch.float32,
                               device=dev).contiguous()
    return _gemm(x_q, w_q, lut, scale=float(np.float32(scale_x * scale_w)),
                 bias=bias, apply_lut=apply_lut, lut_lo=lo, lut_hi=hi)


# ---------------------------------------------------------------------------
# The 400-8-1 face-auth NN on the int8 kernel (paper §III-A datapath)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuantizedNN:
    """Statically calibrated int8 parameters of the 400-8-1 face NN:
    int8 weights and f32 biases on one device, scales as Python floats."""

    w1_q: torch.Tensor    # (n_in, n_hidden) int8
    b1: torch.Tensor      # (n_hidden,) f32
    w2_q: torch.Tensor    # (n_hidden, 1) int8
    b2: torch.Tensor      # (1,) f32
    scale_x: float        # input-pixel quantization step
    scale_w1: float
    scale_h: float        # hidden (sigmoid output in [0, 1]) step
    scale_w2: float
    bits: int = 8
    # the NN kernel's converted arguments for the last LUT (kernel_args)
    _kernel_cache: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1

    def scales(self) -> dict:
        return dict(scale_x=self.scale_x, scale_w1=self.scale_w1,
                    scale_h=self.scale_h, scale_w2=self.scale_w2,
                    qmax=self.qmax)

    def kernel_args(self, lut: torch.Tensor, lo: float, hi: float) -> NNArgs:
        """The NN kernel's arguments for this LUT, converted at the first
        call with it and kept: later calls pay no conversions."""
        args = self._kernel_cache.get("args")
        if (args is None or args.lut is not lut
                or (args.lo, args.hi) != (lo, hi)):
            args = self._kernel_cache["args"] = NNArgs(
                self.w1_q.contiguous(), self.b1.contiguous(),
                self.w2_q.contiguous(), self.b2.contiguous(), lut,
                lo=lo, hi=hi, **self.scales())
        return args


def quantize_nn(nn, *, bits: int = 8, x_max: float = 1.0,
                device=None) -> QuantizedNN:
    """Offline calibration, as the JAX package's ``quantize_nn``: per-tensor
    symmetric weight scales, activation scales from the known ranges
    (pixels in [0, ``x_max``], sigmoid outputs in [0, 1]).

    ``nn`` is duck-typed (``w1``/``b1``/``w2``/``b2`` as tensors or
    arrays).  The result lives on ``device``; when None, on the device of
    ``nn.w1`` if that is a tensor, else on the card."""
    if device is None and isinstance(nn.w1, torch.Tensor):
        device = nn.w1.device
    dev = resolve_device(device)
    qmax = 2 ** (bits - 1) - 1
    w1 = to_numpy(nn.w1).astype(np.float32)
    w2 = to_numpy(nn.w2).astype(np.float32)
    sw1 = float(max(np.abs(w1).max(), 1e-12)) / qmax
    sw2 = float(max(np.abs(w2).max(), 1e-12)) / qmax

    def q8(a):
        return torch.as_tensor(np.clip(np.round(a), -qmax, qmax)
                               .astype(np.int8), device=dev)

    def f32(a):
        return torch.as_tensor(to_numpy(a).astype(np.float32), device=dev)

    return QuantizedNN(
        w1_q=q8(w1 / sw1), b1=f32(nn.b1), w2_q=q8(w2 / sw2), b2=f32(nn.b2),
        scale_x=float(x_max) / qmax, scale_w1=sw1, scale_h=1.0 / qmax,
        scale_w2=sw2, bits=bits)


def nn_forward_quantized(qnn: QuantizedNN, x, lut, meta=None):
    """The NN, quantizers included: (..., n_in) f32 -> (...,) f32, on the
    device of ``qnn``'s weights (one NN-kernel launch on the card)."""
    lo, hi, _entries = _meta_or_default(lut, meta)
    dev = qnn.w1_q.device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    lut = torch.as_tensor(lut, dtype=torch.float32, device=dev).contiguous()
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if dev.type == "cuda":
        y = quant_nn_cuda(x2, qnn.kernel_args(lut, lo, hi))
    else:
        y = nn_forward_ref(x2, qnn.w1_q, qnn.b1, qnn.w2_q, qnn.b2, lut,
                           lut_lo=lo, lut_hi=hi, **qnn.scales())
    return y.reshape(lead)
