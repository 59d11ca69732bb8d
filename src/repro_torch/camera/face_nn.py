"""Face-authentication NN (paper §III-A), inference: 400-8-1 MLP, 8-bit
datapath, 256-entry LUT sigmoid.

The port of the JAX package's ``camera/face_nn.py`` without training:
float, LUT and fake-quantized forward paths.  The int8 datapath of the
funnel is ``kernels.quant_matmul.ops.nn_forward_quantized``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.reduction import quantize_bits
from repro_torch.device import resolve_device
from repro_torch.kernels.quant_matmul.ref import lut_index


@dataclasses.dataclass
class FaceNN:
    w1: torch.Tensor     # (in, hidden)
    b1: torch.Tensor
    w2: torch.Tensor     # (hidden, 1)
    b2: torch.Tensor

    @property
    def topology(self):
        return (self.w1.shape[0], self.w1.shape[1], 1)

    @property
    def macs(self):
        return int(self.w1.numel() + self.w2.numel())


def sigmoid_exact(x):
    return torch.sigmoid(x)


def make_sigmoid_lut(entries: int = 256, lo: float = -8.0, hi: float = 8.0,
                     *, device=None):
    """The hardware LUT: ``entries`` samples of sigmoid over [lo, hi]
    (computed in numpy float32, as the reference does), with its
    (lo, hi, entries) meta."""
    xs = np.linspace(lo, hi, entries, dtype=np.float32)
    lut = torch.as_tensor(1.0 / (1.0 + np.exp(-xs)),
                          device=resolve_device(device))
    return lut, (lo, hi, entries)


def sigmoid_lut(x, lut, meta):
    lo, hi, entries = meta
    return lut[lut_index(x, lo, hi, entries)]


def forward_float(nn: FaceNN, x, act=sigmoid_exact):
    h = act(x @ nn.w1 + nn.b1)
    return act(h @ nn.w2 + nn.b2)[..., 0]


def forward_lut(nn: FaceNN, x, lut, meta):
    h = sigmoid_lut(x @ nn.w1 + nn.b1, lut, meta)
    return sigmoid_lut(h @ nn.w2 + nn.b2, lut, meta)[..., 0]


def forward_quantized(nn: FaceNN, x, bits: int, lut, meta):
    """ASIC emulation: weights and activations fake-quantized to ``bits``,
    float MACs, LUT sigmoid."""
    w1 = quantize_bits(nn.w1, bits, block=nn.w1.shape[0])
    w2 = quantize_bits(nn.w2, bits, block=nn.w2.shape[0])
    xq = quantize_bits(x, bits, block=x.shape[-1])
    h = sigmoid_lut(xq @ w1 + nn.b1, lut, meta)
    hq = quantize_bits(h, bits, block=h.shape[-1])
    return sigmoid_lut(hq @ w2 + nn.b2, lut, meta)[..., 0]
