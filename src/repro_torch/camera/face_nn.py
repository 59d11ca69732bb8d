"""Face-authentication NN (paper §III-A): 400-8-1 MLP, 8-bit datapath,
256-entry LUT sigmoid.

The port of the JAX package's ``camera/face_nn.py``: initialization and
Adam training (an explicit ``torch.Generator`` where the reference takes a
JAX key), the classification error, the float, LUT and fake-quantized
forward paths, and the §III ASIC energy model.  The int8 datapath of the
funnel is ``kernels.quant_matmul.ops.nn_forward_quantized``.

Training splits the reference's loop in two: :func:`draw_batches` draws
the (steps, 128) batch-index schedule, and :func:`fit_face_nn` runs Adam
over a given schedule from given initial weights, so a schedule and
weights drawn elsewhere (the JAX package's, carried by
``bridge.load_train_reference``) train the reference's NN.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.reduction import quantize_bits
from repro_torch.device import as_tensor, resolve_device, to_numpy
from repro_torch.kernels.quant_matmul.ref import lut_index
from repro_torch.models.layers import pin_matmul_precision


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


def init_face_nn(generator: torch.Generator, n_in: int = 400,
                 n_hidden: int = 8, *, device=None) -> FaceNN:
    """Normal weights scaled by 1/sqrt(fan-in), zero biases.  ``generator``
    is a CPU generator, so every device gets the same draws; the tensors go
    to ``device`` (the card when None)."""
    dev = resolve_device(device)
    w1 = torch.randn(n_in, n_hidden, generator=generator) * (
        1.0 / np.sqrt(n_in))
    w2 = torch.randn(n_hidden, 1, generator=generator) * (
        1.0 / np.sqrt(n_hidden))
    return FaceNN(w1=w1.to(dev), b1=torch.zeros(n_hidden, device=dev),
                  w2=w2.to(dev), b2=torch.zeros(1, device=dev))


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


# -- training -----------------------------------------------------------------


def draw_batches(generator: torch.Generator, steps: int, n: int,
                 batch: int = 128) -> torch.Tensor:
    """The batch-index schedule: (steps, batch) int64 indices into n
    training windows, uniform with replacement, from a CPU generator."""
    return torch.randint(0, n, (steps, batch), generator=generator)


def _loss(params, xb, yb, l2: float):
    """The reference's loss: the numerically stable binary cross-entropy
    of the output logit, plus ``l2 * (sum(w1^2) + sum(w2^2))``."""
    w1, b1, w2, b2 = params
    h = torch.sigmoid(xb @ w1 + b1)
    logit = (h @ w2 + b2)[..., 0]
    ce = torch.mean(torch.clamp(logit, min=0) - logit * yb
                    + torch.log1p(torch.exp(-torch.abs(logit))))
    return ce + l2 * (torch.sum(w1 * w1) + torch.sum(w2 * w2))


def fit_face_nn(nn: FaceNN, X, y, batches, lr: float = 3e-3,
                l2: float = 1e-4) -> FaceNN:
    """Adam from the weights of ``nn`` over the batch-index schedule
    ``batches`` (steps, batch), on the weights' device.  The update is the
    reference's, operation for operation: m, v, the bias corrections, then
    ``p - lr * mh / (sqrt(vh) + 1e-8)`` (``torch.optim.Adam`` rounds in
    another order).  Matrix products stay float32 on the card
    (``pin_matmul_precision``: no TF32)."""
    dev = nn.w1.device
    pin_matmul_precision()
    Xd = as_tensor(X, dev, torch.float32)
    yd = as_tensor(y, dev).to(torch.float32)
    batches = torch.as_tensor(batches, device=dev).long()
    params = [p.detach().clone() for p in (nn.w1, nn.b1, nn.w2, nn.b2)]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]

    def scalar(x):
        # a device tensor: CUDA divides by a host scalar as a multiply by
        # its reciprocal
        return torch.tensor(x, dtype=torch.float32, device=dev)

    for t in range(1, len(batches) + 1):
        idx = batches[t - 1]
        ps = [p.requires_grad_() for p in params]
        grads = torch.autograd.grad(_loss(ps, Xd[idx], yd[idx], l2), ps)
        # the bias corrections in float32, as the reference's jitted step
        c1 = scalar(1 - np.float32(0.9) ** np.float32(t))
        c2 = scalar(1 - np.float32(0.999) ** np.float32(t))
        with torch.no_grad():
            for i, g in enumerate(grads):
                m[i] = 0.9 * m[i] + 0.1 * g
                v[i] = 0.999 * v[i] + 0.001 * g * g
                mh, vh = m[i] / c1, v[i] / c2
                params[i] = ps[i].detach() - lr * mh / (torch.sqrt(vh) + 1e-8)
    w1, b1, w2, b2 = params
    return FaceNN(w1=w1, b1=b1, w2=w2, b2=b2)


def train_face_nn(X, y, n_hidden: int = 8, steps: int = 3000,
                  lr: float = 3e-3, seed: int = 0, l2: float = 1e-4, *,
                  device=None) -> FaceNN:
    """Initial weights from a generator seeded ``seed``, the schedule from
    one seeded ``seed + 1``, then :func:`fit_face_nn` on ``device`` (the
    card when None)."""
    X = np.asarray(X, np.float32)
    nn = init_face_nn(torch.Generator().manual_seed(seed), X.shape[1],
                      n_hidden, device=device)
    batches = draw_batches(torch.Generator().manual_seed(seed + 1), steps,
                           len(X))
    return fit_face_nn(nn, X, y, batches, lr=lr, l2=l2)


def classification_error(scores, y, threshold: float = 0.5) -> float:
    pred = to_numpy(scores) >= threshold
    return float((pred != (np.asarray(y) == 1)).mean())


# -- energy model (paper Table I + §III-A) -----------------------------------

NN_POWER_8PE_8BIT_W = 393e-6          # Table I
NN_FREQ_HZ = 27.9e6
NN_PES = 8


def nn_time_per_window(macs: int, n_pes: int = NN_PES,
                       n_hidden: int = 8) -> float:
    """Systolic schedule: macs spread over the PEs, one MAC a PE a cycle,
    plus a drain; PEs beyond the hidden width sit idle (§III-A)."""
    eff = min(n_pes, n_hidden)
    cycles = int(np.ceil(macs / eff)) + 32
    return cycles / NN_FREQ_HZ


def nn_power(bits: int = 8, n_pes: int = NN_PES) -> float:
    """Datapath-width and geometry scaling around the Table I point: 16 ->
    8 bits saves 41% at 8 PEs, width linear in bits through the two
    anchors, PEs linear above a fixed sequencer overhead."""
    p8 = NN_POWER_8PE_8BIT_W
    p16 = p8 / 0.59
    slope = (p16 - p8) / 8.0               # watts per extra bit
    p_width = p8 + slope * (bits - 8)
    fixed = 0.25 * p8                      # sequencer + control overhead
    return fixed + (p_width - fixed) * (n_pes / NN_PES)


def nn_energy_per_window(macs: int, bits: int = 8,
                         n_pes: int = NN_PES) -> float:
    return nn_power(bits, n_pes) * nn_time_per_window(macs, n_pes)
