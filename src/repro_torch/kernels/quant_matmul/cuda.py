"""Wrappers of the CUDA int8 kernels (``csrc/quant_matmul.cu``): the
general GEMM and the whole 400-8-1 NN in one launch."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

NAME = "quant_matmul"
NN_NAME = "quant_nn"
SOURCE = "src/repro_torch/csrc/quant_matmul.cu"
REPLACES = {NAME: "src/repro/kernels/quant_matmul/kernel.py:55",
            NN_NAME: "src/repro/kernels/quant_matmul/kernel.py:55"}
N_HIDDEN = 8          # the NN kernel's hidden width: one mma n8 tile

_fns: dict = {}


def _kernel(name):
    if name not in _fns:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        argtypes = {
            "repro_quant_matmul": [p, p, p, p, i, i, i, i, f, i, f, f, p, p],
            "repro_quant_nn": [p, p, p, p, p, p, i, i, i, f, f, f, f, f, f,
                               f, p, p]}[name]
        _fns[name] = _build.bind(name, argtypes)
    return _fns[name]


def quant_matmul_cuda(x_q, w_q, lut, *, scale: float, bias=None,
                      apply_lut: bool = True, lut_lo: float = -8.0,
                      lut_hi: float = 8.0) -> torch.Tensor:
    """Argument contract of ``ref.quant_matmul_ref``, on one CUDA device."""
    dev = x_q.device
    if dev.type != "cuda":
        raise ValueError("quant_matmul_cuda needs CUDA tensors")
    _build.require(x_q, "x_q", torch.int8, 2, dev)
    _build.require(w_q, "w_q", torch.int8, 2, dev)
    _build.require(lut, "lut", torch.float32, 1, dev)
    m, k = x_q.shape
    if w_q.shape[0] != k:
        raise ValueError(f"x_q {tuple(x_q.shape)} and w_q "
                         f"{tuple(w_q.shape)} do not chain")
    n = w_q.shape[1]
    if bias is not None:
        _build.require(bias, "bias", torch.float32, 1, dev)
        if bias.shape[0] != n:
            raise ValueError(f"bias has {bias.shape[0]} entries, need {n}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    rc = _kernel("repro_quant_matmul")(
        _build.ptr(x_q), _build.ptr(w_q),
        None if bias is None else _build.ptr(bias), _build.ptr(lut),
        lut.shape[0], m, k, n, float(np.float32(scale)), int(apply_lut),
        float(np.float32(lut_lo)), float(np.float32(lut_hi - lut_lo)),
        _build.ptr(out), _build.stream_of(x_q))
    _build.check(rc, NAME)
    _build.launches[NAME] += 1
    return out


class NNArgs:
    """The NN kernel's operands and scalar arguments, checked and converted
    once (``QuantizedNN.kernel_args``), so that a call costs one ctypes
    call and one ``torch.empty``."""

    def __init__(self, w1_q, b1, w2_q, b2, lut, *, scale_x, scale_w1,
                 scale_h, scale_w2, qmax, lo, hi):
        dev = w1_q.device
        if dev.type != "cuda":
            raise ValueError("the NN kernel needs CUDA tensors")
        k = w1_q.shape[0]
        for t, name, dtype, shape in (
                (w1_q, "w1_q", torch.int8, (k, N_HIDDEN)),
                (b1, "b1", torch.float32, (N_HIDDEN,)),
                (w2_q, "w2_q", torch.int8, (N_HIDDEN, 1)),
                (b2, "b2", torch.float32, (1,)),
                (lut, "lut", torch.float32, (lut.shape[0],))):
            _build.require(t, name, dtype, len(shape), dev)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} is {tuple(t.shape)}, the NN kernel "
                                 f"takes {shape}")
        if k % 4:
            raise ValueError(f"the NN kernel takes n_in % 4 == 0, got {k}")
        f32 = np.float32
        self.device, self.k, self.lut, self.lo, self.hi = dev, k, lut, lo, hi
        # w1 k-major, zero-padded to a multiple of 32 (the kernel's k-steps)
        w1t = torch.zeros((N_HIDDEN, -(-k // 32) * 32), dtype=torch.int8,
                          device=dev)
        w1t[:, :k] = w1_q.t()
        self.tensors = (w1t, b1, w2_q, b2)           # kept alive
        self.args = (
            _build.ptr(w1t), _build.ptr(b1), _build.ptr(w2_q),
            _build.ptr(b2), _build.ptr(lut), lut.shape[0])
        self.scalars = tuple(float(v) for v in (
            f32(1) / f32(scale_x), f32(scale_x * scale_w1),
            f32(1) / f32(scale_h), f32(scale_h * scale_w2), f32(qmax),
            f32(lo), f32(hi - lo)))


def quant_nn_cuda(x: torch.Tensor, nn: NNArgs) -> torch.Tensor:
    """(m, n_in) float32 CUDA rows -> (m,) float32: the two-layer
    ``ref.nn_forward_ref`` in one launch."""
    if x.device.type != "cuda":
        raise ValueError("quant_nn_cuda needs CUDA tensors")
    _build.require(x, "x", torch.float32, 2, nn.device)
    if x.shape[1] != nn.k:
        raise ValueError(f"x has {x.shape[1]} inputs, the NN {nn.k}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    m = x.shape[0]
    out = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    rc = _kernel("repro_quant_nn")(
        _build.ptr(x), *nn.args, m, nn.k, *nn.scalars, _build.ptr(out),
        _build.stream_of(x))
    _build.check(rc, NN_NAME)
    _build.launches[NN_NAME] += 1
    return out
