"""The int8 kernels of ``csrc/quant_matmul.cu`` on the CPU: the NN's plain
path against the JAX package, and numpy emulations of both kernels' tile
arithmetic against the plain versions.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them to the
plain versions bit for bit there).  What the emulations pin down here is
the arithmetic the kernels do in another order than the plain versions:
k zero-padded to a multiple of 32 in shared memory, int32 sums per
32-deep step (split over warps in the NN kernel), w turned k-major by the
kernel's own byte permutes, the NN's x tile held flat (a row's padded
k-step reads the next row, against zero weights), the quantizer's
round-half-to-even, and layer 2 as a butterfly sum over a quad.  Integer
sums are exact in any order, so each emulation must equal the plain
version bit for bit.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.camera.face_nn import init_face_nn
from repro.camera.face_nn import make_sigmoid_lut as jax_lut
from repro.kernels.quant_matmul import ops as jops

from repro_torch.kernels import _build
from repro_torch.kernels.quant_matmul import cuda as qcuda
from repro_torch.kernels.quant_matmul import ops as tops
from repro_torch.kernels.quant_matmul.ref import (
    nn_forward_ref,
    quant_matmul_ref,
)

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

f32 = np.float32
SOURCE = Path(__file__).resolve().parents[1] / qcuda.SOURCE


def _t(a):
    return torch.from_numpy(np.array(a))


def epilogue(acc, scale, bias, lut, lo, hi, apply_lut=True):
    """The kernels' epilogue, one IEEE float32 step at a time."""
    y = acc.astype(f32) * f32(scale)
    if bias is not None:
        y = y + bias.astype(f32)
    if apply_lut:
        top = f32(lut.shape[0] - 1)
        t = (y - f32(lo)) / f32(hi - lo) * top
        y = lut[np.clip(t, f32(0), top).astype(np.int64)]
    return y.astype(f32)


def quantize(x, scale, qmax):
    """The NN kernel's quantizer: rintf(x * f32(1 / f32(scale))), clamped."""
    q = np.rint(x.astype(f32) * (f32(1) / f32(scale)))
    return np.clip(q, -qmax, qmax).astype(np.int32)


# -- the byte permutes that turn w k-major ----------------------------------

def byte_perm(x, y, s):
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of
    the 8-byte value y:x."""
    src = int(x) | (int(y) << 32)
    return sum(((src >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def transpose_selectors():
    """The four selectors of the kernel's 4 x 4 transpose, in source order:
    two that interleave a pair of rows, two that gather the result."""
    sels = [int(s, 16) for s in re.findall(
        r"__byte_perm\(\w+, \w+, (0x[0-9a-fA-F]+)\)", SOURCE.read_text())]
    assert len(sels) == 8, sels
    return sels[0], sels[2], sels[4], sels[5]      # lo, hi, gather a, gather b


def k_major_tile(w4):
    """(4, 4) int8 block of w (rows k, columns n) -> its (n, k) transpose,
    by the kernel's byte permutes on the four little-endian row words."""
    lo, hi, ga, gb = transpose_selectors()
    r = [int.from_bytes(w4[i].astype(np.int8).tobytes(), "little")
         for i in range(4)]
    lo01, lo23 = byte_perm(r[0], r[1], lo), byte_perm(r[2], r[3], lo)
    hi01, hi23 = byte_perm(r[0], r[1], hi), byte_perm(r[2], r[3], hi)
    out = [byte_perm(lo01, lo23, ga), byte_perm(lo01, lo23, gb),
           byte_perm(hi01, hi23, ga), byte_perm(hi01, hi23, gb)]
    return np.stack([np.frombuffer(o.to_bytes(4, "little"), np.int8)
                     for o in out])


def test_byte_permutes_transpose():
    rng = np.random.default_rng(0)
    for _ in range(20):
        w4 = rng.integers(-128, 128, (4, 4)).astype(np.int8)
        np.testing.assert_array_equal(k_major_tile(w4), w4.T)


# -- the GEMM ---------------------------------------------------------------

def gemm_emulation(x_q, w_q, lut, *, scale, bias=None, apply_lut=True,
                   lo=-8.0, hi=8.0, bk=64):
    """``repro_quant_matmul``'s tiles: k zero-padded to the k tile (a
    multiple of 32), w turned k-major 4 x 4 blocks at a time, int32 sums
    per 32-deep step, then the epilogue."""
    m, k = x_q.shape
    n = w_q.shape[1]
    kp = -(-k // bk) * bk
    xs = np.zeros((m, kp), np.int32)
    xs[:, :k] = x_q
    wpad = np.zeros((kp, -(-n // 4) * 4), np.int8)
    wpad[:k, :n] = w_q
    wt = np.zeros(wpad.shape[::-1], np.int32)
    for k4 in range(0, kp, 4):
        for n4 in range(0, wpad.shape[1], 4):
            wt[n4:n4 + 4, k4:k4 + 4] = k_major_tile(wpad[k4:k4 + 4, n4:n4 + 4])
    acc = np.zeros((m, wt.shape[0]), np.int32)
    for k0 in range(0, kp, 32):
        acc += xs[:, k0:k0 + 32] @ wt[:, k0:k0 + 32].T
    return epilogue(acc[:, :n], scale, bias, lut, lo, hi, apply_lut)


@pytest.mark.parametrize("m,k,n", [(17, 33, 9), (5, 400, 8), (1, 400, 8),
                                   (70, 96, 130), (33, 64, 1)])
@pytest.mark.parametrize("apply_lut", [True, False])
def test_gemm_tile_emulation_equals_plain(m, k, n, apply_lut):
    rng = np.random.default_rng(m * k + n)
    x_q = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    bias = rng.normal(size=n).astype(f32)
    lut, (lo, hi, _e) = jax_lut()
    lut = np.asarray(lut)
    scale = f32(0.003 * 0.0021)
    got = gemm_emulation(x_q, w_q, lut, scale=scale, bias=bias,
                         apply_lut=apply_lut, lo=lo, hi=hi)
    want = quant_matmul_ref(_t(x_q), _t(w_q), _t(lut), scale=float(scale),
                            bias=_t(bias), apply_lut=apply_lut, lut_lo=lo,
                            lut_hi=hi).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# -- the whole NN in one launch ---------------------------------------------

ROWS, WARPS = 16, 4          # quant_nn_kernel's tile and warps


def nn_emulation(x, qnn, lut, lo, hi):
    """``repro_quant_nn``: per 16-row tile the float32 rows quantized into
    one flat int8 buffer (row r at r * k, 32 zero bytes after the last);
    w1 k-major, zero-padded to a multiple of 32; layer 1's k-steps dealt
    to 4 warps and their int32 sums added; epilogue 1, the hidden
    quantizer; layer 2 as each quad thread's two products, summed by the
    butterfly xor 1, xor 2; epilogue 2."""
    w1 = qnn.w1_q.numpy().astype(np.int32)
    w2 = qnn.w2_q.numpy()[:, 0].astype(np.int32)
    b1, b2 = qnn.b1.numpy(), qnn.b2.numpy()
    m, k = x.shape
    kp = -(-k // 32) * 32
    w1t = np.zeros((8, kp), np.int32)
    w1t[:, :k] = w1.T
    s1 = f32(qnn.scale_x * qnn.scale_w1)
    s2 = f32(qnn.scale_h * qnn.scale_w2)
    out = np.zeros(m, f32)
    for m0 in range(0, m, ROWS):
        rows = x[m0:m0 + ROWS]
        flat = np.zeros(ROWS * k + 32, np.int32)
        flat[:rows.size] = quantize(rows.reshape(-1), qnn.scale_x, qnn.qmax)
        a = np.stack([flat[r * k:r * k + kp] for r in range(ROWS)])
        acc = np.zeros((ROWS, 8), np.int32)
        for warp in range(WARPS):
            part = np.zeros((ROWS, 8), np.int32)
            for k0 in range(32 * warp, kp, 32 * WARPS):
                part += a[:, k0:k0 + 32] @ w1t[:, k0:k0 + 32].T
            acc += part
        h = epilogue(acc, s1, b1, lut, lo, hi)
        hq = quantize(h, qnn.scale_h, qnn.qmax)
        quad = hq[:, 0::2] * w2[0::2] + hq[:, 1::2] * w2[1::2]  # (16, 4 t)
        for off in (1, 2):
            quad = quad + quad[:, np.arange(4) ^ off]
        y = epilogue(quad[:, 0], s2, b2, lut, lo, hi)
        out[m0:m0 + ROWS] = y[:len(rows)]
    return out


def _nn(seed, n_in=400):
    nn = init_face_nn(jax.random.PRNGKey(seed), n_in=n_in)
    return nn, tops.quantize_nn(nn, device="cpu")


def _pixels(m, n_in, seed):
    """Pixels in [0, 1], half of the rows next to the quantizer's ties."""
    rng = np.random.default_rng(seed)
    x = rng.random((m, n_in), dtype=f32)
    ties = ((np.arange(m * n_in) % 127) + 0.5).astype(f32) / f32(127)
    ties = np.nextafter(ties, rng.choice([0.0, 2.0], ties.shape).astype(f32))
    x[: m // 2] = ties.reshape(m, n_in)[: m // 2]
    return x


@pytest.mark.parametrize("m", [1, 17, 200])
def test_nn_plain_path_equals_jitted_jax(m):
    """The NN kernel's plain version (the CPU route of
    ``nn_forward_quantized``) gives the bits of the JAX package's jitted
    ``nn_forward_quantized``, ties of the input quantizer included."""
    nn, qt = _nn(m)
    qj = jops.quantize_nn(nn)
    lut, meta = jax_lut()
    x = _pixels(m, 400, m)
    f = jax.jit(lambda a: jops.nn_forward_quantized(qj, a, lut, meta,
                                                    use_pallas=False))
    want = np.asarray(f(jnp.asarray(x)))
    before = dict(_build.launches)
    got = tops.nn_forward_quantized(qt, _t(x), _t(lut), meta).numpy()
    assert dict(_build.launches) == before
    assert got.shape == (m,)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("m,n_in", [(17, 400), (5, 400), (40, 400),
                                    (33, 64), (3, 36)])
def test_nn_tile_emulation_equals_plain(m, n_in):
    _nn_jax, qt = _nn(m + n_in, n_in)
    lut, (lo, hi, _e) = jax_lut()
    lut = np.asarray(lut)
    x = _pixels(m, n_in, m)
    got = nn_emulation(x, qt, lut, lo, hi)
    want = nn_forward_ref(_t(x), qt.w1_q, qt.b1, qt.w2_q, qt.b2, _t(lut),
                          lut_lo=lo, lut_hi=hi, **qt.scales()).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_nn_lead_dims_and_meta():
    """``nn_forward_quantized`` keeps the leading shape and checks the LUT
    against its meta."""
    _nn_jax, qt = _nn(3)
    lut, meta = jax_lut()
    x = _pixels(12, 400, 3).reshape(2, 3, 2, 400)
    got = tops.nn_forward_quantized(qt, _t(x), _t(lut), meta)
    assert got.shape == (2, 3, 2)
    flat = tops.nn_forward_quantized(qt, _t(x.reshape(12, 400)), _t(lut),
                                     meta)
    torch.testing.assert_close(got.reshape(-1), flat, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tops.nn_forward_quantized(qt, _t(x), _t(lut), (-8.0, 8.0, 128))


def test_nn_wrapper_refuses_cpu_tensors():
    _nn_jax, qt = _nn(4)
    lut, (lo, hi, _e) = jax_lut()
    with pytest.raises(ValueError, match="CUDA"):
        qcuda.NNArgs(qt.w1_q, qt.b1, qt.w2_q, qt.b2, _t(lut), lo=lo, hi=hi,
                     **qt.scales())
    with pytest.raises(ValueError, match="CUDA"):
        qcuda.quant_nn_cuda(torch.zeros((2, 400)), None)
