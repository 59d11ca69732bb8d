"""The port's wire codec against the JAX package's.

The port's plain codec (what a CPU tensor runs, and what the CUDA kernels
are held against on the card) must give the JAX package's jitted
``wire_encode`` / ``wire_decode`` bit for bit: packed bytes, scales and
decoded values, through the JAX oracle and through the Pallas kernel in
interpret mode.  Under ``jit`` the JAX scale ``absmax / qmax`` is computed
as ``absmax * f32(1/qmax)``; the sweep below is made of blocks where the
two differ, so a port that divided would fail it.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core.reduction import dequantize_int8 as jax_dequantize_int8
from repro.core.reduction import quantize_int8 as jax_quantize_int8
from repro.kernels.wire_codec import ops as jops

from repro_torch.core.reduction import dequantize_int8, quantize_int8
from repro_torch.kernels.wire_codec import cuda as wcuda
from repro_torch.kernels.wire_codec import ops as tops
from repro_torch.kernels.wire_codec.cuda import (
    wire_decode_cuda,
    wire_encode_cuda,
)
from repro_torch.kernels.wire_codec.ref import (
    pack_ref,
    quantize_blocks_ref,
    unpack_ref,
)

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

ROUTES = ("oracle", "pallas")


def _jax_encode(x, bits, route, block=256):
    return jops.wire_encode(jnp.asarray(x), bits=bits, block=block,
                            use_pallas=route == "pallas",
                            interpret=route == "pallas")


def _jax_decode(p, s, shape, bits, route, block=256):
    return jops.wire_decode(jnp.asarray(p), jnp.asarray(s), tuple(shape),
                            bits=bits, block=block,
                            use_pallas=route == "pallas",
                            interpret=route == "pallas")


def _assert_codec_equal(x, bits, route, block=256):
    """Encode and decode ``x`` in both packages; bit-equal bytes, scales
    and values.  Returns the port's (packed, scales)."""
    jp, js = _jax_encode(x, bits, route, block)
    tp, ts = tops.wire_encode(torch.from_numpy(x), bits=bits, block=block)
    assert tp.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    jy = _jax_decode(jp, js, x.shape, bits, route, block)
    ty = tops.wire_decode(tp, ts, x.shape, bits=bits, block=block)
    np.testing.assert_array_equal(ty.numpy().view(np.int32),
                                  np.asarray(jy).view(np.int32))
    return tp, ts


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("shape", [(512,), (3, 97), (7, 20, 20), (1,),
                                   (40, 256), (5, 333)])
def test_codec_bit_equal_to_jax(shape, bits, route):
    """Random payloads, with a partial last block where the size is not a
    multiple of 256, and negative values."""
    x = (np.random.default_rng(11).standard_normal(shape) * 11.0).astype(
        np.float32)
    tp, ts = _assert_codec_equal(x, bits, route)
    assert tp.shape == (-(-x.size // 256), 256 * bits // 8)
    assert ts.shape == (tp.shape[0], 1)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_zero_block_and_extremes(bits, route):
    x = np.concatenate([np.zeros(256), [127.0, -127.0, 1e-8, -1e-8],
                        np.zeros(252)]).astype(np.float32)
    tp, ts = _assert_codec_equal(x, bits, route)
    assert float(ts[0, 0]) == 1.0                  # an all-zero block
    assert not tp[0].any()


def _tie_blocks(bits, rng, n_blocks=64):
    """Blocks whose values sit on exact half-steps of their scale, so
    ``x / scale`` is k + 0.5 exactly and round-half-to-even decides."""
    qmax = 2 ** (bits - 1) - 1
    r = np.float32(1.0) / np.float32(qmax)
    blocks = np.zeros((n_blocks, 256), np.float32)
    for i in range(n_blocks):
        a = np.float32(qmax * 2.0 ** int(rng.integers(-6, 4)))
        scale = np.float32(a * r)
        k = rng.integers(-qmax, qmax, 256).astype(np.float32)
        ties = (k + np.float32(0.5)) * scale
        blocks[i] = ties.astype(np.float32)
        blocks[i, 0] = a                           # sets the block's absmax
    return blocks


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_ties_round_half_to_even(bits, route):
    blocks = _tie_blocks(bits, np.random.default_rng(bits))
    qmax = 2 ** (bits - 1) - 1
    scale = (np.abs(blocks).max(1, keepdims=True)
             * (np.float32(1) / np.float32(qmax))).astype(np.float32)
    y = blocks / scale
    exact_ties = np.abs(y - np.floor(y)) == np.float32(0.5)
    assert exact_ties.sum() > 1000                 # the crafted ties survive
    _assert_codec_equal(blocks, bits, route)
    q, _s = quantize_blocks_ref(torch.from_numpy(blocks), bits)
    np.testing.assert_array_equal(q.numpy()[exact_ties],
                                  np.round(y[exact_ties]))


def _reciprocal_sweep(bits, n_blocks=4096, seed=0):
    """Blocks whose absmax gives ``absmax / qmax != absmax * f32(1/qmax)``
    in float32."""
    qmax = np.float32(2 ** (bits - 1) - 1)
    rng = np.random.default_rng(seed)
    found = []
    while sum(len(f) for f in found) < n_blocks:
        a = rng.uniform(1e-3, 1e3, 200_000).astype(np.float32)
        div = a / qmax
        mul = a * (np.float32(1.0) / qmax)
        found.append(a[div != mul])
    a = np.concatenate(found)[:n_blocks]
    blocks = (rng.uniform(-1.0, 1.0, (n_blocks, 256)) * a[:, None]).astype(
        np.float32)
    col = rng.integers(0, 256, n_blocks)
    sign = np.where(rng.random(n_blocks) < 0.5, -1.0, 1.0).astype(np.float32)
    blocks[np.arange(n_blocks), col] = sign * a
    return blocks, a


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_scale_is_the_reciprocal_multiply(bits, route):
    blocks, a = _reciprocal_sweep(bits)
    _tp, ts = _assert_codec_equal(blocks, bits, route)
    qmax = np.float32(2 ** (bits - 1) - 1)
    assert (ts.numpy()[:, 0] != a / qmax).all()    # a division would fail
    np.testing.assert_array_equal(ts.numpy()[:, 0],
                                  a * (np.float32(1.0) / qmax))


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_pack_unpack_lossless(bits):
    qmax = 2 ** (bits - 1) - 1
    q = torch.from_numpy(np.random.default_rng(2).integers(
        -qmax, qmax + 1, (6, 256)).astype(np.int32))
    assert torch.equal(unpack_ref(pack_ref(q, bits), bits), q)


def test_quantize_int8_matches_jitted_reference():
    x = (np.random.default_rng(3).standard_normal((5, 333)) * 7.0).astype(
        np.float32)
    jq, js = jax.jit(lambda v: jax_quantize_int8(v, block=256))(x)
    tq, ts = quantize_int8(torch.from_numpy(x), block=256)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jax.jit(lambda a, b: jax_dequantize_int8(a, b, x.shape))(jq, js)
    td = dequantize_int8(tq, ts, x.shape)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the wire codec at 8 bits is the same quantizer
    y = tops.wire_roundtrip(torch.from_numpy(x), bits=8)
    assert torch.equal(y, td)


def test_wire_bytes_exact():
    for n in (0, 1, 255, 256, 257, 4096, 6138 * 256, 28 * 192 * 400):
        for bits in (None, 4, 8, 16):
            for block in (256, 100):
                assert tops.wire_bytes(n, bits, block=block) == \
                    jops.wire_bytes(n, bits, block=block), (n, bits, block)


@pytest.mark.parametrize("block", [256, 100])
@pytest.mark.parametrize("bits", [None, 4, 8, 16])
def test_wire_bytes_dynamic_bit_equal(bits, block):
    n = np.concatenate([np.arange(-3, 3000), np.random.default_rng(4)
                        .integers(0, 4_000_000, 5000)]).astype(np.int32)
    want = jax.jit(lambda v: jops.wire_bytes_dynamic(v, bits, block=block))(
        jnp.asarray(n))
    got = tops.wire_bytes_dynamic(torch.from_numpy(n), bits, block=block)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


def test_cuda_wrappers_refuse_cpu_tensors():
    """No fallback: the kernels' wrappers take CUDA tensors only."""
    blocks = torch.zeros((2, 256))
    with pytest.raises(ValueError):
        wire_encode_cuda(blocks, 8)
    with pytest.raises(ValueError):
        wire_decode_cuda(torch.zeros((2, 256), dtype=torch.int8),
                         torch.ones((2, 1)), 8)


def test_bad_widths_raise():
    with pytest.raises(ValueError):
        tops.wire_encode(torch.zeros(10), bits=6)


# -- the encode kernel's lane mapping and packing ----------------------------
#
# csrc/wire_codec.cu encodes a block of 256 values with one warp: lane l
# holds values 128 c + 4 l .. + 3 of chunk c = 0, 1 (one float4 each),
# takes the absmax of its values, then 5 butterfly shuffles with a
# NaN-keeping max; it quantizes from registers and stores word 32 c + l of
# the packed row: 4 bytes at 8 bits, 2 at 4 bits, 8 at 16 bits,
# little-endian.  The emulation below does the same in plain PyTorch.


def _nan_max(a, b):
    return torch.where(torch.isnan(a) | (a > b), a, b)


def encode_lane_emulation(blocks, bits):
    nb, block = blocks.shape
    assert block == 256
    C = 2
    qmax = 2 ** (bits - 1) - 1
    v = blocks.reshape(nb, C, 32, 4)                  # chunk, lane, value
    m = torch.zeros((nb, 32))
    for c in range(C):
        for j in range(4):
            m = _nan_max(m, v[:, c, :, j].abs())
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        m = _nan_max(m, m[:, lane ^ off])
    assert torch.equal(m.isnan(), m[:, :1].isnan().expand(-1, 32))
    scale = m[:, :1] * float(np.float32(1.0) / np.float32(qmax))
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    r = torch.round(v / scale[:, :, None, None])
    r = torch.where(r < -qmax, -float(qmax), torch.where(r > qmax,
                                                         float(qmax), r))
    q = torch.where(r.isnan(), 0.0, r).to(torch.int64)   # NaN -> 0, as cvt
    if bits == 8:
        word = sum((q[..., j] & 0xFF) << (8 * j) for j in range(4))
        word = torch.where(word >= 2 ** 31, word - 2 ** 32, word)
        row = word.to(torch.int32).contiguous().view(torch.int8)
    elif bits == 4:
        word = sum((q[..., j] & 0xF) << (4 * j) for j in range(4))
        word = torch.where(word >= 2 ** 15, word - 2 ** 16, word)
        row = word.to(torch.int16).contiguous().view(torch.int8)
    else:
        lo, hi = q & 0xFFFF, (q & 0xFFFF) << 16
        pair = torch.stack([lo[..., 0] | hi[..., 1], lo[..., 2] | hi[..., 3]],
                           -1)
        pair = torch.where(pair >= 2 ** 31, pair - 2 ** 32, pair)
        row = pair.to(torch.int32).contiguous().view(torch.int8)
    return row.reshape(nb, block * bits // 8), scale


def _special_blocks(bits, block):
    """Zero blocks, NaN blocks, half-step ties, values at ±qmax and 3 qmax
    (clamped), random blocks."""
    rng = np.random.default_rng(bits + block)
    zero = np.zeros((2, block), np.float32)
    nan = (rng.standard_normal((3, block)) * 5).astype(np.float32)
    nan[0, 7] = np.nan
    nan[1, :] = np.nan
    nan[2, block - 1] = np.nan
    ties = _tie_blocks(bits, rng, n_blocks=16)
    qmax = 2 ** (bits - 1) - 1
    ends = np.zeros((2, block), np.float32)
    ends[0, ::2], ends[0, 1::2] = qmax, -qmax           # exactly ±qmax
    ends[1] = np.float32(3.0) * ends[0]
    rand = (rng.standard_normal((4, block)) * 11).astype(np.float32)
    return np.concatenate([zero, nan, ties, ends, rand])


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_encode_lane_emulation_special_blocks(bits):
    x = torch.from_numpy(_special_blocks(bits, 256))
    got_p, got_s = encode_lane_emulation(x, bits)
    want_p, want_s = tops.wire_encode(x, bits=bits)
    assert torch.equal(got_p, want_p)
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_encode_lane_emulation_reciprocal_sweep(bits):
    """The 4,096 blocks whose scale a division would round the other
    way."""
    blocks, _a = _reciprocal_sweep(bits)
    x = torch.from_numpy(blocks)
    got_p, got_s = encode_lane_emulation(x, bits)
    want_p, want_s = tops.wire_encode(x, bits=bits)
    assert torch.equal(got_p, want_p)
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))



# -- the decode kernel's lane mapping ----------------------------------------
#
# csrc/wire_codec.cu decodes a block of 256 values with one warp: lane l
# decodes values 128 c + 4 l .. + 3 of chunk c = 0, 1 from one aligned load
# of their packed bytes (2 at 4 bits, 4 at 8, 8 at 16, read as 32-bit
# little-endian words), sign-extends each field by a left shift to bit 31
# and an arithmetic right shift, and multiplies by the block's scale, which
# lane 0 loads and a shuffle broadcasts.  The emulation below does the same
# in numpy.

DECODE_CHUNKS = 2


def decode_lane_emulation(packed, scales, bits):
    packed = np.ascontiguousarray(np.asarray(packed, np.int8)).view(np.uint8)
    scales = np.asarray(scales, np.float32)
    nb, width = packed.shape
    assert width * 8 // bits == 256
    run = 8 // DECODE_CHUNKS                           # values a lane a chunk
    run_bytes = run * bits // 8
    out = np.zeros((nb, 256), np.float32)
    lane_scale = np.broadcast_to(scales[:, :1], (nb, 32))   # lane 0's, shared
    for c in range(DECODE_CHUNKS):
        for lane in range(32):
            v0 = c * 256 // DECODE_CHUNKS + run * lane
            b0 = v0 * bits // 8
            raw = np.zeros((nb, 16), np.uint8)
            raw[:, :run_bytes] = packed[:, b0:b0 + run_bytes]
            words = raw.view("<u4")                        # w.x, w.y, w.z, w.w
            for j in range(run):
                if bits == 4:
                    word, shift, top = words[:, 0], 4 * j, 28
                elif bits == 8:
                    word, shift, top = words[:, j // 4], 8 * (j & 3), 24
                else:
                    word, shift, top = words[:, j // 2], 16 * (j & 1), 16
                up = (word << np.uint32(top - shift)).astype(np.uint32)
                q = up.view(np.int32) >> np.int32(top)
                with np.errstate(invalid="ignore"):    # 0 x inf
                    out[:, v0 + j] = (q.astype(np.float32)
                                      * lane_scale[:, lane])
    return out


# NaN, +-inf, the smallest and a larger subnormal, and ordinary scales
SPECIAL_SCALES = np.array([1.0, np.nan, np.inf, -np.inf, 1e-45, 3e-39, 0.7,
                           -2.5], np.float32)


def _code_payloads(bits):
    """Packed rows holding every code of the width under every special
    scale: all 256 byte values (8 bits), all 256 nibble pairs, so every
    nibble low and high (4 bits), every int16 from -32768 to 32767 (16
    bits)."""
    if bits == 16:
        codes = np.arange(-32768, 32768, dtype=np.int16).view(np.int8)
    else:
        codes = np.tile(np.arange(256, dtype=np.uint8).view(np.int8),
                        2 if bits == 8 else 1)
    rows = codes.reshape(-1, 256 * bits // 8)
    packed = np.concatenate([rows] * len(SPECIAL_SCALES))
    scales = np.repeat(SPECIAL_SCALES, len(rows))[:, None]
    return packed, scales


def _same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_decode_lane_emulation_every_code(bits):
    """Every code of the width under NaN, inf, subnormal and ordinary
    scales: the kernel's lane mapping bit-equal to the port's plain
    decode and, at 4 and 8 bits, to the Pallas decode kernel in interpret
    mode.  XLA on the CPU flushes subnormal operands to zero, so under a
    subnormal scale JAX decodes every value to zero where the port (and
    the CUDA kernel, built without flush-to-zero) gives the IEEE product
    q * scale; every other value is bit-equal."""
    packed, scales = _code_payloads(bits)
    got = decode_lane_emulation(packed, scales, bits)
    want = tops.wire_decode(torch.from_numpy(packed),
                            torch.from_numpy(scales), packed.shape[:1] +
                            (256,), bits=bits)
    assert _same_bits(got, want.numpy())
    assert np.isnan(got[scales[:, 0] != scales[:, 0]]).all()
    sub = (scales[:, 0] != 0) & (np.abs(scales[:, 0])
                                 < np.finfo(np.float32).tiny)
    assert sub.sum() == 2 * len(packed) // len(SPECIAL_SCALES)
    assert (got[sub] != 0).any()                 # IEEE subnormal products
    if bits != 16:                    # the Pallas kernel has 4 and 8 bits
        jax_want = np.asarray(_jax_decode(packed, scales, got.shape, bits,
                                          "pallas"))
        assert _same_bits(got[~sub], jax_want[~sub])
        assert (jax_want[sub] == 0).all()        # flushed to zero


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_decode_lane_emulation_encoded_payloads(bits):
    """The codec's own payloads (the special and reciprocal-sweep blocks):
    the lane mapping equals the plain decode."""
    blocks = np.concatenate([_special_blocks(bits, 256),
                             _reciprocal_sweep(bits, n_blocks=256)[0]])
    packed, scales = tops.wire_encode(torch.from_numpy(blocks), bits=bits)
    got = decode_lane_emulation(packed.numpy(), scales.numpy(), bits)
    want = tops.wire_decode(packed, scales, blocks.shape, bits=bits)
    assert _same_bits(got, want.numpy())


def test_decode_lane_emulation_reads_the_kernels_mapping():
    """The emulation's chunk count is the kernel's ``kDecodeChunks``."""
    from pathlib import Path

    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
           "csrc" / "wire_codec.cu").read_text()
    assert f"constexpr int kDecodeChunks = {DECODE_CHUNKS};\n" in src


@pytest.mark.parametrize("block,off_packed,off_out,route", [
    (256, 0, 0, "vector"), (256, 16, 32, "vector"), (128, 0, 0, "scalar"),
    (512, 0, 0, "scalar"), (256, 1, 0, "scalar"), (256, 0, 1, "scalar"),
    (256, 8, 0, "scalar")])
def test_decode_route(block, off_packed, off_out, route):
    """256-value blocks on 16-byte-aligned packed and output pointers take
    the vector kernel; any other block size or alignment the scalar one."""
    base = 1 << 20
    assert wcuda.decode_route(block, base + off_packed,
                              base + off_out) == route


def test_decode_route_of_views():
    """A packed view one byte into its storage takes the scalar kernel."""
    flat = torch.zeros(1 + 4 * 256, dtype=torch.int8)
    assert flat.data_ptr() % 16 == 0
    out = torch.empty((4, 256))
    assert wcuda.decode_route(256, flat.data_ptr(), out.data_ptr()) == \
        "vector"
    view = flat[1:].view(4, 256)
    assert wcuda.decode_route(256, view.data_ptr(), out.data_ptr()) == \
        "scalar"
