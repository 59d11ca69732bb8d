"""The port's plain flash attention (``kernels/flash_attention``) against
the JAX package: the Pallas kernel in interpret mode
(``flash_attention_bhsd``, and ``flash_attention`` for GQA), its dense
oracle ``attention_ref`` and the model's ``_mha_streaming``, at the cases
of tests/test_kernels.py's ``TestFlashAttention`` plus windows, ragged
lengths and GQA.

Tolerances are the reference's own (tests/test_kernels.py:43): 2e-5 in
float32, atol = rtol = 2e-2 in bf16.  The CUDA kernel runs only on the
card; ``chip_smoke.py`` holds it to these plain versions there.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.attention import _mha_streaming as jax_mha_streaming

from repro_torch.kernels.flash_attention import cuda as fcuda
from repro_torch.kernels.flash_attention.ops import expand_kv, flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref, mha_streaming

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def qkv(shapes, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a, dtype=jnp.dtype(dtype)) for a in arrs]
    pt = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, pt


def close(a, b, dtype="float32"):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(jnp.asarray(a, jnp.float32)),
                               b.float().numpy(), atol=tol, rtol=tol)


def heads_first(t):
    """(b, s, H, d) -> (b*H, s, d)."""
    b, s, H, d = t.shape
    return t.transpose(1, 2).reshape(b * H, s, d)


@pytest.mark.parametrize("BH,s,d,dtype", [
    (4, 256, 64, "float32"),
    (2, 512, 128, "float32"),
    (2, 384, 64, "bfloat16"),
    (1, 128, 256, "float32"),
])
def test_causal_against_pallas_interpret(BH, s, d, dtype):
    (q, k, v), (tq, tk, tv) = qkv([(BH, s, d)] * 3, 0, dtype)
    want = flash_attention_bhsd(q, k, v, causal=True, block_q=128,
                                block_k=128, interpret=True)
    got = attention_ref(tq, tk, tv)
    assert got.dtype == tq.dtype
    close(want, got, dtype)
    close(jax_attention_ref(q, k, v, causal=True), got, dtype)
    # the streaming form in the model's layout, one head per batch row
    stream = mha_streaming(tq[:, :, None], tk[:, :, None], tv[:, :, None],
                           torch.arange(s), torch.arange(s), d ** -0.5,
                           chunk=128)
    close(want, stream[:, :, 0], dtype)


@pytest.mark.parametrize("window", [64, 128, 256])
def test_sliding_window_against_pallas_interpret(window):
    (q, k, v), (tq, tk, tv) = qkv([(2, 512, 64)] * 3, 1)
    want = flash_attention_bhsd(q, k, v, causal=True, window=window,
                                block_q=128, block_k=128, interpret=True)
    close(want, attention_ref(tq, tk, tv, window=window))
    got = flash_attention(tq[:, :, None], tk[:, :, None], tv[:, :, None],
                          window=window)
    close(want, got[:, :, 0])


@pytest.mark.parametrize("b,s,H,KV,d,window", [
    (2, 256, 8, 2, 64, None),          # TestFlashAttention's GQA case
    (2, 200, 4, 1, 32, None),          # ragged against every block size
    (1, 333, 6, 3, 16, 50),            # ragged, grouped, windowed
    (2, 130, 4, 4, 64, 7),
])
def test_gqa_ops_against_jax(b, s, H, KV, d, window):
    (q, k, v), (tq, tk, tv) = qkv([(b, s, H, d), (b, s, KV, d),
                                   (b, s, KV, d)], 2)
    got = flash_attention(tq, tk, tv, window=window)
    assert got.shape == (b, s, H, d)
    kf, vf = jnp.repeat(k, H // KV, axis=2), jnp.repeat(v, H // KV, axis=2)
    pos = jnp.arange(s, dtype=jnp.int32)
    close(jax_mha_streaming(q, kf, vf, pos, pos, 1.0 / np.sqrt(d),
                            window=window), got)
    want = jax_attention_ref(jnp.moveaxis(q, 2, 1).reshape(b * H, s, d),
                             jnp.moveaxis(kf, 2, 1).reshape(b * H, s, d),
                             jnp.moveaxis(vf, 2, 1).reshape(b * H, s, d),
                             causal=True, window=window)
    close(want, heads_first(got))
    if window is None and s % 128 == 0:
        close(jax_flash(q, k, v, causal=True, interpret=True), got)


def test_bf16_model_layout_rounds_once():
    """In a bf16 model the attention output rounds once, in q's (= v's)
    dtype, in the plain version as in the kernel."""
    (q, k, v), (tq, tk, tv) = qkv([(2, 96, 4, 16), (2, 96, 2, 16),
                                   (2, 96, 2, 16)], 3, "bfloat16")
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    pos = jnp.arange(96, dtype=jnp.int32)
    want = jax_mha_streaming(q, jnp.repeat(k, 2, axis=2),
                             jnp.repeat(v, 2, axis=2), pos, pos, 0.25)
    close(want, got, "bfloat16")
    dense = attention_ref(heads_first(tq), heads_first(expand_kv(tk, 4)),
                          heads_first(expand_kv(tv, 4)))
    close(np.asarray(heads_first(got).float()), dense, "bfloat16")


def test_streaming_chunks_agree():
    """The chunk size changes only the float32 summation order."""
    _, (tq, tk, tv) = qkv([(1, 300, 2, 32)] * 3, 4)
    pos = torch.arange(300)
    a = mha_streaming(tq, tk, tv, pos, pos, 0.2, chunk=1024)
    b = mha_streaming(tq, tk, tv, pos, pos, 0.2, chunk=30)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-5)


def test_cuda_wrapper_refuses_cpu_tensors():
    _, (tq, tk, tv) = qkv([(1, 8, 2, 64)] * 3, 5)
    with pytest.raises(ValueError, match="CUDA"):
        fcuda.flash_attention_cuda(tq, tk, tv)


# -- the bf16 CUDA kernel's numerics, emulated with torch ops --------------
#
# The bf16 kernel (csrc/flash_attention.cu, tensor_core) multiplies bf16 q
# and k on the tensor cores with float32 sums, scales S in float32 after
# the product, keeps the running max and row sum in float32 over key tiles
# of 128, rounds P to two bf16 terms (hi = bf16(p), lo = bf16(p - hi))
# before P V (float32 accumulate) and rounds the output once to bf16.
# ``tensor_core_emulation`` does the same with torch ops; it is held to the
# plain streaming form within the bounds that chip_smoke.py holds the
# kernel to on the card: 2e-2 + 2e-2 |x| on the model's own inputs,
# 4e-3 + 2^-7 |x| on random unit-scale inputs.

BK = 128
MODEL_BOUND = (2e-2, 2e-2)
RANDOM_BOUND = (4e-3, 2.0 ** -7)


def tensor_core_emulation(q, k, v, scale, window=None, fold_scale=False,
                          one_bf16_p=False):
    """q: (b, s, H, d), k/v: (b, t, KV, d) bf16 -> (b, s, H, d) bf16.
    ``fold_scale`` rounds q * scale to bf16 before the product instead;
    ``one_bf16_p`` keeps only P's first bf16 term (FlashAttention's P)."""
    b, s, H, d = q.shape
    t = k.shape[1]
    kf, vf = expand_kv(k, H).float(), expand_kv(v, H).float()
    qf = (q.float() * scale).bfloat16().float() if fold_scale else q.float()
    q_pos = torch.arange(s)[:, None]
    m = torch.full((b, H, s), -1e30)
    l = torch.zeros((b, H, s))
    acc = torch.zeros((b, H, s, d))
    for k0 in range(0, t, BK):
        logits = torch.einsum("bshd,bchd->bhsc", qf, kf[:, k0:k0 + BK])
        if not fold_scale:
            logits = logits * scale
        k_pos = torch.arange(k0, min(t, k0 + BK))[None]
        valid = k_pos <= q_pos
        if window is not None:
            valid &= k_pos > q_pos - window
        logits = torch.where(valid, logits, torch.tensor(-1e30))
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        lo = torch.zeros_like(p) if one_bf16_p else (p - hi).bfloat16().float()
        acc = acc * alpha[..., None] + torch.einsum(
            "bhsc,bchd->bhsd", hi, vf[:, k0:k0 + BK]) + torch.einsum(
            "bhsc,bchd->bhsd", lo, vf[:, k0:k0 + BK])
        m = m_new
    return (acc / l.clamp_min(1e-37)[..., None]).transpose(1, 2).bfloat16()


def plain_bf16(q, k, v, scale, window=None):
    H, s, t = q.shape[2], q.shape[1], k.shape[1]
    return mha_streaming(q, expand_kv(k, H), expand_kv(v, H), torch.arange(s),
                         torch.arange(t), scale, window=window)


def worst(got, want, bound):
    """Largest |got - want| / (atol + rtol |want|): <= 1 is inside."""
    atol, rtol = bound
    err = (got.double() - want.double()).abs()
    return float((err / (atol + rtol * want.double().abs())).max())


def bf16_qkv(b, s, H, KV, d, seed, qk_scale=1.0, v_scale=1.0):
    rng = np.random.default_rng(seed)

    def draw(shape, amp):
        return torch.tensor(amp * rng.standard_normal(shape)).bfloat16()

    return (draw((b, s, H, d), qk_scale), draw((b, s, KV, d), qk_scale),
            draw((b, s, KV, d), v_scale))


@pytest.mark.parametrize("d", [64, 128])
def test_tensor_core_numerics_at_model_scale(d):
    """q and k at ~30x unit scale, as the random-weight models make them
    (logits of ~1e3, near one-hot rows); ragged, grouped."""
    q, k, v = bf16_qkv(2, 600, 4, 2, d, 10, qk_scale=30.0)
    got = tensor_core_emulation(q, k, v, d ** -0.5)
    assert worst(got, plain_bf16(q, k, v, d ** -0.5), MODEL_BOUND) <= 1


@pytest.fixture(scope="module")
def yi_prefill_inputs():
    """The q, k, v every layer's attention gets in the prefill of the
    tests/test_torch_lm.py yi-family fixture (yi's smoke config, the JAX
    model's ``init`` at PRNGKey(42) bridged), on a 2 x 300-token prompt,
    ragged against the kernel's 128-key tiles."""
    import dataclasses

    import jax

    from repro.configs import registry as jax_registry
    from repro.models.transformer import Model as JaxModel
    from repro_torch.bridge import lm_params_from
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import ops as flash_ops

    jc = dataclasses.replace(jax_registry.get_config("yi-9b", smoke=True),
                             param_dtype=jnp.float32)
    pc = dataclasses.replace(registry.get_config("yi-9b", smoke=True),
                             param_dtype=torch.float32)
    params = JaxModel(jc).init(jax.random.PRNGKey(42))
    model = lm_params_from(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), params), pc, device="cpu")
    toks = np.random.default_rng(7).integers(0, jc.vocab, (2, 300))
    captured = []
    real = flash_ops.flash_attention

    def spy(q, k, v, **kw):
        captured.append((q.bfloat16(), k.bfloat16(), v.bfloat16(),
                         kw["scale"]))
        return real(q, k, v, **kw)

    flash_ops.flash_attention = spy
    try:
        model.prefill(torch.as_tensor(toks))
    finally:
        flash_ops.flash_attention = real
    assert len(captured) == pc.n_layers
    return captured


@pytest.mark.parametrize("window", [None, 6])
def test_tensor_core_numerics_on_yi_prefill(yi_prefill_inputs, window):
    """Each layer's prefill inputs, causal and with yi-swa's window."""
    for q, k, v, scale in yi_prefill_inputs:
        got = tensor_core_emulation(q, k, v, scale, window)
        assert worst(got, plain_bf16(q, k, v, scale, window),
                     MODEL_BOUND) <= 1


@pytest.mark.parametrize("b,s,H,KV,d,window", [
    (2, 1000, 4, 2, 128, None),
    (2, 1000, 4, 1, 64, 256),
    (1, 777, 2, 2, 128, 100),
])
def test_tensor_core_numerics_random(b, s, H, KV, d, window):
    q, k, v = bf16_qkv(b, s, H, KV, d, 11)
    got = tensor_core_emulation(q, k, v, d ** -0.5, window)
    assert worst(got, plain_bf16(q, k, v, d ** -0.5, window),
                 RANDOM_BOUND) <= 1


def test_folding_scale_into_bf16_q_breaks_the_model_bound():
    """Why the kernel scales S in float32 after the product: rounding
    q * scale to bf16 moves logits of ~1e3 by units, and at d = 128 (scale
    1/sqrt(128), not a power of two) that reorders near-one-hot rows far
    outside the bound.  At d = 64 or yi's smoke d_head 16 the scale is a
    power of two and folding it is exact."""
    q, k, v = bf16_qkv(2, 600, 4, 2, 128, 10, qk_scale=30.0)
    want = plain_bf16(q, k, v, 128 ** -0.5)
    assert worst(tensor_core_emulation(q, k, v, 128 ** -0.5), want,
                 MODEL_BOUND) <= 1
    assert worst(tensor_core_emulation(q, k, v, 128 ** -0.5,
                                       fold_scale=True), want,
                 MODEL_BOUND) > 10


def test_one_bf16_p_breaks_the_model_bound_at_full_width_scale():
    """Why the kernel carries P as two bf16 terms: one bf16 P errs by up
    to 2^-9 of |v| per term, and yi-9b's full-width prefill gives v at ~9x
    unit scale (outputs with rms 8.9, up to 49, on the card).  At that
    scale one bf16 P leaves the bound in its tail (on the card it put 104
    of 1.3e8 values outside, 0.25 off); hi + lo stays inside.  The tail
    needs samples: at 2 x 2048 x 8 heads one bf16 P reaches 1.1-1.4 times
    the bound for three of the seeds 0-3, hi + lo at most 0.82."""
    q, k, v = bf16_qkv(2, 2048, 8, 2, 128, 0, qk_scale=30.0, v_scale=9.0)
    want = plain_bf16(q, k, v, 128 ** -0.5)
    assert worst(tensor_core_emulation(q, k, v, 128 ** -0.5), want,
                 MODEL_BOUND) <= 1
    assert worst(tensor_core_emulation(q, k, v, 128 ** -0.5,
                                       one_bf16_p=True), want,
                 MODEL_BOUND) > 1


# -- the float32 CUDA kernel's tile order, emulated with torch ops ---------
#
# The float32 kernel (csrc/flash_attention.cu, cuda_core) runs blocks of
# 128 queries over the key tiles of 64 that its mask does not empty (none
# past the tile's last row; with a window none wholly at or before
# q0 - window), scales q once in float32, masks logits to -1e30 from
# absolute positions, and reduces each row over its 16 threads: every
# thread holds keys tx + 16 j (j = 0..3), sums its 4 p in order, and the
# 16 partial sums meet in a butterfly (xor 8, 4, 2, 1).  Then acc * alpha
# + P V, and one division by max(l, 1e-37).  ``cuda_core_emulation`` does
# the same in float32 torch ops and is held within the float32 bound
# (2e-5) of the plain version and of JAX's Pallas kernel in interpret mode.

CC_BQ, CC_BK, CC_THREADS = 128, 64, 16


def cuda_core_emulation(q, k, v, scale, window=None):
    """q: (b, s, H, d), k/v: (b, t, KV, d) float32 -> (b, s, H, d)."""
    b, s, H, d = q.shape
    t = k.shape[1]
    pad = -(-t // CC_BK) * CC_BK + CC_BK - t
    kf = torch.nn.functional.pad(expand_kv(k, H), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(expand_kv(v, H), (0, 0, 0, 0, 0, pad))
    qs = q * torch.tensor(scale, dtype=torch.float32)
    lane = torch.arange(CC_THREADS)
    out = torch.empty_like(q)
    for q0 in range(0, s, CC_BQ):
        rows = torch.arange(q0, min(s, q0 + CC_BQ))
        k_stop = min(t, q0 + CC_BQ)
        k_first = max(0, q0 - window + 1) // CC_BK * CC_BK if window else 0
        m = torch.full((b, H, len(rows)), -1e30)
        l = torch.zeros((b, H, len(rows)))
        acc = torch.zeros((b, H, len(rows), d))
        for k0 in range(k_first, k_stop, CC_BK):
            keys = torch.arange(k0, k0 + CC_BK)
            logits = torch.einsum("bshd,bchd->bhsc", qs[:, rows],
                                  kf[:, k0:k0 + CC_BK])
            valid = (keys[None] < t) & (keys[None] <= rows[:, None])
            if window:
                valid &= keys[None] > rows[:, None] - window
            logits = torch.where(valid, logits, torch.tensor(-1e30))
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            # key k0 + tx + 16 j -> [..., j, tx]
            part = p.reshape(*p.shape[:-1], CC_BK // CC_THREADS, CC_THREADS)
            local = part[..., 0, :]
            for j in range(1, part.shape[-2]):
                local = local + part[..., j, :]
            for off in (8, 4, 2, 1):
                local = local + local[..., lane ^ off]
            l = l * alpha + local[..., 0]
            acc = acc * alpha[..., None] + torch.einsum(
                "bhsc,bchd->bhsd", p, vf[:, k0:k0 + CC_BK])
            m = m_new
        out[:, rows] = (acc / l.clamp_min(1e-37)[..., None]).transpose(1, 2)
    return out


@pytest.mark.parametrize("b,s,H,KV,d,window", [
    (2, 320, 4, 2, 64, None),         # GQA, ragged against the query tiles
    (1, 320, 2, 1, 128, 100),         # a window: skipped leading tiles
    (1, 384, 2, 2, 128, 130),
    (1, 448, 2, 1, 64, 64),           # the window's edge on a tile edge
])
def test_cuda_core_emulation_against_pallas_interpret(b, s, H, KV, d,
                                                       window):
    (q, k, v), (tq, tk, tv) = qkv([(b, s, H, d), (b, s, KV, d),
                                   (b, s, KV, d)], 12)
    got = cuda_core_emulation(tq, tk, tv, d ** -0.5, window)
    close(np.asarray(plain_f32(tq, tk, tv, window)), got)
    kf, vf = jnp.repeat(k, H // KV, axis=2), jnp.repeat(v, H // KV, axis=2)
    want = flash_attention_bhsd(
        *(jnp.moveaxis(a, 2, 1).reshape(b * H, s, d) for a in (q, kf, vf)),
        causal=True, window=window, block_q=64, block_k=64, interpret=True)
    close(want, heads_first(got))


def plain_f32(q, k, v, window=None):
    H, s, t, d = q.shape[2], q.shape[1], k.shape[1], q.shape[3]
    return mha_streaming(q, expand_kv(k, H), expand_kv(v, H), torch.arange(s),
                         torch.arange(t), d ** -0.5, window=window)


@pytest.mark.parametrize("b,s,H,KV,d,window", [
    (2, 200, 4, 1, 128, None),        # ragged against both tile sizes
    (1, 333, 6, 3, 64, 50),
    (2, 130, 4, 4, 64, 7),
    (1, 600, 2, 1, 128, 257),
])
def test_cuda_core_emulation_ragged(b, s, H, KV, d, window):
    (q, k, v), (tq, tk, tv) = qkv([(b, s, H, d), (b, s, KV, d),
                                   (b, s, KV, d)], 13)
    got = cuda_core_emulation(tq, tk, tv, d ** -0.5, window)
    close(np.asarray(plain_f32(tq, tk, tv, window)), got)
    kf, vf = jnp.repeat(k, H // KV, axis=2), jnp.repeat(v, H // KV, axis=2)
    want = jax_attention_ref(
        *(jnp.moveaxis(a, 2, 1).reshape(b * H, s, d) for a in (q, kf, vf)),
        causal=True, window=window)
    close(want, heads_first(got))
