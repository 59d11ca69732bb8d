"""The port's plain flash attention (``kernels/flash_attention``) against
the JAX package: the Pallas kernel in interpret mode
(``flash_attention_bhsd``, and ``flash_attention`` for GQA), its dense
oracle ``attention_ref`` and the model's ``_mha_streaming``, at the cases
of tests/test_kernels.py's ``TestFlashAttention`` plus windows, ragged
lengths and GQA.

Tolerances are the reference's own (tests/test_kernels.py:43): 2e-5 in
float32, atol = rtol = 2e-2 in bf16.  The CUDA kernel runs only on the
card; ``chip_smoke.py`` holds it to these plain versions there.  The
backward's plain version ``flash_attention_bwd_ref`` is held to autograd
and to JAX's vjp of ``_mha_streaming``, and the bf16 backward kernels'
arithmetic, emulated in torch ops, to that plain backward, at the end.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.attention import _mha_streaming as jax_mha_streaming

from repro_torch.kernels.flash_attention import cuda as fcuda
from repro_torch.kernels.flash_attention.ops import expand_kv, flash_attention
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    flash_attention_bwd_ref,
    mha_streaming,
)

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
    """q: (b, s, H, d), k: (b, t, KV, d), v: (b, t, KV, dv) bf16 ->
    (b, s, H, dv) bf16.  ``fold_scale`` rounds q * scale to bf16 before
    the product instead; ``one_bf16_p`` keeps only P's first bf16 term
    (FlashAttention's P)."""
    b, s, H, d = q.shape
    t, dv = k.shape[1], v.shape[-1]
    kf, vf = expand_kv(k, H).float(), expand_kv(v, H).float()
    qf = (q.float() * scale).bfloat16().float() if fold_scale else q.float()
    q_pos = torch.arange(s)[:, None]
    m = torch.full((b, H, s), -1e30)
    l = torch.zeros((b, H, s))
    acc = torch.zeros((b, H, s, dv))
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


def cuda_core_emulation(q, k, v, scale, window=None, bk=CC_BK):
    """q: (b, s, H, d), k: (b, t, KV, d), v: (b, t, KV, dv) float32 ->
    (b, s, H, dv), over key tiles of ``bk`` (the kernel's 64, or the 32 of
    MLA's (192, 128) pair)."""
    b, s, H, d = q.shape
    t, dv = k.shape[1], v.shape[-1]
    pad = -(-t // bk) * bk + bk - t
    kf = torch.nn.functional.pad(expand_kv(k, H), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(expand_kv(v, H), (0, 0, 0, 0, 0, pad))
    qs = q * torch.tensor(scale, dtype=torch.float32)
    lane = torch.arange(CC_THREADS)
    out = q.new_empty((b, s, H, dv))
    for q0 in range(0, s, CC_BQ):
        rows = torch.arange(q0, min(s, q0 + CC_BQ))
        k_stop = min(t, q0 + CC_BQ)
        k_first = max(0, q0 - window + 1) // bk * bk if window else 0
        m = torch.full((b, H, len(rows)), -1e30)
        l = torch.zeros((b, H, len(rows)))
        acc = torch.zeros((b, H, len(rows), dv))
        for k0 in range(k_first, k_stop, bk):
            keys = torch.arange(k0, k0 + bk)
            logits = torch.einsum("bshd,bchd->bhsc", qs[:, rows],
                                  kf[:, k0:k0 + bk])
            valid = (keys[None] < t) & (keys[None] <= rows[:, None])
            if window:
                valid &= keys[None] > rows[:, None] - window
            logits = torch.where(valid, logits, torch.tensor(-1e30))
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            # key k0 + tx + 16 j -> [..., j, tx]
            part = p.reshape(*p.shape[:-1], bk // CC_THREADS, CC_THREADS)
            local = part[..., 0, :]
            for j in range(1, part.shape[-2]):
                local = local + part[..., j, :]
            for off in (8, 4, 2, 1):
                local = local + local[..., lane ^ off]
            l = l * alpha + local[..., 0]
            acc = acc * alpha[..., None] + torch.einsum(
                "bhsc,bchd->bhsd", p, vf[:, k0:k0 + bk])
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


# -- the backward (csrc/flash_attention_bwd.cu's plain version) ------------
#
# ``flash_attention_bwd_ref`` computes dq, dk, dv from the forward's output
# and log-sum-exp (``mha_streaming(..., return_lse=True)``) with the kv
# heads expanded and summed back.  It is held to autograd through
# ``mha_streaming`` and to jax.vjp of the reference's ``_mha_streaming``
# with its kv heads repeated (``attention_train``'s form), in float32:
# within 2e-5 of each gradient's largest entry (the float32 TOL above).

def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def jax_attention_vjp(q, k, v, g, window, scale):
    H = q.shape[2]

    def fwd(q, k, v):
        rep = H // k.shape[2]
        pos = jnp.arange(q.shape[1], dtype=jnp.int32)
        return jax_mha_streaming(q, jnp.repeat(k, rep, axis=2),
                                 jnp.repeat(v, rep, axis=2), pos, pos, scale,
                                 window=window)
    _, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("b,s,H,KV,d,window", [
    (1, 650, 4, 4, 64, None),       # GQA group 1, S ragged
    (1, 650, 8, 2, 128, None),      # group 4
    (1, 650, 8, 1, 64, 200),        # group 8, a window
    (2, 200, 4, 1, 128, 64),        # group 4, a window, d 128
    (1, 300, 4, 4, (192, 128), None),   # MLA's (d, dv)
])
def test_flash_bwd_ref_against_autograd_and_jax(b, s, H, KV, d, window):
    d, dv = d if isinstance(d, tuple) else (d, d)
    rng = np.random.default_rng(s + H + d)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, H, d), (b, s, KV, d), (b, s, KV, dv)))
    g = rng.standard_normal((b, s, H, dv)).astype(np.float32)
    scale = d ** -0.5
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    pos = torch.arange(s)
    o, lse = mha_streaming(leaves[0], expand_kv(leaves[1], H),
                           expand_kv(leaves[2], H), pos, pos, scale,
                           window=window, return_lse=True)
    o.backward(torch.tensor(g))
    got = flash_attention_bwd_ref(*(torch.tensor(a) for a in (q, k, v)),
                                  o.detach(), torch.tensor(g), lse.detach(),
                                  window=window, scale=scale, chunk=256)
    want = jax_attention_vjp(q, k, v, g, window, scale)
    for name, a, t, j in zip(("dq", "dk", "dv"), got, leaves, want):
        assert a.shape == t.shape, name
        assert rel_max(a.numpy(), t.grad.numpy()) < 2e-5, name
        assert rel_max(a.numpy(), j) < 2e-5, name


def test_lse_is_the_rows_logsumexp():
    """The streaming form's lse is logsumexp of the scaled, masked logits
    (what the kernel writes and its backward reads)."""
    _, (tq, tk, tv) = qkv([(1, 70, 2, 64)] * 3, 21)
    pos = torch.arange(70)
    _o, lse = mha_streaming(tq, tk, tv, pos, pos, 0.125, window=9,
                            chunk=16, return_lse=True)
    logits = torch.einsum("bshd,bthd->bhst", tq, tk) * 0.125
    mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - 9)
    want = torch.logsumexp(torch.where(mask, logits, -torch.inf), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=2e-6,
                               rtol=2e-6)


def test_autograd_route_on_cpu_is_the_streaming_form():
    """flash_attention on CPU tensors differentiates the plain streaming
    form; the CUDA backward wrapper refuses CPU tensors."""
    _, (tq, tk, tv) = qkv([(1, 12, 4, 64), (1, 12, 2, 64), (1, 12, 2, 64)],
                          22)
    leaves = [t.requires_grad_(True) for t in (tq, tk, tv)]
    out = flash_attention(*leaves)
    assert "FlashAttention" not in type(out.grad_fn).__name__
    out.square().sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in leaves)
    lse = torch.zeros((1, 4, 12))
    with pytest.raises(ValueError, match="CUDA"):
        fcuda.flash_attention_bwd_cuda(tq, tk, tv, tq, tq, lse)


# -- the bf16 backward kernels' numerics, emulated with torch ops ----------
#
# The bf16 backward (csrc/flash_attention_bwd.cu, tensor_core) runs two
# wgmma kernels.  dq: blocks of kDqBQ query rows over the key tiles of
# kDqBK that its mask leaves; S = q k^T and dP = dO V^T with float32 sums,
# the scale on S in float32, P = exp(scale S - lse) (0 where masked), dS =
# P (dP - Dl) rounded to kDsTerms bf16 terms (hi = bf16(x), lo = bf16(x -
# hi)) before dQ += dS K; Dl sums a quarter of d per thread with FMAs, in
# order, then (a0 + a1) + (a2 + a3).  dkdv: blocks of kKvBK keys walk the
# kv head's query heads in order and, for each, the query tiles of kKvBQ
# its mask leaves; P^T rounded to kPTerms terms before dV += P^T dO, dS^T
# to kDsTerms before dK += dS^T Q.  Outputs round once to bf16.
# ``tensor_core_bwd_emulation`` does the same with torch ops, the tile
# sizes, terms and skip rules read from the source, and is held to
# ``flash_attention_bwd_ref`` within the card's bounds (chip_smoke.py
# FLASH_BWD_BF16_REL and FLASH_TOL): 2^-7 of each output's max |plain| and
# MODEL_BOUND elementwise.

BWD_SOURCE = "flash_attention_bwd.cu"
BWD_REL = 2.0 ** -7
SMEM_PER_BLOCK = 232_448          # 227 KB, the H100's most for one block


def _cu_text(name):
    import pathlib

    return (pathlib.Path(__file__).resolve().parents[1] / "src"
            / "repro_torch" / "csrc" / name).read_text()


def _tc_namespace(text):
    """The bf16 kernels' part of the backward source."""
    return text[text.index("namespace tensor_core {"):]


def pair_tiles(text, d, dv):
    """The ``Tiles`` constants of the (d, dv) pair in ``text`` (one
    namespace of the source): its specialization where there is one, else
    the primary template's."""
    import re

    body = re.search(rf"struct Tiles<{d}, {dv}> \{{(.*?)\}};", text, re.S)
    if body is None:
        body = re.search(r"template <int DQK, int DV>\nstruct Tiles \{(.*?)\};",
                         text, re.S)
    return {m[1]: int(m[2]) for m in re.finditer(
        r"static constexpr int (k\w+) = (\d+);", body[1])}


def built_pairs(namespace):
    """The (d, dv) pairs the C entry launches in ``namespace``."""
    import re

    return sorted({(int(m[1]), int(m[2])) for m in re.finditer(
        rf"{namespace}::launch<(\d+), (\d+)>", _cu_text(BWD_SOURCE))})


def bwd_constants(d=128, dv=None):
    """The bf16 backward's constants at the (d, dv) pair (dv None: d): the
    namespace's ``constexpr int k...`` and the pair's ``Tiles``."""
    import re

    text = _tc_namespace(_cu_text(BWD_SOURCE))
    c = {m[1]: int(m[2]) for m in re.finditer(
        r"^constexpr int (k\w+) = (\d+);", text, re.M)}
    return {**c, **pair_tiles(text, d, d if dv is None else dv)}


def _c_to_py(expr):
    """A C int expression of the source as Python: ``a ? b : c``, integer
    ``/`` of non-negative ints, ``min``/``max``, ``&&``."""
    import re

    expr = " ".join(expr.split())
    m = re.fullmatch(r"(.+?) \? (.+) : (.+)", expr)
    if m:
        return (f"(({_c_to_py(m[2])}) if ({_c_to_py(m[1])}) else "
                f"({_c_to_py(m[3])}))")
    return expr.replace("/", "//").replace("&&", " and ")


def bwd_rule(name, pair=(128, 128), **env):
    """Evaluate ``const int <name> = ...;`` of the bf16 backward with the
    kernel's constants at ``pair`` and ``env`` (window 0: none)."""
    import re

    text = _tc_namespace(_cu_text(BWD_SOURCE))
    expr = re.search(rf"const int {name} =\s*(.+?);", text, re.S)[1]
    return eval(_c_to_py(expr), {"min": min, "max": max},
                {**bwd_constants(*pair), **env})


def dq_key_tiles(q0, s, t, window, pair=(128, 128)):
    """The dq block at query row q0 visits these key tiles (k0 values)."""
    env = dict(q0=q0, S=s, Tk=t, window=window or 0)
    for name in ("k_stop", "k_min", "k_first", "n_tiles"):
        env[name] = bwd_rule(name, pair, **env)
    return [env["k_first"] + i * bwd_constants(*pair)["kDqBK"]
            for i in range(env["n_tiles"])]


def dkdv_query_tiles(k0, s, t, window, pair=(128, 128)):
    """The dkdv block at key k0 visits these query tiles (q0 values), for
    each query head of its group."""
    env = dict(k0=k0, S=s, Tk=t, window=window or 0)
    for name in ("q_begin", "q_end", "n_q"):
        env[name] = bwd_rule(name, pair, **env)
    return [env["q_begin"] + i * bwd_constants(*pair)["kKvBQ"]
            for i in range(env["n_q"])]


def bf16_terms(x, terms):
    """x as the sum of ``terms`` bf16 values (hi, then lo = bf16(x - hi))."""
    hi = x.bfloat16().float()
    return hi if terms == 1 else hi + (x - hi).bfloat16().float()


def _fma_rows(g, o):
    """sum_j g[..., j] o[..., j] over the last axis, one FMA per step (each
    rounded once to float32), in order."""
    acc = torch.zeros(g.shape[:-1], dtype=torch.float64)
    g64, o64 = g.double(), o.double()
    for j in range(g.shape[-1]):
        acc = (acc + g64[..., j] * o64[..., j]).float().double()
    return acc.float()


def wgmma_sum(eq, a, b):
    """``einsum(eq, a, b)`` over the last axis as the tensor cores sum a
    score product: in k16 steps, each step's products and the running sum
    added exactly and the result truncated toward zero to float32 (Fasi et
    al., "Numerical behavior of NVIDIA tensor cores", 2021, measured this
    on earlier generations; on the H100 it gives the card's readings)."""
    acc = None
    for c in range(0, a.shape[-1], 16):
        x = torch.einsum(eq, a[..., c:c + 16].double(),
                         b[..., c:c + 16].double())
        if acc is not None:
            x = x + acc.double()
        f = x.float()
        acc = torch.where(f.double().abs() > x.abs(),
                          torch.nextafter(f, torch.zeros_like(f)), f)
    return acc


def tensor_core_bwd_emulation(q, k, v, o, dout, lse, scale, window=None,
                              p_terms=None, ds_terms=None, wgmma_sums=False):
    """q: (b, s, H, d), k: (b, t, KV, d), v: (b, t, KV, dv), o, dout: (b,
    s, H, dv) bf16, lse (b, H, s) -> (dq, dk, dv) bf16, as the bf16
    kernels compute them at the (d, dv) pair's tiles.  ``p_terms`` /
    ``ds_terms`` override the source's kPTerms / kDsTerms.  The score
    products S and dP are float32 sums in the plain backward's order, which
    leaves the rounding of P and dS alone, or with ``wgmma_sums`` summed as
    the tensor cores sum them (``wgmma_sum``)."""
    score = wgmma_sum if wgmma_sums else torch.einsum
    b, s, H, d = q.shape
    t, KV, dv_ = k.shape[1], k.shape[2], v.shape[-1]
    pair = (d, dv_)
    c = bwd_constants(*pair)
    p_terms = c["kPTerms"] if p_terms is None else p_terms
    ds_terms = c["kDsTerms"] if ds_terms is None else ds_terms
    G = H // KV
    qf, kf, vf, gf, of = (x.float().transpose(1, 2)
                          for x in (q, k, v, dout, o))   # (b, heads, n, d)
    quarters = [_fma_rows(gf[..., i * dv_ // 4:(i + 1) * dv_ // 4],
                          of[..., i * dv_ // 4:(i + 1) * dv_ // 4])
                for i in range(4)]
    dl = (quarters[0] + quarters[1]) + (quarters[2] + quarters[3])

    def visible(rows, cols):           # (rows, cols) -> mask
        ok = cols[None] <= rows[:, None]
        if window:
            ok &= cols[None] > rows[:, None] - window
        return ok

    dq = torch.zeros((b, H, s, d))
    for q0 in range(0, s, c["kDqBQ"]):
        rows = torch.arange(q0, min(s, q0 + c["kDqBQ"]))
        acc = torch.zeros((b, H, len(rows), d))
        for k0 in dq_key_tiles(q0, s, t, window, pair):
            cols = torch.arange(k0, min(t, k0 + c["kDqBK"]))
            kt = kf[:, :, cols].repeat_interleave(G, dim=1)
            vt = vf[:, :, cols].repeat_interleave(G, dim=1)
            sc = score("bhqd,bhkd->bhqk", qf[:, :, rows], kt) * scale
            p = torch.where(visible(rows, cols),
                            torch.exp(sc - lse[:, :, rows, None]), 0.0)
            dp = score("bhqd,bhkd->bhqk", gf[:, :, rows], vt)
            ds = p * (dp - dl[:, :, rows, None])
            acc = acc + torch.einsum("bhqk,bhkd->bhqd",
                                     bf16_terms(ds, ds_terms), kt)
        dq[:, :, rows] = acc * scale
    dk = torch.zeros((b, KV, t, d))
    dv = torch.zeros((b, KV, t, dv_))
    for k0 in range(0, t, c["kKvBK"]):
        cols = torch.arange(k0, min(t, k0 + c["kKvBK"]))
        ak = torch.zeros((b, KV, len(cols), d))
        av = torch.zeros((b, KV, len(cols), dv_))
        for g in range(G):                 # the group's heads, in order
            hs = torch.arange(KV) * G + g
            for q0 in dkdv_query_tiles(k0, s, t, window, pair):
                rows = torch.arange(q0, min(s, q0 + c["kKvBQ"]))
                qt, gt = qf[:, hs][:, :, rows], gf[:, hs][:, :, rows]
                st = score("bhkd,bhqd->bhkq", kf[:, :, cols], qt) * scale
                p = torch.where(visible(rows, cols).T,
                                torch.exp(st - lse[:, hs][:, :, None, rows]),
                                0.0)
                dpt = score("bhkd,bhqd->bhkq", vf[:, :, cols], gt)
                ds = p * (dpt - dl[:, hs][:, :, None, rows])
                av = av + torch.einsum("bhkq,bhqd->bhkd",
                                       bf16_terms(p, p_terms), gt)
                ak = ak + torch.einsum("bhkq,bhqd->bhkd",
                                       bf16_terms(ds, ds_terms), qt)
        dk[:, :, cols] = ak * scale
        dv[:, :, cols] = av
    return tuple(x.transpose(1, 2).bfloat16() for x in (dq, dk, dv))


def bwd_case(q, k, v, dout, scale, window=None):
    """The plain forward's (O, lse) and the plain backward on them: what the
    card holds the kernels to."""
    H, s, t = q.shape[2], q.shape[1], k.shape[1]
    o, lse = mha_streaming(q, expand_kv(k, H), expand_kv(v, H),
                           torch.arange(s), torch.arange(t), scale,
                           window=window, return_lse=True)
    want = flash_attention_bwd_ref(q, k, v, o, dout, lse, window=window,
                                   scale=scale)
    return o, lse, want


def bwd_readings(got, want):
    """[max |err| / max |plain|] and [worst elementwise over MODEL_BOUND],
    for dq, dk, dv."""
    rel = [float((a.double() - w.double()).abs().max()
                 / w.double().abs().max()) for a, w in zip(got, want)]
    return rel, [worst(a, w, MODEL_BOUND) for a, w in zip(got, want)]


def assert_bwd_within(got, want, rel_bound=BWD_REL):
    rel, elem = bwd_readings(got, want)
    assert all(x.shape == w.shape and x.dtype == torch.bfloat16
               for x, w in zip(got, want))
    assert max(rel) <= rel_bound, rel
    assert max(elem) <= 1, elem
    return rel


# shared memory of the bf16 kernels at each built pair, from ``dq_smem`` /
# ``dkdv_smem``: the (64, 64) and (128, 128) instantiations as they were
# before MLA's pair was built (D / 64 boxes of each of the two widths),
# and MLA's at its own tiles
BWD_SMEM = {(64, 64): (99368, 67624), (128, 128): (197672, 133160),
            (192, 128): (164904, 124456)}


def test_bwd_tiles_fit_shared_memory():
    """Shared memory of both kernels at each built (d, dv) pair, from the
    source's own ``dq_smem`` / ``dkdv_smem`` expressions and each pair's
    constants, within the 227 KB a block may have (MLA's at its own tiles:
    at the equal pairs' it would not fit); the scratch's rows (S padded to
    kRowPad) cover every row of a dq block and of a dkdv tile."""
    import re

    text = _tc_namespace(_cu_text(BWD_SOURCE))
    assert built_pairs("tensor_core") == sorted(BWD_SMEM)
    exprs = {fn: _c_to_py(re.search(
        rf"constexpr size_t {fn}\(\) \{{\s*return (.+?);", text,
        re.S)[1].replace("Tiles<DQK, DV>::", ""))
        for fn in ("dq_smem", "dkdv_smem")}
    for (d, dv), want in BWD_SMEM.items():
        c = bwd_constants(d, dv)
        assert c["kRowPad"] % c["kDqBQ"] == 0
        assert c["kRowPad"] % c["kKvBQ"] == 0
        need = tuple(eval(exprs[fn], {"box_bytes": lambda r: 128 * r},
                          {**c, "DQK": d, "DV": dv})
                     for fn in ("dq_smem", "dkdv_smem"))
        assert need == want and max(need) <= SMEM_PER_BLOCK, (d, dv, need)
        equal = bwd_constants(128, 128)
        if (d, dv) != (128, 128):         # the equal pairs' tiles would not
            over = eval(exprs["dq_smem"], {"box_bytes": lambda r: 128 * r},
                        {**equal, "DQK": d, "DV": dv})
            assert (over > SMEM_PER_BLOCK) == (d != dv), (d, dv, over)


@pytest.mark.parametrize("s,t,window", [
    (2048, 2048, None), (650, 650, None), (777, 777, 100), (4000, 4000, 1024),
    (130, 130, 7), (300, 300, 64), (200, 333, None), (333, 200, 50),
    (1, 1, None),
])
def test_bwd_skip_rules_visit_exactly_the_live_tiles(s, t, window):
    """Each kernel visits exactly the tiles in which the mask leaves a
    (query, key) pair, for every block of the grid."""
    skip_rules_check(s, t, window, (128, 128))


def skip_rules_check(s, t, window, pair):
    c = bwd_constants(*pair)
    rows, cols = torch.arange(s)[:, None], torch.arange(t)[None]
    mask = cols <= rows
    if window:
        mask &= cols > rows - window
    for q0 in range(0, s, c["kDqBQ"]):
        live = [k0 for k0 in range(0, t, c["kDqBK"])
                if mask[q0:q0 + c["kDqBQ"], k0:k0 + c["kDqBK"]].any()]
        assert dq_key_tiles(q0, s, t, window, pair) == live, q0
    for k0 in range(0, t, c["kKvBK"]):
        live = [q0 for q0 in range(0, s, c["kKvBQ"])
                if mask[q0:q0 + c["kKvBQ"], k0:k0 + c["kKvBK"]].any()]
        assert dkdv_query_tiles(k0, s, t, window, pair) == live, k0


@pytest.mark.parametrize("s,t,window", [
    (2048, 2048, None), (650, 650, None), (4000, 4000, 1024), (130, 130, 7),
    (300, 300, 64), (200, 333, None), (333, 200, 50), (1, 1, None),
])
def test_bwd_skip_rules_at_mla_tiles(s, t, window):
    """The same at MLA's (192, 128) tiles: dq's key tiles of 64, dkdv's
    query tiles of 32."""
    c = bwd_constants(192, 128)
    assert (c["kDqBK"], c["kKvBQ"]) == (64, 32)
    skip_rules_check(s, t, window, (192, 128))


@pytest.fixture(scope="module")
def yi_scale_bwd():
    """q and k at 30x unit scale, v at 9x (the yi-9b scale of
    ``test_one_bf16_p_breaks_the_model_bound_at_full_width_scale``), a unit
    cotangent; the plain forward's O and lse and the plain backward."""
    q, k, v = bf16_qkv(2, 2048, 8, 2, 128, 1, qk_scale=30.0, v_scale=9.0)
    dout = bf16_qkv(2, 2048, 8, 2, 128, 2)[0]
    o, lse, want = bwd_case(q, k, v, dout, 128 ** -0.5)
    return q, k, v, o, dout, lse, want


def test_tensor_core_bwd_numerics_at_model_scale(yi_scale_bwd):
    """The design's rounding of P and dS (hi + lo for each) alone, with S
    and dP summed in the plain backward's own order, keeps each output
    within half the card's 2^-7 bound at yi's scale, where the outputs' own
    bf16 rounding already takes up to 2^-8.  (The card's tensor cores sum S
    otherwise and read one bf16 step more: ``yi_scale_bwd_wgmma``.)"""
    q, k, v, o, dout, lse, want = yi_scale_bwd
    got = tensor_core_bwd_emulation(q, k, v, o, dout, lse, 128 ** -0.5)
    assert_bwd_within(got, want, BWD_REL / 2)


def test_one_bf16_p_or_ds_leaves_no_margin_at_model_scale(yi_scale_bwd):
    """The rounding of P and dS alone (S and dP in the plain backward's
    order): with one term, dS moves dK past half the 2^-7 bound at yi's
    scale (5.59e-3 of max |plain|) and breaks the elementwise MODEL_BOUND
    (24.7 times it), and P moves dV past half the bound (4.44e-3), where
    two terms keep each output within 1.40e-3 (0.38 of MODEL_BOUND).  What
    the card reads, where S's own sums add one step, is in
    ``test_one_bf16_term_breaks_the_elementwise_bound_with_wgmma_sums``."""
    q, k, v, o, dout, lse, want = yi_scale_bwd
    one_ds = tensor_core_bwd_emulation(q, k, v, o, dout, lse, 128 ** -0.5,
                                       p_terms=2, ds_terms=1)
    one_p = tensor_core_bwd_emulation(q, k, v, o, dout, lse, 128 ** -0.5,
                                      p_terms=1, ds_terms=2)
    rel_ds, elem_ds = bwd_readings(one_ds, want)
    rel_p, _ = bwd_readings(one_p, want)
    assert rel_ds[1] > BWD_REL / 2 and max(elem_ds) > 10, (rel_ds, elem_ds)
    assert rel_p[2] > BWD_REL / 2, rel_p


# benchmarks/torch_kernel_variants.py ``flash_bwd`` on an H100 (NVIDIA
# H100 80GB HBM3, 700 W), the committed kernels given the plain forward's
# O and lse on ``yi_scale_bwd``'s inputs: dQ, dK, dV in bf16 steps of max
# |plain|'s binade, and their worst |err| over MODEL_BOUND
CARD_YI_SCALE_STEPS = [0.5, 1.0, 1.0]
CARD_YI_SCALE_ELEM = [5.65, 1.50, 0.345]


def top_steps(got, want):
    """Per output: max |err| in bf16 steps of max |plain|'s binade (the
    2^-7 bound admits one such step, never two)."""
    import math

    out = []
    for a, w in zip(got, want):
        top = float(w.double().abs().max())
        out.append(float((a.double() - w.double()).abs().max())
                   / 2.0 ** (math.floor(math.log2(top)) - 7))
    return out


@pytest.fixture(scope="module")
def yi_scale_bwd_wgmma(yi_scale_bwd):
    """The emulation at yi's scale with S and dP summed as the tensor
    cores sum them, with the source's terms and with one term of each."""
    q, k, v, o, dout, lse, want = yi_scale_bwd
    design = tensor_core_bwd_emulation(q, k, v, o, dout, lse, 128 ** -0.5,
                                       wgmma_sums=True)
    one = tensor_core_bwd_emulation(q, k, v, o, dout, lse, 128 ** -0.5,
                                    p_terms=1, ds_terms=1, wgmma_sums=True)
    return design, one, want


def test_bwd_emulation_with_wgmma_sums_reads_the_cards_steps(
        yi_scale_bwd_wgmma):
    """With S and dP summed as the tensor cores sum them, the emulation
    reads what the card reads on these inputs: dK and dV one bf16 step of
    the top binade off (5.59e-3 and 4.44e-3 of max |plain|, the most the
    2^-7 bound admits), dQ half a step; at logits of ~1e3 the truncated
    sums of S, not the rounding of P or dS, set that step."""
    design, _one, want = yi_scale_bwd_wgmma
    assert top_steps(design, want) == CARD_YI_SCALE_STEPS
    rel, elem = bwd_readings(design, want)
    assert max(rel) <= BWD_REL, rel
    for got, card in zip(elem, CARD_YI_SCALE_ELEM):
        assert abs(got - card) <= 0.05 * card, (elem, CARD_YI_SCALE_ELEM)


def test_one_bf16_term_breaks_the_elementwise_bound_with_wgmma_sums(
        yi_scale_bwd_wgmma):
    """Why the kernels keep P and dS as two bf16 terms, as the card reads
    it: one term leaves the steps as they are on these inputs but puts dQ
    and dK 5 and 16 times further past the elementwise MODEL_BOUND (30.6
    and 24.7 times it, against 5.65 and 1.50)."""
    design, one, want = yi_scale_bwd_wgmma
    assert top_steps(one, want) == top_steps(design, want)
    _rel, elem_design = bwd_readings(design, want)
    _rel, elem_one = bwd_readings(one, want)
    assert elem_one[0] > 4 * elem_design[0], (elem_one, elem_design)
    assert elem_one[1] > 10 * elem_design[1], (elem_one, elem_design)


@pytest.mark.parametrize("b,s,H,KV,d,window", [
    (2, 600, 4, 2, 128, None),        # ragged against every tile, GQA
    (1, 777, 4, 1, 64, 100),          # a window, group 4, D 64
    (2, 333, 6, 3, 64, 50),
    (1, 650, 8, 2, 128, 200),         # yi's group of 4 heads a kv head
    (1, 130, 2, 2, 128, 7),           # a window narrower than a tile
    # MLA's (d, dv): a kv head a query head, ragged against dq's key tiles
    # of 64 and dkdv's query tiles of 32; and a window with GQA
    (2, 300, 4, 4, (192, 128), None),
    (1, 333, 4, 2, (192, 128), 50),
])
def test_tensor_core_bwd_numerics_random(b, s, H, KV, d, window):
    d, dv = d if isinstance(d, tuple) else (d, d)
    q, k, v = bf16_qkv(b, s, H, KV, d, 14)
    if dv != d:
        v = bf16_qkv(b, s, H, KV, dv, 16)[2]
    dout = bf16_qkv(b, s, H, KV, dv, 15)[0]
    o, lse, want = bwd_case(q, k, v, dout, d ** -0.5, window)
    got = tensor_core_bwd_emulation(q, k, v, o, dout, lse, d ** -0.5, window)
    assert [x.shape[-1] for x in got] == [d, d, dv]
    assert_bwd_within(got, want)


@pytest.fixture(scope="module")
def yi_layer0_bwd_inputs():
    """q, k, v and the output's cotangent of layer 0's attention in the loss
    backward of the tests/test_torch_lm.py yi-family fixture (yi's smoke
    config, the JAX model's ``init`` at PRNGKey(42) bridged, remat off so
    that the layer runs once) on 2 x 300 tokens, as bf16."""
    import dataclasses

    import jax

    from repro.configs import registry as jax_registry
    from repro.models.transformer import Model as JaxModel
    from repro_torch.bridge import lm_params_from
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.train.step import grads_of

    jc = dataclasses.replace(jax_registry.get_config("yi-9b", smoke=True),
                             param_dtype=jnp.float32)
    pc = dataclasses.replace(registry.get_config("yi-9b", smoke=True),
                             param_dtype=torch.float32, remat=False)
    params = JaxModel(jc).init(jax.random.PRNGKey(42))
    model = lm_params_from(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), params), pc, device="cpu")
    toks = np.random.default_rng(8).integers(0, jc.vocab, (2, 300))
    captured = {}
    real = flash_ops.flash_attention

    def spy(q, k, v, **kw):
        out = real(q, k, v, **kw)
        if "q" not in captured:
            captured.update(q=q.detach().bfloat16(), k=k.detach().bfloat16(),
                            v=v.detach().bfloat16(), scale=kw["scale"])
            out.register_hook(lambda g: captured.update(dout=g.bfloat16()))
        return out

    flash_ops.flash_attention = spy
    try:
        grads_of(model, {"tokens": torch.as_tensor(toks)})
    finally:
        flash_ops.flash_attention = real
    return captured


def test_tensor_core_bwd_numerics_on_yi_layer0(yi_layer0_bwd_inputs):
    x = yi_layer0_bwd_inputs
    q, k, v, dout, scale = x["q"], x["k"], x["v"], x["dout"], x["scale"]
    assert float(dout.float().abs().max()) > 0
    o, lse, want = bwd_case(q, k, v, dout, scale)
    got = tensor_core_bwd_emulation(q, k, v, o, dout, lse, scale)
    assert_bwd_within(got, want)
