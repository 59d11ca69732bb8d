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
