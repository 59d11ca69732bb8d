"""The port's plain WKV recurrence (``kernels/rwkv_scan``) against the JAX
package: the chunked Pallas kernel in interpret mode (``rwkv_wkv``), its
sequential oracle ``wkv_ref`` and the model's ``_wkv_step`` scanned from
the zero state, whose final state the port's recurrence also returns (the
prefill hands it to decode).  ``wkv_chunked_ref``, the CUDA kernel's
chunked arithmetic in plain PyTorch, is held to the same references.

Tolerance: the reference's own, relative error below 2e-4 of the largest
|output| (tests/test_kernels.py:372) against the chunked kernel; against
the sequential oracle and the scan, which run the same steps in float32,
1e-5.  The CUDA kernel runs only on the card; ``chip_smoke.py`` holds it
to these plain versions there.  The backward's plain version
``wkv_bwd_ref`` is held to autograd and to JAX's vjp at the end, and
``wkv_bwd_chunked_ref``, the backward kernel's chunked arithmetic, to all
three within the kernel's bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_scan.ops import rwkv_wkv as jax_rwkv_wkv
from repro.kernels.rwkv_scan.ref import wkv_ref as jax_wkv_ref
from repro.models.ssm import _wkv_step as jax_wkv_step

from repro_torch.kernels.rwkv_scan import cuda as wcuda
from repro_torch.kernels.rwkv_scan.ops import rwkv_wkv
from repro_torch.kernels.rwkv_scan.ref import (
    CHUNK,
    SPLIT,
    wkv_bwd_chunked_ref,
    wkv_bwd_ref,
    wkv_chunked_ref,
    wkv_ref,
    wkv_step,
)

# the test files run in parallel worker processes: one intra-op thread
# per process keeps PyTorch's CPU kernels from oversubscribing the cores
torch.set_num_threads(1)


def inputs(BH, T, K, dscale, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((BH, T, K)).astype(np.float32) * 0.5
               for _ in range(3))
    w = 1.0 / (1.0 + np.exp(-rng.standard_normal((BH, T, K)) * dscale))
    u = rng.standard_normal((BH, K)).astype(np.float32) * 0.3
    return r, k, v, w.astype(np.float32), u


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def jax_scan_state(r, k, v, w, u):
    """The model's recurrence (ssm.rwkv_time_mix's scan) from the zero
    state, the BH rows as heads of one batch row: (outputs (BH, T, V),
    final state (BH, K, V))."""
    BH, T, K = r.shape

    def step(S, inp):
        return jax_wkv_step(S, *inp, jnp.asarray(u))

    S, outs = jax.lax.scan(step, jnp.zeros((1, BH, K, v.shape[2])),
                           tuple(jnp.moveaxis(jnp.asarray(a), 1, 0)[:, None]
                                 for a in (r, k, v, w)))
    return np.moveaxis(np.asarray(outs)[:, 0], 0, 1), np.asarray(S)[0]


@pytest.mark.parametrize("T,chunk,dscale", [(64, 16, 2.0), (100, 32, 2.0),
                                            (96, 16, 6.0), (128, 32, 10.0)])
def test_against_pallas_interpret_and_oracle(T, chunk, dscale):
    r, k, v, w, u = inputs(4, T, 64, dscale, T)
    out, state = wkv_ref(*(torch.tensor(a) for a in (r, k, v, w, u)))
    pallas = jax_rwkv_wkv(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                          chunk=chunk, interpret=True)
    assert rel(out.numpy(), pallas) < 2e-4
    assert rel(out.numpy(), jax_wkv_ref(*(jnp.asarray(a)
                                          for a in (r, k, v, w, u)))) < 1e-5
    scan_out, scan_state = jax_scan_state(r, k, v, w, u)
    assert rel(out.numpy(), scan_out) < 1e-5
    assert rel(state.numpy(), scan_state) < 1e-5


def test_model_layout_ops_against_oracle():
    """ops.rwkv_wkv takes (b, T, H, K) and a per-head bonus (H, K)."""
    b, T, H = 2, 37, 3
    r, k, v, w, _ = inputs(b * H, T, 64, 3.0, 7)
    u = np.random.default_rng(8).standard_normal((H, 64)).astype(np.float32)

    def model_layout(a):
        return torch.tensor(a.reshape(b, H, T, 64)).transpose(1, 2)

    out, state = rwkv_wkv(*(model_layout(a) for a in (r, k, v, w)),
                          torch.tensor(u))
    assert out.shape == (b, T, H, 64) and state.shape == (b, H, 64, 64)
    want_out, want_state = jax_scan_state(r, k, v, w, np.tile(u, (b, 1)))
    assert rel(out.transpose(1, 2).reshape(b * H, T, 64).numpy(),
               want_out) < 1e-5
    assert rel(state.reshape(b * H, 64, 64).numpy(), want_state) < 1e-5


def test_step_is_the_model_step():
    rng = np.random.default_rng(9)
    S = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    r, k, v, w = (rng.standard_normal((2, 3, 8)).astype(np.float32)
                  for _ in range(4))
    u = rng.standard_normal((3, 8)).astype(np.float32)
    got_s, got_o = wkv_step(*(torch.tensor(a) for a in (S, r, k, v, w, u)))
    want_s, want_o = jax_wkv_step(*(jnp.asarray(a)
                                    for a in (S, r, k, v, w, u)))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-5,
                               atol=1e-5)


def test_strong_decays_stay_finite():
    """w down to 1e-30 (|log w| ~ 69): no log-space form, no overflow."""
    r, k, v, _, u = inputs(2, 40, 64, 1.0, 10)
    w = np.full_like(r, 1e-30)
    out, state = wkv_ref(*(torch.tensor(a) for a in (r, k, v, w, u)))
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    assert rel(out.numpy(), jax_wkv_ref(*(jnp.asarray(a)
                                          for a in (r, k, v, w, u)))) < 1e-5


def test_cuda_wrapper_refuses_cpu_tensors():
    t = torch.zeros((1, 4, 1, 64))
    with pytest.raises(ValueError, match="CUDA"):
        wcuda.rwkv_wkv_cuda(t, t, t, t, torch.zeros((1, 64)))


@pytest.mark.parametrize("T,dscale,w_fill", [
    (100, 2.0, None),          # ragged against the chunk of 16
    (650, 10.0, None),         # the JAX record's prompt length, dscale 10
    (100, 3.0, 0.0),           # exp(-exp(x)) underflows to w = 0
    (64, 1.0, 1e-30),
    (650, 2.0, 0.0),
])
def test_chunked_emulation_against_jax_and_oracle(T, dscale, w_fill):
    """The kernel's chunked form (linear-domain decays, chunk CHUNK, a
    ragged last chunk padded with w = 1) against the JAX chunked Pallas
    kernel in interpret mode (outputs; it keeps no state), the model's scan
    (final state) and the port's sequential ``wkv_ref`` (both): within the
    reference's 2e-4 of the largest entry, finite at w = 0 and 1e-30 in
    every third step's even channels."""
    r, k, v, w, u = inputs(4, T, 64, dscale, T + 1)
    if w_fill is not None:
        w[:, ::3, ::2] = w_fill
    args = [torch.tensor(a) for a in (r, k, v, w, u)]
    out, state = wkv_chunked_ref(*args)
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    seq_out, seq_state = wkv_ref(*args)
    assert rel(out.numpy(), seq_out.numpy()) < 2e-4
    assert rel(state.numpy(), seq_state.numpy()) < 2e-4
    pallas = jax_rwkv_wkv(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                          chunk=32, interpret=True)
    assert rel(out.numpy(), pallas) < 2e-4
    _scan_out, scan_state = jax_scan_state(r, k, v, w, u)
    assert rel(state.numpy(), scan_state) < 2e-4


@pytest.mark.parametrize("w_value", [0.0, 1e-30])
def test_chunked_emulation_every_decay_extreme(w_value):
    """Every w at 0 or 1e-30: each step forgets the state (|log w| = inf
    or 69, where a log-space difference is NaN or a factored form
    overflows); the linear-domain products stay exact zeros or underflow."""
    r, k, v, _, u = inputs(2, 40, 64, 1.0, 10)
    w = np.full_like(r, w_value)
    args = [torch.tensor(a) for a in (r, k, v, w, u)]
    out, state = wkv_chunked_ref(*args)
    seq_out, seq_state = wkv_ref(*args)
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    assert rel(out.numpy(), seq_out.numpy()) < 2e-4
    assert rel(state.numpy(), seq_state.numpy()) < 2e-4


def test_kernel_constants():
    """csrc/rwkv_scan.cu's chunk is the emulation's, and its shared memory
    (two stages of padded r, w, k, v rows, the state, the score tile, A_L
    and u) fits kMinBlocks blocks an SM: 228 KB less 1 KB a block."""
    import pathlib
    import re

    text = (pathlib.Path(__file__).resolve().parents[1] / "src"
            / "repro_torch" / "csrc" / "rwkv_scan.cu").read_text()
    c = {m[1]: int(m[2])
         for m in re.finditer(r"constexpr int (k\w+) = (\d+);", text)}
    assert c["kChunk"] == CHUNK and c["kHead"] == 64
    L = c["kChunk"]
    stage = L * (2 * (64 + 4) + (64 + 8) + (64 + 8))
    floats = 2 * stage + 64 * (64 + 8) + L * (L + 4) + 2 * 64
    assert c["kMinBlocks"] * (4 * floats + 1024) <= 228 * 1024
    assert c["kMinBlocks"] * c["kThreads"] <= 2048
    # the B * H blocks of the rwkv6-7b prefill fill one wave
    assert 8 * 64 <= 132 * c["kMinBlocks"]


# -- the backward (csrc/rwkv_scan_bwd.cu's plain version) ------------------
#
# ``wkv_bwd_ref``, the explicit reverse recurrence, is held to autograd
# through ``wkv_ref`` and to jax.vjp through the reference's scan of
# _wkv_step, for a zero cotangent of the final state (the training path
# never uses it).  All three run the same float32 steps in different
# orders: relative 1e-5 of each gradient's largest entry, the sequential
# tolerance above.


def jax_scan_vjp(r, k, v, w, u, g):
    """Cotangents of (r, k, v, w, u) for output cotangent ``g`` through
    the reference's scan of _wkv_step, u (BH, K) per row."""
    def outs(r, k, v, w, u):
        def step(S, inp):
            return jax_wkv_step(S, *inp, u)
        _S, o = jax.lax.scan(step, jnp.zeros((1, r.shape[0], r.shape[2],
                                              v.shape[2])),
                             tuple(jnp.moveaxis(a, 1, 0)[:, None]
                                   for a in (r, k, v, w)))
        return jnp.moveaxis(o[:, 0], 0, 1)
    _, vjp = jax.vjp(outs, *(jnp.asarray(a) for a in (r, k, v, w, u)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("T,dscale,w_zero", [
    (100, 2.0, False),          # ragged against the kernel's chunk of 16
    (37, 3.0, True),            # w = 0 in every third step's even channels
    (130, 10.0, True),
])
def test_wkv_bwd_ref_against_autograd_and_jax(T, dscale, w_zero):
    r, k, v, w, u = inputs(3, T, 64, dscale, T + 1)
    if w_zero:
        w[:, ::3, ::2] = 0.0
    g = np.random.default_rng(T).standard_normal(v.shape).astype(np.float32)
    got = wkv_bwd_ref(*(torch.tensor(a) for a in (r, k, v, w, u, g)),
                      ckpt_every=16)
    leaves = [torch.tensor(a, requires_grad=True) for a in (r, k, v, w, u)]
    out, _state = wkv_ref(*leaves)
    out.backward(torch.tensor(g))
    want = jax_scan_vjp(r, k, v, w, u, g)
    assert rel(want[4], np.zeros_like(want[4])) > 0     # u is moved
    for name, a, t, j in zip("rkvwu", got, leaves, want):
        assert rel(a.numpy(), t.grad.numpy()) < 1e-5, name
        assert rel(a.numpy(), j) < 1e-5, name
    assert all(torch.isfinite(a).all() for a in got)


def test_wkv_bwd_ref_rebuilds_states_at_any_spacing():
    r, k, v, w, u = inputs(2, 45, 64, 3.0, 11)
    g = np.random.default_rng(12).standard_normal(v.shape).astype(np.float32)
    args = [torch.tensor(a) for a in (r, k, v, w, u, g)]
    every = wkv_bwd_ref(*args, ckpt_every=1)
    for spacing in (16, 64):
        for a, b in zip(wkv_bwd_ref(*args, ckpt_every=spacing), every):
            assert torch.equal(a, b)


def test_autograd_route_on_cpu_is_the_plain_recurrence():
    """ops.rwkv_wkv on CPU tensors differentiates the plain recurrence (no
    kernel, no custom backward); the CUDA backward wrapper refuses CPU
    tensors."""
    b, T, H = 1, 20, 2
    r, k, v, w, _ = inputs(b * H, T, 64, 2.0, 13)
    u = np.random.default_rng(14).standard_normal((H, 64)).astype(np.float32)
    leaves = [torch.tensor(a.reshape(b, H, T, 64)).transpose(1, 2)
              .contiguous().requires_grad_(True) for a in (r, k, v, w)]
    tu = torch.tensor(u, requires_grad=True)
    out, _state = rwkv_wkv(*leaves, tu)
    assert out.grad_fn is not None and "RwkvWkv" not in type(out.grad_fn).__name__
    out.sum().backward()
    assert all(t.grad is not None for t in leaves) and tu.grad is not None
    t = torch.zeros((1, 4, 1, 64))
    with pytest.raises(ValueError, match="CUDA"):
        wcuda.rwkv_wkv_bwd_cuda(t, t, t, t, torch.zeros((1, 64)), t)


# -- the backward kernel's chunked arithmetic (wkv_bwd_chunked_ref) ---------
#
# csrc/rwkv_scan_bwd.cu's algorithm in plain PyTorch: chunks of CHUNK
# steps, decays as products of w, the channel split's dv partials summed
# group by group.  Held, in the model's (B, T, H, 64) layout with du summed
# over b, to wkv_bwd_ref, to autograd through ops.rwkv_wkv's CPU route
# (wkv_ref) and to jax.vjp of the reference's scan: every gradient within
# WKV_REL of its largest plain entry, the kernel's bound on the card.

WKV_REL = 2e-4          # chip_smoke.WKV_REL (tests/test_kernels.py:372)


def model_layout_bwd(fn, r, k, v, w, u, g, **kw):
    """fn over the heads-first rows of (B, T, H, 64) inputs, u (H, 64);
    -> (dr, dk, dv, dw (B, T, H, 64), du (H, 64) summed over b)."""
    B, T, H, K = r.shape

    def hf(x):
        return torch.tensor(x).transpose(1, 2).reshape(B * H, T, K)

    out = fn(*(hf(x) for x in (r, k, v, w)),
             torch.tensor(np.tile(u, (B, 1))), hf(g), **kw)
    grads = [x.reshape(B, H, T, K).transpose(1, 2).numpy() for x in out[:4]]
    return (*grads, out[4].reshape(B, H, K).sum(0).numpy())


def model_inputs(B, T, H, dscale, seed, w_mode=None):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, 64)).astype(np.float32) * 0.5
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, H, 64))
                             * dscale))).astype(np.float32)
    if w_mode == "zero":                # exp(-exp(x)) underflows to 0
        w[:, ::3, :, ::2] = 0.0
    elif w_mode is not None:
        w[:] = w_mode
    u = rng.standard_normal((H, 64)).astype(np.float32) * 0.3
    g = rng.standard_normal((B, T, H, 64)).astype(np.float32)
    return r, k, v, w, u, g


def autograd_model_bwd(r, k, v, w, u, g):
    leaves = [torch.tensor(a, requires_grad=True) for a in (r, k, v, w, u)]
    out, _state = rwkv_wkv(*leaves)
    out.backward(torch.tensor(g))
    return [t.grad.numpy() for t in leaves]


def jax_model_bwd(r, k, v, w, u, g):
    B, T, H, K = r.shape

    def hf(x):
        return np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(
            B * H, T, K)

    out = jax_scan_vjp(*(hf(x) for x in (r, k, v, w)), np.tile(u, (B, 1)),
                       hf(g))
    grads = [x.reshape(B, H, T, K).transpose(0, 2, 1, 3) for x in out[:4]]
    return (*grads, out[4].reshape(B, H, K).sum(0))


@pytest.mark.parametrize("B,T,H,dscale,w_mode", [
    (1, 37, 2, 2.0, None),       # ragged against the chunk of 16, B = 1
    (2, 100, 2, 3.0, "zero"),    # w = 0 in every third step's even channels
    (2, 130, 1, 10.0, "zero"),
    (3, 9, 2, 2.0, None),        # T shorter than a chunk, du summed over 3
    (1, 40, 2, 1.0, 0.0),        # every decay extreme: w = 0, 1, 1e-30
    (1, 40, 2, 1.0, 1.0),
    (2, 40, 1, 1.0, 1e-30),
])
def test_wkv_bwd_chunked_ref_against_oracle_autograd_and_jax(B, T, H, dscale,
                                                             w_mode):
    r, k, v, w, u, g = model_inputs(B, T, H, dscale, 100 + T, w_mode)
    got = model_layout_bwd(wkv_bwd_chunked_ref, r, k, v, w, u, g)
    assert all(np.isfinite(a).all() for a in got)
    oracle = model_layout_bwd(wkv_bwd_ref, r, k, v, w, u, g, ckpt_every=16)
    auto = autograd_model_bwd(r, k, v, w, u, g)
    want = jax_model_bwd(r, k, v, w, u, g)
    for name, a, o, t, j in zip("rkvwu", got, oracle, auto, want):
        assert rel(a, o) < WKV_REL, name
        assert rel(a, t) < WKV_REL, name
        assert rel(a, j) < WKV_REL, name


def test_wkv_bwd_chunked_ref_bonus_moves_the_gradients():
    """A nonzero u: du is nonzero, and the bonus moves dr, dk and dv by far
    more than the bound, so an emulation (or kernel) that dropped or
    misplaced it could not pass; u = 0 agrees with the oracle too."""
    r, k, v, w, u, g = model_inputs(2, 70, 2, 3.0, 17, "zero")
    got = model_layout_bwd(wkv_bwd_chunked_ref, r, k, v, w, u, g)
    zero_u = model_layout_bwd(wkv_bwd_chunked_ref, r, k, v, w, 0 * u, g)
    want = jax_model_bwd(r, k, v, w, u, g)
    assert rel(got[4], np.zeros_like(got[4])) > 0
    assert rel(got[4], want[4]) < WKV_REL
    for name, a, z in zip("rkv", got[:3], zero_u[:3]):
        assert rel(a, z) > 10 * WKV_REL, name
    oracle = model_layout_bwd(wkv_bwd_ref, r, k, v, w, 0 * u, g)
    for name, a, o in zip("rkvwu", zero_u, oracle):
        assert rel(a, o) < WKV_REL, name


@pytest.mark.parametrize("split", [1, 2, SPLIT, 8])
def test_wkv_bwd_chunked_ref_channel_split(split):
    """dv summed over 1-8 channel groups in order (the cluster's CTAs)
    stays within the bound of the oracle; the other gradients do not
    depend on the split."""
    r, k, v, w, u, g = model_inputs(1, 50, 2, 2.0, 23)
    got = model_layout_bwd(wkv_bwd_chunked_ref, r, k, v, w, u, g,
                           split=split)
    one = model_layout_bwd(wkv_bwd_chunked_ref, r, k, v, w, u, g, split=1)
    oracle = model_layout_bwd(wkv_bwd_ref, r, k, v, w, u, g)
    for name, a, b, o in zip("rkvwu", got, one, oracle):
        assert rel(a, o) < WKV_REL, name
        if name != "v":
            np.testing.assert_array_equal(a, b)


def kernel_constants(name):
    """The ``constexpr int`` values of a csrc file, expressions evaluated
    in order (C++'s integer division)."""
    import pathlib
    import re

    text = (pathlib.Path(__file__).resolve().parents[1] / "src"
            / "repro_torch" / "csrc" / name).read_text()
    text = re.sub(r"//[^\n]*", "", text)
    c = {}
    for m in re.finditer(r"constexpr int (k\w+) =\s*([^;]+);", text):
        c[m[1]] = eval(" ".join(m[2].split()).replace("/", "//"), {},
                       dict(c))
    return c


def test_bwd_kernel_constants():
    """csrc/rwkv_scan_bwd.cu's chunk and channel split are the emulation's;
    its shared memory (two stages of the CTA's r, k, w columns and all of
    v and dout, S_0, dS, X, Y, G, A, k Bs, r A, the scores per warp, two
    buffers of the cluster's dv partials and their mbarriers, the chunk's
    outputs) is what this layout counts, fits a
    block (227 KB) and kMinBlocks blocks an SM (228 KB less 1 KB a block);
    the threads fit an SM and the cluster is portable (at most 8 CTAs)."""
    c = kernel_constants("rwkv_scan_bwd.cu")
    assert c["kChunk"] == CHUNK and c["kSplit"] == SPLIT
    assert c["kHead"] == 64 and c["kCh"] * c["kSplit"] == 64
    L, ch, wide = c["kChunk"], c["kCh"], c["kWRow"]
    stage = 3 * L * c["kSRow"] + 2 * L * wide
    floats = (2 * stage + 2 * ch * wide + 2 * ch * L + L * c["kGRow"]
              + L * ch + L * c["kKbRow"] + L * c["kRaRow"]
              + c["kWarps"] * L * L + 2 * c["kSplit"] * L * ch
              + 3 * L * ch + 3 * ch + 4)
    assert floats == c["kSmemFloats"]
    assert 4 * floats <= 227 * 1024
    assert c["kMinBlocks"] * (4 * floats + 1024) <= 228 * 1024
    assert c["kMinBlocks"] * c["kThreads"] <= 2048
    assert 2 <= c["kSplit"] <= 8
    # the first pass's kernel: its ring of k, w and v chunks, k Bs and A_L
    states = (c["kStatesStages"] * (2 * L * c["kSRow"] + L * wide)
              + L * c["kRaRow"] + ch)
    assert states == c["kStatesSmemFloats"]
    assert c["kStatesBlocks"] * (4 * states + 1024) <= 228 * 1024
    assert c["kStatesBlocks"] * c["kThreads"] <= 2048
    # the fragment strides: 16-byte rows for cp.async and float4 loads
    for name in ("kWRow", "kSRow", "kGRow"):
        assert c[name] % 4 == 0, name
