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
to these plain versions there.
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
