"""Plain PyTorch versions of the WKV kernel.

:func:`wkv_step` is the model's single recurrence step (the JAX package's
``models/ssm.py`` ``_wkv_step``) and :func:`wkv_ref` the sequential
recurrence from the zero state over (BH, T, K) (``kernels/rwkv_scan/ref.py``
``wkv_ref``), which also returns the final state.  :func:`wkv_chunked_ref`
is the CUDA kernel's chunked arithmetic (``csrc/rwkv_scan.cu``) in plain
PyTorch, for the tests and ``chip_smoke.py``; the CPU route stays
:func:`wkv_ref`.
"""

from __future__ import annotations

import torch


def wkv_step(state, r, k, v, w, u):
    """One step.  r, k, w: (..., K); v: (..., V); u broadcastable to
    (..., K); state: (..., K, V) float32 -> (new_state, out (..., V))."""
    kv = k[..., :, None] * v[..., None, :]
    out = torch.einsum("...k,...kv->...v", r, state + u[..., :, None] * kv)
    return w[..., :, None] * state + kv, out


def wkv_ref(r, k, v, w, u):
    """r/k/w: (BH, T, K), v: (BH, T, V), u: (BH, K), float32 ->
    (out (BH, T, V), final state (BH, K, V))."""
    BH, T, K = r.shape
    state = torch.zeros((BH, K, v.shape[2]), device=r.device)
    outs = []
    for t in range(T):
        state, out = wkv_step(state, r[:, t], k[:, t], v[:, t], w[:, t], u)
        outs.append(out)
    out = torch.stack(outs, dim=1) if outs else v.new_zeros(v.shape)
    return out, state


CHUNK = 16      # csrc/rwkv_scan.cu kChunk


def wkv_chunked_ref(r, k, v, w, u, chunk: int = CHUNK):
    """The kernel's chunked form over (BH, T, K), same contract as
    :func:`wkv_ref`.  Per chunk of ``chunk`` steps, every decay a product
    of w's in the linear domain (no logarithm, so w = 0 is exact):
    A_t = prod_{j<t} w_j, Bs_i = prod_{j>i} w_j, D_ti = prod_{i<j<t} w_j;
    out_t = (r_t A_t) . S + sum_{i<t} (sum_k r_t k_i D_ti) v_i
    + (r_t . u k_t) v_t and S' = diag(A_L) S + sum_i (k_i Bs_i) v_i^T.  A
    ragged last chunk is padded with r = k = v = 0 and w = 1."""
    BH, T, K = r.shape
    V = v.shape[2]
    pad = (-T) % chunk
    if pad:
        r, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                   for t in (r, k, v))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad), value=1.0)
    L = chunk
    later = torch.arange(L, device=r.device)
    later = later[:, None] > later[None, :]               # (j, i): j > i
    ones = r.new_ones((BH, 1, K))
    S = r.new_zeros((BH, K, V))
    outs = []
    for t0 in range(0, T + pad, L):
        rc, kc, vc, wc = (t[:, t0:t0 + L] for t in (r, k, v, w))
        incl = torch.cumprod(wc, dim=1)
        A = torch.cat([ones, incl[:, :-1]], dim=1)
        suffix = torch.cumprod(wc.flip(1), dim=1).flip(1)
        Bs = torch.cat([suffix[:, 1:], ones], dim=1)
        # D[t, i] = prod_{j<t} (w_j if j > i else 1)
        M = torch.where(later[None, :, :, None], wc[:, :, None, :], 1.0)
        D = torch.cat([r.new_ones((BH, 1, L, K)),
                       torch.cumprod(M, dim=1)[:, :-1]], dim=1)
        P = torch.einsum("btk,bik,btik->bti", rc, kc, D) * later
        P = P + torch.diag_embed((rc * u[:, None, :] * kc).sum(-1))
        outs.append((rc * A) @ S + P @ vc)
        S = incl[:, -1, :, None] * S + (kc * Bs).transpose(1, 2) @ vc
    out = torch.cat(outs, dim=1)[:, :T] if outs else v.new_zeros(v.shape)
    return out, S
