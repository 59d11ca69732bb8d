"""Plain PyTorch versions of the WKV kernel.

:func:`wkv_step` is the model's single recurrence step (the JAX package's
``models/ssm.py`` ``_wkv_step``) and :func:`wkv_ref` the sequential
recurrence from the zero state over (BH, T, K) (``kernels/rwkv_scan/ref.py``
``wkv_ref``), which also returns the final state.  :func:`wkv_chunked_ref`
is the CUDA kernel's chunked arithmetic (``csrc/rwkv_scan.cu``) in plain
PyTorch, for the tests and ``chip_smoke.py``; the CPU route stays
:func:`wkv_ref`.  :func:`wkv_bwd_ref` is the recurrence's backward as an
explicit reverse recurrence, the plain version of the backward kernel
(``csrc/rwkv_scan_bwd.cu``); on the CPU the model differentiates
:func:`wkv_ref` with autograd.
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


def wkv_bwd_ref(r, k, v, w, u, dout, ckpt_every: int = 64):
    """The backward of :func:`wkv_ref` for a zero cotangent of the final
    state, over (BH, T, K) (v, dout (BH, T, V), u (BH, K)) -> (dr, dk, dv,
    dw, du (BH, K)).  A reverse recurrence from dS_T = 0:
    e_t = v_t . dout_t, dr_t = S_t dout_t + u k_t e_t,
    dk_t = dS_{t+1} v_t + r_t u e_t,
    dv_t = dS_{t+1}^T k_t + (r_t . u k_t) dout_t,
    dw_t = rowsum(dS_{t+1} S_t), du = sum_t r_t k_t e_t,
    dS_t = diag(w_t) dS_{t+1} + r_t dout_t^T.  The states S_t come from the
    forward recurrence, kept every ``ckpt_every`` steps and rebuilt in
    between, so memory stays at ``ckpt_every`` states."""
    BH, T, K = r.shape
    V = v.shape[2]
    S = r.new_zeros((BH, K, V))
    starts = []
    for t in range(T):
        if t % ckpt_every == 0:
            starts.append(S)
        S, _ = wkv_step(S, r[:, t], k[:, t], v[:, t], w[:, t], u)
    grads = [torch.zeros_like(x) for x in (r, k, v, w)]
    dr, dk, dv, dw = grads
    du = torch.zeros_like(u)
    dS = r.new_zeros((BH, K, V))
    for c in reversed(range(len(starts))):
        t0 = c * ckpt_every
        states = [starts[c]]
        for t in range(t0, min(T, t0 + ckpt_every) - 1):
            states.append(w[:, t, :, None] * states[-1]
                          + k[:, t, :, None] * v[:, t, None, :])
        for t in reversed(range(t0, t0 + len(states))):
            St = states[t - t0]
            rt, kt, vt, wt, gt = r[:, t], k[:, t], v[:, t], w[:, t], dout[:, t]
            e = (vt * gt).sum(-1, keepdim=True)
            dr[:, t] = torch.einsum("bkv,bv->bk", St, gt) + u * kt * e
            dk[:, t] = torch.einsum("bkv,bv->bk", dS, vt) + rt * u * e
            dv[:, t] = (torch.einsum("bkv,bk->bv", dS, kt)
                        + (rt * u * kt).sum(-1, keepdim=True) * gt)
            dw[:, t] = (dS * St).sum(-1)
            du = du + rt * kt * e
            dS = wt[:, :, None] * dS + rt[:, :, None] * gt[:, None, :]
    return dr, dk, dv, dw, du
