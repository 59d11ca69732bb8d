"""Plain PyTorch versions of the WKV kernel.

:func:`wkv_step` is the model's single recurrence step (the JAX package's
``models/ssm.py`` ``_wkv_step``) and :func:`wkv_ref` the sequential
recurrence from the zero state over (BH, T, K) (``kernels/rwkv_scan/ref.py``
``wkv_ref``), which also returns the final state.  :func:`wkv_chunked_ref`
is the CUDA kernel's chunked arithmetic (``csrc/rwkv_scan.cu``) in plain
PyTorch, for the tests and ``chip_smoke.py``; the CPU route stays
:func:`wkv_ref`.  :func:`wkv_bwd_ref` is the recurrence's backward as an
explicit reverse recurrence, the plain version of the backward kernel
(``csrc/rwkv_scan_bwd.cu``), and :func:`wkv_bwd_chunked_ref` that kernel's
chunked arithmetic, for the tests and ``chip_smoke.py``; on the CPU the
model differentiates :func:`wkv_ref` with autograd.
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


SPLIT = 4       # csrc/rwkv_scan_bwd.cu kSplit: CTAs (channel groups) a head


def wkv_bwd_chunked_ref(r, k, v, w, u, dout, chunk: int = CHUNK,
                        split: int = SPLIT):
    """The backward kernel's chunked arithmetic (``csrc/rwkv_scan_bwd.cu``)
    over (BH, T, K), same contract as :func:`wkv_bwd_ref`.  A first pass
    carries S chunk by chunk as :func:`wkv_chunked_ref` does and keeps it
    at every chunk start; the chunks are then walked in reverse from
    dS_L = 0.  Per chunk of L steps, with S_0 the state at its start, dS_L
    the cotangent at its end, A_t = prod_{m<t} w_m, Bs_t = prod_{m>t} w_m,
    D_ti = prod_{i<m<t} w_m (all products, no division: w = 0 is exact)
    and a_ti = D_ti k_i (i < t), the Gram products
    X = S_0 dout^T, Y = dS_L v^T, G = v dout^T and SdS = rowsum(S_0 dS_L)
    give, channel by channel (i, j, t in the chunk),
    W_it = v_i . dS_{t+1} = Bs_t Y_i + sum_{j>t} D_jt r_j G_ij,
    U_t = S_0 . dS_{t+1} = Bs_t SdS + sum_{j>t} D_jt r_j X_j,
    dr_t = A_t X_t + sum_{i<t} a_ti G_it + u k_t G_tt,
    dk_t = W_tt + r_t u G_tt,  dw_t = A_t U_t + sum_{i<t} a_ti W_it,
    du += r_t k_t G_tt; dv = (k Bs) dS_L + P^T dout with the forward's
    scores P_ti = sum_k r_t a_ti (i < t), P_tt = sum_k r_t u k_t, summed
    group by group over ``split`` groups of channels in order, as the
    kernel's cluster sums its CTAs' partials; and the carry
    dS_0 = diag(A_L) dS_L + (r A)^T dout.  A ragged last chunk is padded
    with r = k = v = dout = 0 and w = 1."""
    BH, T, K = r.shape
    V = v.shape[2]
    L = chunk
    pad = (-T) % L
    if pad:
        r, k, v, dout = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                         for t in (r, k, v, dout))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad), value=1.0)
    n = (T + pad) // L
    idx = torch.arange(L, device=r.device)
    later = idx[:, None] > idx[None, :]                   # (t, i): t > i
    ones = r.new_ones((BH, 1, K))
    starts, S = [], r.new_zeros((BH, K, V))
    for c in range(n):
        starts.append(S)
        kc, vc, wc = (t[:, c * L:(c + 1) * L] for t in (k, v, w))
        suffix = torch.cumprod(wc.flip(1), dim=1).flip(1)
        Bs = torch.cat([suffix[:, 1:], ones], dim=1)
        S = suffix[:, 0, :, None] * S + (kc * Bs).transpose(1, 2) @ vc
    grads = [torch.zeros_like(t) for t in (r, k, v, w)]
    dr, dk, dv, dw = grads
    du = torch.zeros_like(u)
    dS = r.new_zeros((BH, K, V))
    groups = torch.arange(K, device=r.device).chunk(split)
    for c in reversed(range(n)):
        sl = slice(c * L, (c + 1) * L)
        rc, kc, vc, wc, gc = (t[:, sl] for t in (r, k, v, w, dout))
        S0 = starts[c]
        incl = torch.cumprod(wc, dim=1)
        A = torch.cat([ones, incl[:, :-1]], dim=1)        # (BH, L, K)
        suffix = torch.cumprod(wc.flip(1), dim=1).flip(1)
        Bs = torch.cat([suffix[:, 1:], ones], dim=1)
        # D[t, i] = prod_{i<m<t} w_m for t > i (1 where t <= i, unused)
        M = torch.where(later[None, :, :, None], wc[:, :, None, :], 1.0)
        D = torch.cat([r.new_ones((BH, 1, L, K)),
                       torch.cumprod(M, dim=1)[:, :-1]], dim=1)
        a = torch.where(later[None, :, :, None], D * kc[:, None], 0.0)
        X = S0 @ gc.transpose(1, 2)                       # (BH, K, L)
        Y = dS @ vc.transpose(1, 2)                       # (BH, K, L)
        G = vc @ gc.transpose(1, 2)                       # (BH, L, L)
        SdS = (S0 * dS).sum(-1)                           # (BH, K)
        diag = torch.diagonal(G, dim1=1, dim2=2)          # e_t
        # b[j, t] = D_jt r_j for j > t
        b = torch.where(later[None, :, :, None], D * rc[:, :, None], 0.0)
        W = (Bs[:, None, :, :] * Y.transpose(1, 2)[:, :, None, :]
             + torch.einsum("bjtk,bij->bitk", b, G))      # (BH, i, t, K)
        U = Bs * SdS[:, None] + torch.einsum("bjtk,bkj->btk", b, X)
        dr[:, sl] = (A * X.transpose(1, 2)
                     + torch.einsum("btik,bit->btk", a, G)
                     + u[:, None] * kc * diag[..., None])
        dk[:, sl] = (torch.diagonal(W, dim1=1, dim2=2).transpose(1, 2)
                     + rc * u[:, None] * diag[..., None])
        dw[:, sl] = A * U + torch.einsum("btik,bitk->btk", a, W)
        du = du + (rc * kc * diag[..., None]).sum(1)
        part = None
        for grp in groups:
            P = torch.einsum("btk,btik->bti", rc[..., grp], a[..., grp])
            P = P + torch.diag_embed((rc[..., grp] * u[:, None, grp]
                                      * kc[..., grp]).sum(-1))
            g = ((kc * Bs)[..., grp] @ dS[:, grp]
                 + P.transpose(1, 2) @ gc)
            part = g if part is None else part + g
        dv[:, sl] = part
        dS = incl[:, -1, :, None] * dS + (rc * A).transpose(1, 2) @ gc
    return (*(g[:, :T] for g in grads), du)
