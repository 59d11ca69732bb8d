"""Plain PyTorch versions of the flash-attention kernel.

:func:`attention_ref` is the JAX package's dense oracle
(``kernels/flash_attention/ref.py``) over (BH, s, d); :func:`mha_streaming`
is the model's chunked online softmax (``models/attention.py``
``_mha_streaming``) over the model's (b, s, H, d) layout, which never holds
the (s, t) logits: at s = 32768 the dense form would need 34 GB.
:func:`flash_attention_bwd_ref` is the plain backward of both, from the
forward's output and log-sum-exp, for the tests and ``chip_smoke.py``; on
the CPU the model differentiates :func:`mha_streaming` with autograd.  The
two
mask constants differ (-1e30 here and in the kernel, -0.7 * float32 max in
the streaming form); under a causal mask every row sees its own key, so a
masked logit never wins and the results agree.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30
STREAM_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_ref(q, k, v, *, window=None, scale=None):
    """q: (BH, s, d), k/v: (BH, t, d|dv) -> (BH, s, dv) in q's dtype.
    Dense causal softmax in float32."""
    s, d = q.shape[1], q.shape[2]
    t = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("hsd,htd->hst", q.float(), k.float()) * scale
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    logits = torch.where(mask[None], logits, NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    return torch.einsum("hst,htd->hsd", probs, v.float()).to(q.dtype)


def pick_chunk(t: int, target: int = 1024) -> int:
    """Largest divisor of t that is <= target."""
    c = min(t, target)
    while t % c:
        c -= 1
    return c


def mha_streaming(q, k, v, q_pos, k_pos, scale, window=None, chunk=1024,
                  return_lse=False):
    """Online-softmax attention over key chunks.

    q: (b, s, H, d); k, v: (b, t, H, d|dv), GQA already expanded;
    q_pos: (s,), k_pos: (t,).  Returns (b, s, H, dv) in v's dtype, and
    with ``return_lse`` also each row's log-sum-exp m + log l of its
    scaled logits, (b, H, s) float32.  Peak temporary per chunk is (b, H,
    s, chunk) float32.
    """
    b, s, H, d = q.shape
    t = k.shape[1]
    dv = v.shape[-1]
    c = pick_chunk(t, chunk)
    q32 = q.float() * scale
    m = torch.full((b, H, s), STREAM_NEG_INF, device=q.device)
    l = torch.zeros((b, H, s), device=q.device)
    acc = torch.zeros((b, H, s, dv), device=q.device)
    for c0 in range(0, t, c):
        k_i = k[:, c0:c0 + c].float()
        v_i = v[:, c0:c0 + c].float()
        p_i = k_pos[c0:c0 + c]
        logits = torch.einsum("bshd,bchd->bhsc", q32, k_i)
        valid = p_i[None, :] <= q_pos[:, None]
        if window is not None:
            valid &= p_i[None, :] > (q_pos[:, None] - window)
        logits = torch.where(valid[None, None], logits, STREAM_NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhsc,bchd->bhsd", p, v_i)
        m = m_new
    out = acc / l.clamp_min(1e-37)[..., None]
    out = out.transpose(1, 2).to(v.dtype)
    if return_lse:
        return out, m + torch.log(l.clamp_min(1e-37))
    return out


def flash_attention_bwd_ref(q, k, v, o, dout, lse, *, window=None,
                            scale=None, chunk=1024):
    """The backward of causal attention from the forward's output ``o``
    and log-sum-exp ``lse``: q, o, dout (b, s, H, d), k, v (b, t, KV, d),
    lse (b, H, s) -> (dq, dk, dv) in q's dtype.  In float32 with the kv
    heads expanded, over query chunks of ``chunk`` rows:
    P = exp(scale q k^T - lse) (0 where masked), Dl = rowsum(dout o),
    dV = P^T dout, dS = P (dout V^T - Dl), dQ = scale dS K,
    dK = scale dS^T Q; then each kv head's gradient is the sum of its
    H / KV query heads'."""
    b, s, H, d = q.shape
    t, KV = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    g = H // KV
    ke = k.float().repeat_interleave(g, dim=2)
    ve = v.float().repeat_interleave(g, dim=2)
    delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)   # (b, H, s)
    dq = torch.empty((b, s, H, d), device=q.device)
    dk = torch.zeros((b, t, H, d), device=q.device)
    dv = torch.zeros((b, t, H, v.shape[-1]), device=q.device)
    k_pos = torch.arange(t, device=q.device)
    for i0 in range(0, s, chunk):
        qc = q[:, i0:i0 + chunk].float()
        gc = dout[:, i0:i0 + chunk].float()
        q_pos = torch.arange(i0, i0 + qc.shape[1], device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        logits = torch.einsum("bshd,bthd->bhst", qc, ke) * scale
        p = torch.exp(logits - lse[:, :, i0:i0 + chunk, None])
        p = torch.where(mask[None, None], p, 0.0)
        dv += torch.einsum("bhst,bshd->bthd", p, gc)
        dp = torch.einsum("bshd,bthd->bhst", gc, ve)
        ds = p * (dp - delta[:, :, i0:i0 + chunk, None])
        dq[:, i0:i0 + chunk] = torch.einsum("bhst,bthd->bshd", ds, ke) * scale
        dk += torch.einsum("bhst,bshd->bthd", ds, qc) * scale
    dk = dk.reshape(b, t, KV, g, d).sum(3)
    dv = dv.reshape(b, t, KV, g, v.shape[-1]).sum(3)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
