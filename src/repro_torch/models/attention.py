"""Attention (GQA / MQA / MHA, sliding window, DeepSeek's MLA) with KV
caches: the JAX package's ``models/attention.py``.

Prefill attention goes through ``kernels.flash_attention.ops``: the
hand-written kernel on a CUDA tensor, the plain streaming form (the
reference's ``_mha_streaming``, ``ref.mha_streaming`` there) on a CPU
tensor.  Decode is the dense form over the
cache, all softmax math in float32.  The encoder's self-attention and the
decoder's cross-attention (whisper) are the reference's dense einsums in
plain PyTorch on either device, as the reference computes them outside
any Pallas kernel; with a ``d_head`` of 4^k their scale 1 / sqrt(d_head)
is exact, so multiplying by it is the reference's division.

MLA (multi-head latent attention) caches a normed latent ``ckv`` and one
roped key ``krope`` a position instead of every head's keys and values.
Its prefill (``mla_train``) folds the shared rope key into every head's
key, as the reference does, and runs the flash kernel with keys of
qk_nope + qk_rope and values of v_dim (192 and 128 at DeepSeek-V2's
width).  Its decode (``mla_decode``) absorbs the key up-projection into
the query and attends in the latent space, in plain PyTorch on either
device, as the reference computes it outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import STREAM_NEG_INF as NEG_INF
from repro_torch.models.layers import apply_rope, dense, rms_norm, spec


def attn_specs(cfg) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    dt = cfg.param_dtype
    if cfg.attn_type == "mla":
        m = cfg.mla
        return {
            "wq": spec((d, H, m.qk_nope + m.qk_rope), dtype=dt),
            "wkv_down": spec((d, m.kv_lora + m.qk_rope), dtype=dt),
            "kv_norm": spec((m.kv_lora,), "ones", dtype=dt),
            "wk_up": spec((m.kv_lora, H, m.qk_nope), dtype=dt),
            "wv_up": spec((m.kv_lora, H, m.v_dim), dtype=dt),
            "wo": spec((H, m.v_dim, d), dtype=dt),
        }
    out = {
        "wq": spec((d, H, hd), dtype=dt),
        "wk": spec((d, KV, hd), dtype=dt),
        "wv": spec((d, KV, hd), dtype=dt),
        "wo": spec((H, hd, d), dtype=dt),
    }
    if cfg.attn_bias:
        out["bq"] = spec((H, hd), "zeros", dtype=dt)
        out["bk"] = spec((KV, hd), "zeros", dtype=dt)
        out["bv"] = spec((KV, hd), "zeros", dtype=dt)
    if cfg.qk_norm:
        out["q_norm"] = spec((hd,), "ones", dtype=dt)
        out["k_norm"] = spec((hd,), "ones", dtype=dt)
    return out


def _project_qkv(params, cfg, x):
    q = dense(params["wq"], x, "bsd,dhe->bshe")
    k = dense(params["wk"], x, "bsd,dke->bske")
    v = dense(params["wv"], x, "bsd,dke->bske")
    if cfg.attn_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    if cfg.qk_norm:
        q = rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = rms_norm(params["k_norm"], k, cfg.norm_eps)
    return q, k, v


def attention_train(params, cfg, x, positions, return_kv=False):
    """Full-sequence causal attention.  x: (b, s, d)."""
    q, k, v = _project_qkv(params, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.window if cfg.attn_type == "swa" else None
    out = flash_ops.flash_attention(q, k, v, window=window,
                                    scale=1.0 / math.sqrt(cfg.d_head))
    y = dense(params["wo"], out, "bshe,hed->bsd")
    if return_kv:
        return y, _ring_cache_entry(cfg, k, v)
    return y


def _ring_cache_entry(cfg, k, v):
    """Prefill K/V in the decode cache's layout.  Full attention: as is.
    SWA: the last ``window`` positions at ring slots ``pos % window``."""
    if cfg.attn_type != "swa":
        return {"k": k, "v": v}
    S, W = k.shape[1], cfg.window
    if S <= W:
        def pad(a):
            return torch.cat([a, a.new_zeros((a.shape[0], W - S)
                                             + a.shape[2:])], dim=1)
        return {"k": pad(k), "v": pad(v)}
    # slot i <- largest position p < S with p % W == i
    slots = torch.arange(W, device=k.device)
    pos = (S - 1) - ((S - 1 - slots) % W)
    return {"k": k[:, pos], "v": v[:, pos]}


def init_cache(cfg, batch: int, max_seq: int, device):
    """A zero decode cache.  SWA caches only the window (ring buffer); MLA
    the latent and the rope key of every position."""
    if cfg.attn_type == "mla":
        m = cfg.mla
        return {"ckv": torch.zeros((batch, max_seq, m.kv_lora),
                                   dtype=cfg.param_dtype, device=device),
                "krope": torch.zeros((batch, max_seq, m.qk_rope),
                                     dtype=cfg.param_dtype, device=device)}
    seq = min(max_seq, cfg.window) if cfg.attn_type == "swa" else max_seq
    shape = (batch, seq, cfg.n_kv, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.param_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.param_dtype, device=device)}


def attention_decode(params, cfg, x, cache, position: int):
    """One-token decode against a populated cache.

    x: (b, 1, d); position: index of the new token.  Returns (out, cache):
    the new K/V are written into ``cache`` in place (SWA: at ring slot
    ``position % window``), where the reference returns an updated copy.
    Query head h reads kv head h // (H / KV); all softmax math in float32.
    """
    b = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.d_head
    q, k_new, v_new = _project_qkv(params, cfg, x)
    pos_arr = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos_arr, cfg.rope_theta)
    k_new = apply_rope(k_new, pos_arr, cfg.rope_theta)

    swa = cfg.attn_type == "swa"
    slot = position % cfg.window if swa else position
    k, v = cache["k"], cache["v"]
    k[:, slot] = k_new[:, 0]
    v[:, slot] = v_new[:, 0]

    S = k.shape[1]
    idx = torch.arange(S, device=x.device)
    if swa:
        # slot i holds the absolute position p with p % window == i and
        # p in (position - window, position]
        W = cfg.window
        base = position - (position % W)
        k_pos = torch.where(idx <= (position % W), base + idx, base - W + idx)
        valid = (k_pos >= 0) & (k_pos > position - W) & (k_pos <= position)
    else:
        valid = idx <= position

    qg = q.float().reshape(b, 1, KV, H // KV, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(hd)
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    out = out.reshape(b, 1, H, hd).to(x.dtype)
    return dense(params["wo"], out, "bshe,hed->bsd"), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent KV compression
# ---------------------------------------------------------------------------


def _mla_latent(params, cfg, x, positions):
    """x (b, s, d) -> (q_nope, roped q_rope, normed ckv, roped k_rope):
    the query heads and the per-position latent and rope key."""
    m = cfg.mla
    q = dense(params["wq"], x, "bsd,dhe->bshe")
    q_nope, q_rope = q.split([m.qk_nope, m.qk_rope], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv = dense(params["wkv_down"], x, "bsd,de->bse")
    ckv, k_rope = kv.split([m.kv_lora, m.qk_rope], dim=-1)
    ckv = rms_norm(params["kv_norm"], ckv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, k_rope


def mla_train(params, cfg, x, positions, return_kv=False):
    """Full-sequence causal MLA.  x: (b, s, d).  The rope key, shared by
    the heads, is folded into each head's key: attention over
    [nope, rope] keys is the two-term MLA logit sum, with the scale
    1 / sqrt(qk_nope + qk_rope).  The cache entry is the normed latent
    and the roped key."""
    m = cfg.mla
    q_nope, q_rope, ckv, k_rope = _mla_latent(params, cfg, x, positions)
    q = torch.cat([q_nope, q_rope], dim=-1)
    del q_nope, q_rope
    k_nope = dense(params["wk_up"], ckv, "bse,ehn->bshn")
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        k_nope.shape[:3] + (m.qk_rope,))], dim=-1)
    del k_nope
    v = dense(params["wv_up"], ckv, "bse,ehn->bshn")
    out = flash_ops.flash_attention(
        q, k, v, scale=1.0 / math.sqrt(m.qk_nope + m.qk_rope))
    del q, k, v
    y = dense(params["wo"], out, "bshe,hed->bsd")
    if return_kv:
        return y, {"ckv": ckv, "krope": k_rope}
    return y


def mla_decode(params, cfg, x, cache, position: int):
    """One-token MLA decode against a populated cache, with the key
    up-projection absorbed into the query: scores and values in the
    latent space.  x: (b, 1, d); the new latent and rope key are written
    into ``cache`` in place.  The reference's roundings: q_lat and o_lat
    in x's dtype, the logits as two float32 sums, the softmax in float32
    (every product of exactly upcast operands, float32 sums)."""
    m = cfg.mla
    b = x.shape[0]
    pos_arr = torch.full((b, 1), position, dtype=torch.int32,
                         device=x.device)
    q_nope, q_rope, ckv_new, k_rope_new = _mla_latent(params, cfg, x,
                                                      pos_arr)
    ckv, krope = cache["ckv"], cache["krope"]
    ckv[:, position] = ckv_new[:, 0]
    krope[:, position] = k_rope_new[:, 0]

    q_lat = torch.einsum("bshn,ehn->bshe", q_nope.float(),
                         params["wk_up"].float()).to(x.dtype)
    logits = torch.einsum("bshe,bte->bhst", q_lat.float(), ckv.float())
    logits = logits + torch.einsum("bshr,btr->bhst", q_rope.float(),
                                   krope.float())
    valid = torch.arange(ckv.shape[1], device=x.device) <= position
    scale = 1.0 / math.sqrt(m.qk_nope + m.qk_rope)
    probs = torch.softmax(torch.where(valid, logits * scale, NEG_INF),
                          dim=-1)
    o_lat = torch.einsum("bhst,bte->bshe", probs, ckv.float()).to(x.dtype)
    out = torch.einsum("bshe,ehn->bshn", o_lat.float(),
                       params["wv_up"].float()).to(x.dtype)
    return dense(params["wo"], out, "bshe,hed->bsd"), cache


# ---------------------------------------------------------------------------
# The encoder and cross attention (whisper): dense, plain PyTorch
# ---------------------------------------------------------------------------


def _mha(q, k, v, mask, scale):
    """q: (b, s, kv, g, d), k/v: (b, t, kv, d), mask: (s, t) bool or None
    (attend everywhere) -> (b, s, kv, g, d).  The reference's dense form:
    logits in float32 from exactly upcast operands, softmax in float32, the
    probabilities cast to v's dtype before the PV product, the output cast
    to v's dtype."""
    logits = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype)


def cross_attn_specs(cfg) -> dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.d_head
    dt = cfg.param_dtype
    return {"wq": spec((d, H, hd), dtype=dt), "wk": spec((d, H, hd), dtype=dt),
            "wv": spec((d, H, hd), dtype=dt), "wo": spec((H, hd, d), dtype=dt)}


def cross_kv(params, enc_out):
    """The cross-attention keys and values of the encoder output
    (b, t, d) -> two (b, t, H, d_head): what a request's decode cache
    holds."""
    return (dense(params["wk"], enc_out, "btd,dhe->bthe"),
            dense(params["wv"], enc_out, "btd,dhe->bthe"))


def cross_attend(params, cfg, x, k, v):
    """Queries of x (b, s, d) against cross keys and values (no mask)."""
    q = dense(params["wq"], x, "bsd,dhe->bshe")
    b, s, H, hd = q.shape
    out = _mha(q.reshape(b, s, H, 1, hd), k, v, None, 1.0 / math.sqrt(hd))
    return dense(params["wo"], out.reshape(b, s, H, hd), "bshe,hed->bsd")


def cross_attention(params, cfg, x, enc_out):
    """x: (b, s, d) queries; enc_out: (b, t, d) keys/values (no mask)."""
    return cross_attend(params, cfg, x, *cross_kv(params, enc_out))


def bidir_attention(params, cfg, x):
    """Encoder self-attention (no mask)."""
    b, s, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.d_head
    q, k, v = _project_qkv(params, cfg, x)
    out = _mha(q.reshape(b, s, KV, H // KV, hd), k, v, None,
               1.0 / math.sqrt(hd))
    return dense(params["wo"], out.reshape(b, s, H, hd), "bshe,hed->bsd")
