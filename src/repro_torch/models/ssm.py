"""Attention-free sequence mixers: RWKV6 (Finch) time-mix and
channel-mix, and Mamba, Jamba's mixer (the JAX package's
``models/ssm.py``).

RWKV: a prefill from the zero state runs the WKV recurrence through
``kernels.rwkv_scan.ops`` (the hand-written kernel on a CUDA tensor, the
plain sequential recurrence on a CPU tensor); a call with a carried state
(decode) runs the plain single step, as the reference computes it outside
any Pallas kernel.

Mamba: the reference has no Pallas kernel for it (its ``_mamba_scan`` is a
``jax.lax.scan``), so the selective scan here is plain PyTorch, a step at
a time.  The reference builds the scan's ``exp(delta A)`` and ``Bx`` whole,
(b, s, d_inner, d_state) in float32 (17.2 GB each at 8 x 4096 tokens of
jamba's full width); :func:`_mamba_scan` builds them one chunk of time
steps at a time from the same elementwise products, so any chunk size
gives the same bits.  Under autograd each chunk runs under
``torch.utils.checkpoint``, so that training keeps one chunk's buffers at
a time in the backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.rwkv_scan import ops as wkv_ops
from repro_torch.kernels.rwkv_scan.ref import wkv_step as _wkv_step
from repro_torch.models.layers import dense, rms_norm, spec

RWKV_HEAD_DIM = 64
RWKV_LORA_MIX = 32
RWKV_LORA_DECAY = 64


def rwkv_time_mix_specs(cfg) -> dict:
    d, dt = cfg.d_model, cfg.param_dtype
    H = d // RWKV_HEAD_DIM
    return {
        "mu_base": spec((5, d), "zeros", dtype=dt),
        "maa_w1": spec((d, 5 * RWKV_LORA_MIX), dtype=dt),
        "maa_w2": spec((5, RWKV_LORA_MIX, d), dtype=dt),
        "decay_base": spec((d,), "zeros", dtype=torch.float32),
        "decay_w1": spec((d, RWKV_LORA_DECAY), dtype=dt),
        "decay_w2": spec((RWKV_LORA_DECAY, d), dtype=dt),
        "bonus": spec((H, RWKV_HEAD_DIM), "zeros", dtype=torch.float32),
        "wr": spec((d, d), dtype=dt),
        "wk": spec((d, d), dtype=dt),
        "wv": spec((d, d), dtype=dt),
        "wg": spec((d, d), dtype=dt),
        "wo": spec((d, d), dtype=dt),
        "ln_scale": spec((d,), "ones", dtype=dt),
    }


def _rwkv_mix_inputs(params, x, x_prev):
    """Data-dependent token-shift interpolation -> [xw, xk, xv, xr, xg]."""
    xx = x_prev - x
    base = x + xx * params["mu_base"][0].to(x.dtype)
    lora = torch.tanh(dense(params["maa_w1"], base, "...d,de->...e"))
    lora = lora.reshape(*lora.shape[:-1], 5, RWKV_LORA_MIX)
    deltas = torch.einsum("...fe,fed->...fd", lora.float(),
                          params["maa_w2"].float()).to(x.dtype)
    return [x + xx * (params["mu_base"][i].to(x.dtype) + deltas[..., i, :])
            for i in range(5)]


def _rwkv_decay(params, xw):
    lora = torch.tanh(dense(params["decay_w1"], xw, "...d,de->...e"))
    dd = dense(params["decay_w2"], lora, "...e,ed->...d").float()
    return torch.exp(-torch.exp(params["decay_base"] + dd))     # in (0, 1)


def rwkv_state_init(cfg, batch: int, device):
    d = cfg.d_model
    H = d // RWKV_HEAD_DIM
    return {
        "x_prev": torch.zeros((batch, d), dtype=cfg.param_dtype,
                              device=device),
        "wkv": torch.zeros((batch, H, RWKV_HEAD_DIM, RWKV_HEAD_DIM),
                           device=device),
        "x_prev_cm": torch.zeros((batch, d), dtype=cfg.param_dtype,
                                 device=device),
    }


def rwkv_time_mix(params, cfg, x, state=None):
    """x: (b, s, d) -> (out, new_state).  ``state`` None: a prefill from
    the zero state through the WKV kernel's ops."""
    b, s, d = x.shape
    H = d // RWKV_HEAD_DIM
    x_prev = (torch.zeros((b, d), dtype=x.dtype, device=x.device)
              if state is None else state["x_prev"])
    x_prev_seq = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _rwkv_mix_inputs(params, x, x_prev_seq)

    heads = (b, s, H, RWKV_HEAD_DIM)
    r = dense(params["wr"], xr, "bsd,de->bse").reshape(heads)
    k = dense(params["wk"], xk, "bsd,de->bse").reshape(heads)
    v = dense(params["wv"], xv, "bsd,de->bse").reshape(heads)
    g = dense(params["wg"], xg, "bsd,de->bse")
    w = _rwkv_decay(params, xw).reshape(heads)
    u = params["bonus"]
    r32, k32, v32 = r.float(), k.float(), v.float()

    if state is None:
        out, new_wkv = wkv_ops.rwkv_wkv(r32, k32, v32, w, u)
    else:
        new_wkv, outs = state["wkv"], []
        for t in range(s):
            new_wkv, o = _wkv_step(new_wkv, r32[:, t], k32[:, t], v32[:, t],
                                   w[:, t], u)
            outs.append(o)
        out = torch.stack(outs, dim=1)

    # per-head group norm, gate, project
    mu = out.mean(dim=-1, keepdim=True)
    var = out.var(dim=-1, keepdim=True, correction=0)
    out = ((out - mu) * torch.rsqrt(var + 64e-5)).reshape(b, s, d)
    out = out * params["ln_scale"].float()
    out = out.to(x.dtype) * F.silu(g.float()).to(x.dtype)
    y = dense(params["wo"], out, "bsd,de->bse")

    x_prev_cm = (torch.zeros((b, d), dtype=cfg.param_dtype, device=x.device)
                 if state is None else state["x_prev_cm"])
    return y, {"x_prev": x[:, -1], "wkv": new_wkv, "x_prev_cm": x_prev_cm}


def rwkv_channel_mix_specs(cfg) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {
        "mu_k": spec((d,), "zeros", dtype=dt),
        "mu_r": spec((d,), "zeros", dtype=dt),
        "wk": spec((d, f), dtype=dt),
        "wv": spec((f, d), dtype=dt),
        "wr": spec((d, d), dtype=dt),
    }


def rwkv_channel_mix(params, cfg, x, x_prev_last=None):
    """RWKV6 channel-mix (squared-ReLU FFN with token shift) ->
    (out, last input row)."""
    b, s, d = x.shape
    if x_prev_last is None:
        x_prev_last = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    x_prev = torch.cat([x_prev_last[:, None], x[:, :-1]], dim=1)
    xx = x_prev - x
    xk = x + xx * params["mu_k"].to(x.dtype)
    xr = x + xx * params["mu_r"].to(x.dtype)
    k = dense(params["wk"], xk, "bsd,df->bsf")
    k = torch.square(F.relu(k.float())).to(x.dtype)
    kv = dense(params["wv"], k, "bsf,fd->bsd")
    r = torch.sigmoid(dense(params["wr"], xr, "bsd,de->bse").float())
    return r.to(x.dtype) * kv, x[:, -1]


# ---------------------------------------------------------------------------
# Mamba (selective SSM): Jamba's mixer
# ---------------------------------------------------------------------------

# the scan's chunk: time steps whose float32 (b, steps, d_inner, d_state)
# buffers (exp(delta A), Bx, the states) stay within this many bytes each:
# 256 steps at 8 requests of jamba's full width
MAMBA_CHUNK_BYTES = 2 ** 30


def mamba_specs(cfg, m) -> dict:
    d, dt = cfg.d_model, cfg.param_dtype
    di = m.expand * d
    return {
        "in_proj": spec((d, 2 * di), dtype=dt),
        "conv_w": spec((m.d_conv, di), scale=1.0, dtype=dt),
        "conv_b": spec((di,), "zeros", dtype=dt),
        "x_proj": spec((di, m.dt_rank + 2 * m.d_state), dtype=dt),
        "dt_proj": spec((m.dt_rank, di), dtype=dt),
        "dt_bias": spec((di,), "zeros", dtype=torch.float32),
        "A_log": spec((di, m.d_state), "zeros", dtype=torch.float32),
        "D": spec((di,), "ones", dtype=torch.float32),
        "out_proj": spec((di, d), dtype=dt),
        # Jamba adds RMS norms on dt, B and C
        "dt_norm": spec((m.dt_rank,), "ones", dtype=dt),
        "b_norm": spec((m.d_state,), "ones", dtype=dt),
        "c_norm": spec((m.d_state,), "ones", dtype=dt),
    }


def mamba_state_init(cfg, m, batch: int, device):
    di = m.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, m.d_conv - 1, di), dtype=cfg.param_dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, m.d_state), device=device),
    }


def mamba_chunk(b: int, di: int, n: int) -> int:
    """Time steps a chunk of the scan: MAMBA_CHUNK_BYTES of float32
    (b, steps, di, n)."""
    return max(1, MAMBA_CHUNK_BYTES // (4 * b * di * n))


def _scan_chunk(h, delta, A, B, xc, C):
    """One chunk of :func:`_mamba_scan`: its ``exp(delta A)`` and ``Bx``,
    the steps from state ``h`` and the readout -> (y of the chunk, its last
    state).  The steps take their operands from ``unbind``, whose backward
    is one stack (a select's is a zero fill of the whole chunk buffer and
    an add)."""
    dA = torch.exp(delta[..., None] * A)
    Bx = (delta[..., None] * B[:, :, None, :]) * xc[..., None]
    hs = []
    for dA_t, Bx_t in zip(dA.unbind(1), Bx.unbind(1)):
        h = torch.addcmul(Bx_t, dA_t, h)
        hs.append(h)
    del dA, Bx
    return (torch.stack(hs, dim=1) * C[:, :, None, :]).sum(-1), h


def _mamba_scan(delta, A, B, xc, C, h0=None, chunk=None):
    """The reference's ``_mamba_scan(delta, A, Bx, C, h0)`` with its Bx
    given by its factors: h_t = exp(delta_t A) h_{t-1} + Bx_t, y_t = C_t .
    h_t, where Bx = (delta B) xc, in that association.
    delta, xc: (b, s, di); A: (di, n); B, C: (b, s, n); h0: (b, di, n) or
    None (zero), all float32 -> (y (b, s, di), h_s).  ``exp(delta A)`` and
    ``Bx`` are built ``chunk`` time steps at a time (``mamba_chunk`` when
    None), so no (b, s, di, n) tensor is made.  Every step is one
    ``addcmul`` whatever the chunk, so the bits are the same at any chunk
    size; where its multiply-add is fused (PyTorch's CPU kernel, and nvcc
    contracts it on the card) it rounds once, as the reference's XLA
    does with its FMA.

    Under autograd (grad enabled and an input that requires it) each chunk
    runs under ``torch.utils.checkpoint``: the backward keeps only the
    chunk-start states besides the inputs, and rebuilds one chunk's
    ``exp(delta A)``, ``Bx``, states and their stack at a time, with the
    same bits as autograd through the chunks without checkpoints.  Inside
    ``Model.forward``'s remat of a period the scan then runs three times a
    training step: the forward, the period's recompute and each chunk's
    recompute in the backward.  A's gradient, a sum over b and t, is
    summed chunk by chunk, so its last bits depend on the chunk size; no
    other input's does."""
    b, s, di = delta.shape
    n = A.shape[-1]
    chunk = mamba_chunk(b, di, n) if chunk is None else chunk
    h = (torch.zeros((b, di, n), dtype=torch.float32, device=delta.device)
         if h0 is None else h0)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (delta, A, B, xc, C, h0))
    ys = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, t0 + chunk)
        args = (h, delta[:, sl], A, B[:, sl], xc[:, sl], C[:, sl])
        if grad:
            y, h = checkpoint(_scan_chunk, *args, use_reentrant=False)
        else:
            y, h = _scan_chunk(*args)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba_mixer(params, cfg, m, x, state=None):
    """x: (b, s, d) -> (out, new state {"conv", "ssm"}).  ``state`` None: the
    sequence from the zero state; with a state, it carries on from it (the
    decode step)."""
    b, s, d = x.shape
    di = m.expand * d
    xz = dense(params["in_proj"], x, "bsd,de->bse")
    xi, z = xz.chunk(2, dim=-1)

    # depthwise causal conv over the sequence, carrying its last inputs
    pad = (torch.zeros((b, m.d_conv - 1, di), dtype=xi.dtype,
                       device=x.device) if state is None else state["conv"])
    xpad = torch.cat([pad, xi], dim=1)
    conv_w = params["conv_w"].float()                      # (w, di)
    xc = sum(xpad[:, i:i + s].float() * conv_w[i] for i in range(m.d_conv))
    xc = F.silu(xc + params["conv_b"].float()).to(x.dtype)

    proj = dense(params["x_proj"], xc, "bse,ef->bsf")
    dt, B, C = proj.split([m.dt_rank, m.d_state, m.d_state], dim=-1)
    dt = rms_norm(params["dt_norm"], dt, cfg.norm_eps)
    B = rms_norm(params["b_norm"], B, cfg.norm_eps).float()
    C = rms_norm(params["c_norm"], C, cfg.norm_eps).float()
    pre = dense(params["dt_proj"], dt, "bsr,re->bse").float() + params["dt_bias"]
    delta = torch.logaddexp(pre, pre.new_zeros(()))  # jax.nn.softplus's form
    A = -torch.exp(params["A_log"])                      # (di, n)
    xc32 = xc.float()
    ys, h = _mamba_scan(delta, A, B, xc32, C,
                        None if state is None else state["ssm"])
    y = ys + params["D"] * xc32
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    out = dense(params["out_proj"], y, "bse,ed->bsd")
    return out, {"conv": xpad[:, s:] if m.d_conv > 1 else pad, "ssm": h}
