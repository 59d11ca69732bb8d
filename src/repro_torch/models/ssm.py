"""RWKV6 (Finch) time-mix and channel-mix: the RWKV part of the JAX
package's ``models/ssm.py``.

A prefill from the zero state runs the WKV recurrence through
``kernels.rwkv_scan.ops`` (the hand-written kernel on a CUDA tensor, the
plain sequential recurrence on a CPU tensor); a call with a carried state
(decode) runs the plain single step, as the reference computes it outside
any Pallas kernel.  Mamba is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv_scan import ops as wkv_ops
from repro_torch.kernels.rwkv_scan.ref import wkv_step as _wkv_step
from repro_torch.models.layers import dense, spec

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
