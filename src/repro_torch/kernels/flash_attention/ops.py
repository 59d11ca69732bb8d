"""Causal (optionally sliding-window) attention in the model's layout.

A CUDA tensor goes to the hand-written kernels: the forward reads kv head
``h // (H // KV)`` for query head ``h`` and masks the ragged edge itself;
where autograd needs a gradient, :class:`FlashAttention` saves the
forward's output and log-sum-exp and its backward is the backward kernel.
A CPU tensor goes to the plain streaming form with the kv heads repeated,
as the JAX model computes it, and autograd differentiates it as JAX
differentiates the reference.  There is no fallback between them.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.cuda import (
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import mha_streaming


def expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, t, KV, d) -> (b, t, H, d), each kv head repeated H // KV times."""
    g = n_heads // k.shape[2]
    return k if g == 1 else torch.repeat_interleave(k, g, dim=2)


class FlashAttention(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window, scale):
        o, lse = flash_attention_cuda(q, k, v, window=window, scale=scale,
                                      return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.scale = window, scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, o, dout.contiguous(), lse, window=ctx.window,
            scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window=None, scale=None) -> torch.Tensor:
    """q: (b, s, H, d), k: (b, t, KV, d), v: (b, t, KV, dv) with KV | H ->
    (b, s, H, dv); query i and key j sit at positions i and j."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type == "cuda":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, window, scale)
        return flash_attention_cuda(q, k, v, window=window, scale=scale)
    H = q.shape[2]
    q_pos = torch.arange(q.shape[1], device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    return mha_streaming(q, expand_kv(k, H), expand_kv(v, H), q_pos, k_pos,
                         scale, window=window)
