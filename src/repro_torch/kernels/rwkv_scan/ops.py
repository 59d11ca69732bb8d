"""The WKV recurrence from the zero state in the model's layout.

A CUDA tensor goes to the hand-written kernel; where autograd needs a
gradient, :class:`RwkvWkv` wraps it with the backward kernel as its
gradient.  A CPU tensor goes to the plain sequential recurrence, which
autograd differentiates as JAX differentiates the reference's scan.  There
is no fallback between them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rwkv_scan.cuda import rwkv_wkv_bwd_cuda, rwkv_wkv_cuda
from repro_torch.kernels.rwkv_scan.ref import wkv_ref


class RwkvWkv(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient.  The
    training path never uses the final state, so its cotangent is None
    (grads are not materialized) and the backward refuses any other."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.set_materialize_grads(False)
        out, state = rwkv_wkv_cuda(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u)
        return out, state

    @staticmethod
    def backward(ctx, dout, dstate):
        if dstate is not None:
            raise NotImplementedError(
                "the WKV backward kernel takes no cotangent of the final "
                "state")
        r, k, v, w, u = ctx.saved_tensors
        if dout is None:
            return (None,) * 5
        return rwkv_wkv_bwd_cuda(r, k, v, w, u, dout.contiguous())


def rwkv_wkv(r, k, v, w, u):
    """r/k/w: (b, T, H, K), v: (b, T, H, V), u: (H, K), float32 ->
    (out (b, T, H, V), final state (b, H, K, V))."""
    if r.device.type == "cuda":
        args = tuple(t.contiguous() for t in (r, k, v, w, u))
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            return RwkvWkv.apply(*args)
        return rwkv_wkv_cuda(*args)
    b, T, H, K = r.shape
    V = v.shape[-1]

    def heads_first(t):
        return t.transpose(1, 2).reshape(b * H, T, t.shape[-1])

    out, state = wkv_ref(heads_first(r), heads_first(k), heads_first(v),
                         heads_first(w), u.expand(b, H, K).reshape(b * H, K))
    return (out.reshape(b, H, T, V).transpose(1, 2),
            state.reshape(b, H, K, V))
