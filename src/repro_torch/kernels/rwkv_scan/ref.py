"""Plain PyTorch versions of the WKV kernel.

:func:`wkv_step` is the model's single recurrence step (the JAX package's
``models/ssm.py`` ``_wkv_step``) and :func:`wkv_ref` the sequential
recurrence from the zero state over (BH, T, K) (``kernels/rwkv_scan/ref.py``
``wkv_ref``), which also returns the final state.
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
