"""The WKV recurrence from the zero state in the model's layout.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
sequential recurrence; there is no fallback between them.
"""

from __future__ import annotations

from repro_torch.kernels.rwkv_scan.cuda import rwkv_wkv_cuda
from repro_torch.kernels.rwkv_scan.ref import wkv_ref


def rwkv_wkv(r, k, v, w, u):
    """r/k/w: (b, T, H, K), v: (b, T, H, V), u: (H, K), float32 ->
    (out (b, T, H, V), final state (b, H, K, V))."""
    if r.device.type == "cuda":
        return rwkv_wkv_cuda(*(t.contiguous() for t in (r, k, v, w, u)))
    b, T, H, K = r.shape
    V = v.shape[-1]

    def heads_first(t):
        return t.transpose(1, 2).reshape(b * H, T, t.shape[-1])

    out, state = wkv_ref(heads_first(r), heads_first(k), heads_first(v),
                         heads_first(w), u.expand(b, H, K).reshape(b * H, K))
    return (out.reshape(b, H, T, V).transpose(1, 2),
            state.reshape(b, H, K, V))
