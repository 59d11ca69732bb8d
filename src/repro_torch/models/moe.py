"""Mixture-of-Experts with sort-based dispatch: the JAX package's
``models/moe.py`` on one card.

The router runs in float32 whatever the parameter dtype.  Dispatch is
sort-based (linear in tokens): assignments are ranked within their expert
by a stable argsort and scattered into a static (e, capacity, d) buffer;
assignments past an expert's capacity are dropped.  The capacity is the
reference's ``_capacity``, Python's ``round`` included (half to even), so
it depends on how many tokens a call routes: a prefill of the prompt and
a decode step of one token a request drop differently from one forward
over the whole sequence, as they do in the reference.

The experts keep the float32 sums of their gate and up products until
the SiLU, as the reference's ``preferred_element_type=float32`` does; on
the card a bf16 model's products go to cuBLAS with a float32 output
(``torch.mm(..., out_dtype=torch.float32)``), on the CPU they run on
float32 operands.  Experts are computed one after another: each expert's
products are independent, and a prefill's float32 gate and up for all
experts at once would not fit.

Under autograd the module is the reference's ``jax.grad`` of
``_moe_local``.  PyTorch has no derivative for the card's bf16 product
with a float32 output, so there it runs in :class:`_MM32`, whose backward
is what JAX's transpose of ``dot_general`` with
``preferred_element_type=float32`` computes: the float32 cotangent times
the other operand in float32, rounded to the operand's dtype (on the CPU
autograd of the float32 product computes the same).

The reference computes MoE outside any Pallas kernel, so this module is
plain PyTorch on both devices.  Its expert-parallel and tensor-parallel
``shard_map`` bodies (``_moe_ep_body``, ``_moe_tp_body``,
``_moe_shard_mapped``) need a mesh of several chips and are not ported
yet (ROADMAP.md queue 1, item 4d); ``moe_ffn`` is the reference's path
without a mesh.  ``moe_ffn_dense`` is the reference's one-hot oracle.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.lm_archs import MoEConfig
from repro_torch.models.layers import spec, swiglu

def moe_specs(cfg, m: MoEConfig) -> dict:
    d, dt = cfg.d_model, cfg.param_dtype
    e, f = m.n_experts, m.d_ff_expert
    out = {
        "router": spec((d, e), dtype=torch.float32),
        "w_gate": spec((e, d, f), dtype=dt),
        "w_up": spec((e, d, f), dtype=dt),
        "w_down": spec((e, f, d), dtype=dt),
    }
    if m.n_shared:
        fs = f * m.n_shared
        out["shared"] = {
            "w_gate": spec((d, fs), dtype=dt),
            "w_up": spec((d, fs), dtype=dt),
            "w_down": spec((fs, d), dtype=dt),
        }
    return out


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


def top_k(probs, k: int):
    """The k largest entries of each row, ties to the lower index, as
    ``jax.lax.top_k``: a stable descending sort keeps equal entries in
    index order on either device, which ``torch.topk`` does not promise."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def expert_counts(idx, e: int):
    """How many entries of ``idx`` name each of the e experts: a scatter
    add, which, unlike ``bincount`` or ``one_hot`` on the card, does not
    wait for the card to size or check its output."""
    flat = idx.reshape(-1)
    return torch.zeros(e, dtype=torch.int64, device=idx.device).index_add_(
        0, flat, torch.ones_like(flat))


def router_topk(router_w, m: MoEConfig, xt):
    """xt: (t, d) -> (top_w (t, k), top_idx (t, k), aux scalar), all in
    float32: the load-balance loss plus the router z-loss."""
    logits = xt.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = top_k(probs, m.top_k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    me = probs.mean(dim=0)
    # the mean over tokens of each expert's one-hot sum over k
    ce = expert_counts(top_idx, m.n_experts).float() / xt.shape[0] / m.top_k
    lb_loss = m.n_experts * (me * ce).sum()
    z_loss = m.router_z_loss * torch.logsumexp(logits, dim=-1).square().mean()
    return top_w, top_idx, lb_loss + z_loss


# ---------------------------------------------------------------------------
# Sort-based dispatch (linear in tokens)
# ---------------------------------------------------------------------------


def _capacity(t: int, m: MoEConfig) -> int:
    cap = int(max(1, round(t * m.top_k * m.capacity_factor / m.n_experts)))
    return min(cap, t * m.top_k)


def sort_dispatch(xt, top_idx, e: int, cap: int):
    """Scatter tokens into a static (e, cap, d) expert buffer.

    Returns (expert_in, slot (t, k) int32, keep (t, k) bool).  slot indexes
    the flattened (e * cap) buffer; a dropped assignment has keep False
    and the overflow slot e * cap."""
    t, k = top_idx.shape
    dev = top_idx.device
    flat_e = top_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)     # assignments by expert
    counts = expert_counts(flat_e, e)
    seg_start = torch.cumsum(counts, 0) - counts   # exclusive prefix sum
    rank = torch.empty(t * k, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(t * k, device=dev) - seg_start[flat_e[order]]
    keep = rank < cap
    slot = torch.where(keep, flat_e * cap + rank, e * cap)
    token_of = torch.arange(t * k, device=dev) // k
    buf = xt.new_zeros((e * cap + 1, xt.shape[-1]))
    buf[slot] = xt[token_of]           # the overflow row takes any dropped
    expert_in = buf[:e * cap].reshape(e, cap, -1)
    return (expert_in, slot.to(torch.int32).reshape(t, k),
            keep.reshape(t, k))


def sort_combine(expert_out, slot, keep, top_w):
    """Inverse of sort_dispatch: expert_out (e, cap, d) -> (t, d) float32,
    each token's kept outputs weighted by top_w and summed over k in
    float32, one k at a time."""
    e, cap, d = expert_out.shape
    flat = torch.cat([expert_out.reshape(e * cap, d),
                      expert_out.new_zeros((1, d))])
    w = (top_w * keep).float()
    slot = slot.long().clamp(max=e * cap)
    out = flat[slot[:, 0]].float() * w[:, :1]
    for j in range(1, slot.shape[1]):
        out = out + flat[slot[:, j]].float() * w[:, j:j + 1]
    return out


def _mm_f32_out(a, b):
    """cuBLAS's product of two bf16 matrices with a float32 output."""
    return torch.mm(a, b, out_dtype=torch.float32)


class _MM32(torch.autograd.Function):
    """``_mm_f32_out`` with a derivative: the float32 cotangent g gives
    (g @ b^T, a^T @ g) as float32 products of float32 operands, each
    rounded to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32_out(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g @ b.float().t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (a.float().t() @ g).to(b.dtype)
        return ga, gb


def _mm32(a, b):
    """a @ b with float32 sums and a float32 result.  A bf16 product on
    the card goes to cuBLAS with a float32 output (:class:`_MM32` where
    autograd records it); elsewhere the operands are float32 (exact for
    bf16 values)."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype != torch.float32:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _MM32.apply(a, b)
        return _mm_f32_out(a, b)
    return a.float() @ b.float()


def _expert_ffn(w_gate, w_up, w_down, expert_in):
    """SwiGLU over experts, one expert at a time.  expert_in: (e, c, d).
    Gate and up keep their float32 sums until the SiLU; h is rounded to
    the input dtype before the down product, whose float32 sums are
    rounded once more."""
    out = torch.empty_like(expert_in)
    for i in range(expert_in.shape[0]):
        x = expert_in[i]
        g = _mm32(x, w_gate[i])
        u = _mm32(x, w_up[i])
        h = (F.silu(g) * u).to(x.dtype)
        del g, u
        out[i] = _mm32(h, w_down[i]).to(x.dtype)
    return out


# ---------------------------------------------------------------------------
# The local (one-device) path
# ---------------------------------------------------------------------------


def _moe_local(params, m: MoEConfig, xt):
    top_w, top_idx, aux = router_topk(params["router"], m, xt)
    cap = _capacity(xt.shape[0], m)
    expert_in, slot, keep = sort_dispatch(xt, top_idx, m.n_experts, cap)
    expert_out = _expert_ffn(params["w_gate"], params["w_up"],
                             params["w_down"], expert_in)
    del expert_in
    yt = sort_combine(expert_out, slot, keep, top_w)
    return yt.to(xt.dtype), aux


def _shared(params, x):
    sh = params["shared"]
    return swiglu(sh["w_gate"], sh["w_up"], sh["w_down"], x)


def moe_ffn(params, cfg, m: MoEConfig, x):
    """x: (b, s, d) -> (y, aux): the routed experts over the b * s tokens
    of the call, plus the shared experts where ``m.n_shared``."""
    b, s, d = x.shape
    yt, aux = _moe_local(params, m, x.reshape(b * s, d))
    y = yt.reshape(b, s, d)
    if m.n_shared:
        y = y + _shared(params, x)
    return y, aux


# ---------------------------------------------------------------------------
# Dense one-hot reference (oracle for tests; the same routing semantics)
# ---------------------------------------------------------------------------


def moe_ffn_dense(params, cfg, m: MoEConfig, x):
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    top_w, top_idx, aux = router_topk(params["router"], m, xt)
    cap = _capacity(t, m)

    onehot = F.one_hot(top_idx, m.n_experts)                    # (t, k, e)
    flat = onehot.reshape(t * m.top_k, m.n_experts)
    pos = (torch.cumsum(flat, dim=0) * flat - 1).reshape(onehot.shape)
    in_cap = (pos >= 0) & (pos < cap)
    slotmat = F.one_hot(pos.clamp(0, cap - 1), cap).float()
    slotmat = slotmat * in_cap[..., None]
    dispatch = slotmat.sum(dim=1)                               # (t, e, c)
    combine = (slotmat * top_w[:, :, None, None]).sum(dim=1)

    expert_in = torch.einsum("tec,td->ecd", dispatch,
                             xt.float()).to(x.dtype)
    expert_out = _expert_ffn(params["w_gate"], params["w_up"],
                             params["w_down"], expert_in)
    yt = torch.einsum("tec,ecd->td", combine,
                      expert_out.float()).to(x.dtype)
    y = yt.reshape(b, s, d)
    if m.n_shared:
        y = y + _shared(params, x)
    return y, aux
