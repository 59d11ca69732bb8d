"""Model assembly for the dense, MoE, RWKV, hybrid (Mamba and attention)
and encoder-decoder families (the JAX package's ``models/transformer.py``
on one card).

The reference stacks parameters and caches per period of layer kinds and
scans over them; here each layer is an ``nn.Module`` in a Python loop and
the cache is a list with one dict per layer.  ``Model.specs()`` still
returns the reference's tree: the unstacked dense prefix (``prefix``, a
list of ``first_dense`` layers, DeepSeek's first dense layer) and the
stacked body (``stack/sub{j}`` with a leading period axis, the period
taken over the layers after the prefix), which is what :meth:`Model.init`
draws from, what :meth:`Model.load_tree` reads and what
``bridge.numpy_lm_params`` builds.

:meth:`Model.forward` is the full forward that autograd sees (each layer
under ``torch.utils.checkpoint`` when ``cfg.remat``, the counterpart of
the reference's ``jax.checkpoint`` of its period body) and
:meth:`Model.loss` the next-token cross-entropy on it; the serving calls
(``logits``, ``prefill``, ``decode_step``) run it without autograd.

The encoder-decoder (whisper) adds an encoder stack (``enc_stack`` in
the tree, :class:`EncoderLayer` here) run by :meth:`Model.encode`, and a
cross-attention step in every decoder layer.  Its serving cache keeps each
layer's cross keys and values, computed once per request in
:meth:`Model.prefill`.  The decoder stream and the encoder output must
share a dtype: where the reference's scan would promote the stream it
raises, and the port raises a ``ValueError``.

A MoE layer (``models/moe.py``) returns its router's auxiliary loss;
:meth:`Model.forward` sums it over layers when asked (``with_aux``) and
:meth:`Model.loss` adds it to the cross-entropy, as the reference does.
Prefill and decode drop it.

All ten configs run: yi-9b, codeqwen1.5-7b, phi3-medium-14b,
granite-34b, chameleon-34b, mixtral-8x22b, deepseek-v2-236b (MLA and its
dense prefix), rwkv6-7b, whisper-medium and jamba-v0.1-52b (Mamba layers
with an attention layer in every period of 8, MoE on odd layers).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm
from repro_torch.models.layers import (
    dense,
    embed,
    embed_spec,
    fill_,
    gelu_mlp,
    layer_norm,
    param_count,
    param_dict,
    pin_matmul_precision,
    rms_norm,
    sinusoidal_positions,
    spec,
    stack_specs,
    swiglu,
    tree_leaves,
    unembed,
)


def layer_kind(cfg, i: int) -> tuple:
    """(mixer, mlp) kind of decoder layer ``i``."""
    if cfg.mixer == "rwkv":
        return ("rwkv", "rwkv_cm")
    if cfg.mixer == "mamba":
        is_attn = bool(cfg.attn_every) and (i % cfg.attn_every == cfg.attn_offset)
        mixer = "attn" if is_attn else "mamba"
    else:
        mixer = "attn"
    mlp = cfg.mlp_type
    if cfg.moe is not None and i >= cfg.first_dense and i % cfg.moe_every == cfg.moe_offset:
        mlp = "moe"
    return (mixer, mlp)


def layer_kinds(cfg) -> list:
    return [layer_kind(cfg, i) for i in range(cfg.n_layers)]


def find_period(kinds: list) -> int:
    n = len(kinds)
    for p in range(1, n + 1):
        if n % p == 0 and kinds == kinds[:p] * (n // p):
            return p
    return n


def unsupported(cfg):
    """What of ``cfg`` the port cannot run yet, or None: None for every
    config of the reference."""
    return None


# ---------------------------------------------------------------------------
# Single-layer specs / forward
# ---------------------------------------------------------------------------


def _norm_specs(cfg):
    d, dt = cfg.d_model, cfg.param_dtype
    if cfg.norm_type == "ln":
        return {"scale": spec((d,), "ones", dtype=dt),
                "bias": spec((d,), "zeros", dtype=dt)}
    return {"scale": spec((d,), "ones", dtype=dt)}


def _apply_norm(p, cfg, x):
    if cfg.norm_type == "ln":
        return layer_norm(p["scale"], p["bias"], x, cfg.norm_eps)
    return rms_norm(p["scale"], x, cfg.norm_eps)


def _mlp_specs(cfg, kind: str):
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    if kind == "moe":
        return moe_lib.moe_specs(cfg, cfg.moe)
    if kind == "swiglu":
        return {"w_gate": spec((d, f), dtype=dt),
                "w_up": spec((d, f), dtype=dt),
                "w_down": spec((f, d), dtype=dt)}
    if kind == "gelu":
        return {"w_fc": spec((d, f), dtype=dt),
                "b_fc": spec((f,), "zeros", dtype=dt),
                "w_proj": spec((f, d), dtype=dt),
                "b_proj": spec((d,), "zeros", dtype=dt)}
    if kind == "rwkv_cm":
        return ssm.rwkv_channel_mix_specs(cfg)
    raise ValueError(kind)


def _mixer_specs(cfg, kind: str):
    if kind in ("attn", "bidir"):
        return attn.attn_specs(cfg)
    if kind == "rwkv":
        return ssm.rwkv_time_mix_specs(cfg)
    if kind == "mamba":
        return ssm.mamba_specs(cfg, cfg.mamba)
    raise ValueError(kind)


def decoder_layer_specs(cfg, kind: tuple, cross: bool = False) -> dict:
    mixer, mlp = kind
    out = {"norm1": _norm_specs(cfg), "mixer": _mixer_specs(cfg, mixer),
           "norm2": _norm_specs(cfg), "mlp": _mlp_specs(cfg, mlp)}
    if cross:
        out["norm_cross"] = _norm_specs(cfg)
        out["cross"] = attn.cross_attn_specs(cfg)
    return out


def encoder_layer_specs(cfg) -> dict:
    return {"norm1": _norm_specs(cfg), "mixer": _mixer_specs(cfg, "bidir"),
            "norm2": _norm_specs(cfg), "mlp": _mlp_specs(cfg, cfg.mlp_type)}


def check_enc_dtype(x, enc_out):
    """The decoder stream ``x`` and the encoder output must share a dtype:
    the reference adds cross-attention in the encoder output's dtype to
    the stream inside its layer scan, which raises where that promotes
    the stream (float32 frames to a bf16 model)."""
    if enc_out is None:
        raise ValueError("an encoder-decoder needs the encoder output")
    if enc_out.dtype != x.dtype:
        raise ValueError(f"the encoder output is {enc_out.dtype} but the "
                         f"decoder stream is {x.dtype}; give the encoder "
                         "its input in the model's parameter dtype")


def _apply_mlp(p, cfg, kind: str, x, cm_state=None):
    """Returns (out, aux loss, new channel-mix state or None)."""
    if kind == "moe":
        y, aux = moe_lib.moe_ffn(p, cfg, cfg.moe, x)
        return y, aux, None
    if kind == "swiglu":
        return swiglu(p["w_gate"], p["w_up"], p["w_down"], x), 0.0, None
    if kind == "gelu":
        return (gelu_mlp(p["w_fc"], p["b_fc"], p["w_proj"], p["b_proj"], x),
                0.0, None)
    if kind == "rwkv_cm":
        y, last = ssm.rwkv_channel_mix(p, cfg, x, cm_state)
        return y, 0.0, last
    raise ValueError(kind)


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer: norm1 -> mixer -> norm2 -> MLP, each
    residual; an encoder-decoder's has norm_cross -> cross-attention after
    its mixer.  Its parameters sit in one ``ParameterDict`` per part, under
    the reference's names."""

    def __init__(self, cfg, kind: tuple, device):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        specs = decoder_layer_specs(cfg, kind, cross=cfg.is_encdec)
        for part, sp in specs.items():
            setattr(self, part, param_dict(sp, device))

    def forward(self, x, positions, enc_out=None):
        """Full sequence -> (x, this layer's decode-cache entry, its MoE
        aux loss or 0.0).  An encoder-decoder layer attends to ``enc_out``
        after its mixer, and its entry holds the cross keys and values
        under "cross"."""
        cfg = self.cfg
        mixer, mlp = self.kind
        h = _apply_norm(self.norm1, cfg, x)
        if mixer == "attn" and cfg.attn_type == "mla":
            mo, entry = attn.mla_train(self.mixer, cfg, h, positions,
                                       return_kv=True)
        elif mixer == "attn":
            mo, entry = attn.attention_train(self.mixer, cfg, h, positions,
                                             return_kv=True)
        elif mixer == "mamba":
            mo, entry = ssm.mamba_mixer(self.mixer, cfg, cfg.mamba, h)
        else:
            mo, entry = ssm.rwkv_time_mix(self.mixer, cfg, h)
        x = x + mo
        if cfg.is_encdec:
            check_enc_dtype(x, enc_out)
            k, v = attn.cross_kv(self.cross, enc_out)
            h = _apply_norm(self.norm_cross, cfg, x)
            x = x + attn.cross_attend(self.cross, cfg, h, k, v)
            entry = dict(entry, cross={"k": k, "v": v})
        h = _apply_norm(self.norm2, cfg, x)
        mo, aux, new_cm = _apply_mlp(self.mlp, cfg, mlp, h)
        if new_cm is not None:
            entry = dict(entry, x_prev_cm=new_cm)
        return x + mo, entry, aux

    def decode(self, x, cache, position: int):
        """One token against this layer's cache -> (x, new cache)."""
        cfg = self.cfg
        mixer, mlp = self.kind
        h = _apply_norm(self.norm1, cfg, x)
        if mixer == "attn" and cfg.attn_type == "mla":
            mo, new_cache = attn.mla_decode(self.mixer, cfg, h, cache,
                                            position)
        elif mixer == "attn":
            mo, new_cache = attn.attention_decode(self.mixer, cfg, h, cache,
                                                  position)
        elif mixer == "mamba":
            mo, new_cache = ssm.mamba_mixer(self.mixer, cfg, cfg.mamba, h,
                                            cache)
        else:
            mo, new_cache = ssm.rwkv_time_mix(self.mixer, cfg, h, cache)
        x = x + mo
        if cfg.is_encdec:       # the request's cross K/V, from its prefill
            h = _apply_norm(self.norm_cross, cfg, x)
            x = x + attn.cross_attend(self.cross, cfg, h,
                                      cache["cross"]["k"],
                                      cache["cross"]["v"])
            new_cache = dict(new_cache, cross=cache["cross"])
        h = _apply_norm(self.norm2, cfg, x)
        cm_state = cache["x_prev_cm"] if mixer == "rwkv" else None
        mo, _aux, new_cm = _apply_mlp(self.mlp, cfg, mlp, h, cm_state)
        if new_cm is not None:
            new_cache = dict(new_cache, x_prev_cm=new_cm)
        return x + mo, new_cache


class EncoderLayer(nn.Module):
    """One pre-norm encoder layer: norm1 -> bidirectional attention ->
    norm2 -> MLP, each residual."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        for part, sp in encoder_layer_specs(cfg).items():
            setattr(self, part, param_dict(sp, device))

    def forward(self, x):
        cfg = self.cfg
        x = x + attn.bidir_attention(self.mixer, cfg,
                                     _apply_norm(self.norm1, cfg, x))
        mo, _aux, _ = _apply_mlp(self.mlp, cfg, cfg.mlp_type,
                                 _apply_norm(self.norm2, cfg, x))
        return x + mo


# the reference's stacked subtrees: a leaf there holds one slice a layer
STACKED = ("stack", "enc_stack")


def body_period(cfg) -> int:
    """The period of the layer kinds after the dense prefix, over which
    the reference stacks its body (1 when there is no body)."""
    body = layer_kinds(cfg)[cfg.first_dense:]
    return find_period(body) if body else 1


def model_specs(cfg) -> dict:
    """The reference's parameter spec tree for ``cfg``: the dense prefix
    unstacked, the body stacked."""
    kinds = layer_kinds(cfg)
    body = kinds[cfg.first_dense:]
    period = body_period(cfg)
    out = {"embed": embed_spec(cfg.vocab, cfg.d_model, cfg.param_dtype),
           "final_norm": _norm_specs(cfg)}
    if cfg.first_dense:
        out["prefix"] = [decoder_layer_specs(cfg, k)
                         for k in kinds[:cfg.first_dense]]
    if body:
        out["stack"] = stack_specs({f"sub{j}": decoder_layer_specs(
            cfg, k, cross=cfg.is_encdec)
            for j, k in enumerate(body[:period])}, len(body) // period)
    if not cfg.tie_embeddings:
        out["unembed"] = {"w": spec((cfg.d_model, cfg.vocab), "scaled",
                                    0.02 / math.sqrt(cfg.d_model),
                                    dtype=cfg.param_dtype)}
    if cfg.is_encdec:
        out["enc_stack"] = stack_specs(encoder_layer_specs(cfg),
                                       cfg.enc_layers)
        out["enc_final_norm"] = _norm_specs(cfg)
    return out


class _NextTokenCE(torch.autograd.Function):
    """Next-token cross-entropy, mean over (b, s - 1), as the reference's
    loss computes it (logits in float32, logsumexp less the gold logit),
    a batch row of the float32 logits at a time: at deepseek's training
    step the (8, 2047, 102400) float32 logits are 6.25 GiB, and autograd
    of the whole-tensor form keeps them and makes three more of their size
    in the backward (the softmax term, the gold logit's scatter, their
    sum).  Here only ``logits`` (in their own dtype) and each row's
    logsumexp are kept; the backward recomputes a row's float32 logits and
    writes grad (exp(lg - logz) with -grad added at the gold logit, the
    terms autograd of the whole-tensor form sums) in ``logits``' dtype.
    Every operation is autograd's own, elementwise or over one row's
    vocabulary, so the bits are the same
    (tests/test_torch_mla_train.py)."""

    @staticmethod
    def forward(ctx, logits, tgt):
        logz = torch.empty(tgt.shape, dtype=torch.float32,
                           device=logits.device)
        d = torch.empty_like(logz)
        for i in range(logits.shape[0]):
            lg = logits[i:i + 1, :-1].float()
            logz[i:i + 1] = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, tgt[i:i + 1, :, None])[..., 0]
            d[i:i + 1] = logz[i:i + 1] - gold
        ctx.save_for_backward(logits, tgt, logz)
        return d.mean()

    @staticmethod
    def backward(ctx, grad):
        logits, tgt, logz = ctx.saved_tensors
        # mean's backward: grad spread over the (b, s - 1) terms
        g = grad.expand(tgt.shape) / tgt.numel()
        out = torch.zeros_like(logits)
        for i in range(logits.shape[0]):
            lg = logits[i:i + 1, :-1].float()
            e = g[i:i + 1, :, None] * (lg - logz[i:i + 1, :, None]).exp()
            e.scatter_add_(-1, tgt[i:i + 1, :, None], -g[i:i + 1, :, None])
            out[i:i + 1, :-1] = e
        return out, None


class Model(nn.Module):
    """A configured architecture on one device: specs, init, the full
    forward, prefill and decode.  Parameters are allocated on ``device``
    (the card when None) and filled by :meth:`init` or :meth:`load_tree`.
    Building a model pins the matrix-product precision
    (``layers.pin_matmul_precision``)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        pin_matmul_precision()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.kinds = layer_kinds(cfg)
        self.period = body_period(cfg)
        specs = self.specs()
        self.embed = param_dict(specs["embed"], self.device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, k, self.device)
                                    for k in self.kinds)
        self.final_norm = param_dict(specs["final_norm"], self.device)
        self.unembed = (param_dict(specs["unembed"], self.device)
                        if "unembed" in specs else None)
        self.enc_layers = nn.ModuleList(EncoderLayer(cfg, self.device)
                                        for _ in range(cfg.enc_layers))
        self.enc_final_norm = (param_dict(specs["enc_final_norm"],
                                          self.device)
                               if cfg.is_encdec else None)

    # -- parameters ------------------------------------------------------
    def specs(self) -> dict:
        return model_specs(self.cfg)

    def n_params(self) -> int:
        return param_count(self.specs())

    def n_active_params(self) -> int:
        """Parameters a token uses: the routed experts' leaves (a body of
        (n_experts, ., .) under w_gate, w_up or w_down, outside "shared")
        count top_k / n_experts of their size, as the reference's."""
        cfg = self.cfg
        total = self.n_params()
        if cfg.moe is None:
            return total
        routed = 0
        for path, s in tree_leaves(self.specs()):
            body = s.shape[1:] if path[0] in STACKED else s.shape
            if (len(body) == 3 and body[0] == cfg.moe.n_experts
                    and path[-1] in ("w_gate", "w_up", "w_down")
                    and "shared" not in path):
                routed += math.prod(s.shape)
        return total - routed + int(routed * cfg.moe.top_k
                                    / cfg.moe.n_experts)

    def named_leaves(self) -> dict:
        """name -> parameter, in the reference's leaf order (a stacked
        leaf's slices in layer order): the order in which the optimizer
        sums the gradient norm."""
        names = {id(p): n for n, p in self.named_parameters()}
        return {names[id(t)]: t for _path, _s, tensors in self._leaves()
                for t in tensors}

    def _leaves(self):
        """(path, spec, tensors) for every leaf of the reference's tree;
        ``tensors`` are the port's parameters that hold its slices along
        the stacked axis (one for an unstacked leaf)."""
        def leaf(owner, keys):      # a part, then its (nested) names
            a = getattr(owner, keys[0])
            for k in keys[1:]:
                a = a[k]
            return a

        for path, s in tree_leaves(self.specs()):
            if path[0] == "stack":
                j = int(path[1][3:])
                yield path, s, [leaf(self.layers[i], path[2:])
                                for i in range(self.cfg.first_dense + j,
                                               len(self.layers),
                                               self.period)]
            elif path[0] == "prefix":
                yield path, s, [leaf(self.layers[path[1]], path[2:])]
            elif path[0] == "enc_stack":
                yield path, s, [leaf(layer, path[1:])
                                for layer in self.enc_layers]
            else:
                yield path, s, [leaf(self, path)]

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """Draw every parameter from its spec's distribution, leaf by leaf
        in the reference's flatten order.  As in the reference
        (``_init_leaf`` on the stacked tree), a stacked leaf's fan-in is
        its leading axis: the number of periods; a prefix leaf, unstacked,
        has its own."""
        for _path, s, tensors in self._leaves():
            for t in tensors:
                fill_(t, s, generator)
        return self

    @torch.no_grad()
    def load_tree(self, tree: dict):
        """Copy a parameter tree in the reference's layout (numpy or
        anything numpy reads) into the model, cast to each spec's dtype."""
        for path, s, tensors in self._leaves():
            a = tree
            for k in path:
                a = a[k]
            a = np.asarray(a, dtype=np.float32)
            if a.shape != s.shape:
                raise ValueError(f"{'/'.join(path)}: shape {a.shape}, "
                                 f"expected {s.shape}")
            if path[0] not in STACKED:
                a = a[None]
            for i, t in enumerate(tensors):
                t.copy_(torch.tensor(a[i]))
        return self

    # -- forward -----------------------------------------------------------
    def _head(self, x):
        x = _apply_norm(self.final_norm, self.cfg, x)
        if self.cfg.tie_embeddings:
            return unembed(self.embed, x)
        return dense(self.unembed["w"], x, "bsd,dv->bsv")

    def _positions(self, tokens):
        b, s = tokens.shape
        return torch.arange(s, dtype=torch.int32,
                            device=tokens.device).expand(b, s)

    def _period(self, i: int, x, positions, enc_out=None, n=None):
        """Layers i .. i + n - 1 (``n`` the period when None: one period
        of the reference's scanned stack) -> (x, their MoE aux loss)."""
        aux_total = 0.0
        for layer in self.layers[i:i + (self.period if n is None else n)]:
            x, _entry, aux = layer(x, positions, enc_out)
            aux_total = aux_total + aux
        return x, aux_total

    def encode(self, enc_input):
        """enc_input: (b, enc_seq, d_model) precomputed frame embeddings
        (the reference's stub frontend) -> the encoder output in
        enc_input's dtype: sinusoidal positions added, the bidirectional
        stack, the final norm.  Under autograd with ``cfg.remat`` each
        layer runs under ``torch.utils.checkpoint``, as the reference's
        ``jax.checkpoint`` of its layer."""
        x = enc_input + sinusoidal_positions(
            enc_input.shape[1], self.cfg.d_model,
            enc_input.device).to(enc_input.dtype)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.enc_layers:
            x = (checkpoint(layer, x, use_reentrant=False) if remat
                 else layer(x))
        return _apply_norm(self.enc_final_norm, self.cfg, x)

    def forward(self, tokens, enc_out=None, with_aux=False):
        """tokens: (b, s) -> logits (b, s, vocab), the full forward, and
        with ``with_aux`` the MoE aux loss summed over layers (float32,
        0 without MoE) beside them; ``enc_out`` is the encoder output of
        an encoder-decoder.  Under autograd with ``cfg.remat`` each period
        runs under ``torch.utils.checkpoint`` (its activations recomputed
        in the backward), as the reference's ``jax.checkpoint`` of its
        period; the dense prefix runs before them without, as the
        reference's unscanned prefix layers."""
        x = embed(self.embed, tokens)
        positions = self._positions(tokens)
        remat = self.cfg.remat and torch.is_grad_enabled()
        x, aux_total = self._period(0, x, positions, enc_out,
                                    n=self.cfg.first_dense)
        for i in range(self.cfg.first_dense, len(self.layers), self.period):
            if remat:
                x, aux = checkpoint(self._period, i, x, positions, enc_out,
                                    use_reentrant=False)
            else:
                x, aux = self._period(i, x, positions, enc_out)
            aux_total = aux_total + aux
        logits = self._head(x)
        if not with_aux:
            return logits
        return logits, torch.as_tensor(aux_total, dtype=torch.float32,
                                       device=x.device)

    @torch.no_grad()
    def logits(self, tokens, enc_out=None, with_aux=False):
        """tokens: (b, s) -> logits (b, s, vocab) (and the aux loss with
        ``with_aux``), without autograd."""
        return self.forward(tokens, enc_out, with_aux)

    def loss(self, batch):
        """Next-token cross-entropy plus the MoE aux loss: (ce + aux,
        {"ce", "aux"}); ``batch`` is {"tokens"} and, for an
        encoder-decoder, "enc_input" too.  ``aux`` (the routers' balance
        and z losses summed over layers) is 0 without MoE.  The gold logit
        is a gather, which gives the bits of the reference's masked sum:
        that sum adds zeros to one value."""
        tokens = batch["tokens"]
        enc_out = (self.encode(batch["enc_input"]) if self.cfg.is_encdec
                   else None)
        logits, aux = self.forward(tokens, enc_out, with_aux=True)
        ce = _NextTokenCE.apply(logits, tokens[:, 1:].long())
        return ce + aux, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def prefill(self, tokens, enc_out=None):
        """Process a full prompt -> (last-token logits (b, vocab), decode
        cache: one dict per layer).  The cache holds the prompt's length
        (SWA: the window); ``pad_cache`` extends it for generation.  An
        encoder-decoder layer's entry also holds the cross keys and values
        of ``enc_out`` under "cross", computed here once per request, as
        the reference's ``prefill_cross``."""
        x = embed(self.embed, tokens)
        positions = self._positions(tokens)
        cache = []
        for layer in self.layers:
            x, entry, _aux = layer(x, positions, enc_out)
            cache.append(entry)
        return self._head(x[:, -1:])[:, 0], cache

    def pad_cache(self, cache, extra: int):
        """Grow full-attention caches (k and v, MLA's ckv and krope) by
        ``extra`` zero positions; the cross keys and values keep the
        encoder's length, and a Mamba layer's state its size."""
        if self.cfg.attn_type == "swa" or self.cfg.mixer == "rwkv":
            return cache    # ring buffer / recurrent state: fixed size

        def grow(a):
            return torch.cat([a, a.new_zeros((a.shape[0], extra)
                                             + a.shape[2:])], dim=1)

        seq = (("ckv", "krope") if self.cfg.attn_type == "mla"
               else ("k", "v"))
        return [dict(c, **{k: grow(c[k]) for k in seq if k in c})
                for c in cache]

    def init_cache(self, batch: int, max_seq: int):
        """A zero cache; an encoder-decoder's entries hold zero cross keys
        and values of the encoder's length, which ``prefill`` fills."""
        cfg = self.cfg
        cache = [attn.init_cache(cfg, batch, max_seq, self.device)
                 if kind[0] == "attn" else
                 ssm.mamba_state_init(cfg, cfg.mamba, batch, self.device)
                 if kind[0] == "mamba" else
                 ssm.rwkv_state_init(cfg, batch, self.device)
                 for kind in self.kinds]
        if cfg.is_encdec:
            shape = (batch, cfg.enc_seq, cfg.n_heads, cfg.d_head)
            cache = [dict(c, cross={
                "k": torch.zeros(shape, dtype=cfg.param_dtype,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=cfg.param_dtype,
                                 device=self.device)}) for c in cache]
        return cache

    @torch.no_grad()
    def decode_step(self, token, cache, position: int):
        """token: (b, 1) -> (logits (b, 1, vocab), cache).  Attention
        caches are updated in place.  An encoder-decoder layer projects
        only the query for its cross step and reads the keys and values
        from the cache."""
        x = embed(self.embed, token)
        new_cache = []
        for layer, c in zip(self.layers, cache):
            x, nc = layer.decode(x, c, position)
            new_cache.append(nc)
        return self._head(x), new_cache
