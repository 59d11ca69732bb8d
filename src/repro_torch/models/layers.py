"""Parameter specs and elementary layers of the LM stack (the JAX package's
``models/layers.py`` on one card).

A spec tree mirrors the JAX package's parameter tree; each leaf is a
:class:`ParamSpec` (shape, initializer, scale, dtype).  The reference's
logical sharding axes and its manual-FSDP ``shard_map`` branch of
``dense`` stay behind: one card.  Elementary ops take their parameters
first, as the reference's free functions do.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


def pin_matmul_precision():
    """Matrix products of the LM path accumulate in float32, as the
    reference's ``dense`` does (``preferred_element_type=float32``).
    PyTorch lets cuBLAS reduce bf16 products in bf16 by default
    (``allow_bf16_reduced_precision_reduction`` is True); this turns that
    off, and TF32 with it.  ``Model`` calls it, so the tests and
    ``chip_smoke.py`` run with the same settings."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    init: str = "normal"              # normal | zeros | ones | scaled
    scale: float = 1.0                # stddev multiplier for normal/scaled
    dtype: torch.dtype = torch.bfloat16


def spec(shape, init="normal", scale=1.0, dtype=torch.bfloat16) -> ParamSpec:
    return ParamSpec(tuple(shape), init, scale, dtype)


def stack_specs(specs, n: int):
    """Prepend a layer-stack dimension to every leaf (the reference's
    scanned stacks)."""
    return tree_map(lambda s: dataclasses.replace(s, shape=(n,) + s.shape),
                    specs)


def tree_map(fn, tree):
    """``fn`` over the leaves of a nest of dicts and lists, in sorted key
    order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, t) for t in tree]
    return fn(tree)


def tree_leaves(tree, path=()):
    """(path, leaf) pairs of a nest of dicts and lists (a list's entries
    keyed by their index) in the reference's flatten order (keys
    sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from tree_leaves(t, path + (i,))
    else:
        yield path, tree


def leaf_std(s: ParamSpec) -> float:
    """The standard deviation of ``_init_leaf`` (the reference's
    ``models/layers.py:51-62``): normal is scale / sqrt(fan_in) with fan_in
    the leading axis of the leaf's shape, scaled is scale itself."""
    if s.init == "normal":
        fan_in = s.shape[0] if s.shape else 1
        return s.scale / math.sqrt(max(fan_in, 1))
    if s.init == "scaled":
        return s.scale
    raise ValueError(s.init)


def fill_(t: torch.Tensor, s: ParamSpec,
          generator: torch.Generator) -> torch.Tensor:
    """Draw ``t`` in place from the distribution of the spec ``s`` that it
    is (a slice of)."""
    if s.init == "zeros":
        return t.zero_()
    if s.init == "ones":
        return t.fill_(1)
    draw = torch.randn(t.shape, generator=generator, device=t.device,
                       dtype=torch.float32)
    return t.copy_(draw * leaf_std(s))


def numpy_leaf(s: ParamSpec, rng: np.random.Generator) -> np.ndarray:
    """One leaf drawn with numpy from the spec's distribution, float32."""
    if s.init == "zeros":
        return np.zeros(s.shape, np.float32)
    if s.init == "ones":
        return np.ones(s.shape, np.float32)
    return rng.standard_normal(s.shape, dtype=np.float32) * np.float32(
        leaf_std(s))


def param_count(specs) -> int:
    return sum(int(math.prod(s.shape)) for _p, s in tree_leaves(specs))


def param_dict(specs: dict, device) -> torch.nn.ParameterDict:
    """Uninitialised parameters for a dict of specs; a nested dict (a MoE
    layer's shared experts) becomes a nested ``ParameterDict``."""
    return torch.nn.ParameterDict({
        k: param_dict(s, device) if isinstance(s, dict) else
        torch.nn.Parameter(torch.empty(s.shape, dtype=s.dtype,
                                       device=device), requires_grad=False)
        for k, s in specs.items()})


# ---------------------------------------------------------------------------
# Elementary ops
# ---------------------------------------------------------------------------


def dense(w: torch.Tensor, x: torch.Tensor, eq: str) -> torch.Tensor:
    """einsum with float32 accumulation, the result cast to x's dtype.
    Same-dtype products on the card go to cuBLAS in that dtype, which
    accumulates in float32 under :func:`pin_matmul_precision`; on the CPU,
    or for mixed dtypes, the product runs in float32."""
    if x.dtype == w.dtype and (x.is_cuda or x.dtype == torch.float32):
        return torch.einsum(eq, x, w)
    return torch.einsum(eq, x.float(), w.float()).to(x.dtype)


def rms_norm(scale, x, eps: float = 1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(scale, bias, x, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def swiglu(w_gate, w_up, w_down, x):
    """LLaMA-style gated MLP.  x: (..., d_model)."""
    g = dense(w_gate, x, "...d,df->...f")
    u = dense(w_up, x, "...d,df->...f")
    h = F.silu(g.float()).to(x.dtype) * u
    return dense(w_down, h, "...f,fd->...d")


def gelu_mlp(w_fc, b_fc, w_proj, b_proj, x):
    """GPT-style two-matrix MLP (granite), tanh-approximate GELU."""
    h = dense(w_fc, x, "...d,df->...f") + b_fc.to(x.dtype)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return dense(w_proj, h, "...f,fd->...d") + b_proj.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding (llama-style, half-dim pairing)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rope_freqs(d_head: int, theta: float, device: torch.device):
    exact = 1.0 / theta ** (np.arange(0, d_head, 2) / d_head)
    return torch.tensor(exact.astype(np.float32), device=device)


def rope_freqs(d_head: int, theta: float = 10000.0, device=None):
    """1 / theta^(2i/d) rounded once to float32: the values the reference
    computes inside its compiled model, where XLA folds the constant in
    float64.  (Its op-by-op ``jnp`` power, like ``torch.pow`` in float32,
    is an ulp off at 17-25 of d = 128's 64 frequencies, which moves a key
    by ~3e-5 of its size at position 650.)  Computed once per device;
    ``device`` None is the card, as everywhere in the port."""
    return _rope_freqs(d_head, float(theta), resolve_device(device))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., seq, heads, d_head); positions: broadcastable to
    (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sinusoidal(seq: int, d_model: int, device: torch.device):
    half = d_model // 2
    f32 = np.float32
    # the exponent as jitted XLA folds it: i * f32(f32(-ln 1e4) / (d/2 - 1))
    arg = np.arange(half, dtype=f32) * (f32(-math.log(10000.0)) / f32(half - 1))
    inv = np.exp(arg.astype(np.float64)).astype(f32)
    ang = np.arange(seq, dtype=f32)[:, None] * inv[None, :]
    ang = ang.astype(np.float64)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.tensor(table.astype(f32), device=device)


def sinusoidal_positions(seq: int, d_model: int, device=None):
    """Whisper-style fixed sinusoidal embeddings (seq, d_model), float32:
    sin then cos of pos * 10000^(-i / (d/2 - 1)), computed on the host so
    the card and the CPU hold one table.  It follows the reference's
    jitted form: the exponent's constant folded as XLA folds it, the
    frequencies and angles rounded to float32 as there, and exp, sin and
    cos each in float64 rounded once.  XLA's float32 exp is its own
    polynomial: 59 of whisper's 512 frequencies lie an ulp from the jitted
    reference's (more from the eager one's, which divides), so row p of
    either table lies within (p + 1) 2^-22 of this one: the position times
    a frequency's ulp (2^-24), an angle's ulp (at most p 2^-23) and the
    rounding of sin or cos (1.2e-4 at 1500 x 1024, row 1499).  Computed
    once per device; ``device`` None is the card."""
    return _sinusoidal(int(seq), int(d_model), resolve_device(device))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_spec(vocab: int, d_model: int, dtype=torch.bfloat16):
    return {"embedding": spec((vocab, d_model), "scaled", 0.02, dtype)}


def embed(params, tokens):
    return params["embedding"][tokens]


def unembed(params, x):
    return dense(params["embedding"], x, "...d,vd->...v")
