"""Serving engine: batched prefill + decode with sampling, plus the
cascade-serving combinator (the JAX package's ``serve/engine.py``).

Sampled draws come from an explicit ``torch.Generator``; they cannot
match ``jax.random``'s, so only greedy decoding is comparable with the
reference token for token.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.cascade import Stage, compacting_cascade


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0                # 0 => off


def sample(logits, generator: torch.Generator, cfg: SamplerConfig):
    """logits: (b, vocab) -> (b,) int64 tokens."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / cfg.temperature
    vocab = logits.shape[-1]
    # top_k >= vocab keeps the whole distribution (top_k == 0 means off)
    k = min(int(cfg.top_k), vocab)
    if 0 < k < vocab:
        kth = torch.sort(logits, dim=-1).values[:, vocab - k][:, None]
        logits = torch.where(logits < kth, -math.inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def stream(model, prompt, n_tokens: int, *, enc_out=None,
           sampler: SamplerConfig = SamplerConfig(), seed: int = 0):
    """Prefill ``prompt`` (b, s), then yield (token (b,), the logits it was
    drawn from (b, vocab)) for each of ``n_tokens`` steps; a decode step
    runs between two yields.  ``enc_out``: an encoder-decoder's encoder
    output (b, enc_seq, d_model), whose cross keys and values the prefill
    computes once."""
    s = prompt.shape[1]
    logits, cache = model.prefill(prompt, enc_out)
    cache = model.pad_cache(cache, n_tokens)
    gen = torch.Generator(device=prompt.device).manual_seed(seed)
    for t in range(n_tokens):
        tok = sample(logits, gen, sampler)
        yield tok, logits
        if t + 1 < n_tokens:
            logits, cache = model.decode_step(tok[:, None], cache, s + t)
            logits = logits[:, 0]


def generate(model, prompt, n_tokens: int, *, enc_out=None,
             sampler: SamplerConfig = SamplerConfig(), seed: int = 0):
    """Prefill the prompt, then ``n_tokens`` greedy or sampled tokens.
    prompt: (b, s) int64 -> (b, n_tokens) int64; ``enc_out`` as for
    :func:`stream`."""
    toks = [tok for tok, _logits in stream(model, prompt, n_tokens,
                                           enc_out=enc_out, sampler=sampler,
                                           seed=seed)]
    if not toks:
        return prompt.new_zeros((prompt.shape[0], 0))
    return torch.stack(toks, dim=1)


# ---------------------------------------------------------------------------
# Cascade serving (paper §III at cluster scale)
# ---------------------------------------------------------------------------


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def cascade_serve(scorer_fn, big_model_fn, requests, *, threshold: float,
                  capacity_fraction: float = 0.25,
                  capacity: int | None = None):
    """Run a cheap scorer over all requests; only survivors, at most a
    fixed capacity of them, reach the big model.

    scorer_fn: (batch_items) -> scores (b,); big_model_fn: (batch_items) ->
    outputs, a tensor or a nest of dicts / lists of tensors with a leading
    batch axis.  ``capacity`` is the big model's batch (clamped to [1, b]);
    when None it is ``int(b * capacity_fraction)``.

    Returns ``(outputs, served, stats)`` as the reference does: outputs
    scattered back to the request index space (zeros for rows not served),
    the (b,) bool mask of served requests, and the counts.  Capacity is
    enforced inside the compacting cascade, whose stable compaction keeps
    the ``capacity`` lowest-indexed survivors;
    ``stats['dropped_capacity_idx']`` lists the other survivors ascending,
    padded with -1.
    """
    b = requests.shape[0]
    dev = requests.device
    cap = int(b * capacity_fraction) if capacity is None else int(capacity)
    cap = max(1, min(cap, b))

    def scorer(items):                       # one cascade row
        return scorer_fn(items[0])[None]

    def admit(items):
        return torch.zeros(items.shape[:2], device=dev)

    res = compacting_cascade(
        [Stage(scorer, threshold, "scorer"),
         Stage(admit, -math.inf, "capacity")],
        requests[None], capacities=[b, cap])
    scorer_mask = res.scores[0, 0] >= threshold
    served = res.mask[0]

    # the cascade's compaction permutation (the same stable argsort on the
    # post-scorer mask) gathers the big model's sub-batch
    order = torch.argsort((~scorer_mask).to(torch.int8), stable=True)
    picked = order[:cap]
    sub_out = big_model_fn(requests[picked])

    def scatter(leaf):
        out = leaf.new_zeros((b,) + tuple(leaf.shape[1:]))
        out[picked] = leaf
        keep = served.reshape((b,) + (1,) * (out.dim() - 1))
        return torch.where(keep, out, torch.zeros_like(out))

    outputs = _tree_map(scatter, sub_out)
    idx = torch.arange(b, device=dev)
    dropped = scorer_mask & ~served
    dropped_idx = torch.sort(torch.where(dropped, idx, b)).values
    stats = {
        "n_candidates": res.n_survivors[0, 0],
        "n_served": res.n_survivors[0, 1],
        "n_dropped_capacity": res.dropped[0, 1],
        "dropped_capacity_idx": torch.where(dropped_idx == b, -1,
                                            dropped_idx),
    }
    return outputs, served, stats
