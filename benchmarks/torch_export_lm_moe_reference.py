"""Export the JAX MoE LM reference (mixtral) for the PyTorch port.

Runs the JAX ``Model`` on the CPU in float32 on MIXTRAL_SMOKE (4 layers,
d_model 64, 4 experts top-2, window 16) with mixtral's head shape (d_head
128, a GQA group of 6: n_heads 6, n_kv 1; the card's flash kernel is
built for d_head 64 and 128) at the published capacity factor of 1.25,
with weights from ``repro_torch.bridge.numpy_lm_params(cfg,
seed=0)`` (the same tree the port loads with ``lm_params_from``), and
writes ``src/repro_torch/assets/lm_moe_reference.npz``.

Traffic: 4 prompts of 650 tokens (ragged against the port's 64-row flash
tiles; the window of 16 binds) and 16 more tokens, uniform ids from
numpy's generator seeded with 1.  It stores

* the full forward's logits over the 666 tokens, and ``loss`` with its
  ``ce`` and ``aux`` (the routers' balance and z losses) on them;
* the prefill's last-token logits and the logits of 16 teacher-forced
  ``decode_step``s at 4 requests, where a step's capacity is round(2.5)
  = 2 slots an expert, so steps drop assignments;
* ``generate``'s 16 greedy tokens from the prompts, with the gap between
  the top two logits and the largest |logit| at each step;
* the number of assignments each MoE layer drops in the forward, in the
  prefill and in each teacher-forced decode step (read by rebinding
  ``repro.models.moe.sort_dispatch`` in this process only, with an
  ordered ``jax.debug.callback``; the JAX package is not edited);
* E for each output: ULP_MARGIN times the largest move, relative to the
  output's largest entry (each step's for the served logits), over
  ULP_SEEDS draws that move every weight by one ulp up or down at random,
  of which only the draws whose drop counts equal the record's are taken:
  the forward's for the logits and the loss, the prefill's and every
  decode step's for the served logits.  A port that drops otherwise fails
  the drop check on its own, and a draw that reorders the drops moves the
  logits by far more than rounding (0.44 of max |logit| in deepseek's
  forward), so it would make E pass almost any answer.

Only outputs and E are stored: ``numpy_lm_params`` rebuilds the weights,
the seed the tokens.  ``main(out, desc)`` writes the same record for
another MoE config (``torch_export_lm_mla_reference.py``: deepseek's;
``torch_export_lm_hybrid_reference.py``: jamba's).

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python benchmarks/torch_export_lm_moe_reference.py
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "src", "repro_torch", "assets",
                   "lm_moe_reference.npz")

SEED = 0                   # numpy_lm_params
DATA_SEED = 1              # prompts and teacher tokens
N_PROMPTS, PROMPT_LEN, N_STEPS = 4, 650, 16
DESC = {"arch": "mixtral-8x22b", "smoke": True,
        "overrides": {"n_heads": 6, "n_kv": 1, "d_head": 128}}
ULP_SEEDS = tuple(range(5, 29))
ULP_MARGIN = 2
# the fewest draws with the record's drops that an E may be taken over
MIN_DRAWS = 8
# each output's E is taken over the draws whose drops of these runs equal
# the record's
DROPS_OF = {"logits": ("forward",), "loss": ("forward",),
            "ce": ("forward",), "aux": ("forward",),
            "served": ("prefill", "decode")}


def one_ulp(tree, seed):
    """Every leaf moved by one ulp up or down at random."""
    rng = np.random.default_rng(seed)

    def move(a):
        if isinstance(a, dict):
            return {k: move(v) for k, v in a.items()}
        if isinstance(a, list):
            return [move(v) for v in a]
        away = np.where(rng.random(a.shape) < 0.5, -np.inf, np.inf)
        return np.nextafter(a, away.astype(np.float32))

    return move(tree)


@contextlib.contextmanager
def counting_drops(log: list):
    """``repro.models.moe.sort_dispatch`` appending each call's number of
    dropped assignments to ``log``, in call order (one call a layer)."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe

    orig = moe.sort_dispatch

    def counted(xt, top_idx, e, cap):
        out = orig(xt, top_idx, e, cap)
        jax.debug.callback(lambda n: log.append(int(n)),
                           jnp.sum(~out[2]), ordered=True)
        return out

    moe.sort_dispatch = counted
    try:
        yield log
    finally:
        moe.sort_dispatch = orig


def config(desc=DESC):
    """(JAX config, port config) of ``desc``, float32; an "mla" or "mamba"
    override is a dict of ``MLAConfig`` or ``MambaConfig`` fields."""
    import dataclasses

    import jax.numpy as jnp
    import torch

    from repro.configs.registry import get_config
    from repro.models.ssm import MambaConfig
    from repro.models.transformer import MLAConfig
    from repro_torch.bridge import record_overrides
    from repro_torch.configs import registry as port_registry

    over = dict(desc["overrides"])
    for key, kind in (("mla", MLAConfig), ("mamba", MambaConfig)):
        if key in over:
            over[key] = kind(**over[key])
    cfg = dataclasses.replace(get_config(desc["arch"], smoke=desc["smoke"]),
                              param_dtype=jnp.float32, **over)
    port = dataclasses.replace(
        port_registry.get_config(desc["arch"], smoke=desc["smoke"]),
        param_dtype=torch.float32, **record_overrides(desc))
    return cfg, port


def run(model, params, toks, drops=None):
    """The outputs of one weight tree; with ``drops`` (a dict) each
    call's per-layer drop counts too.  Fresh jits, so that the counting
    ``sort_dispatch`` is traced in."""
    import jax
    import jax.numpy as jnp

    prompts, teacher = toks[:, :PROMPT_LEN], toks[:, PROMPT_LEN:]
    ctx = counting_drops([]) if drops is not None else contextlib.nullcontext([])
    with ctx as log:
        logits, _ = jax.jit(model.logits)(params, jnp.asarray(toks))
        loss, metrics = jax.jit(model.loss)(params, {"tokens":
                                                     jnp.asarray(toks)})
        jax.effects_barrier()
        n_fwd = len(log)
        lg, cache = jax.jit(model.prefill)(params, jnp.asarray(prompts))
        jax.effects_barrier()
        n_pre = len(log)
        cache = model.pad_cache(cache, N_STEPS)
        step = jax.jit(model.decode_step)
        served = [np.asarray(lg, np.float32)]
        for i in range(N_STEPS):
            lg, cache = step(params, jnp.asarray(teacher[:, i:i + 1]), cache,
                             jnp.int32(PROMPT_LEN + i))
            served.append(np.asarray(lg[:, 0], np.float32))
        jax.effects_barrier()
    out = {"logits": np.asarray(logits, np.float32),
           "served": np.stack(served, axis=1),
           "loss": np.float32(loss), "ce": np.float32(metrics["ce"]),
           "aux": np.float32(metrics["aux"])}
    if drops is not None:
        L = sum(kind[1] == "moe" for kind in model.kinds)   # MoE layers
        # the forward runs twice (logits, loss): keep the first
        drops["forward"] = np.asarray(log[:L], np.int32)
        drops["prefill"] = np.asarray(log[n_fwd:n_pre], np.int32)
        drops["decode"] = np.asarray(log[n_pre:], np.int32).reshape(
            N_STEPS, L)
        if n_fwd != 2 * L or n_pre - n_fwd != L:
            raise AssertionError(f"counted {n_fwd} forward and "
                                 f"{n_pre - n_fwd} prefill dispatches")
    return out


def rel_move(moved, base, axis=None):
    if axis is None:
        return float(np.abs(moved - base).max() / np.abs(base).max())
    return float((np.abs(moved - base).max(axis)
                  / np.abs(base).max(axis)).max())


def main(out=OUT, desc=DESC):
    import jax
    import jax.numpy as jnp

    from repro.models.transformer import Model
    from repro.serve.engine import generate
    from repro_torch.bridge import numpy_lm_params

    t0 = time.perf_counter()
    cfg, port_cfg = config(desc)
    model = Model(cfg)
    tree = numpy_lm_params(port_cfg, SEED)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    toks = np.random.default_rng(DATA_SEED).integers(
        0, cfg.vocab, (N_PROMPTS, PROMPT_LEN + N_STEPS)).astype(np.int32)
    drops = {}
    base = run(model, params, toks, drops)

    moves = {k: 0.0 for k in DROPS_OF}
    draws = {k: 0 for k in DROPS_OF}
    for seed in ULP_SEEDS:
        moved_drops = {}
        moved = run(model, jax.tree_util.tree_map(jnp.asarray,
                                                  one_ulp(tree, seed)), toks,
                    moved_drops)
        for k, runs in DROPS_OF.items():
            if not all(np.array_equal(moved_drops[r], drops[r])
                       for r in runs):
                continue
            draws[k] += 1
            moves[k] = max(moves[k], rel_move(
                moved[k], base[k], axis=-1 if k == "served" else None))
    if min(draws.values()) < MIN_DRAWS:
        raise AssertionError(f"too few one-ulp draws keep the record's "
                             f"drops: {draws}")
    sens = {k: ULP_MARGIN * v for k, v in moves.items()}

    prompts = toks[:, :PROMPT_LEN]
    greedy = np.asarray(generate(model, params, jnp.asarray(prompts),
                                 N_STEPS), np.int32)
    lg, cache = jax.jit(model.prefill)(params, jnp.asarray(prompts))
    cache = model.pad_cache(cache, N_STEPS)
    step = jax.jit(model.decode_step)
    gaps, tops = [], []
    for i in range(N_STEPS):
        lg = np.asarray(lg, np.float32)
        if not np.array_equal(lg.argmax(-1), greedy[:, i]):
            raise AssertionError(f"step {i}: generate disagrees with argmax")
        srt = np.sort(lg, axis=-1)
        gaps.append(srt[:, -1] - srt[:, -2])
        tops.append(np.abs(lg).max(axis=-1))
        nxt, cache = step(params, jnp.asarray(greedy[:, i:i + 1]), cache,
                          jnp.int32(PROMPT_LEN + i))
        lg = nxt[:, 0]

    arrays = {
        "config": np.array(json.dumps(desc)), "seed": np.int64(SEED),
        "prompts": prompts, "teacher": toks[:, PROMPT_LEN:],
        "logits": base["logits"], "prefill_logits": base["served"][:, 0],
        "decode_logits": base["served"][:, 1:], "loss": base["loss"],
        "ce": base["ce"], "aux": base["aux"],
        "forward_drops": drops["forward"], "prefill_drops": drops["prefill"],
        "decode_drops": drops["decode"], "greedy": greedy,
        "greedy_gap": np.stack(gaps, 1), "greedy_max": np.stack(tops, 1),
        "sensitivity": np.array(json.dumps(sens)),
    }
    np.savez_compressed(out, **arrays)
    print(f"{time.perf_counter() - t0:.1f} s; E {sens} over {draws} of "
          f"{len(ULP_SEEDS)} draws; drops: forward "
          f"{drops['forward'].tolist()}, prefill {drops['prefill'].tolist()}"
          f", decode steps {drops['decode'].tolist()}; loss "
          f"{float(base['loss']):.6g} (ce {float(base['ce']):.6g}, aux "
          f"{float(base['aux']):.6g}); smallest top-2 gap "
          f"{float((np.stack(gaps, 1) / np.stack(tops, 1)).min()):.3g} of "
          "max |logit|", flush=True)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    main()
