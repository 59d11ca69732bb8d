"""Export the JAX LM reference for the PyTorch port.

Runs the JAX ``Model`` on the CPU in float32 on two reduced configs, with
weights from ``repro_torch.bridge.numpy_lm_params(cfg, seed=0)`` (the same
tree the port loads with ``lm_params_from``), and writes
``src/repro_torch/assets/lm_reference.npz``:

* "yi": yi-9b's family with its head shape kept (d_head 128, a GQA group
  of 8: n_heads 8, n_kv 1), d_model 256, d_ff 512, vocab 512, 2 layers;
* "rwkv": RWKV6_SMOKE (3 layers, d_model 128, two heads of 64).

Traffic, for both: 4 prompts of 650 tokens (ragged against the JAX flash
kernel's 256-row blocks, the port's 64-row tiles and the WKV chunk of 32)
and 16 more tokens, uniform ids from numpy's generator seeded with 1.  It
stores the prefill's last-token logits, the logits of 16 teacher-forced
``decode_step``s on the extra tokens, and ``generate``'s 16 greedy tokens
from the prompts with the gap between the top two logits and the largest
|logit| at each step.  Only outputs are stored: ``numpy_lm_params``
rebuilds the weights from the seed.

It also stores each record's float32 sensitivity E: the largest move of
the prefill and teacher-forced logits, relative to each step's largest
|logit|, when every weight moves by one ulp up or down at random.  These
random-weight models amplify rounding layer by layer (E is 6.5e-5 for yi
and 2.9e-4 for rwkv), so a float32 implementation that rounds differently
is held to max(1e-4, E) of the largest |logit|.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python benchmarks/torch_export_lm_reference.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "src", "repro_torch", "assets", "lm_reference.npz")

SEED = 0                   # numpy_lm_params
DATA_SEED = 1              # prompts and teacher tokens
N_PROMPTS, PROMPT_LEN, N_STEPS = 4, 650, 16
RECORDS = {
    "yi": {"arch": "yi-9b", "smoke": False,
           "overrides": {"n_layers": 2, "d_model": 256, "n_heads": 8,
                         "n_kv": 1, "d_head": 128, "d_ff": 512,
                         "vocab": 512}},
    "rwkv": {"arch": "rwkv6-7b", "smoke": True, "overrides": {}},
}


def one_ulp(tree, seed=5):
    """Every leaf moved by one ulp up or down at random."""
    rng = np.random.default_rng(seed)

    def move(a):
        away = np.where(rng.random(a.shape) < 0.5, -np.inf, np.inf)
        return np.nextafter(a, away.astype(np.float32))

    return {k: one_ulp_tree(v, move) for k, v in tree.items()}


def one_ulp_tree(tree, move):
    if isinstance(tree, dict):
        return {k: one_ulp_tree(v, move) for k, v in tree.items()}
    return move(tree)


def teacher_forced(model, params, prompts, teacher):
    """(b, 1 + n, vocab): the prefill's logits, then one per decode step."""
    import jax
    import jax.numpy as jnp

    logits, cache = jax.jit(model.prefill)(params, jnp.asarray(prompts))
    cache = model.pad_cache(cache, teacher.shape[1])
    out = [np.asarray(logits, np.float32)]
    step = jax.jit(model.decode_step)
    for i in range(teacher.shape[1]):
        lg, cache = step(params, jnp.asarray(teacher[:, i:i + 1]), cache,
                         jnp.int32(prompts.shape[1] + i))
        out.append(np.asarray(lg[:, 0], np.float32))
    return np.stack(out, axis=1)


def record(desc):
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs.registry import get_config
    from repro.models.transformer import Model
    from repro.serve.engine import generate
    from repro_torch.bridge import numpy_lm_params
    from repro_torch.configs import registry as port_registry

    cfg = dataclasses.replace(get_config(desc["arch"], smoke=desc["smoke"]),
                              param_dtype=jnp.float32, **desc["overrides"])
    port_cfg = dataclasses.replace(
        port_registry.get_config(desc["arch"], smoke=desc["smoke"]),
        param_dtype=torch.float32, **desc["overrides"])
    model = Model(cfg)
    tree = numpy_lm_params(port_cfg, SEED)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    toks = np.random.default_rng(DATA_SEED).integers(
        0, cfg.vocab, (N_PROMPTS, PROMPT_LEN + N_STEPS)).astype(np.int32)
    prompts, teacher = toks[:, :PROMPT_LEN], toks[:, PROMPT_LEN:]
    prefill = jax.jit(model.prefill)
    step = jax.jit(model.decode_step)

    forced = teacher_forced(model, params, prompts, teacher)
    moved = teacher_forced(
        model, jax.tree_util.tree_map(jnp.asarray, one_ulp(tree)), prompts,
        teacher)
    sensitivity = float((np.abs(moved - forced).max(-1)
                         / np.abs(forced).max(-1)).max())
    out = {"prompts": prompts, "teacher": teacher,
           "prefill_logits": forced[:, 0], "decode_logits": forced[:, 1:],
           "sensitivity": np.float32(sensitivity)}

    greedy = np.asarray(generate(model, params, jnp.asarray(prompts),
                                 N_STEPS), np.int32)
    # the logits along the greedy path, for the near-tie rule
    lg, cache = prefill(params, jnp.asarray(prompts))
    cache = model.pad_cache(cache, N_STEPS)
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
    out.update(greedy=greedy, greedy_gap=np.stack(gaps, 1),
               greedy_max=np.stack(tops, 1))
    return out


def main(out=OUT):
    arrays = {"names": np.array(list(RECORDS)), "seed": np.int64(SEED)}
    for name, desc in RECORDS.items():
        t0 = time.perf_counter()
        rec = record(desc)
        arrays[f"{name}_config"] = np.array(json.dumps(desc))
        arrays.update({f"{name}_{k}": v for k, v in rec.items()})
        gap = rec["greedy_gap"] / rec["greedy_max"]
        print(f"{name}: {time.perf_counter() - t0:.1f} s; sensitivity E "
              f"{float(rec['sensitivity']):.3g}; smallest top-2 gap "
              f"{gap.min():.3g} of max |logit|", flush=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    main()
