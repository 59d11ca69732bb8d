"""Export the JAX LM training record for the PyTorch port.

Runs the JAX package's jitted ``make_train_step`` on the CPU in float32 on
the two configs of ``lm_reference.npz`` ("yi": yi-9b's family with d_head
128, 8 / 1 heads, d_model 256, 2 layers, vocab 512; "rwkv": RWKV6_SMOKE),
with weights from ``repro_torch.bridge.numpy_lm_params(cfg, seed=0)``,
``AdamWConfig(warmup_steps=1)`` and the batches
``batch_for_step(DataConfig(vocab, seq=650, global_batch=4, seed=0), step)``
for 4 steps, and writes ``src/repro_torch/assets/lm_train_reference.npz``:

* per step: the loss, ce, global gradient norm and learning rate;
* at step 0, per gradient leaf: the float64 sums of g^2 and of g * p, p a
  probe from ``bridge.lm_train_probe`` (numpy seed 7, the leaf's shape);
* each quantity's one-ulp sensitivity E: the largest relative move of it
  over 24 draws in which every weight moves by one ulp up or down at
  random.  A single draw's move varies severalfold, so a few draws
  underestimate E: yi's norm1-scale gradient norm reads 2.15e-4 from JAX
  on the CPU port against 1.47e-4 over three draws and 3.28e-4 over
  eight; its step-2 grad norm reads 0.116 against 0.090 over eight draws
  and 0.137 over 24.  The per-step quantities (loss, ce, grad norm) get an E per
  step: from step 1 on, AdamW moves every weight by about lr sign(g), so a
  gradient entry near zero that changes sign under one ulp moves the next
  steps' gradients far (the grad norm's E is 0.12 at yi's step 1).  A
  probe's move is taken relative to |g| |p|, a leaf norm's to |g|, the
  largest over the leaves.

Nothing that ``numpy_lm_params`` rebuilds is stored.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python benchmarks/torch_export_lm_train_reference.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from benchmarks.torch_export_lm_reference import RECORDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "src", "repro_torch", "assets",
                   "lm_train_reference.npz")

SEED = 0                   # numpy_lm_params
SEQ, BATCH, DATA_SEED = 650, 4, 0
STEPS = 4
OPT = {"warmup_steps": 1}
ULP_SEEDS = tuple(range(5, 29))


def one_ulp(tree, seed):
    """Every leaf moved by one ulp up or down at random."""
    rng = np.random.default_rng(seed)

    def move(a):
        away = np.where(rng.random(a.shape) < 0.5, -np.inf, np.inf)
        return np.nextafter(a, away.astype(np.float32))

    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) \
            else move(t)

    return walk(tree)


def run(cfg, tree, data):
    """(per-step arrays, leaf names, per-leaf float64 sums of g^2 and
    g * probe at step 0) of the jitted JAX train step from ``tree``."""
    import jax
    import jax.numpy as jnp

    from repro.data.pipeline import batch_for_step
    from repro.models.transformer import Model
    from repro.train.optimizer import AdamWConfig, init_opt_state
    from repro.train.step import make_train_step
    from repro_torch.bridge import lm_train_probe

    model = Model(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    batch0 = {"tokens": jnp.asarray(batch_for_step(data, 0)["tokens"])}
    (_l, _m), grads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
        params, batch0)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    names = ["/".join(str(k.key) for k in path) for path, _g in flat]
    g = [np.asarray(x, np.float64) for _p, x in flat]
    g_sq = np.array([np.sum(x * x) for x in g])
    g_probe = np.array([np.sum(x * lm_train_probe(x.shape)) for x in g])

    step = jax.jit(make_train_step(model, AdamWConfig(**OPT)))
    opt = init_opt_state(params)
    out = {k: [] for k in ("loss", "ce", "grad_norm", "lr")}
    for s in range(STEPS):
        batch = {"tokens": jnp.asarray(batch_for_step(data, s)["tokens"])}
        params, opt, met = step(params, opt, batch)
        for k in out:
            out[k].append(np.float32(met[k]))
    return ({k: np.array(v, np.float32) for k, v in out.items()}, names,
            g_sq, g_probe)


def sensitivity(base, moved_runs, probe_norms):
    """One-ulp E of each quantity (see the module's docstring)."""
    arrays, _names, g_sq, g_probe = base
    e = {"loss": np.zeros(STEPS), "ce": np.zeros(STEPS),
         "grad_norm": np.zeros(STEPS), "g_norm": 0.0, "g_probe": 0.0}
    norm = np.sqrt(g_sq)
    for m_arrays, _n, m_sq, m_probe in moved_runs:
        for k in ("loss", "ce", "grad_norm"):
            rel = np.abs(m_arrays[k].astype(np.float64) - arrays[k]) / np.abs(
                arrays[k])
            e[k] = np.maximum(e[k], rel)
        e["g_norm"] = max(e["g_norm"], float(
            (np.abs(np.sqrt(m_sq) - norm) / norm).max()))
        e["g_probe"] = max(e["g_probe"], float(
            (np.abs(m_probe - g_probe) / (norm * probe_norms)).max()))
    return {k: v.tolist() if isinstance(v, np.ndarray) else v
            for k, v in e.items()}


def record(desc):
    import jax.numpy as jnp
    import torch

    from repro.configs.registry import get_config
    from repro.data.pipeline import DataConfig
    from repro_torch.bridge import lm_train_probe, numpy_lm_params
    from repro_torch.configs import registry as port_registry

    cfg = dataclasses.replace(get_config(desc["arch"], smoke=desc["smoke"]),
                              param_dtype=jnp.float32, **desc["overrides"])
    port_cfg = dataclasses.replace(
        port_registry.get_config(desc["arch"], smoke=desc["smoke"]),
        param_dtype=torch.float32, **desc["overrides"])
    tree = numpy_lm_params(port_cfg, SEED)
    data = DataConfig(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH,
                      seed=DATA_SEED)
    base = run(cfg, tree, data)
    moved = [run(cfg, one_ulp(tree, s), data) for s in ULP_SEEDS]
    arrays, names, g_sq, g_probe = base
    shapes = {"/".join(p): np.shape(leaf) for p, leaf in _leaves(tree)}
    probe_norms = np.array([np.sqrt(np.sum(lm_train_probe(shapes[n]) ** 2))
                            for n in names])
    meta = dict(desc, data={"vocab": cfg.vocab, "seq": SEQ,
                            "global_batch": BATCH, "seed": DATA_SEED},
                steps=STEPS, opt=OPT, leaves=names,
                sensitivity=sensitivity(base, moved, probe_norms))
    return meta, dict(arrays, g_sq=g_sq, g_probe=g_probe)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def main(out=OUT):
    arrays = {"names": np.array(list(RECORDS)), "seed": np.int64(SEED)}
    for name, desc in RECORDS.items():
        t0 = time.perf_counter()
        meta, rec = record(desc)
        arrays[f"{name}_config"] = np.array(json.dumps(meta))
        arrays.update({f"{name}_{k}": v for k, v in rec.items()})
        print(f"{name}: {time.perf_counter() - t0:.1f} s; losses "
              f"{rec['loss'].tolist()}; grad norms "
              f"{rec['grad_norm'].tolist()}; E {meta['sensitivity']}",
              flush=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    main()
