"""Export the JAX MoE training record for the PyTorch port.

Runs the JAX package's jitted ``make_train_step`` on the CPU in float32 on
the MoE record's config (``torch_export_lm_moe_reference.DESC``:
MIXTRAL_SMOKE, 4 layers, 4 experts top-2, window 16, 6 / 1 heads of 128,
capacity factor 1.25), with weights from
``repro_torch.bridge.numpy_lm_params(cfg, seed=0)``,
``AdamWConfig(warmup_steps=1)`` and the batches
``batch_for_step(DataConfig(256, seq=650, global_batch=4, seed=0), step)``
for STEPS steps, as ``torch_export_lm_train_reference.py`` does for the
dense records, and writes ``src/repro_torch/assets/
lm_moe_train_reference.npz``:

* per step: the loss, ce, aux (the routers' balance and z losses), global
  gradient norm and learning rate;
* per step and MoE layer: the assignments the layer drops in the step's
  forward, counted once.  The counts come from rebinding
  ``repro.models.moe.sort_dispatch`` in this process only, with an ordered
  ``jax.debug.callback`` (``torch_export_lm_moe_reference.counting_drops``;
  the JAX package is not edited).  Under remat JAX dispatches each layer
  again where the backward recomputes it, and the ordered callbacks come
  in program order, the forward's first: a step's first L counts (L MoE
  layers) are its forward's;
* at step 0, per gradient leaf: the float64 sums of g^2 and of g * p, p a
  probe from ``bridge.lm_train_probe``;
* each quantity's one-ulp sensitivity E: ULP_MARGIN times the largest
  relative move of it over ULP_SEEDS draws in which every weight moves by
  one ulp up or down at random, as the MoE serving records take theirs,
  taken for step s only over the draws whose drops equal the record's at
  steps 0 to s (the step-0 gradient's over those that keep step 0's),
  with at least ``MIN_DRAWS`` such draws.  A draw that drops otherwise
  routes otherwise, and its move says nothing of rounding.  A step with
  fewer draws ends the record before it (and at least MIN_STEPS must
  remain).  The margin: a port run is one more run a rounding away from
  JAX's, and two such runs lie up to twice the largest move apart.  From
  step 1 on the random-weight model is chaotic (AdamW's first step moves
  every weight by about lr sign(g), and the sign of a gradient entry near
  zero is rounding): the step-1 grad norm's largest move over the draws
  is 7.2%, and the CPU port reads 13.6% from JAX's there
  (``chip_smoke.lm_train_record_check``'s reading).

Nothing that ``numpy_lm_params`` rebuilds is stored.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python benchmarks/torch_export_lm_moe_train_reference.py
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from benchmarks.torch_export_lm_moe_reference import (
    DESC,
    MIN_DRAWS,
    ULP_MARGIN,
    config,
    counting_drops,
    one_ulp,
)
from benchmarks.torch_export_lm_train_reference import (
    BATCH,
    DATA_SEED,
    OPT,
    SEED,
    SEQ,
    ULP_SEEDS,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "src", "repro_torch", "assets",
                   "lm_moe_train_reference.npz")

STEPS = 4
MIN_STEPS = 3
PER_STEP = ("loss", "ce", "aux", "grad_norm")


def forward_drops(log: list, n_moe: int, remat: bool) -> list:
    """The forward's drop counts of one ``loss`` evaluation's callbacks
    (``log``): its first ``n_moe``; under remat the recompute's follow."""
    if len(log) != (2 if remat else 1) * n_moe:
        raise AssertionError(f"{len(log)} dispatches counted for {n_moe} MoE "
                             f"layers (remat {remat})")
    return list(log[:n_moe])


def run(fns, params, data, log, n_moe, remat):
    """One weight tree through the jitted gradient and STEPS train steps:
    ({quantity: (steps,) float32}, (steps, n_moe) drops, leaf names, g^2
    and g * probe sums at step 0, the step-0 gradient's drops)."""
    import jax
    import jax.numpy as jnp

    from repro.data.pipeline import batch_for_step
    from repro.train.optimizer import init_opt_state
    from repro_torch.bridge import lm_train_probe

    vg, step = fns

    def batch(s):
        return {"tokens": jnp.asarray(batch_for_step(data, s)["tokens"])}

    log.clear()
    (_l, _m), grads = vg(params, batch(0))
    jax.effects_barrier()
    grad_drops = forward_drops(log, n_moe, remat)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    # a list's entries (deepseek's dense prefix) by their index
    names = ["/".join(str(k.key if hasattr(k, "key") else k.idx)
                      for k in path) for path, _g in flat]
    g = [np.asarray(x, np.float64) for _p, x in flat]
    g_sq = np.array([np.sum(x * x) for x in g])
    g_probe = np.array([np.sum(x * lm_train_probe(x.shape)) for x in g])

    opt = init_opt_state(params)
    out = {k: [] for k in PER_STEP + ("lr",)}
    drops = []
    for s in range(STEPS):
        log.clear()
        params, opt, met = step(params, opt, batch(s))
        jax.effects_barrier()
        drops.append(forward_drops(log, n_moe, remat))
        for k in out:
            out[k].append(np.float32(met[k]))
    return ({k: np.array(v, np.float32) for k, v in out.items()},
            np.array(drops, np.int32), names, g_sq, g_probe, grad_drops)


def sensitivity(base, moved_runs, probe_norms):
    """E of each quantity over the draws that keep the record's drops (see
    the module's docstring); the number of such draws a step; the steps
    the record keeps."""
    arrays, drops, _names, g_sq, g_probe, grad_drops = base
    kept = np.zeros(STEPS, np.int64)
    e = {k: np.zeros(STEPS) for k in PER_STEP}
    e["g_norm"] = e["g_probe"] = 0.0
    norm = np.sqrt(g_sq)
    grad_draws = 0
    for m_arrays, m_drops, _n, m_sq, m_probe, m_grad_drops in moved_runs:
        same = np.cumprod([np.array_equal(m_drops[s], drops[s])
                           for s in range(STEPS)]).astype(bool)
        kept += same
        for k in PER_STEP:
            rel = np.abs(m_arrays[k].astype(np.float64) - arrays[k]) / np.abs(
                arrays[k])
            e[k] = np.where(same, np.maximum(e[k], rel), e[k])
        if m_grad_drops == grad_drops:
            grad_draws += 1
            e["g_norm"] = max(e["g_norm"], float(
                (np.abs(np.sqrt(m_sq) - norm) / norm).max()))
            e["g_probe"] = max(e["g_probe"], float(
                (np.abs(m_probe - g_probe) / (norm * probe_norms)).max()))
    if grad_draws < MIN_DRAWS:
        raise AssertionError(f"{grad_draws} one-ulp draws keep the step-0 "
                             "gradient's drops")
    steps = int(np.argmin(kept >= MIN_DRAWS)) if (kept < MIN_DRAWS).any() \
        else STEPS
    if steps < MIN_STEPS:
        raise AssertionError(f"draws that keep the drops a step: "
                             f"{kept.tolist()}; fewer than {MIN_DRAWS} "
                             f"from step {steps} on")
    sens = {k: (ULP_MARGIN * v[:steps]).tolist()
            if isinstance(v, np.ndarray) else ULP_MARGIN * v
            for k, v in e.items()}
    return sens, kept, grad_draws, steps


def main(out=OUT, desc=DESC, opt=OPT):
    import jax
    import jax.numpy as jnp

    from repro.data.pipeline import DataConfig
    from repro.models.transformer import Model
    from repro.train.optimizer import AdamWConfig
    from repro.train.step import make_train_step
    from repro_torch.bridge import lm_train_probe, numpy_lm_params

    t0 = time.perf_counter()
    cfg, port_cfg = config(desc)
    model = Model(cfg)
    n_moe = sum(kind[1] == "moe" for kind in model.kinds)
    tree = numpy_lm_params(port_cfg, SEED)
    data = DataConfig(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH,
                      seed=DATA_SEED)
    with counting_drops([]) as log:
        fns = (jax.jit(jax.value_and_grad(model.loss, has_aux=True)),
               jax.jit(make_train_step(model, AdamWConfig(**opt))))

        def one(t):
            return run(fns, jax.tree_util.tree_map(jnp.asarray, t), data,
                       log, n_moe, cfg.remat)

        base = one(tree)
        moved = [one(one_ulp(tree, s)) for s in ULP_SEEDS]
    arrays, drops, names, g_sq, g_probe, _grad_drops = base
    shapes = {n: np.shape(g) for n, g in zip(names, (
        jax.tree_util.tree_leaves(tree)))}
    probe_norms = np.array([np.sqrt(np.sum(lm_train_probe(shapes[n]) ** 2))
                            for n in names])
    sens, kept, grad_draws, steps = sensitivity(base, moved, probe_norms)
    meta = dict(desc, data={"vocab": cfg.vocab, "seq": SEQ,
                            "global_batch": BATCH, "seed": DATA_SEED},
                steps=steps, opt=opt, leaves=names, sensitivity=sens,
                draws={"steps": kept[:steps].tolist(), "g": grad_draws,
                       "of": len(ULP_SEEDS)})
    np.savez_compressed(
        out, config=np.array(json.dumps(meta)), seed=np.int64(SEED),
        drops=drops[:steps], g_sq=g_sq, g_probe=g_probe,
        **{k: v[:steps] for k, v in arrays.items()})
    print(f"{time.perf_counter() - t0:.1f} s; {steps} of {STEPS} steps "
          f"kept; losses {arrays['loss'].tolist()}; aux "
          f"{arrays['aux'].tolist()}; grad norms "
          f"{arrays['grad_norm'].tolist()}; drops {drops.tolist()}; draws "
          f"that keep the drops {kept.tolist()} (step-0 gradient "
          f"{grad_draws}) of {len(ULP_SEEDS)}; E {sens}", flush=True)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    main()
