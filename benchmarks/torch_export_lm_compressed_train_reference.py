"""Export the JAX compressed-training record for the PyTorch port.

Runs the JAX package's jitted ``make_train_step_compressed`` (int8 +
error-feedback gradient exchange over the "pod" axis) on the CPU in
float32, on yi-9b's SMOKE config with d_head 64 (the width the port's
flash kernels are built for; SMOKE's own 16 is not), with weights from
``repro_torch.bridge.numpy_lm_params(cfg, seed=0)``,
``AdamWConfig(warmup_steps=1, lr_peak=3e-6)`` and the batches
``batch_for_step(DataConfig(vocab, seq=64, global_batch=4, seed=0), step)``
for 3 steps, at 1 pod and at 2 pods (pod p takes rows 2p and 2p + 1), on a
mesh with ``AxisType.Auto`` axes (on this jax a plain ``jax.make_mesh``
makes Explicit axes, which the step's model refuses inside its
``shard_map``), and writes
``src/repro_torch/assets/lm_compressed_train_reference.npz``:

* per run and step: the loss, ce, global gradient norm and learning rate,
  and after the step, for each pod, the norm of every leaf's
  error-feedback residual and of all of them (float64 sums of the float32
  residuals).  The reference's step returns the residuals as replicated
  over the pods (``out_specs`` ``P()``) while each pod's differ: a pod
  keeps its own on its device, read here shard by shard in device (pod)
  order;
* each quantity's one-ulp sensitivity E: the largest relative move of it
  over 24 draws in which every weight moves by one ulp up or down at
  random (see ``torch_export_lm_train_reference.py``).  A residual moves
  by a quantization step wherever a one-ulp move carries a value across a
  rounding boundary, so its norms' E is per step and leaf.

The peak lr is 3e-6, as the MLA and hybrid training records': AdamW's
first step moves every weight by about lr sign(g), and a code that one
ulp carries across a rounding boundary turns an update of 0 into one of
lr.  At the default 3e-4 the step-2 E of the 1-pod grad norm was 0.36 and
of the residual norm 0.31; at 3e-6, 2.4e-4 and 2.8e-3.

Nothing that ``numpy_lm_params`` rebuilds is stored.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python benchmarks/torch_export_lm_compressed_train_reference.py
"""

from __future__ import annotations

import os

# two fake CPU devices for the 2-pod run; set before JAX starts its backend
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=2")

import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from benchmarks.torch_export_lm_train_reference import one_ulp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "src", "repro_torch", "assets",
                   "lm_compressed_train_reference.npz")

DESC = {"arch": "yi-9b", "smoke": True, "overrides": {"d_head": 64}}
SEED = 0                   # numpy_lm_params
SEQ, BATCH, DATA_SEED = 64, 4, 0
STEPS = 3
PODS = (1, 2)
OPT = {"warmup_steps": 1, "lr_peak": 3e-6}
ULP_SEEDS = tuple(range(5, 29))
QUANTITIES = ("loss", "ce", "grad_norm", "res_norm")


def pod_mesh(npods: int):
    """A 1-D "pod" mesh of the first ``npods`` devices, its axis Auto."""
    import jax

    return jax.make_mesh((npods,), ("pod",), devices=jax.devices()[:npods],
                         axis_types=(jax.sharding.AxisType.Auto,))


def pod_residuals(leaf) -> list:
    """Each pod's residual of one leaf: its devices' buffers, in device
    order."""
    shards = sorted(leaf.addressable_shards, key=lambda sh: sh.device.id)
    return [np.asarray(sh.data) for sh in shards]


def residual_norms(ef):
    """(per pod the norm of each leaf's residual, (pods, leaves); per pod
    the norm of all, (pods,)), float64."""
    import jax

    sq = np.array([[np.sum(np.asarray(r, np.float64) ** 2)
                    for r in pod_residuals(leaf)]
                   for leaf in jax.tree_util.tree_leaves(ef)]).T
    return np.sqrt(sq), np.sqrt(sq.sum(axis=1))


def run(cfg, tree, data, npods):
    """Per-step arrays of the jitted compressed step from ``tree``."""
    import jax
    import jax.numpy as jnp

    from repro.data.pipeline import batch_for_step
    from repro.models.transformer import Model
    from repro.parallel.axes import use_sharding
    from repro.train.optimizer import AdamWConfig, init_opt_state
    from repro.train.step import init_ef_states, make_train_step_compressed

    model = Model(cfg)
    out = {k: [] for k in ("loss", "ce", "grad_norm", "lr", "res_norm",
                           "res_leaf")}
    with use_sharding(pod_mesh(npods)):
        step = jax.jit(make_train_step_compressed(model, AdamWConfig(**OPT)))
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        opt = init_opt_state(params)
        ef = init_ef_states(params)
        for s in range(STEPS):
            batch = {"tokens": jnp.asarray(
                batch_for_step(data, s)["tokens"])}
            params, opt, ef, met = step(params, opt, ef, batch)
            for k in ("loss", "ce", "grad_norm", "lr"):
                out[k].append(np.float32(met[k]))
            leaf, total = residual_norms(ef)
            out["res_leaf"].append(leaf)
            out["res_norm"].append(total)
    arrays = {k: np.array(v, np.float32) for k, v in out.items()
              if k not in ("res_norm", "res_leaf")}
    arrays["res_norm"] = np.array(out["res_norm"])
    arrays["res_leaf"] = np.array(out["res_leaf"])
    return arrays


def sensitivity(base, moved_runs):
    """Per step, the largest relative move of each quantity (of the
    residual norms per step and pod, and of a leaf's per step, pod and
    leaf)."""
    e = {k: np.zeros(np.shape(base[k])) for k in QUANTITIES}
    e["res_leaf"] = np.zeros_like(base["res_leaf"])
    for m in moved_runs:
        for k in e:
            rel = np.abs(m[k].astype(np.float64) - base[k]) / np.where(
                base[k] == 0, 1.0, np.abs(base[k]))
            e[k] = np.maximum(e[k], rel)
    return e


def main(out=OUT):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs.registry import get_config
    from repro.data.pipeline import DataConfig
    from repro_torch.bridge import numpy_lm_params
    from repro_torch.configs import registry as port_registry

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(DESC["arch"], smoke=DESC["smoke"]),
                              param_dtype=jnp.float32, **DESC["overrides"])
    port_cfg = dataclasses.replace(
        port_registry.get_config(DESC["arch"], smoke=DESC["smoke"]),
        param_dtype=torch.float32, **DESC["overrides"])
    tree = numpy_lm_params(port_cfg, SEED)
    data = DataConfig(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH,
                      seed=DATA_SEED)
    names = ["/".join(str(k.key) for k in path) for path, _l in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    arrays = {"seed": np.int64(SEED), "pods": np.array(PODS)}
    sens = {}
    for npods in PODS:
        base = run(cfg, tree, data, npods)
        moved = [run(cfg, one_ulp(tree, s), data, npods) for s in ULP_SEEDS]
        e = sensitivity(base, moved)
        arrays.update({f"pods{npods}_{k}": v for k, v in base.items()})
        arrays[f"pods{npods}_e_res_leaf"] = e.pop("res_leaf")
        sens[npods] = {k: v.tolist() for k, v in e.items()}
        print(f"{npods} pod(s): losses {base['loss'].tolist()}; grad norms "
              f"{base['grad_norm'].tolist()}; residual norms "
              f"{base['res_norm'].tolist()}; E {sens[npods]}; largest leaf "
              f"E {arrays[f'pods{npods}_e_res_leaf'].max(axis=2).tolist()}",
              flush=True)
    meta = dict(DESC, data={"vocab": cfg.vocab, "seq": SEQ,
                            "global_batch": BATCH, "seed": DATA_SEED},
                steps=STEPS, opt=OPT, leaves=names,
                sensitivity={str(k): v for k, v in sens.items()})
    arrays["config"] = np.array(json.dumps(meta))
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({os.path.getsize(out)} bytes) in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
