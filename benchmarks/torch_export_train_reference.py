"""Export the §III training inputs and outcomes for the PyTorch port.

The NN of ``assets/fa_reference.npz`` was trained by the JAX package's
``train_face_nn(steps=1500)`` on ``face_dataset(n_per_class=400, seed=3)``
from ``init_face_nn(PRNGKey(0), 400, 8)``, drawing each step's 128 batch
indices with ``jax.random``, which the port cannot reproduce.  This script
writes ``src/repro_torch/assets/train_reference.npz``:

* the initial weights ``w1``, ``b1``, ``w2``, ``b2``;
* ``batches``, the (1500, 128) uint16 batch-index schedule the training
  drew (``split(PRNGKey(1))`` each step, then ``randint``);
* ``classification_error``, JAX's error of the trained NN (float path) on
  the 800 training windows;
* ``accepted`` and ``stage_evals``, JAX's ``cascade_apply`` of the asset's
  cascade on the cascade's 2,300 training windows (the face set plus the
  hard negatives harvested from ``security_video()``).

With the weights and the schedule, the port's ``fit_face_nn`` trains the
asset's NN.  The legacy threefry layout is set, as in
``torch_export_fa_reference.py``: the asset's NN was trained under it.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python benchmarks/torch_export_train_reference.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "src", "repro_torch", "assets",
                   "train_reference.npz")
FA_ASSET = os.path.join(REPO, "src", "repro_torch", "assets",
                        "fa_reference.npz")

N_PER_CLASS, DATA_SEED = 400, 3      # workloads.fa_cascade, fa_hotpath
STEPS, BATCH = 1500, 128             # fa_hotpath._workload, train_face_nn


def batch_schedule(steps: int, n: int, seed: int = 0) -> np.ndarray:
    """The batch indices ``train_face_nn(seed=seed)`` draws, step by step."""
    import jax

    key = jax.random.PRNGKey(seed + 1)
    out = np.empty((steps, BATCH), np.int64)
    for t in range(steps):
        key, sub = jax.random.split(key)
        out[t] = np.asarray(jax.random.randint(sub, (BATCH,), 0, n))
    return out


def main(out: str = OUT):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_threefry_partitionable", False)
    from repro.camera.face_nn import (
        classification_error, forward_float, init_face_nn, train_face_nn)
    from repro.camera.synthetic import face_dataset, security_video
    from repro.camera.viola_jones import (
        Cascade, HaarFeature, cascade_apply, harvest_hard_negatives)

    X, y, _ = face_dataset(n_per_class=N_PER_CLASS, seed=DATA_SEED)
    nn = train_face_nn(X, y, steps=STEPS)
    with np.load(FA_ASSET) as fa:
        if not np.array_equal(np.asarray(nn.w1), fa["w1"]):
            raise RuntimeError("train_face_nn no longer trains the NN of "
                               "fa_reference.npz")
        casc = Cascade(
            feats=[HaarFeature(*(int(v) for v in f)) for f in fa["feats"]],
            thresholds=fa["thresholds"], polarity=fa["polarity"],
            alphas=fa["alphas"], stage_sizes=[int(s) for s in
                                              fa["stage_sizes"]],
            stage_thresholds=fa["stage_thresholds"])
    init = init_face_nn(jax.random.PRNGKey(0), X.shape[1], 8)
    batches = batch_schedule(STEPS, len(X))
    err = classification_error(forward_float(nn, jnp.asarray(X)), y)

    frames, truth = security_video()
    neg = harvest_hard_negatives(frames, truth)
    windows = np.concatenate([X, neg]).reshape(-1, 20, 20)
    accepted, evals = cascade_apply(casc, jnp.asarray(windows))
    np.savez_compressed(
        out,
        w1=np.asarray(init.w1), b1=np.asarray(init.b1),
        w2=np.asarray(init.w2), b2=np.asarray(init.b2),
        batches=batches.astype(np.uint16),
        classification_error=np.float64(err),
        accepted=np.asarray(accepted), stage_evals=np.asarray(evals),
        dataset=np.array([N_PER_CLASS, DATA_SEED, len(neg)], np.int64))
    print(f"wrote {out}: error {err}, {int(np.asarray(accepted).sum())} of "
          f"{len(windows)} training windows accepted, "
          f"{int(np.asarray(evals).sum())} stage evaluations, "
          f"{os.path.getsize(out)} bytes")


if __name__ == "__main__":
    main()
