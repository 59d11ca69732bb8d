"""Export the JAX hybrid training record (jamba) for the PyTorch port.

``torch_export_lm_moe_train_reference.py``'s record on the hybrid serving
record's config (``torch_export_lm_hybrid_reference.DESC``: JAMBA_SMOKE, 8
layers of d_model 64 with a period of 4, Mamba layers at the published
d_state of 16 (d_conv 4, expand 2, dt_rank 16), attention at layers 2 and
6 with d_head 128 over 4 query and 2 KV heads, 4 experts top-2 on the odd
layers, capacity factor 1.25), in float32: the jitted ``make_train_step``
on ``batch_for_step(DataConfig(256, seq=650, global_batch=4, seed=0),
step)`` (650 is ragged against every tile of the flash kernels and every
chunk of the scan), weights from ``repro_torch.bridge.numpy_lm_params(cfg,
seed=0)``; each step's loss, ce, aux, grad norm, lr and drops a MoE layer,
the step-0 gradient's sums a leaf, and each quantity's E over the one-ulp
draws that keep the record's drops.  Writes
``src/repro_torch/assets/lm_hybrid_train_reference.npz``.

The peak learning rate is LR_PEAK, a hundredth of ``AdamWConfig``'s, as
the MLA record's.  The 4 x 650 batches drop nothing at 1.25 in any of the
four steps, in the record and in all 24 one-ulp draws, so the drops do
not bind here; the chaos of the random-weight model after AdamW's first
step does.  At the default 3e-4 the grad norm's E over the draws was
2.9e-2, 0.88 and 1.25 at steps 1-3 (a bound that holds nothing from step
2 on) and the aux loss's 8.7e-4 at step 2; at 3e-6 the grad norm's E is
7.9e-3 or less at every step, the loss's 2.3e-5 or less.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python benchmarks/torch_export_lm_hybrid_train_reference.py
"""

from __future__ import annotations

import os

from benchmarks import torch_export_lm_moe_train_reference as train_export
from benchmarks.torch_export_lm_hybrid_reference import DESC

OUT = os.path.join(train_export.REPO, "src", "repro_torch", "assets",
                   "lm_hybrid_train_reference.npz")
LR_PEAK = 3e-6


if __name__ == "__main__":
    train_export.main(out=OUT, desc=DESC,
                      opt=dict(train_export.OPT, lr_peak=LR_PEAK))
