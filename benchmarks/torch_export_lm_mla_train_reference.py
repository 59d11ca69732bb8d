"""Export the JAX MLA training record (deepseek) for the PyTorch port.

``torch_export_lm_moe_train_reference.py``'s record on the MLA record's
config (``torch_export_lm_mla_reference.DESC``: DEEPSEEK_SMOKE, 3 layers,
the dense first layer and 2 MoE layers of 8 experts top-2 with one shared
expert, MLA at DeepSeek-V2's widths, queries and folded keys of qk_nope
128 + qk_rope 64 = 192 and values of 128 over a latent of 32, 2 heads,
capacity factor 1.25), in float32: the jitted ``make_train_step`` with
``AdamWConfig(warmup_steps=1)`` on ``batch_for_step(DataConfig(256,
seq=650, global_batch=4, seed=0), step)`` (650 is ragged against every
tile of the flash kernels), weights from
``repro_torch.bridge.numpy_lm_params(cfg, seed=0)``; each step's loss, ce,
aux, grad norm, lr and drops a MoE layer, the step-0 gradient's sums a
leaf, and each quantity's E over the one-ulp draws that keep the record's
drops.  Writes ``src/repro_torch/assets/lm_mla_train_reference.npz``.

The peak learning rate is LR_PEAK, a hundredth of ``AdamWConfig``'s: the
step-0 batch drops 641 and 80 of each MoE layer's 5,200 assignments, and
AdamW's first step moves every weight by about lr sign(g), where the sign
of a gradient entry near zero is rounding.  At the default 3e-4 that
moved the step-1 drops of 23 of the 24 one-ulp draws (by 1-2 of ~250), so
no step after the first could be held to JAX's drops; at 3e-5 step 3
still moved; at 3e-6 the drops of four steps stayed put in every draw
read.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python benchmarks/torch_export_lm_mla_train_reference.py
"""

from __future__ import annotations

import os

from benchmarks import torch_export_lm_moe_train_reference as train_export
from benchmarks.torch_export_lm_mla_reference import DESC

OUT = os.path.join(train_export.REPO, "src", "repro_torch", "assets",
                   "lm_mla_train_reference.npz")
LR_PEAK = 3e-6


if __name__ == "__main__":
    train_export.main(out=OUT, desc=DESC,
                      opt=dict(train_export.OPT, lr_peak=LR_PEAK))
