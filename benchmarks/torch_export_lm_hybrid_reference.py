"""Export the JAX hybrid LM reference (jamba) for the PyTorch port.

``torch_export_lm_moe_reference.py``'s record on JAMBA_SMOKE (8 layers,
d_model 64, a period of 4: Mamba layers with attention at layers 2 and 6,
4 experts top-2 on the odd layers) with the overrides that put the card's
flash kernel at its (128, 128) pair, d_head 128 over 4 query and 2 KV
heads, and Mamba at the published d_state of 16 (d_conv 4, expand 2,
dt_rank 16), at the published capacity factor of 1.25.  Weights from
``repro_torch.bridge.numpy_lm_params(cfg, seed=0)``; 4 prompts of 650
tokens and 16 teacher-forced steps (seed 1); the forward's logits, loss
(ce, aux), the prefill and decode logits, ``generate``'s greedy tokens,
every MoE layer's drops and E over the one-ulp draws that keep them.
Writes ``src/repro_torch/assets/lm_hybrid_reference.npz``.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python benchmarks/torch_export_lm_hybrid_reference.py
"""

from __future__ import annotations

import os

from benchmarks import torch_export_lm_moe_reference as moe_export

OUT = os.path.join(moe_export.REPO, "src", "repro_torch", "assets",
                   "lm_hybrid_reference.npz")
DESC = {"arch": "jamba-v0.1-52b", "smoke": True,
        "overrides": {"d_head": 128,
                      "mamba": {"d_state": 16, "d_conv": 4, "expand": 2,
                                "dt_rank": 16}}}


if __name__ == "__main__":
    moe_export.main(out=OUT, desc=DESC)
