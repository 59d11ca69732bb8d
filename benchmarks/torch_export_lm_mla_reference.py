"""Export the JAX MLA LM reference (deepseek) for the PyTorch port.

``torch_export_lm_moe_reference.py``'s record on DEEPSEEK_SMOKE (d_model
64, 8 experts top-2 with one shared expert, the dense first layer) with
the overrides that put the card's flash kernel at MLA's shape: MLA of
DeepSeek-V2's widths (queries and folded keys of qk_nope 128 + qk_rope 64
= 192, values of 128) over a latent of 32, 2 heads, 3 layers (the dense
prefix and 2 MoE layers), at the published capacity factor of 1.25.
Weights from ``repro_torch.bridge.numpy_lm_params(cfg, seed=0)``; 4
prompts of 650 tokens and 16 teacher-forced steps (seed 1); the forward's
logits, loss (ce, aux), the prefill and decode logits, ``generate``'s
greedy tokens, every layer's drops and E over 24 one-ulp draws.  Writes
``src/repro_torch/assets/lm_mla_reference.npz``.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python benchmarks/torch_export_lm_mla_reference.py
"""

from __future__ import annotations

import os

from benchmarks import torch_export_lm_moe_reference as moe_export

OUT = os.path.join(moe_export.REPO, "src", "repro_torch", "assets",
                   "lm_mla_reference.npz")
DESC = {"arch": "deepseek-v2-236b", "smoke": True,
        "overrides": {"n_layers": 3, "n_heads": 2, "n_kv": 2,
                      "mla": {"kv_lora": 32, "qk_nope": 128, "qk_rope": 64,
                              "v_dim": 128}}}


if __name__ == "__main__":
    moe_export.main(out=OUT, desc=DESC)
