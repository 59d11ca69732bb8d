"""The ten LM architectures of the JAX package (``configs/lm_archs.py``),
field for field, and their reduced SMOKE variants, with the configuration
dataclasses as plain data (``ModelConfig`` and ``MLAConfig`` from the
reference's ``models/transformer.py``, ``MoEConfig`` from ``models/moe.py``,
``MambaConfig`` from ``models/ssm.py``).  ``param_dtype`` is a
``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0              # DeepSeek shared experts (always-on)
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    parallelism: str = "ep"        # "ep" | "tp"


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 256


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    # attention
    attn_type: str = "full"         # full | swa | mla
    window: int = 4096
    rope_theta: float = 1e4
    attn_bias: bool = False
    qk_norm: bool = False
    mla: Optional[MLAConfig] = None
    # mixer pattern (ssm / hybrid)
    mixer: str = "attn"             # attn | rwkv | mamba
    attn_every: int = 0             # hybrid: attention where i % attn_every == attn_offset
    attn_offset: int = 0
    mamba: Optional[MambaConfig] = None
    # mlp pattern
    mlp_type: str = "swiglu"        # swiglu | gelu | rwkv_cm
    moe: Optional[MoEConfig] = None
    moe_every: int = 1              # MoE where i % moe_every == moe_offset (if moe set)
    moe_offset: int = 0
    first_dense: int = 0            # leading dense-MLP layers (DeepSeek: 1)
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500
    # misc
    norm_type: str = "rms"          # rms | ln
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: torch.dtype = torch.bfloat16
    remat: bool = True              # the reference's jax.checkpoint; unused here
    # assignment metadata
    sub_quadratic: bool = False     # may run long_500k
    source: str = ""

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


# [moe] mixtral-8x22b — 8 experts top-2, SWA  [arXiv:2401.04088; hf]
MIXTRAL_8X22B = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv=8, d_head=128,
    d_ff=16384, vocab=32768,
    attn_type="swa", window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384, parallelism="tp"),
    rope_theta=1e6,
    sub_quadratic=True,
    source="arXiv:2401.04088; hf",
)
MIXTRAL_SMOKE = _replace(
    MIXTRAL_8X22B, n_layers=4, d_model=64, n_heads=4, n_kv=2, d_head=16,
    d_ff=128, vocab=256, window=16,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, parallelism="tp"),
)

# [moe] deepseek-v2-236b — MLA kv_lora=512, 2 shared + 160 routed top-6
# [arXiv:2405.04434; hf]
DEEPSEEK_V2 = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv=128, d_head=128,
    d_ff=12288, vocab=102400,
    attn_type="mla", mla=MLAConfig(kv_lora=512, qk_nope=128, qk_rope=64, v_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2,
                  parallelism="ep"),
    first_dense=1,
    source="arXiv:2405.04434; hf",
)
DEEPSEEK_SMOKE = _replace(
    DEEPSEEK_V2, n_layers=3, d_model=64, n_heads=4, n_kv=4, d_head=16,
    d_ff=128, vocab=256,
    mla=MLAConfig(kv_lora=32, qk_nope=16, qk_rope=8, v_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                  parallelism="ep"),
)

# [dense] granite-34b — llama-arch per assignment, MQA (kv=1), code
# [arXiv:2405.04324; hf]  (GPT-BigCode lineage: GELU MLP, LN, tied, biases)
GRANITE_34B = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv=1, d_head=128,
    d_ff=24576, vocab=49152,
    mlp_type="gelu", norm_type="ln", attn_bias=True, tie_embeddings=True,
    source="arXiv:2405.04324; hf",
)
GRANITE_SMOKE = _replace(
    GRANITE_34B, n_layers=4, d_model=64, n_heads=4, n_kv=1, d_head=16,
    d_ff=128, vocab=256,
)

# [dense] yi-9b — llama-arch GQA  [arXiv:2403.04652; hf]
YI_9B = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv=4, d_head=128,
    d_ff=11008, vocab=64000,
    rope_theta=5e6,
    source="arXiv:2403.04652; hf",
)
YI_SMOKE = _replace(YI_9B, n_layers=4, d_model=64, n_heads=4, n_kv=2,
                    d_head=16, d_ff=128, vocab=256)

# [dense] codeqwen1.5-7b — qwen1.5-arch (MHA kv=32, attn bias)
# [hf:Qwen/CodeQwen1.5-7B; hf]
CODEQWEN_7B = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=32, d_head=128,
    d_ff=13440, vocab=92416,
    attn_bias=True, rope_theta=1e6,
    source="hf:Qwen/CodeQwen1.5-7B; hf",
)
CODEQWEN_SMOKE = _replace(CODEQWEN_7B, n_layers=4, d_model=64, n_heads=4,
                          n_kv=4, d_head=16, d_ff=128, vocab=256)

# [dense] phi3-medium-14b — RoPE SwiGLU GQA  [arXiv:2404.14219; unverified]
PHI3_MEDIUM = ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv=10, d_head=128,
    d_ff=17920, vocab=100352,
    source="arXiv:2404.14219; unverified",
)
PHI3_SMOKE = _replace(PHI3_MEDIUM, n_layers=4, d_model=64, n_heads=4, n_kv=2,
                      d_head=16, d_ff=128, vocab=256)

# [ssm] rwkv6-7b — Finch, data-dependent decay, attention-free
# [arXiv:2404.05892; hf]   (heads = d_model/64)
RWKV6_7B = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv=64, d_head=64,
    d_ff=14336, vocab=65536,
    mixer="rwkv", norm_type="ln",
    sub_quadratic=True,
    source="arXiv:2404.05892; hf",
)
RWKV6_SMOKE = _replace(RWKV6_7B, n_layers=3, d_model=128, n_heads=2, n_kv=2,
                       d_head=64, d_ff=256, vocab=256)

# [audio] whisper-medium — enc-dec, conv frontend stub (precomputed frame
# embeddings)  [arXiv:2212.04356; unverified]; vocab 51865 padded to 51968
WHISPER_MEDIUM = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, enc_layers=24, enc_seq=1500,
    d_model=1024, n_heads=16, n_kv=16, d_head=64,
    d_ff=4096, vocab=51968,
    mlp_type="gelu", norm_type="ln", attn_bias=True, tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
)
WHISPER_SMOKE = _replace(WHISPER_MEDIUM, n_layers=2, enc_layers=2, enc_seq=16,
                         d_model=64, n_heads=4, n_kv=4, d_head=16, d_ff=128,
                         vocab=256)

# [vlm] chameleon-34b — early-fusion, VQ image tokens in the vocab,
# QK-norm  [arXiv:2405.09818; unverified]
CHAMELEON_34B = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv=8, d_head=128,
    d_ff=22016, vocab=65536,
    qk_norm=True,
    source="arXiv:2405.09818; unverified",
)
CHAMELEON_SMOKE = _replace(CHAMELEON_34B, n_layers=4, d_model=64, n_heads=4,
                           n_kv=2, d_head=16, d_ff=128, vocab=256)

# [hybrid] jamba-v0.1-52b — Mamba+attn 1:7 interleave, MoE 16e top-2 every
# other layer  [arXiv:2403.19887; hf]
JAMBA_52B = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_head=128,
    d_ff=14336, vocab=65536,
    mixer="mamba", attn_every=8, attn_offset=4,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, parallelism="ep"),
    moe_every=2, moe_offset=1,
    sub_quadratic=True,
    source="arXiv:2403.19887; hf",
)
JAMBA_SMOKE = _replace(
    JAMBA_52B, n_layers=8, d_model=64, n_heads=4, n_kv=2, d_head=16,
    d_ff=128, vocab=256, attn_every=4, attn_offset=2,
    mamba=MambaConfig(d_state=4, d_conv=4, expand=2, dt_rank=16),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, parallelism="ep"),
)
