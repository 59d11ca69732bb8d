"""``--arch <id>`` resolution (the JAX package's ``configs/registry.py``
without its dry-run helpers)."""

from __future__ import annotations

from repro_torch.configs import lm_archs as A
from repro_torch.configs.lm_archs import ModelConfig

CONFIGS = {
    "mixtral-8x22b": A.MIXTRAL_8X22B,
    "deepseek-v2-236b": A.DEEPSEEK_V2,
    "granite-34b": A.GRANITE_34B,
    "yi-9b": A.YI_9B,
    "codeqwen1.5-7b": A.CODEQWEN_7B,
    "phi3-medium-14b": A.PHI3_MEDIUM,
    "rwkv6-7b": A.RWKV6_7B,
    "whisper-medium": A.WHISPER_MEDIUM,
    "chameleon-34b": A.CHAMELEON_34B,
    "jamba-v0.1-52b": A.JAMBA_52B,
}

SMOKE_CONFIGS = {
    "mixtral-8x22b": A.MIXTRAL_SMOKE,
    "deepseek-v2-236b": A.DEEPSEEK_SMOKE,
    "granite-34b": A.GRANITE_SMOKE,
    "yi-9b": A.YI_SMOKE,
    "codeqwen1.5-7b": A.CODEQWEN_SMOKE,
    "phi3-medium-14b": A.PHI3_SMOKE,
    "rwkv6-7b": A.RWKV6_SMOKE,
    "whisper-medium": A.WHISPER_SMOKE,
    "chameleon-34b": A.CHAMELEON_SMOKE,
    "jamba-v0.1-52b": A.JAMBA_SMOKE,
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    table = SMOKE_CONFIGS if smoke else CONFIGS
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(table)}")
    return table[arch]


def list_archs():
    return sorted(CONFIGS)
