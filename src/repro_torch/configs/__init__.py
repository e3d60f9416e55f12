"""Architecture registry — one module per assigned architecture (port of
`repro/configs/`: the same ten configs as plain dataclasses)."""

import importlib

_ARCH_MODULES = [
    "jamba_1_5_large_398b",
    "internvl2_76b",
    "mistral_large_123b",
    "yi_9b",
    "qwen2_72b",
    "codeqwen1_5_7b",
    "musicgen_medium",
    "xlstm_350m",
    "llama4_scout_17b_a16e",
    "qwen2_moe_a2_7b",
]

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _loaded = True


from repro_torch.configs.base import ModelConfig, MoEConfig, get_config, list_archs  # noqa: E402,F401
