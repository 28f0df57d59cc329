"""Architecture registry: ``get_config(arch_id)`` for every assigned
architecture (+ the paper-demo MLP used by examples/tests)."""
from .base import ModelConfig, ShapeConfig, SHAPES, supported_shapes  # noqa: F401

_MODULES = {
    "qwen1.5-110b": "qwen1_5_110b",
    "granite-34b": "granite_34b",
    "deepseek-7b": "deepseek_7b",
    "minicpm-2b": "minicpm_2b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mixtral-8x22b": "mixtral_8x22b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "xlstm-350m": "xlstm_350m",
    "whisper-medium": "whisper_medium",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
}

ARCHS = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    import importlib

    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {ARCHS}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.config()
