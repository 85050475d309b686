"""Config registry (port of ``repro.configs``): one module per assigned
architecture, field for field the reference's own."""
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeCard,
                                      shape_applicable)

_ARCH_MODULES = {
    "whisper-small": "whisper_small",
    "qwen2-1.5b": "qwen2_1_5b",
    "gemma-2b": "gemma_2b",
    "qwen2-7b": "qwen2_7b",
    "qwen1.5-4b": "qwen1_5_4b",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-370m": "mamba2_370m",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    import importlib

    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


__all__ = ["ARCH_NAMES", "SHAPES", "ModelConfig", "ShapeCard", "get_config",
           "shape_applicable"]
