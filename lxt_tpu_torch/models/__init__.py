"""Model zoo: LRP-aware transformers + HF weight conversion (the ported
families of ``lxt_tpu.models``: Llama 2/3 / TinyLlama, Qwen 2/3, Mistral,
Phi-3, Gemma 3 text, GPT-2 and Mixtral).

The family modules and the registry's ``SUPPORTED_FAMILIES``,
``AttributionModel``, ``detect_family`` and ``from_hf`` are imported on
first access (``from lxt_tpu_torch.models import mixtral`` or
``lxt_tpu_torch.models.AttributionModel``): ``ops.attention`` imports
``models.common`` while the package is being imported.
"""

import importlib

_MODULES = ("common", "gemma3", "gpt2", "llama", "mixtral")
_REGISTRY = ("SUPPORTED_FAMILIES", "AttributionModel", "detect_family", "from_hf")

__all__ = [*_MODULES, *_REGISTRY]


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f"lxt_tpu_torch.models.{name}")
    if name in _REGISTRY:
        return getattr(importlib.import_module("lxt_tpu_torch.models.registry"), name)
    raise AttributeError(f"module 'lxt_tpu_torch.models' has no attribute {name!r}")
