"""Model zoo: LRP-aware transformers + HF weight conversion (the ported
families of ``lxt_tpu.models``: Llama 2/3 / TinyLlama, Qwen 2/3, Mistral,
Phi-3, Gemma 3 (text, and image + text), GPT-2, Mixtral, BERT, the ViT /
OpenCLIP and SigLIP vision towers), ``decode``, the KV-cached prefill
and decode steps of the causal families, and the explicit-path forwards
``llama_explicit``, ``gpt2_explicit`` and ``bert_explicit``.

The family modules and the registry's ``SUPPORTED_FAMILIES``,
``AttributionModel``, ``detect_family`` and ``from_hf`` are imported on
first access (``from lxt_tpu_torch.models import mixtral`` or
``lxt_tpu_torch.models.AttributionModel``): ``ops.attention`` imports
``models.common`` while the package is being imported.
"""

import importlib

_MODULES = ("bert", "bert_explicit", "common", "decode", "gemma3", "gpt2",
            "gpt2_explicit", "llama", "llama_explicit", "mixtral", "siglip",
            "vit")
_REGISTRY = ("SUPPORTED_FAMILIES", "AttributionModel", "detect_family", "from_hf")

__all__ = [*_MODULES, *_REGISTRY]


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f"lxt_tpu_torch.models.{name}")
    if name in _REGISTRY:
        return getattr(importlib.import_module("lxt_tpu_torch.models.registry"), name)
    raise AttributeError(f"module 'lxt_tpu_torch.models' has no attribute {name!r}")
