"""lxt_tpu_torch — AttnLRP attribution for transformers in PyTorch, with
hand-written Hopper (sm_90a) kernels: Llama-family (Llama 2/3, TinyLlama,
Qwen 2/3, Mistral, Phi-3), Gemma 3 text, GPT-2 and Mixtral models.

The port of ``lxt_tpu`` (JAX on a TPU), which stays in this repository as
the reference each ported part is tested against. Every LRP rule is an
autograd Function or a stop-gradient inside the model forward, so
``relevance = x * grad`` is one backward pass. Attention and nf4
dequantization on CUDA tensors run the kernels in ``csrc/`` (built with
nvcc at first use); on CPU tensors they run their plain PyTorch versions.

``from_pretrained``, ``from_hf``, ``quantize_params``,
``QuantizedTensor``, ``flash_attention_lse``, the sequence-parallel ring
(``ring_flash_attention``, ``attribute_sequence_parallel``), the
multi-target and latent attribution functions, the faithfulness
evaluation, the gradient baselines and the canonizers are imported on
first access.
"""

import importlib

__version__ = "0.1.0"

from lxt_tpu_torch.attribution import input_relevance, select_logit
from lxt_tpu_torch.composites import Composite, attnlrp, cp_lrp, vanilla_gradient

_LAZY = {
    "from_pretrained": "lxt_tpu_torch.models.registry",
    "from_hf": "lxt_tpu_torch.models.registry",
    "quantize_params": "lxt_tpu_torch.ops.quant",
    "QuantizedTensor": "lxt_tpu_torch.ops.quant",
    "flash_attention_lse": "lxt_tpu_torch.ops.flash_attention",
    "ring_flash_attention": "lxt_tpu_torch.parallel.ring",
    "attribute_sequence_parallel": "lxt_tpu_torch.parallel.ring",
    **dict.fromkeys(
        ("latent_relevance", "contrastive_target", "normalize_relevance",
         "multi_token_relevance", "topk_relevance", "multi_site_relevance",
         "multi_site_latent_relevance"), "lxt_tpu_torch.attribution"),
    **dict.fromkeys(("perturbation_curve", "faithfulness_report",
                     "aopc_scores"), "lxt_tpu_torch.utils.faithfulness"),
    **dict.fromkeys(("integrated_gradients", "smoothgrad", "gradient_x_input"),
                    "lxt_tpu_torch.baselines"),
    **dict.fromkeys(("apply_canonizers", "fold_norm_scales"),
                    "lxt_tpu_torch.canonizers"),
}

__all__ = [
    "Composite", "attnlrp", "cp_lrp", "vanilla_gradient",
    "input_relevance", "select_logit", "__version__", *_LAZY,
]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'lxt_tpu_torch' has no attribute {name!r}")
