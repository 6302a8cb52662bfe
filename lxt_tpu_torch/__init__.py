"""lxt_tpu_torch — AttnLRP attribution for transformers in PyTorch, with
hand-written Hopper (sm_90a) kernels: Llama-family (Llama 2/3, TinyLlama,
Qwen 2/3, Mistral, Phi-3), Gemma 3 text, GPT-2, Mixtral and BERT models,
KV-cached decoding of the causal ones (``AttributionModel.generate``, then
``attribute_response`` explains each generated token), the vision towers
(torchvision ViT, OpenCLIP, SigLIP: pixel heatmaps) and Gemma 3 image +
text (joint token and pixel relevance).

The port of ``lxt_tpu`` (JAX on a TPU), which stays in this repository as
the reference each ported part is tested against. Every LRP rule is an
autograd Function or a stop-gradient inside the model forward, so
``relevance = x * grad`` is one backward pass. Attention and nf4
dequantization on CUDA tensors run the kernels in ``csrc/`` (built with
nvcc at first use); on CPU tensors they run their plain PyTorch versions.

``from_pretrained``, ``from_hf``, ``from_torchvision``, ``from_openclip``,
``from_siglip``, ``VisionAttributionModel``, ``MultimodalAttributionModel``,
``load_checkpoint_params``,
``quantize_params``,
``QuantizedTensor``, ``flash_attention_lse``, the sequence-parallel ring
(``ring_flash_attention``, ``attribute_sequence_parallel``), the
multi-target and latent attribution functions, the faithfulness
evaluation, the gradient baselines, the canonizers, the batched pipeline
(``AttributionPipeline``), the server (``AttributionServer``,
``http_server``; ``python -m lxt_tpu_torch.serve``), the rule audit
(``audit``, ``AuditEntry``, ``UnruledOpError``) and the conservation check
(``conservation_check``, ``conservation_error``) are imported on first
access. The explicit path (relevance as the cotangent itself) is
``lxt_tpu_torch.explicit``, ``ops.functional`` and the
``models.{llama,gpt2,bert}_explicit`` forwards.
"""

import importlib

__version__ = "0.1.0"

from lxt_tpu_torch.attribution import input_relevance, select_logit
from lxt_tpu_torch.composites import Composite, attnlrp, cp_lrp, vanilla_gradient

_LAZY = {
    **dict.fromkeys(("from_pretrained", "from_hf", "from_torchvision",
                     "from_openclip", "from_siglip", "VisionAttributionModel",
                     "MultimodalAttributionModel"),
                    "lxt_tpu_torch.models.registry"),
    "load_checkpoint_params": "lxt_tpu_torch.io",
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
    "AttributionPipeline": "lxt_tpu_torch.pipeline",
    **dict.fromkeys(("audit", "AuditEntry", "UnruledOpError"),
                    "lxt_tpu_torch.rule_audit"),
    **dict.fromkeys(("conservation_check", "conservation_error"),
                    "lxt_tpu_torch.ops.check"),
    **dict.fromkeys(("AttributionServer", "http_server"), "lxt_tpu_torch.serve"),
}

__all__ = [
    "Composite", "attnlrp", "cp_lrp", "vanilla_gradient",
    "input_relevance", "select_logit", "__version__", *_LAZY,
]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'lxt_tpu_torch' has no attribute {name!r}")
