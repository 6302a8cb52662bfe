"""Canonizers: pre-transforms of (params, cfg) before the rules attach
(counterpart of ``lxt_tpu/canonizers.py``).

The reference's ``Composite(canonizers=...)`` hook (zennit's canonizer
protocol) mutates a torch module graph before rule registration and undoes
itself afterwards. Here a model is ``(params, cfg, forward)``, so a
canonizer is a function

    canonizer(params, cfg, family) -> params      (or (params, cfg))

applied once at conversion (``from_hf(..., canonizers=[...])`` /
``from_pretrained``) or later by ``AttributionModel.canonize(...)``; it
returns new tensors and mutates nothing.

:func:`fold_norm_scales` folds every RMSNorm elementwise scale into the
linear projections it feeds (zennit's merge-norm family). It is exact in
the forward and under every composite's backward: the norm's gamma multiply
and the folded matmul are the same linear map of the normalized input.
"""

import torch

__all__ = ["apply_canonizers", "fold_norm_scales"]


def apply_canonizers(params, cfg, family, canonizers):
    """Run ``canonizers`` in order; each may return ``params`` or
    ``(params, cfg)``."""
    for canonizer in canonizers:
        out = canonizer(params, cfg, family)
        if isinstance(out, tuple):
            params, cfg = out
        else:
            params = out
    return params, cfg


def _require_fp(w, name):
    if not hasattr(w, "dtype"):        # QuantizedTensor
        raise ValueError(
            f"fold_norm_scales needs full-precision weights, but {name!r} "
            f"is {type(w).__name__}; canonize BEFORE quantize_params")
    return w


def fold_norm_scales(params, cfg, family):
    """Fold RMSNorm scales into the projections they feed (the llama
    family: llama/mistral/qwen2/qwen3/phi3, one parameter layout).

    ln1 -> wq/wk/wv, ln2 -> wg/wu, final_norm -> lm_head; the norm scales
    are reset to ones. Tied embeddings keep final_norm (folding would
    change the shared embedding matrix); Gemma-3's (1 + w) norms are not
    the plain ``normalize(x) * w`` form this folding assumes."""
    if family not in ("llama", "qwen2", "qwen3", "phi3", "mistral"):
        raise ValueError(
            f"fold_norm_scales supports the llama param family, got "
            f"{family!r}")
    layers = dict(params["layers"])
    ln1 = _require_fp(layers["ln1"], "ln1")   # [L, D]
    ln2 = _require_fp(layers["ln2"], "ln2")
    for w_name, g in (("wq", ln1), ("wk", ln1), ("wv", ln1),
                      ("wg", ln2), ("wu", ln2)):
        w = _require_fp(layers[w_name], w_name)       # [L, D, out]
        layers[w_name] = (w * g[:, :, None].to(w.dtype)).to(w.dtype)
    layers["ln1"] = torch.ones_like(ln1)
    layers["ln2"] = torch.ones_like(ln2)
    out = dict(params, layers=layers)
    if "lm_head" in params:
        head = _require_fp(params["lm_head"], "lm_head")  # [D, V]
        g = _require_fp(params["final_norm"], "final_norm")
        out["lm_head"] = (head * g[:, None].to(head.dtype)).to(head.dtype)
        out["final_norm"] = torch.ones_like(g)
    return out
