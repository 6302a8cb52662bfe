"""One-call user surface: HF checkpoint or model of a Llama-family,
Gemma-3 text, Mixtral or GPT-2 model -> :class:`AttributionModel`
(counterpart of ``lxt_tpu/models/registry.py``, for the families the port
has).

    import lxt_tpu_torch
    model = lxt_tpu_torch.from_pretrained("/path/to/llama-dir",
                                          quantize_bits="nf4", device="cuda")
    value, relevance = model.attribute(input_ids)

``from_pretrained`` reads ``config.json`` with :mod:`json` and the weights
with the numpy safetensors reader (:mod:`lxt_tpu_torch.io`): it needs
neither ``transformers`` nor ``safetensors``. bitsandbytes-serialized
4-bit and 8-bit checkpoints are ingested on the host and re-quantized in
kind.
"""

import dataclasses
import json
import types
import warnings
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from lxt_tpu_torch import composites
from lxt_tpu_torch.attribution import (_pick, input_relevance,
                                       latent_relevance, multi_token_relevance,
                                       select_logit, topk_relevance)
from lxt_tpu_torch.models import gemma3, gpt2, llama, mixtral
from lxt_tpu_torch.ops.quant import QuantizedTensor

_LLAMA = {"config": llama.LlamaConfig, "from_hf": llama.params_from_hf,
          "forward": llama.forward,
          "embed": lambda params, ids, cfg: llama.embed(params, ids)}
_GEMMA3 = {"config": gemma3.Gemma3Config, "from_hf": gemma3.params_from_hf,
           "forward": gemma3.forward, "embed": gemma3.embed}
#: the families the port has a model for: family -> config class, HF
#: converter, forward and embedding (``embed(params, ids, cfg)``)
FAMILIES = {"llama": _LLAMA, "qwen2": _LLAMA, "qwen3": _LLAMA,
            "mistral": _LLAMA, "phi3": _LLAMA, "gemma3": _GEMMA3,
            "gemma3_text": _GEMMA3,
            "gpt2": {"config": gpt2.GPT2Config, "from_hf": gpt2.params_from_hf,
                     "forward": gpt2.forward,
                     "embed": lambda params, ids, cfg: gpt2.embed(params, ids)[0]},
            "mixtral": {"config": mixtral.MixtralConfig,
                        "from_hf": mixtral.params_from_hf,
                        "forward": mixtral.forward,
                        "embed": lambda params, ids, cfg: mixtral.embed(params, ids)}}
SUPPORTED_FAMILIES = tuple(FAMILIES)

_QWEN = dict(vocab_size=151936, hidden_size=4096, intermediate_size=22016,
             num_hidden_layers=32, num_attention_heads=32,
             num_key_value_heads=32, rope_theta=10000.0, rms_norm_eps=1e-6,
             tie_word_embeddings=False, rope_scaling=None,
             use_sliding_window=False, sliding_window=4096,
             max_position_embeddings=32768, hidden_act="silu")

#: transformers' defaults, per ``model_type``, for every key that
#: ``LlamaConfig.from_hf`` reads (and ``hidden_act``): what ``AutoConfig``
#: gives for a key that ``config.json`` leaves out
_HF_DEFAULTS = {
    "llama": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                  num_hidden_layers=32, num_attention_heads=32,
                  num_key_value_heads=None, head_dim=None, rope_theta=10000.0,
                  rms_norm_eps=1e-6, tie_word_embeddings=False,
                  rope_scaling=None, max_position_embeddings=2048,
                  hidden_act="silu"),
    "qwen2": _QWEN,
    "qwen3": dict(_QWEN, head_dim=128),
    "mistral": dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    head_dim=None, rope_theta=10000.0, rms_norm_eps=1e-6,
                    tie_word_embeddings=False, sliding_window=4096,
                    max_position_embeddings=131072, hidden_act="silu"),
    "phi3": dict(vocab_size=32064, hidden_size=3072, intermediate_size=8192,
                 num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=None, rope_theta=10000.0,
                 rms_norm_eps=1e-5, tie_word_embeddings=False,
                 rope_scaling=None, sliding_window=None,
                 max_position_embeddings=4096,
                 original_max_position_embeddings=4096, hidden_act="silu"),
    "gemma3_text": dict(vocab_size=262208, hidden_size=2304,
                        intermediate_size=9216, num_hidden_layers=26,
                        num_attention_heads=8, num_key_value_heads=4,
                        head_dim=256, hidden_activation="gelu_pytorch_tanh",
                        rms_norm_eps=1e-6,
                        tie_word_embeddings=True, rope_theta=1e6,
                        query_pre_attn_scalar=256, sliding_window=4096,
                        layer_types=None, rope_scaling=None,
                        rope_local_base_freq=10000.0),
    "mixtral": dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    rope_theta=1e6, rms_norm_eps=1e-5,
                    tie_word_embeddings=False, num_local_experts=8,
                    num_experts_per_tok=2, sliding_window=None,
                    hidden_act="silu"),
    "gpt2": dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
                 n_head=12, layer_norm_epsilon=1e-5,
                 activation_function="gelu_new",
                 scale_attn_by_inverse_layer_idx=False,
                 reorder_and_upcast_attn=False, tie_word_embeddings=True),
}


def read_hf_config(model_dir):
    """``config.json`` of a checkpoint directory as an attribute namespace,
    with the keys it leaves out filled as transformers' config class for
    its ``model_type`` fills them (a ``model_type`` outside the table is
    taken as written). A ``gemma3`` (image + text) config keeps its
    ``text_config``, filled the same way, as a nested namespace."""
    return _filled(json.loads((Path(model_dir) / "config.json").read_text()))


def _filled(raw):
    mt = raw.get("model_type")
    if mt == "gemma3":
        text = dict(raw.get("text_config") or {}, model_type="gemma3_text")
        return types.SimpleNamespace(**dict(raw, text_config=_filled(text)))
    if mt not in _HF_DEFAULTS:
        return types.SimpleNamespace(**raw)
    cfg = dict(_HF_DEFAULTS[mt])
    cfg.update(raw)
    if "num_key_value_heads" in cfg and cfg["num_key_value_heads"] is None:
        cfg["num_key_value_heads"] = cfg["num_attention_heads"]
    if mt == "llama" and cfg["head_dim"] is None:
        cfg["head_dim"] = cfg["hidden_size"] // cfg["num_attention_heads"]
    if mt in ("qwen2", "qwen3") and not cfg["use_sliding_window"]:
        cfg["sliding_window"] = None
    rs = cfg.get("rope_scaling")
    if mt == "phi3" and rs and rs.get("type") in ("su", "yarn"):
        cfg["rope_scaling"] = dict(rs, type="longrope")
    if mt == "gemma3_text" and cfg["layer_types"] is None:
        # configs on the Hub may carry only the older integer pattern
        pattern = cfg.get("sliding_window_pattern", 6)
        cfg["layer_types"] = [
            "sliding_attention" if (i + 1) % pattern else "full_attention"
            for i in range(cfg["num_hidden_layers"])]
    return types.SimpleNamespace(**cfg)


def _tensor(x, device):
    """``x`` (a tensor on any device, an array or a list) as a tensor on
    ``device``."""
    return (x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))).to(device)


def _padding_args(kv_begin, attention_mask, kv_end, device):
    """Validated padding keywords for a batch of left-padded prompts:
    ``kv_begin [B]`` (each row's first real index; the flash kernels stay
    eligible) or an arbitrary ``attention_mask [B, T]`` (an additive bias).
    ``kv_end`` is the right-padded (BERT) convention, which no ported
    family takes."""
    if kv_end is not None:
        raise ValueError(
            "kv_end is the BERT (right-padded) convention; causal families "
            "take kv_begin=[first real index per row] or attention_mask")
    kw = {}
    if kv_begin is not None:
        kw["kv_begin"] = _tensor(kv_begin, device).to(torch.int32)
    if attention_mask is not None:
        if kw:
            raise ValueError("pass attention_mask OR kv_begin, not both")
        kw["attention_mask"] = _tensor(attention_mask, device)
    return kw


@dataclasses.dataclass
class AttributionModel:
    """A converted model of one of :data:`FAMILIES` plus its attribution
    entry points. PyTorch runs eagerly, so there is no program cache and no
    ``jit=``; ``check=`` waits for the port of ``ops/check.py``.

    ``remat`` is the family forward's keyword, which every entry point
    passes: True (the default) recomputes each layer in the backward, and
    with it in every pull of the multi-target methods; False keeps each
    layer's activations instead (the main path's setting, where they fit)."""

    family: str
    cfg: Any
    params: Any
    composite: composites.Composite
    remat: bool = True

    @property
    def device(self):
        """The parameters' device: that of the first leaf, whatever the
        family names its embedding."""
        leaf = self.params
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        return leaf.q.device if isinstance(leaf, QuantizedTensor) else leaf.device

    def embed(self, input_ids):
        ids = _tensor(input_ids, self.device)
        return FAMILIES[self.family]["embed"](self.params, ids.long(), self.cfg)

    def _forward(self, composite=None, kv_begin=None, attention_mask=None,
                 kv_end=None, **kw):
        """``run(embeds, **more) -> ModelOutputs``: the family forward under
        ``composite`` (default: the model's) with this model's weights and
        ``remat``, the validated padding keywords and ``kw``."""
        forward = FAMILIES[self.family]["forward"]
        params, cfg = self.params, self.cfg
        composite = composites.resolve(composite or self.composite)
        kw.update(_padding_args(kv_begin, attention_mask, kv_end, self.device),
                  remat=self.remat)
        return lambda e, **more: forward(params, cfg, e, composite, **kw, **more)

    def canonize(self, *canonizers):
        """A copy with ``canonizers`` applied to (params, cfg): the
        reference's ``Composite(canonizers=...)`` hook as a pure
        pre-transform (see :mod:`lxt_tpu_torch.canonizers`)."""
        from lxt_tpu_torch.canonizers import apply_canonizers
        params, cfg = apply_canonizers(self.params, self.cfg, self.family,
                                       canonizers)
        return dataclasses.replace(self, params=params, cfg=cfg)

    def logits(self, input_ids, composite=None):
        run = self._forward(composite)
        with torch.no_grad():
            return run(self.embed(input_ids)).logits

    def attribute(self, input_ids, *, target: Optional[Callable] = None,
                  position: int = -1, token=None, composite=None,
                  kv_begin=None, attention_mask=None, kv_end=None):
        """Per-token input relevance, one forward and one backward.

        Default target: the argmax logit at ``position`` (only that row's
        logits are computed), or the ``token [B]`` ids there; ``target``
        maps the full ``[B, T, V]`` logits to a scalar instead. Returns
        ``(target_value, relevance [B, T])``. ``kv_begin`` /
        ``attention_mask`` mark left padding (see :func:`_padding_args`)."""
        run = self._forward(composite, kv_begin, attention_mask, kv_end)
        tok = None if token is None else _tensor(token, self.device)

        def tgt(e):
            if target is not None:
                return target(run(e).logits)
            return select_logit(run(e, logits_at=position).logits,
                                position=-1, token=tok)

        return input_relevance(tgt, self.embed(input_ids))

    def attribute_latent(self, input_ids, *, target: Optional[Callable] = None,
                         position: int = -1, composite=None):
        """Input relevance and per-layer latent relevance in ONE backward
        (reference docs/latent-feature-attribution-efficient.rst). Returns
        ``(value, input_rel [B, T], latent_rel [L, B, T, D])``; the default
        target computes only the row at ``position``."""
        run = self._forward(composite, output_hidden_states=True)
        embeds = self.embed(input_ids)

        def forward_with_probes(e, probes):
            if target is not None:
                out = run(e, probes=probes)
                return target(out.logits), out.hidden_states
            out = run(e, probes=probes, logits_at=position)
            return select_logit(out.logits, position=-1), out.hidden_states

        return latent_relevance(forward_with_probes, embeds,
                                (self.cfg.num_layers, *embeds.shape))

    def attribute_multi(self, input_ids, tokens, *, position: int = -1,
                        composite=None, kv_begin=None, attention_mask=None,
                        kv_end=None, via: str = "scan"):
        """K relevance maps for K candidate tokens sharing ONE forward
        (:func:`lxt_tpu_torch.attribution.multi_token_relevance`).

        ``tokens``: ``[K]`` (the same candidates for every batch row) or
        ``[K, B]`` int ids. Returns ``(values [K, B], relevance [K, B, T])``.
        Padding as in :meth:`attribute`."""
        run = self._forward(composite, kv_begin, attention_mask, kv_end)
        return multi_token_relevance(
            lambda e: run(e, logits_at=position).logits,
            self.embed(input_ids), _tensor(tokens, self.device), via=via)

    def attribute_topk(self, input_ids, k: int = 5, *, position: int = -1,
                       composite=None, kv_begin=None, attention_mask=None,
                       kv_end=None, via: str = "scan"):
        """Explain the model's own top-k candidates at ``position`` in one
        forward: ``(tokens [K, B], values [K, B], relevance [K, B, T])``.
        Padding as in :meth:`attribute`."""
        run = self._forward(composite, kv_begin, attention_mask, kv_end)
        return topk_relevance(lambda e: run(e, logits_at=position).logits,
                              self.embed(input_ids), k, via=via)

    def faithfulness(self, input_ids, *, steps: int = 10, position: int = -1,
                     token=None, composite=None, kv_begin=None,
                     attention_mask=None, kv_end=None, baseline="zero",
                     generator=None):
        """A faithfulness report for this model's own attribution.

        The relevance map is :meth:`attribute`'s, its token pinned to the
        unperturbed argmax (under the same padding) so every perturbation
        step scores the same target; MoRF / LeRF / random perturbation
        curves then evaluate it. Returns the
        :func:`lxt_tpu_torch.utils.faithfulness.faithfulness_report` dict.
        ``attention_mask`` doubles as the curves' ``valid_mask``, so padding
        is never ablated. One forward and backward, then 3 × (steps + 1)
        forwards without a graph. ``generator`` (a ``torch.Generator`` on
        the model's device) draws the random order; by default a fixed seed
        keeps the control reproducible."""
        from lxt_tpu_torch.utils.faithfulness import faithfulness_report

        run = self._forward(composite, kv_begin, attention_mask, kv_end)
        embeds = self.embed(input_ids)
        valid = (None if attention_mask is None
                 else _tensor(attention_mask, self.device).bool())
        if baseline is not None and not isinstance(baseline, str):
            baseline = _tensor(baseline, self.device)
        pinned = {"token": None if token is None
                  else _tensor(token, self.device).reshape(-1)}

        def rows(e):                          # [B, vocab] at the position
            return run(e, logits_at=position).logits[:, -1, :]

        def target(e):
            row = rows(e)
            if pinned["token"] is None:
                pinned["token"] = row.detach().argmax(-1)
            return _pick(row, pinned["token"]).sum()

        _, rel = input_relevance(target, embeds)
        return faithfulness_report(
            lambda e: _pick(rows(e), pinned["token"]), embeds, rel,
            steps=steps, baseline=baseline, valid_mask=valid,
            generator=generator)


def _llama_structural_match(hf_config, state_dict) -> bool:
    """True when an out-of-registry architecture is computationally Llama:
    the Llama config attributes with a SiLU gated MLP, and exactly the Llama
    parameter naming (a clone with extra layer-0 computation weights, which
    the converter would drop, does not match)."""
    needed_cfg = ("vocab_size", "hidden_size", "intermediate_size",
                  "num_hidden_layers", "num_attention_heads", "rms_norm_eps")
    if not all(hasattr(hf_config, a) for a in needed_cfg):
        return False
    act = getattr(hf_config, "hidden_act",
                  getattr(hf_config, "hidden_activation", None))
    if act not in ("silu", "swish") or state_dict is None:
        return False
    needed_keys = ("model.layers.0.self_attn.q_proj.weight",
                   "model.layers.0.self_attn.o_proj.weight",
                   "model.layers.0.mlp.gate_proj.weight",
                   "model.layers.0.mlp.up_proj.weight",
                   "model.layers.0.mlp.down_proj.weight",
                   "model.layers.0.input_layernorm.weight",
                   "model.layers.0.post_attention_layernorm.weight",
                   "model.embed_tokens.weight", "model.norm.weight")
    if not all(k in state_dict for k in needed_keys):
        return False
    allowed = {"self_attn.q_proj.weight", "self_attn.k_proj.weight",
               "self_attn.v_proj.weight", "self_attn.o_proj.weight",
               "mlp.gate_proj.weight", "mlp.up_proj.weight",
               "mlp.down_proj.weight",
               # non-computation buffer older HF versions serialize
               "self_attn.rotary_emb.inv_freq"}
    prefix = "model.layers.0."
    return all(k[len(prefix):] in allowed for k in state_dict
               if k.startswith(prefix + "self_attn.")
               or k.startswith(prefix + "mlp."))


def detect_family(hf_config, state_dict=None) -> str:
    mt = getattr(hf_config, "model_type", None)
    if mt in SUPPORTED_FAMILIES:
        return mt
    if _llama_structural_match(hf_config, state_dict):
        warnings.warn(
            f"model_type {mt!r} is not registered, but its config and "
            f"parameter naming match the Llama family exactly — converting "
            f"as 'llama'. Pass family='llama' to silence this, or a "
            f"different family to override.")
        return "llama"
    raise ValueError(
        f"{mt!r} not yet supported by lxt_tpu_torch. Supported models are: "
        f"{', '.join(SUPPORTED_FAMILIES)}. If the architecture matches one "
        f"of these computationally, pass family='<name>' to force it.")


def _text_model(state_dict, hf_config):
    """A ``gemma3`` (image + text) config and state dict -> its language
    model's (``text_config``, ``model.language_model.*`` weights renamed
    to ``model.*``). A checkpoint that holds vision weights is refused: the
    port has no SigLIP tower yet, and dropping it would explain a different
    model."""
    vision = [k for k in state_dict if k.startswith(
        ("model.vision_tower.", "model.multi_modal_projector.",
         "vision_tower.", "multi_modal_projector."))]
    if vision:
        raise ValueError(
            f"this gemma3 checkpoint holds vision weights ({vision[0]}, ...): "
            f"the image + text model is not ported to lxt_tpu_torch yet "
            f"(it needs the SigLIP tower); save the language model alone "
            f"(Gemma3ForCausalLM) to attribute its text")
    prefix = "model.language_model."
    if any(k.startswith(prefix) for k in state_dict):
        text = {"model." + k[len(prefix):]: v for k, v in state_dict.items()
                if k.startswith(prefix)}
        if "lm_head.weight" in state_dict:
            text["lm_head.weight"] = state_dict["lm_head.weight"]
        state_dict = text
    return state_dict, hf_config.text_config


def _convert(state_dict, hf_config, composite, dtype, device, family=None):
    """state dict (torch tensors or numpy arrays) -> AttributionModel."""
    if (getattr(hf_config, "model_type", None) == "gemma3"
            and hasattr(hf_config, "text_config")):
        state_dict, hf_config = _text_model(state_dict, hf_config)
    if family is not None:
        if family not in SUPPORTED_FAMILIES:
            raise ValueError(f"family={family!r} is not one of: "
                             f"{', '.join(SUPPORTED_FAMILIES)}")
    else:
        family = detect_family(hf_config, state_dict)
    table = FAMILIES[family]
    cfg = table["config"].from_hf(hf_config)
    params = table["from_hf"](state_dict, cfg, dtype=dtype or torch.float32,
                              device=device)
    if composite is None:
        composite = composites.cp_lrp if family == "gpt2" else composites.attnlrp
    composite = composites.resolve(composite)
    return AttributionModel(family=family, cfg=cfg, params=params,
                            composite=composite)


def from_hf(hf_model, composite: composites.Composite = None, dtype=None,
            family: str = None, device="cuda", canonizers=None):
    """Convert a loaded HF torch model of one of :data:`SUPPORTED_FAMILIES`
    (``.config`` and ``.state_dict()``) into an :class:`AttributionModel` on
    ``device``.
    ``family`` forces a family for an out-of-registry ``model_type`` that
    is computationally one of :data:`SUPPORTED_FAMILIES`; exact Llama clones
    are detected. The composite defaults to AttnLRP (CP-LRP for GPT-2, as
    the reference recommends). ``canonizers``: an
    optional list of ``(params, cfg, family)`` pre-transforms applied to the
    converted model (:meth:`AttributionModel.canonize`)."""
    if not hasattr(hf_model, "config"):
        raise ValueError("from_hf takes an HF model with a .config; the "
                         "vision layouts are not ported to lxt_tpu_torch yet")
    model = _convert(hf_model.state_dict(), hf_model.config, composite, dtype,
                     device, family)
    return model.canonize(*canonizers) if canonizers else model


def from_pretrained(model_dir, composite: composites.Composite = None,
                    dtype=None, quantize_bits=None, family: str = None,
                    device="cuda", canonizers=None):
    """Load an :class:`AttributionModel` straight from an HF checkpoint
    directory onto ``device``; no torch model is instantiated.

    ``quantize_bits`` (8, 4 or "nf4") quantizes the family's projections
    after conversion. bitsandbytes-serialized checkpoints (keys ending in
    ``.quant_state.bitsandbytes__*`` for 4-bit, ``.SCB`` for 8-bit) are
    dequantized on the host and, unless ``quantize_bits`` says otherwise,
    re-quantized in kind ("nf4" / 8), which reproduces their values
    exactly. ``canonizers`` as in :func:`from_hf`, applied before the
    quantization (they transform full-precision weights)."""
    from lxt_tpu_torch.io import load_checkpoint_state_dict
    from lxt_tpu_torch.ops.quant import ingest_bnb_state_dict, quantize_params

    hf_config = read_hf_config(model_dir)
    state = load_checkpoint_state_dict(model_dir)
    had_8bit = any(k.endswith(".SCB") for k in state)
    if ingest_bnb_state_dict(state) and quantize_bits is None:
        quantize_bits = 8 if had_8bit else "nf4"
    model = _convert(state, hf_config, composite, dtype, device, family)
    if canonizers:
        model = model.canonize(*canonizers)
    if quantize_bits:
        model.params = quantize_params(model.params, bits=quantize_bits,
                                       family=model.family)
    return model
