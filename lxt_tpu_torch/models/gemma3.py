"""Gemma 3 (text) with LRP-aware forward — the counterpart of the text half
of ``lxt_tpu/models/gemma3.py``.

Gemma-3 specifics (HF ``modeling_gemma3``):
- embeddings scaled by sqrt(hidden_size), the scale rounded to the
  embedding dtype first;
- RMSNorm in float32 throughout, multiplied by ``(1 + weight)`` in float32
  before the cast (identity rule: stop-grad rsqrt);
- per-head q/k RMSNorm, attention scale ``query_pre_attn_scalar ** -0.5``;
- sandwich norms: the post-attention and post-feedforward norms apply to
  each block's output before the residual add;
- local layers (sliding window, ``rope_local_base_freq``) and global layers
  (no window, ``rope_theta`` with linear rope scaling), chosen per layer by
  ``layer_types``. The layer loop is Python, so each layer passes its own
  window and tables to the attention (in-kernel rope on the flash path).

The multimodal half (``Gemma3ForConditionalGeneration``): the SigLIP tower
(``models/siglip.py``) encodes the pixels, :func:`project_image_features`
pools and projects them into the text embedding space, and
:func:`merge_image_embeds` scatters them over the image placeholder
tokens; :func:`multimodal_forward` runs the text model on the merge. The
attention is causal everywhere, as in ``lxt_tpu`` (HF lets image tokens
attend to each other when the processor passes ``token_type_ids``;
ROADMAP F9).
"""

import dataclasses
from typing import Any, Tuple

import torch

from lxt_tpu_torch import composites
from lxt_tpu_torch.models import common
from lxt_tpu_torch.models.common import ACTIVATIONS, ModelOutputs
from lxt_tpu_torch.ops import tensor_parallel
from lxt_tpu_torch.ops.attention import attention
from lxt_tpu_torch.ops.rules import stop_gradient


@dataclasses.dataclass(frozen=True)
class Gemma3Config:
    vocab_size: int = 262144
    hidden_size: int = 2560
    intermediate_size: int = 10240
    num_layers: int = 34
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 256
    rope_theta: float = 1_000_000.0
    rope_local_theta: float = 10_000.0
    rope_global_scaling: float = 1.0   # linear rope_scaling factor (e.g. 8.0)
    rms_eps: float = 1e-6
    act: str = "gelu"                  # gelu_pytorch_tanh
    query_pre_attn_scalar: float = 256.0
    sliding_window: int = 1024
    layer_types: Tuple[str, ...] = ()  # 'sliding_attention' | 'full_attention'
    tie_embeddings: bool = True

    @classmethod
    def from_hf(cls, hf_config):
        """Build from a transformers ``Gemma3TextConfig`` (or a namespace
        with its attributes)."""
        rs = getattr(hf_config, "rope_scaling", None) or {}
        linear = rs.get("rope_type", rs.get("type")) == "linear"
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            intermediate_size=hf_config.intermediate_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            num_kv_heads=hf_config.num_key_value_heads,
            head_dim=hf_config.head_dim,
            rope_theta=hf_config.rope_theta,
            rope_local_theta=getattr(hf_config, "rope_local_base_freq", 10_000.0),
            rope_global_scaling=float(rs.get("factor", 1.0)) if linear else 1.0,
            rms_eps=hf_config.rms_norm_eps,
            query_pre_attn_scalar=hf_config.query_pre_attn_scalar,
            sliding_window=hf_config.sliding_window,
            layer_types=tuple(getattr(hf_config, "layer_types", None) or ()),
            tie_embeddings=getattr(hf_config, "tie_word_embeddings", True),
        )


def gemma_rms_norm(x, weight, eps, composite):
    """Gemma RMSNorm: float32 throughout, the ``(1 + w)`` multiplier applied
    before the cast; identity rule via stop-grad rsqrt. (Not
    ``Composite.rms_norm(offset=1)``, which multiplies in x's dtype.)"""
    x32 = x.float()
    rs = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    if composite.norm == "identity":
        rs = stop_gradient(rs)
    return (x32 * rs * (1.0 + weight.float())).to(x.dtype)


def init_params(cfg: Gemma3Config, generator: torch.Generator,
                dtype=torch.float32, device=None):
    """Random parameters (smoke runs and benchmarks), stacked over layers,
    drawn from ``generator`` (which must live on ``device``); norm weights
    are 0, i.e. a multiplier of 1. The head is the tied embedding."""
    device = device if device is not None else generator.device
    L, D, I, hd = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    H, Hkv = cfg.num_heads, cfg.num_kv_heads

    def u(*shape):
        return common.uniform_init(generator, shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = {
        "ln_in": zeros(L, D), "ln_post_attn": zeros(L, D),
        "ln_pre_ff": zeros(L, D), "ln_post_ff": zeros(L, D),
        "wq": u(L, D, H * hd), "wk": u(L, D, Hkv * hd), "wv": u(L, D, Hkv * hd),
        "wo": u(L, H * hd, D), "q_norm": zeros(L, hd), "k_norm": zeros(L, hd),
        "wg": u(L, D, I), "wu": u(L, D, I), "wd": u(L, I, D),
    }
    return {"embed": u(cfg.vocab_size, D), "final_norm": zeros(D),
            "layers": layers}


def embed(params, input_ids, cfg: Gemma3Config):
    """Scaled word embedding (``Gemma3TextScaledWordEmbedding``): sqrt(D)
    rounded to the embedding dtype, then the product."""
    table = params["embed"]
    scale = torch.tensor(cfg.hidden_size ** 0.5, dtype=table.dtype,
                         device=table.device)
    return tensor_parallel.embedding(table, input_ids) * scale


def layer_sliding_flags(cfg: Gemma3Config):
    """Whether each layer is a local (sliding-window) layer; without
    ``layer_types``, HF's default pattern: every 6th layer is global."""
    layer_types = cfg.layer_types or tuple(
        "sliding_attention" if (i + 1) % 6 else "full_attention"
        for i in range(cfg.num_layers))
    return [t == "sliding_attention" for t in layer_types]


def rope_table_pair(positions, cfg: Gemma3Config):
    """(global, local) rotary tables: global uses ``rope_theta`` with the
    linear scaling factor, local ``rope_local_base_freq`` unscaled."""
    glob = common.rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                              scaling=cfg.rope_global_scaling)
    local = common.rope_tables(positions, cfg.head_dim, cfg.rope_local_theta)
    return glob, local


def forward(
    params,
    cfg: Gemma3Config,
    inputs_embeds,
    composite: composites.Composite = composites.attnlrp,
    *,
    probes=None,
    output_hidden_states: bool = False,
    remat: bool = True,
    positions=None,
    attention_mask=None,
    kv_begin=None,
    attn_impl: str = "auto",
    logits_at=None,
    layer_driver=None,
):
    """Causal-LM forward; the keywords are those of ``llama.forward``.
    Returns :class:`ModelOutputs`."""
    T = inputs_embeds.shape[1]
    positions, bias, kv_begin = common.padding_setup(
        attention_mask, kv_begin, positions, T, inputs_embeds.device)
    rope_global, rope_local = rope_table_pair(positions, cfg)
    scale = cfg.query_pre_attn_scalar ** -0.5
    H, Hkv, hd, eps = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.rms_eps
    act_fn = ACTIVATIONS[cfg.act]
    sliding = layer_sliding_flags(cfg)
    lp = params["layers"]
    probes = common.layer_probes(probes)

    def layer(h, i):
        comp = composite.for_layer(i, cfg.num_layers)
        x = tensor_parallel.copy(gemma_rms_norm(h, lp["ln_in"][i], eps, comp))
        q = common.split_heads(comp.linear(x, lp["wq"][i], site="wq"), H, hd)
        k = common.split_heads(comp.linear(x, lp["wk"][i], site="wk"), Hkv, hd)
        v = common.split_heads(comp.linear(x, lp["wv"][i], site="wv"), Hkv, hd)
        q = gemma_rms_norm(q, lp["q_norm"][i], eps, comp)
        k = gemma_rms_norm(k, lp["k_norm"][i], eps, comp)
        # global layers: no window at all (lxt_tpu's 2**30 sentinel)
        attn = attention(q, k, v, causal=True,
                         window=cfg.sliding_window if sliding[i] else None,
                         bias=bias, composite=comp, scale=scale,
                         rope=rope_local if sliding[i] else rope_global,
                         impl=attn_impl, kv_begin=kv_begin)
        out = comp.linear(common.merge_heads(attn), lp["wo"][i], site="wo",
                          row_parallel=True)
        h = h + gemma_rms_norm(out, lp["ln_post_attn"][i], eps, comp)
        x = tensor_parallel.copy(gemma_rms_norm(h, lp["ln_pre_ff"][i], eps, comp))
        g = comp.gated_mul(act_fn, comp.linear(x, lp["wg"][i], site="wg"),
                           comp.linear(x, lp["wu"][i], site="wu"))
        out = comp.linear(g, lp["wd"][i], site="wd", row_parallel=True)
        h = h + gemma_rms_norm(out, lp["ln_post_ff"][i], eps, comp)
        if probes is not None:
            h = h + probes[i]
        return h

    h, hiddens = common.run_layers(layer, inputs_embeds, cfg.num_layers, remat,
                                   keep_hidden=output_hidden_states,
                                   driver=layer_driver)
    logits = forward_head(params, cfg, h, composite, logits_at=logits_at)
    if output_hidden_states:
        hiddens = torch.cat([inputs_embeds[None], hiddens], dim=0)
    return ModelOutputs(logits=logits, hidden_states=hiddens)


def forward_head(params, cfg: Gemma3Config, h, composite=composites.attnlrp, *,
                 logits_at=None):
    """Final Gemma norm + head on a hidden state ``h`` (the tied embedding
    when there is no ``lm_head``)."""
    h = gemma_rms_norm(h, params["final_norm"], cfg.rms_eps, composite)
    if logits_at is not None:
        h = common.take_frontier(h, logits_at)
    return common.vocab_head(composite, h, params.get("lm_head"),
                             params["embed"])


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------

def params_from_hf(state_dict, cfg: Gemma3Config, dtype=torch.float32,
                   device="cuda", quant=None):
    """Convert HF ``Gemma3ForCausalLM`` (text) weights (torch tensors, numpy
    arrays or an ``io.LazyState``) to the stacked parameter dict, layer by
    layer (``common.HFWeights``; ``quant`` quantizes the eligible
    projections as they are converted); linear weights are transposed to
    ``[in, out]``."""
    hf = common.HFWeights(state_dict, dtype, device, quant=quant)
    pre = "model.layers.{}."
    leaves = {
        "ln_in": hf.each(pre + "input_layernorm.weight"),
        "ln_post_attn": hf.each(pre + "post_attention_layernorm.weight"),
        "ln_pre_ff": hf.each(pre + "pre_feedforward_layernorm.weight"),
        "ln_post_ff": hf.each(pre + "post_feedforward_layernorm.weight"),
        "q_norm": hf.each(pre + "self_attn.q_norm.weight"),
        "k_norm": hf.each(pre + "self_attn.k_norm.weight"),
    }
    for ours, name in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                       ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj"),
                       ("wg", "mlp.gate_proj"), ("wu", "mlp.up_proj"),
                       ("wd", "mlp.down_proj")):
        leaves[ours] = hf.each(pre + name + ".weight", transpose=True)
    params = {"embed": hf.tensor("model.embed_tokens.weight"),
              "final_norm": hf.tensor("model.norm.weight"),
              "layers": hf.stack(cfg.num_layers, leaves)}
    if not cfg.tie_embeddings and "lm_head.weight" in hf:
        params["lm_head"] = hf.tensor("lm_head.weight", lambda w: w.T)
    return params


# ---------------------------------------------------------------------------
# Multimodal (image + text): Gemma3ForConditionalGeneration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Gemma3MultimodalConfig:
    """Text config + SigLIP vision tower + projector geometry (HF
    ``Gemma3Config`` / ``Gemma3MultiModalProjector``)."""

    text: Gemma3Config
    vision: Any                # models.siglip.SiglipConfig
    mm_tokens_per_image: int = 256
    image_token_id: int = 262144

    @classmethod
    def from_hf(cls, hf_config):
        from lxt_tpu_torch.models import siglip
        return cls(
            text=Gemma3Config.from_hf(hf_config.text_config),
            vision=siglip.SiglipConfig.from_hf(hf_config.vision_config),
            mm_tokens_per_image=hf_config.mm_tokens_per_image,
            image_token_id=hf_config.image_token_index,
        )


def project_image_features(params, mmcfg: Gemma3MultimodalConfig,
                           vision_out, composite):
    """``Gemma3MultiModalProjector``: a k×k average pool of the patch grid
    down to ``mm_tokens_per_image``, Gemma RMSNorm with the vision eps, and
    the projection into the text width. ``[B, P, Dv] -> [B, mm_tokens,
    Dt]``; the pool is linear, so the gradient handles it exactly."""
    B, P, Dv = vision_out.shape
    pps = mmcfg.vision.image_size // mmcfg.vision.patch_size
    side = int(mmcfg.mm_tokens_per_image ** 0.5)
    k = pps // side
    x = vision_out.reshape(B, side, k, side, k, Dv).mean(dim=(2, 4))
    x = x.reshape(B, side * side, Dv)
    x = gemma_rms_norm(x, params["mm_norm"], mmcfg.vision.ln_eps, composite)
    return composite.linear(x, params["mm_proj"], site="mm_proj")


def merge_image_embeds(params, mmcfg: Gemma3MultimodalConfig, inputs_embeds,
                       pixel_values, image_token_mask,
                       composite=composites.attnlrp):
    """SigLIP-encode the pixels, project them into the text space and
    scatter the projected tokens over the image placeholders (position t
    takes image token ``cumsum(mask)[t] - 1``). The gradient reaches both
    the image tokens and the text embeds at the other positions. The one
    definition of the merge: the joint forward's and the cached decode's
    prefix."""
    from lxt_tpu_torch.models import siglip

    vision_out = siglip.forward(params["vision"], mmcfg.vision, pixel_values,
                                composite)
    img = project_image_features(params, mmcfg, vision_out, composite)
    B, T, D = inputs_embeds.shape
    flat_img = img.reshape(-1, D).to(inputs_embeds.dtype)
    mask = image_token_mask.reshape(-1)
    idx = torch.clamp(torch.cumsum(mask.long(), 0) - 1, min=0)
    merged = torch.where(mask[:, None], flat_img[idx],
                         inputs_embeds.reshape(-1, D))
    return merged.reshape(B, T, D)


def multimodal_forward(params, mmcfg: Gemma3MultimodalConfig, inputs_embeds,
                       pixel_values, image_token_mask,
                       composite=composites.attnlrp, **kw):
    """Joint image + text forward: the merged prefix (see
    :func:`merge_image_embeds`) through the text model; ``kw`` are
    :func:`forward`'s keywords. ``pixel_values``: NHWC ``[B_img, H, W,
    3]``; ``image_token_mask``: bool ``[B, T]`` marking the placeholders
    (``B_img * mm_tokens_per_image`` of them). One backward gives the
    relevance of the pixels and of the text embeds."""
    merged = merge_image_embeds(params, mmcfg, inputs_embeds, pixel_values,
                                image_token_mask, composite)
    return forward(params["text"], mmcfg.text, merged, composite, **kw)


def multimodal_params_from_hf(state_dict, mmcfg: Gemma3MultimodalConfig,
                              dtype=torch.float32, device="cuda"):
    """Convert ``Gemma3ForConditionalGeneration`` weights
    (``model.vision_tower.*``, ``model.multi_modal_projector.*``,
    ``model.language_model.*``, ``lm_head``): ``{"vision", "mm_proj",
    "mm_norm", "text"}``."""
    from lxt_tpu_torch.io import Renamed
    from lxt_tpu_torch.models import siglip

    hf = common.HFWeights(state_dict, dtype, device)
    prefix = "model.language_model."
    names = {"model." + k[len(prefix):]: k for k in state_dict
             if k.startswith(prefix)}
    if "lm_head.weight" in state_dict:
        names["lm_head.weight"] = "lm_head.weight"
    return {
        "vision": siglip.params_from_hf(
            state_dict, mmcfg.vision, dtype=dtype, device=device,
            prefix="model.vision_tower.vision_model."),
        "mm_proj": hf.tensor("model.multi_modal_projector.mm_input_projection_weight"),
        "mm_norm": hf.tensor("model.multi_modal_projector.mm_soft_emb_norm.weight"),
        "text": params_from_hf(Renamed(state_dict, names), mmcfg.text, dtype=dtype,
                               device=device),
    }
