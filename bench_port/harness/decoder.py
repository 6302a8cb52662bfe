"""What the decoder families share: the checkpoint tensors of the attention
half, the count of useful FLOPs, and the build of the program's model from a
seeded checkpoint through the port's own layer-by-layer conversion."""

import types

ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")


def head_dim(hf):
    return hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]


def attention_shape(hf):
    """(query heads, key/value heads, head dim)."""
    return (hf["num_attention_heads"],
            hf.get("num_key_value_heads") or hf["num_attention_heads"],
            head_dim(hf))


def common_tensors(hf):
    """``name -> (shape, kind)`` of the embedding, the head, the norms and
    the attention projections of every layer (the HF layout)."""
    D, V = hf["hidden_size"], hf["vocab_size"]
    H, Hkv, hd = attention_shape(hf)
    out = {"model.embed_tokens.weight": ((V, D), "weight"),
           "model.norm.weight": ((D,), "norm")}
    if not hf.get("tie_word_embeddings"):
        out["lm_head.weight"] = ((V, D), "weight")
    for i in range(hf["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        out[pre + "input_layernorm.weight"] = ((D,), "norm")
        out[pre + "post_attention_layernorm.weight"] = ((D,), "norm")
        out[pre + "self_attn.q_proj.weight"] = ((H * hd, D), "weight")
        out[pre + "self_attn.k_proj.weight"] = ((Hkv * hd, D), "weight")
        out[pre + "self_attn.v_proj.weight"] = ((Hkv * hd, D), "weight")
        out[pre + "self_attn.o_proj.weight"] = ((D, H * hd), "weight")
    return out


def attention_params(hf):
    """Parameters of one layer's q, k, v and o projections."""
    D = hf["hidden_size"]
    H, Hkv, hd = attention_shape(hf)
    return D * (2 * H * hd + 2 * Hkv * hd)


def heatmap_flops(hf, length, mlp_params_per_token):
    """Useful FLOPs of one heatmap of a prompt of ``length`` tokens: every
    product of the layers forward and its input gradient (4 FLOPs a
    parameter and token; no weight gradient, no recompute, no padding),
    attention over the causal pairs (two products forward, five backward:
    3.5 x the forward's 4 FLOPs a pair, head and head dim), and the head at
    the explained position alone (forward and input gradient)."""
    L, D, V = hf["num_hidden_layers"], hf["hidden_size"], hf["vocab_size"]
    H, _, hd = attention_shape(hf)
    linear = 4 * (attention_params(hf) + mlp_params_per_token) * length * L
    pairs = length * (length + 1) // 2
    attention = 3.5 * 4 * H * hd * pairs * L
    return linear + attention + 4 * D * V


def hf_namespace(config):
    """The published ``config.json`` as the attribute namespace that the
    port's ``Config.from_hf`` reads."""
    return types.SimpleNamespace(**config["config"])


def build(config, state, device, family):
    """The program's ``AttributionModel`` of ``config``, converted from the
    mapping ``state`` by the family's own converter (``registry.FAMILIES``),
    layer by layer on ``device``, quantized while converting where the
    configuration says so: the path ``registry.from_pretrained`` takes from
    a checkpoint."""
    import torch
    from lxt_tpu_torch import composites
    from lxt_tpu_torch.models.registry import FAMILIES, AttributionModel
    from lxt_tpu_torch.ops.quant import eligibility

    table = FAMILIES[family]
    cfg = table["config"].from_hf(hf_namespace(config))
    quant = config.get("quantization")
    bits = quant["format"] if quant else None
    params = table["from_hf"](
        state, cfg, dtype=getattr(torch, config["dtype"]), device=device,
        quant=(bits, eligibility(bits, family=family)) if bits else None)
    return AttributionModel(family=family, cfg=cfg, params=params,
                            composite=composites.resolve(config["composite"]),
                            remat=bool(config["remat"]))
