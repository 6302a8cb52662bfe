"""DeepSeek-V3 (the port's ``deepseek_v3`` family, ``models/deepseek_v3.py``;
Moonlight-16B-A3B): latent attention in every layer, a dense gated MLP in
the first ``first_k_dense_replace`` layers, and in the others a sigmoid
router over many small experts beside shared ones."""

from bench_port.harness import decoder

#: the port's family name
FAMILY = "deepseek_v3"


def mla_shape(hf):
    """(heads, q/k head dim, v head dim)."""
    return (hf["num_attention_heads"],
            hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"], hf["v_head_dim"])


def _attention_tensors(hf):
    """``name -> (out, in)`` of one layer's attention projections and
    ``name -> width`` of its norms (after ``self_attn.``)."""
    D, H, dqk, dv = hf["hidden_size"], *mla_shape(hf)
    r, dr, dn = hf["kv_lora_rank"], hf["qk_rope_head_dim"], hf["qk_nope_head_dim"]
    proj = {"kv_a_proj_with_mqa": (r + dr, D), "kv_b_proj": (H * (dn + dv), r),
            "o_proj": (D, H * dv)}
    norms = {"kv_a_layernorm": r}
    qr = hf.get("q_lora_rank")
    if qr is None:
        proj["q_proj"] = (H * dqk, D)
    else:
        proj.update(q_a_proj=(qr, D), q_b_proj=(H * dqk, qr))
        norms["q_a_layernorm"] = qr
    return proj, norms


def tensors(config):
    """``name -> (shape, kind)`` of every tensor of the checkpoint (the HF
    layout; the selection bias drawn as a weight)."""
    hf = config["config"]
    D, V = hf["hidden_size"], hf["vocab_size"]
    E, I = hf["n_routed_experts"], hf["moe_intermediate_size"]
    out = {"model.embed_tokens.weight": ((V, D), "weight"),
           "model.norm.weight": ((D,), "norm")}
    if not hf.get("tie_word_embeddings"):
        out["lm_head.weight"] = ((V, D), "weight")
    proj, norms = _attention_tensors(hf)

    def mlp(pre, width):
        out[pre + "gate_proj.weight"] = ((width, D), "weight")
        out[pre + "up_proj.weight"] = ((width, D), "weight")
        out[pre + "down_proj.weight"] = ((D, width), "weight")

    for i in range(hf["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        out[pre + "input_layernorm.weight"] = ((D,), "norm")
        out[pre + "post_attention_layernorm.weight"] = ((D,), "norm")
        for name, shape in proj.items():
            out[pre + f"self_attn.{name}.weight"] = (shape, "weight")
        for name, width in norms.items():
            out[pre + f"self_attn.{name}.weight"] = ((width,), "norm")
        if i < hf.get("first_k_dense_replace", 0):
            mlp(pre + "mlp.", hf["intermediate_size"])
            continue
        out[pre + "mlp.gate.weight"] = ((E, D), "weight")
        out[pre + "mlp.gate.e_score_correction_bias"] = ((E,), "weight")
        for e in range(E):
            mlp(pre + f"mlp.experts.{e}.", I)
        mlp(pre + "mlp.shared_experts.", hf["n_shared_experts"] * I)
    return out


def heatmap_flops(config, length):
    """Useful FLOPs of one heatmap of a prompt of ``length`` tokens: every
    product of the layers forward and its input gradient (4 FLOPs a
    parameter and token: MLA's own projections, the router, the K chosen
    experts, the shared experts, the dense layers' MLP), attention over the
    causal pairs at MLA's own head dims (2 · (Dqk + Dv) FLOPs a pair and
    head forward, × 3.5 for forward and backward), and the head at the
    explained position alone."""
    hf = config["config"]
    L, D, V = hf["num_hidden_layers"], hf["hidden_size"], hf["vocab_size"]
    E, K = hf["n_routed_experts"], hf["num_experts_per_tok"]
    I = hf["moe_intermediate_size"]
    k_dense = hf.get("first_k_dense_replace", 0)
    H, dqk, dv = mla_shape(hf)
    proj, _ = _attention_tensors(hf)
    attn = sum(o * i for o, i in proj.values())
    dense = 3 * D * hf["intermediate_size"]
    moe = D * E + K * 3 * D * I + 3 * D * hf["n_shared_experts"] * I
    per_token = L * attn + k_dense * dense + (L - k_dense) * moe
    pairs = length * (length + 1) // 2
    attention = 3.5 * 2 * (dqk + dv) * H * pairs * L
    return 4 * per_token * length + attention + 4 * D * V


def build(config, state, device):
    return decoder.build(config, state, device, FAMILY)


class Recorder:
    """The program's routing, as the reference follows it: as
    ``families/mixtral.Recorder``, around ``models.deepseek_v3._route``,
    keeping a call's first ``num_hidden_layers - first_k_dense_replace``
    routed calls (one a mixture layer of the forward; remat's recompute is
    not kept)."""

    def __init__(self, config):
        hf = config["config"]
        self.layers = hf["num_hidden_layers"] - hf.get("first_k_dense_replace", 0)
        self.routes = []

    def __enter__(self):
        from lxt_tpu_torch.models import deepseek_v3
        self._module, self._route = deepseek_v3, deepseek_v3._route

        def route(*args, **kw):
            top_w, top_idx = self._route(*args, **kw)
            if len(self.routes) < self.layers:
                self.routes.append(top_idx)
            return top_w, top_idx

        deepseek_v3._route = route
        return self

    def __exit__(self, *exc):
        self._module._route = self._route

    def take(self, prompts, keep):
        """As ``families/mixtral.Recorder.take``."""
        import torch
        forward, self.routes = self.routes, []
        if not keep:
            return {}
        if len(forward) < self.layers or forward[0].shape[0] % len(prompts):
            return dict.fromkeys(keep)
        T = forward[0].shape[0] // len(prompts)
        return {j: {"routes": list(torch.stack(
            [idx.view(len(prompts), T, -1)[j, T - len(prompts[j]):]
             for idx in forward]).unbind(0))} for j in keep}
