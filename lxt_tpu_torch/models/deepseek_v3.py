"""DeepSeek-V3 (Moonlight, Kimi-K2, DeepSeek-V3) with LRP-aware forward:
latent attention, then either a dense gated MLP (the first
``first_k_dense_replace`` layers) or a mixture of many small experts
beside shared ones. The equations are transformers' ``deepseek_v3``;
``lxt_tpu`` has no counterpart.

Latent attention (MLA), written as published, with no weight absorption:

- ``q = x Wq`` (or ``RMSNorm(x Wq_a) Wq_b`` where ``q_lora_rank`` is set),
  split per head into ``q_nope`` and ``q_pe``;
- ``[c_kv, k_pe] = x Wkv_a``, ``c_kv <- RMSNorm(c_kv)``, and
  ``[k_nope, v] = c_kv Wkv_b`` (``kv_b_proj`` split per head at
  conversion into ``wk_b`` and ``wv_b``);
- RoPE on ``q_pe`` and on ``k_pe``, one head shared by every query head.
  The checkpoint's interleaved rope layout (``rope_interleave``) is folded
  into a fixed permutation of the rope columns of ``Wq`` (``Wq_b``) and
  ``Wkv_a`` at conversion: q and k take the same permutation, so every
  score is unchanged, and the rotation runs in the port's rotate-half
  layout (``common.apply_rope``) on the rope slice;
- ``q = [q_nope, q_pe]``, ``k = [k_nope, k_pe]``: q/k head dim
  ``qk_nope + qk_rope`` (192), v head dim ``v_head_dim`` (128), causal at
  scale ``192^-0.5`` through ``ops.attention.attention`` (the flash route
  pads q, k and v to 256 and slices the output to 128).

The latent norms (``q_a_layernorm``, ``kv_a_layernorm``) take eps 1e-6,
transformers' default, whatever ``rms_norm_eps`` says. Everything from the
projections to the attention's output runs inside the span ``lxt.mla``.

The mixture shares ``models/mixtral.moe_block_ragged`` (sort, one host
read a block, per-expert products, combine) and its ``routing`` counters;
only the router differs (:func:`_route`):

- router logits in float32 (input and weight upcast), ``s = sigmoid``;
- the choice is the top K of ``s + e_score_correction_bias`` by a stable
  descending sort; with ``n_group > 1`` the groups outside the
  ``topk_group`` best (each scored by the sum of its two best) are first
  set to 0, as transformers' ``get_topk_indices`` does;
- the weights are ``s`` at the chosen experts, never the bias, divided by
  their sum (``norm_topk_prob``) and multiplied by
  ``routed_scaling_factor``.

The shared experts are one gated MLP of width ``n_shared_experts *
moe_intermediate_size`` on every token, added to the routed sum inside
the span ``lxt.moe``.

Rules at the new sites: the latent norms take the identity norm rule
(``Composite.rms_norm``); the projections are ``Composite.linear``;
``Composite.qkv`` scales the gradients of the concatenated q, k and v; the
rotation and concatenations are linear and take their plain gradient; the
sigmoid scoring takes its plain gradient, as Mixtral's softmax does; the
routing weights' denominator is stop-gradded under the identity norm rule
as in ``mixtral._route``; the selection (bias, sort, group mask) is
piecewise constant and carries no gradient; the routing weight × expert
output product and the gated products (routed, shared and dense) take the
uniform rule.

Not supported, refused by :meth:`DeepseekV3Config.from_hf`:
``rope_scaling``, a ``scoring_func`` other than sigmoid, quantization
(``quantization_config``, ``quantize_bits``) and ``attention_bias``. No
KV-cached decoding and no tensor parallelism.
"""

import dataclasses
from typing import Optional

import torch

from lxt_tpu_torch import composites, tracing
from lxt_tpu_torch.models import common, mixtral
from lxt_tpu_torch.models.common import ACTIVATIONS, ModelOutputs
from lxt_tpu_torch.models.llama import forward_head
from lxt_tpu_torch.ops.attention import attention
from lxt_tpu_torch.ops.rules import stop_gradient

#: eps of the latent RMSNorms (transformers builds them with its default)
LATENT_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class DeepseekV3Config:
    vocab_size: int = 129280
    hidden_size: int = 7168
    #: the dense layers' MLP width
    intermediate_size: int = 18432
    #: one routed expert's width (and, times ``n_shared_experts``, the
    #: shared MLP's)
    moe_intermediate_size: int = 2048
    num_layers: int = 61
    num_heads: int = 128
    q_lora_rank: Optional[int] = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    num_experts: int = 256
    experts_per_token: int = 8
    n_shared_experts: int = 1
    n_group: int = 8
    topk_group: int = 4
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.5
    first_k_dense: int = 3
    rope_theta: float = 10000.0
    rope_interleave: bool = True
    rms_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False
    #: the mixture: 'ragged' or 'dense' (``mixtral.MixtralConfig.moe_impl``)
    moe_impl: str = "ragged"

    @property
    def qk_head_dim(self):
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @classmethod
    def from_hf(cls, hf_config):
        """Build from a transformers ``DeepseekV3Config`` (or a namespace with
        its attributes); refuses what the port does not run, naming the
        key."""
        def get(name, default=None):
            return getattr(hf_config, name, default)

        if get("rope_scaling"):
            raise ValueError("deepseek_v3: rope_scaling is not supported "
                             f"(got {get('rope_scaling')!r})")
        if get("scoring_func", "sigmoid") != "sigmoid":
            raise ValueError("deepseek_v3: scoring_func must be 'sigmoid', "
                             f"got {get('scoring_func')!r}")
        if get("quantization_config"):
            raise ValueError("deepseek_v3: quantized checkpoints "
                             "(quantization_config) are not supported")
        if get("attention_bias", False):
            raise ValueError("deepseek_v3: attention_bias=True is not supported")
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            intermediate_size=hf_config.intermediate_size,
            moe_intermediate_size=hf_config.moe_intermediate_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            q_lora_rank=get("q_lora_rank"),
            kv_lora_rank=hf_config.kv_lora_rank,
            qk_nope_head_dim=hf_config.qk_nope_head_dim,
            qk_rope_head_dim=hf_config.qk_rope_head_dim,
            v_head_dim=hf_config.v_head_dim,
            num_experts=hf_config.n_routed_experts,
            experts_per_token=hf_config.num_experts_per_tok,
            n_shared_experts=hf_config.n_shared_experts,
            n_group=get("n_group") or 1,
            topk_group=get("topk_group") or 1,
            norm_topk_prob=get("norm_topk_prob", True),
            routed_scaling_factor=float(hf_config.routed_scaling_factor),
            first_k_dense=get("first_k_dense_replace", 0),
            rope_theta=get("rope_theta", 10000.0),
            rope_interleave=get("rope_interleave", True),
            rms_eps=hf_config.rms_norm_eps,
            act=get("hidden_act", "silu"),
            tie_embeddings=get("tie_word_embeddings", False),
        )


def _route(x, lp, cfg, composite):
    """Router: float32 sigmoid scores, the top K of score + selection bias
    (group-limited first when ``n_group > 1``) by a stable descending sort,
    weighted by the scores alone. Returns ``(top_w`` float32, ``top_idx)``,
    each ``[..., K]``."""
    logits = composite.linear(x.float(), lp["w_router"].float(), site="w_router")
    scores = torch.sigmoid(logits)
    choice = scores.detach() + lp["e_bias"]
    if cfg.n_group > 1:
        choice = _group_limited(choice, cfg)
    top_idx = torch.sort(choice, dim=-1, descending=True,
                         stable=True).indices[..., :cfg.experts_per_token]
    top_w = scores.gather(-1, top_idx)
    if cfg.norm_topk_prob:
        denom = top_w.sum(-1, keepdim=True)
        if composite.norm == "identity":
            denom = stop_gradient(denom)
        top_w = top_w / denom
    return top_w * cfg.routed_scaling_factor, top_idx


def _group_limited(choice, cfg):
    """``choice`` with the experts outside the ``topk_group`` best groups
    (a group scored by the sum of its two best) set to 0, as transformers
    sets them."""
    G = cfg.n_group
    groups = choice.view(*choice.shape[:-1], G, choice.shape[-1] // G)
    group_scores = groups.topk(2, dim=-1).values.sum(-1)
    best = torch.sort(group_scores, dim=-1, descending=True,
                      stable=True).indices[..., :cfg.topk_group]
    keep = torch.zeros_like(group_scores, dtype=torch.bool).scatter_(-1, best, True)
    return groups.masked_fill(~keep[..., None], 0.0).view(choice.shape)


def _mlp(x, wg, wu, wd, composite, act_fn, site=""):
    g = composite.gated_mul(act_fn, composite.linear(x, wg, site=site + "wg"),
                            composite.linear(x, wu, site=site + "wu"))
    return composite.linear(g, wd, site=site + "wd")


def moe_block(x, lp, cfg: DeepseekV3Config, composite, act_fn):
    """The routed mixture (``mixtral``'s blocks, this family's router) plus
    the shared experts, inside the span ``lxt.moe``."""
    with tracing.span("lxt.moe"):
        routed = _route(x.reshape(-1, x.shape[-1]), lp, cfg, composite)
        block = (mixtral.moe_block_ragged if cfg.moe_impl == "ragged"
                 else mixtral.moe_block_dense)
        out = block(x, lp, cfg, composite, act_fn, routed=routed)
        return out + _mlp(x, lp["s_wg"], lp["s_wu"], lp["s_wd"], composite,
                          act_fn, site="s_")


def _mla(x, lp, i, cfg, composite, rope, bias, kv_begin, attn_impl):
    """Latent attention of layer ``i`` on the normed ``x``: ``[B, H, T,
    v_head_dim]``."""
    B, T, _ = x.shape
    H, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank is None:
        q = composite.linear(x, lp["wq"][i], site="wq")
    else:
        qa = composite.rms_norm(composite.linear(x, lp["wq_a"][i], site="wq_a"),
                                lp["q_norm"][i], LATENT_EPS)
        q = composite.linear(qa, lp["wq_b"][i], site="wq_b")
    q_nope, q_pe = common.split_heads(q, H, dn + dr).split([dn, dr], dim=-1)
    c_kv, k_pe = composite.linear(x, lp["wkv_a"][i], site="wkv_a").split(
        [cfg.kv_lora_rank, dr], dim=-1)
    c_kv = composite.rms_norm(c_kv, lp["kv_norm"][i], LATENT_EPS)
    k_nope = common.split_heads(composite.linear(c_kv, lp["wk_b"][i], site="wk_b"),
                                H, dn)
    v = common.split_heads(composite.linear(c_kv, lp["wv_b"][i], site="wv_b"),
                           H, cfg.v_head_dim)
    q_pe, k_pe = common.apply_rope(q_pe, k_pe[:, None], *rope)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(B, H, T, dr)], dim=-1)
    return attention(q, k, v, causal=True, bias=bias, composite=composite,
                     scale=cfg.qk_head_dim ** -0.5, impl=attn_impl,
                     kv_begin=kv_begin)


MOE_LEAVES = {"w_router": "w_router", "e_bias": "e_bias", "wg": "e_wg",
              "wu": "e_wu", "wd": "e_wd", "s_wg": "s_wg", "s_wu": "s_wu",
              "s_wd": "s_wd"}


def forward(
    params,
    cfg: DeepseekV3Config,
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
    Layer ``i < first_k_dense`` runs the dense MLP, the others the
    mixture. Returns :class:`ModelOutputs`."""
    T = inputs_embeds.shape[1]
    positions, bias, kv_begin = common.padding_setup(
        attention_mask, kv_begin, positions, T, inputs_embeds.device)
    rope = common.rope_tables(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    act_fn = ACTIVATIONS[cfg.act]
    lp = params["layers"]
    probes = common.layer_probes(probes)
    k_dense = cfg.first_k_dense

    def layer(h, i):
        comp = composite.for_layer(i, cfg.num_layers)
        x = comp.rms_norm(h, lp["ln1"][i], cfg.rms_eps)
        with tracing.span("lxt.mla"):
            attn = _mla(x, lp, i, cfg, comp, rope, bias, kv_begin, attn_impl)
        h = h + comp.linear(common.merge_heads(attn), lp["wo"][i], site="wo")
        x = comp.rms_norm(h, lp["ln2"][i], cfg.rms_eps)
        if i < k_dense:
            h = h + _mlp(x, lp["wg"][i], lp["wu"][i], lp["wd"][i], comp, act_fn)
        else:
            moe = {n: lp[leaf][i - k_dense] for n, leaf in MOE_LEAVES.items()}
            h = h + moe_block(x, moe, cfg, comp, act_fn)
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


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------

def rope_permutation(d):
    """The columns of a rope slice of width ``d`` in the rotate-half layout:
    transformers' ``apply_rotary_pos_emb_interleave`` reads pairs
    ``(2j, 2j + 1)`` as ``(j, j + d/2)``."""
    return list(range(0, d, 2)) + list(range(1, d, 2))


def params_from_hf(state_dict, cfg: DeepseekV3Config, dtype=torch.float32,
                   device="cuda", quant=None):
    """Convert HF ``DeepseekV3ForCausalLM`` weights (torch tensors, numpy
    arrays or an ``io.LazyState``) to the stacked parameter dict, layer by
    layer (``common.HFWeights``): linear weights transposed to ``[in,
    out]``; the rope columns of ``q_proj`` (``q_b_proj``) and
    ``kv_a_proj_with_mqa`` permuted to the rotate-half layout where the
    config interleaves; ``kv_b_proj`` split per head into ``wk_b`` and
    ``wv_b``; the dense layers' MLP ``[first_k_dense, ...]``; the mixture
    layers' router, experts ``[L_moe, E, D, I]``, shared experts and
    ``e_score_correction_bias`` (float32) stacked over the mixture layers."""
    if quant:
        raise ValueError("deepseek_v3: quantization (quantize_bits) is not "
                         "supported")
    hf = common.HFWeights(state_dict, dtype, device)
    pre = "model.layers.{}."
    H, dn, dr, dv = (cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim)
    r, k_dense = cfg.kv_lora_rank, cfg.first_k_dense
    L_moe = cfg.num_layers - k_dense
    rope_cols = rope_permutation(dr) if cfg.rope_interleave else list(range(dr))
    q_cols = torch.tensor([h * (dn + dr) + c for h in range(H)
                           for c in list(range(dn)) + [dn + p for p in rope_cols]],
                          device=hf.device)
    kv_cols = torch.tensor(list(range(r)) + [r + p for p in rope_cols],
                           device=hf.device)

    def permuted(name, cols):
        get = hf.each(pre + name, transpose=True)
        return lambda i: get(i)[:, cols]

    def kv_b(part):
        get = hf.each(pre + "self_attn.kv_b_proj.weight", transpose=True)
        sl = slice(0, dn) if part == "k" else slice(dn, dn + dv)
        return lambda i: get(i).reshape(r, H, dn + dv)[..., sl].reshape(r, -1)

    attn = {"ln1": hf.each(pre + "input_layernorm.weight"),
            "ln2": hf.each(pre + "post_attention_layernorm.weight")}
    if cfg.q_lora_rank is None:
        attn["wq"] = permuted("self_attn.q_proj.weight", q_cols)
    else:
        attn.update(wq_a=hf.each(pre + "self_attn.q_a_proj.weight", True),
                    q_norm=hf.each(pre + "self_attn.q_a_layernorm.weight"),
                    wq_b=permuted("self_attn.q_b_proj.weight", q_cols))
    attn.update(wkv_a=permuted("self_attn.kv_a_proj_with_mqa.weight", kv_cols),
                kv_norm=hf.each(pre + "self_attn.kv_a_layernorm.weight"),
                wk_b=kv_b("k"), wv_b=kv_b("v"),
                wo=hf.each(pre + "self_attn.o_proj.weight", True))
    layers = hf.stack(cfg.num_layers, attn)

    mlp = pre + "mlp."
    layers.update(hf.stack(k_dense, {
        ours: hf.each(mlp + name + ".weight", True)
        for ours, name in (("wg", "gate_proj"), ("wu", "up_proj"),
                           ("wd", "down_proj"))}))

    def moe(fmt, transpose=True):
        def get(i):
            w = hf.get(fmt.format(i + k_dense))
            return w.T if transpose else w
        return get

    def experts(name):
        fmt = mlp + "experts.{}." + name + ".weight"
        return cfg.num_experts, lambda i, e: hf.get(fmt.format(i + k_dense, e)).T

    layers.update(hf.stack(L_moe, {
        "w_router": moe(mlp + "gate.weight"),
        "e_wg": experts("gate_proj"), "e_wu": experts("up_proj"),
        "e_wd": experts("down_proj"),
        "s_wg": moe(mlp + "shared_experts.gate_proj.weight"),
        "s_wu": moe(mlp + "shared_experts.up_proj.weight"),
        "s_wd": moe(mlp + "shared_experts.down_proj.weight")}))
    bias = common.HFWeights(state_dict, torch.float32, device)
    bias_fmt = mlp + "gate.e_score_correction_bias"
    layers.update(bias.stack(L_moe, {
        "e_bias": lambda i: bias.get(bias_fmt.format(i + k_dense))}))

    params = {"embed": hf.tensor("model.embed_tokens.weight"),
              "final_norm": hf.tensor("model.norm.weight"),
              "layers": layers}
    if not cfg.tie_embeddings and "lm_head.weight" in hf:
        params["lm_head"] = hf.tensor("lm_head.weight", lambda w: w.T)
    return params
