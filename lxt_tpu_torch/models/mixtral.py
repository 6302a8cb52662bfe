"""Mixtral (sparse mixture of experts) with LRP-aware forward — the
counterpart of ``lxt_tpu/models/mixtral.py``.

The attention half is Llama's (RMSNorm, GQA, RoPE through the kernels, an
optional sliding window). The MLP is a router over E experts, of which each
token takes its top K:

- the router's softmax runs in float32 over all experts; the top K follow
  ``lax.top_k``'s order (a stable descending sort: among equal
  probabilities the lower expert id first) and are renormalized, the
  denominator stop-gradded under the identity norm rule (the epsilon rule
  of the reference's ``NormWeight``);
- :func:`moe_block_ragged` (the default) sorts the N·K (token, expert)
  assignments by expert, gathers the token rows, reads the group sizes to
  the host once per block (the one synchronisation of the block), and runs each expert's gate, up and down
  products on its own contiguous row group (``torch.matmul``, or
  ``quant_matmul`` for a quantized expert: K3 for NF4). The products are
  called directly, not through ``Composite.linear``: ``lxt_tpu`` gives its
  ``ragged_dot`` no rule site. The combine un-sorts the K rows of each
  token and sums them (deterministic, no atomics);
- :func:`moe_block_dense` runs every expert on every token with a one-hot
  combine: the parity reference.

The rule sites are ``lxt_tpu``'s: the uniform rule at the gated product and
at the routing weight × expert output product. The top-K selection is a
piecewise-constant mask with no gradient.

``routing`` counts, per block run, the host reads of the group sizes and
the non-empty groups (each one expert's three products).
"""

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from lxt_tpu_torch import composites
from lxt_tpu_torch.models import common
from lxt_tpu_torch.models.common import ACTIVATIONS, ModelOutputs
from lxt_tpu_torch.models.llama import _sliding_window_spec, _torch_dtype
from lxt_tpu_torch.ops.attention import attention
from lxt_tpu_torch.ops.quant import QuantizedTensor, dequantize, quant_matmul
from lxt_tpu_torch.ops.rules import stop_gradient

#: host reads of the ragged block's group sizes (one per block run) and
#: the non-empty expert groups they held; :func:`reset_routing` zeroes them
routing = {"host_reads": 0, "nonempty_groups": 0}


def reset_routing():
    for name in routing:
        routing[name] = 0


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    num_experts: int = 8
    experts_per_token: int = 2
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-5
    act: str = "silu"
    tie_embeddings: bool = False
    #: 'ragged' = each expert on its own sorted row group (the selected K
    #: experts per token only); 'dense' = every expert on every token with
    #: a one-hot combine (the parity reference)
    moe_impl: str = "ragged"
    #: causal sliding window (HF ``sliding_window``); None = full causal
    sliding_window: Optional[int] = None

    @property
    def hd(self):
        return self.hidden_size // self.num_heads

    @classmethod
    def from_hf(cls, hf_config):
        """Build from a transformers ``MixtralConfig`` (or a namespace with
        its attributes)."""
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            intermediate_size=hf_config.intermediate_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            num_kv_heads=hf_config.num_key_value_heads,
            num_experts=hf_config.num_local_experts,
            experts_per_token=hf_config.num_experts_per_tok,
            rope_theta=hf_config.rope_theta,
            rms_eps=hf_config.rms_norm_eps,
            tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
            sliding_window=_sliding_window_spec(hf_config),
        )


EXPERT_LEAVES = ("wg", "wu", "wd")


def init_params(cfg: MixtralConfig, generator: torch.Generator,
                dtype=torch.float32, device=None, quantize_bits=None):
    """Random parameters (smoke runs and benchmarks), stacked over layers,
    drawn from ``generator`` (which must live on ``device``).

    The expert stacks ``[L, E, D, I]`` are drawn one layer at a time;
    ``quantize_bits`` (8, 4 or "nf4") quantizes each layer's draw before
    the next, so a full-precision stack of all layers never exists. The
    other projections are quantized after their draw; embed, lm_head and
    norms stay full precision."""
    from lxt_tpu_torch.ops.quant import quantize
    dtype = _torch_dtype(dtype)
    device = device if device is not None else generator.device
    L, D, I, hd = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.hd
    H, Hkv, E = cfg.num_heads, cfg.num_kv_heads, cfg.num_experts

    def draw(*shape):
        return common.uniform_init(generator, shape, dtype=dtype, device=device)

    def u(*shape):
        w = draw(*shape)
        return quantize(w, quantize_bits) if quantize_bits else w

    def experts(*shape):
        out = None
        for i in range(L):
            w = u(E, *shape)
            leaves = (w.q, w.scale) if quantize_bits else (w,)
            if out is None:
                out = [torch.empty((L, *t.shape), dtype=t.dtype, device=device)
                       for t in leaves]
            for o, t in zip(out, leaves):
                o[i] = t
        return QuantizedTensor(*out, w.bits, w.block) if quantize_bits else out[0]

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "ln1": ones(L, D), "ln2": ones(L, D),
        "wq": u(L, D, H * hd), "wk": u(L, D, Hkv * hd), "wv": u(L, D, Hkv * hd),
        "wo": u(L, H * hd, D), "w_router": u(L, D, E),
        "wg": experts(D, I), "wd": experts(I, D), "wu": experts(D, I),
    }
    params = {"embed": draw(cfg.vocab_size, D), "final_norm": ones(D),
              "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = draw(D, cfg.vocab_size)
    return params


def embed(params, input_ids):
    return params["embed"][input_ids]


def _route(x, lp, cfg, composite):
    """Router: float32 softmax over all experts, the top K in ``lax.top_k``
    order (lower id first among ties), renormalized. Returns ``(top_w``
    float32, ``top_idx)``, each ``[..., K]``."""
    logits = composite.linear(x, lp["w_router"], site="w_router")
    probs = torch.softmax(logits.float(), dim=-1)
    top_idx = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[..., :cfg.experts_per_token]
    top_w = probs.gather(-1, top_idx)
    denom = top_w.sum(-1, keepdim=True)
    if composite.norm == "identity":
        denom = stop_gradient(denom)
    return top_w / denom, top_idx


def _dq(w, dtype):
    return dequantize(w, dtype) if isinstance(w, QuantizedTensor) else w


def moe_block_dense(x, lp, cfg: MixtralConfig, composite, act_fn):
    """The mixture as a dense one-hot combine: every expert on every token."""
    top_w, top_idx = _route(x, lp, cfg, composite)                # [B,T,K]
    onehot = F.one_hot(top_idx, cfg.num_experts).to(top_w.dtype)  # [B,T,K,E]
    dense_w = (top_w[..., None] * onehot).sum(-2).to(x.dtype)     # [B,T,E]
    gate = torch.einsum("btd,edi->btei", x, _dq(lp["wg"], x.dtype))
    up = torch.einsum("btd,edi->btei", x, _dq(lp["wu"], x.dtype))
    hidden = composite.gated_mul(act_fn, gate, up)
    expert_out = torch.einsum("btei,eid->bted", hidden, _dq(lp["wd"], x.dtype))
    weighted = composite.mul_uniform(dense_w[..., None], expert_out)
    return weighted.sum(-2)


def _expert_matmul(x, w):
    return quant_matmul(x, w) if isinstance(w, QuantizedTensor) else torch.matmul(x, w)


def moe_block_ragged(x, lp, cfg: MixtralConfig, composite, act_fn):
    """The mixture as per-expert products on the rows sorted by expert:
    K/E of the dense products, and the same rules at the same sites."""
    B, T, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    N = B * T
    xf = x.reshape(N, D)
    top_w, top_idx = _route(xf, lp, cfg, composite)               # [N,K]
    expert_flat = top_idx.reshape(-1)                              # [N*K]
    order = torch.argsort(expert_flat, stable=True)
    gathered = xf[order // K]                                      # [N*K,D]
    # one host read per block: torch.bincount would first read the ids'
    # minimum and maximum to the host, two more synchronisations
    sizes = torch.zeros(E, dtype=expert_flat.dtype, device=x.device).scatter_add_(
        0, expert_flat, torch.ones_like(expert_flat)).tolist()
    routing["host_reads"] += 1
    routing["nonempty_groups"] += sum(1 for n in sizes if n)

    def grouped(lhs, w):
        # one split, whose backward is one concatenation: slicing each
        # group would give each group's backward a zero tensor of the
        # whole lhs to fill and add
        return torch.cat([_expert_matmul(rows, w[e])
                          for e, rows in enumerate(lhs.split(sizes)) if sizes[e]])

    gate = grouped(gathered, lp["wg"])
    up = grouped(gathered, lp["wu"])
    hidden = composite.gated_mul(act_fn, gate, up)
    expert_out = grouped(hidden, lp["wd"])                         # [N*K,D]

    w_sorted = top_w.reshape(-1)[order].to(x.dtype)
    weighted = composite.mul_uniform(w_sorted[:, None], expert_out)
    # un-sort: row n*K + k is token n's k-th choice, then sum the K rows
    unsort = torch.empty_like(order).scatter_(
        0, order, torch.arange(N * K, device=order.device))
    out = weighted[unsort].view(N, K, D).sum(1)
    return out.view(B, T, D).to(x.dtype)


def moe_block(x, lp, cfg: MixtralConfig, composite, act_fn):
    if cfg.moe_impl == "ragged":
        return moe_block_ragged(x, lp, cfg, composite, act_fn)
    return moe_block_dense(x, lp, cfg, composite, act_fn)


def forward(
    params,
    cfg: MixtralConfig,
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
):
    """Causal-LM forward; the keywords are those of ``llama.forward``.
    Returns :class:`ModelOutputs`."""
    T = inputs_embeds.shape[1]
    positions, bias, kv_begin = common.padding_setup(
        attention_mask, kv_begin, positions, T, inputs_embeds.device)
    rope = common.rope_tables(positions, cfg.hd, cfg.rope_theta)
    scale = cfg.hd ** -0.5
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    act_fn = ACTIVATIONS[cfg.act]
    lp, comp = params["layers"], composite
    probes = common.layer_probes(probes)

    def layer(h, i):
        x = comp.rms_norm(h, lp["ln1"][i], cfg.rms_eps)
        q = common.split_heads(comp.linear(x, lp["wq"][i], site="wq"), H, hd)
        k = common.split_heads(comp.linear(x, lp["wk"][i], site="wk"), Hkv, hd)
        v = common.split_heads(comp.linear(x, lp["wv"][i], site="wv"), Hkv, hd)
        attn = attention(q, k, v, causal=True, window=cfg.sliding_window,
                         bias=bias, composite=comp, rope=rope, scale=scale,
                         impl=attn_impl, kv_begin=kv_begin)
        h = h + comp.linear(common.merge_heads(attn), lp["wo"][i], site="wo")
        x = comp.rms_norm(h, lp["ln2"][i], cfg.rms_eps)
        moe = {n: lp[n][i] for n in ("w_router",) + EXPERT_LEAVES}
        h = h + moe_block(x, moe, cfg, comp, act_fn)
        if probes is not None:
            h = h + probes[i]
        return h

    h, hiddens = common.run_layers(layer, inputs_embeds, cfg.num_layers, remat,
                                   keep_hidden=output_hidden_states)
    h = composite.rms_norm(h, params["final_norm"], cfg.rms_eps)
    if logits_at is not None:
        h = common.take_frontier(h, logits_at)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = composite.linear(h, head)
    if output_hidden_states:
        hiddens = torch.cat([inputs_embeds[None], hiddens], dim=0)
    return ModelOutputs(logits=logits, hidden_states=hiddens)


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------

def params_from_hf(state_dict, cfg: MixtralConfig, dtype=torch.float32,
                   device="cuda"):
    """Convert HF ``MixtralForCausalLM`` weights (torch tensors or numpy
    arrays) to the stacked parameter dict: linear weights transposed to
    ``[in, out]``, the experts stacked on axis 1 (HF ``w1`` / ``w3`` /
    ``w2`` -> ``wg`` / ``wu`` / ``wd``)."""

    def t(name):
        w = state_dict[name]
        if isinstance(w, torch.Tensor):
            w = w.detach().to("cpu").float().numpy()
        return np.asarray(w, dtype=np.float32)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                            dtype=dtype)

    L, E = cfg.num_layers, cfg.num_experts
    pre = "model.layers."

    def stack(fmt, transpose=False):
        ws = [t(pre + fmt.format(i)) for i in range(L)]
        return tensor(np.stack([w.T if transpose else w for w in ws]))

    def stack_experts(hf):
        fmt = pre + "{}.block_sparse_moe.experts.{}." + hf + ".weight"
        return tensor(np.stack([np.stack([t(fmt.format(i, e)).T for e in range(E)])
                                for i in range(L)]))

    layers = {
        "ln1": stack("{}.input_layernorm.weight"),
        "ln2": stack("{}.post_attention_layernorm.weight"),
        "wq": stack("{}.self_attn.q_proj.weight", True),
        "wk": stack("{}.self_attn.k_proj.weight", True),
        "wv": stack("{}.self_attn.v_proj.weight", True),
        "wo": stack("{}.self_attn.o_proj.weight", True),
        "w_router": stack("{}.block_sparse_moe.gate.weight", True),
        "wg": stack_experts("w1"),
        "wd": stack_experts("w2"),
        "wu": stack_experts("w3"),
    }
    params = {"embed": tensor(t("model.embed_tokens.weight")),
              "final_norm": tensor(t("model.norm.weight")), "layers": layers}
    if not cfg.tie_embeddings and "lm_head.weight" in state_dict:
        params["lm_head"] = tensor(t("lm_head.weight").T)
    return params
