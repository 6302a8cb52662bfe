"""Llama-family decoder with LRP-aware forward (Llama 2/3, TinyLlama, Qwen
2/3, Mistral, Phi-3) — the counterpart of ``lxt_tpu/models/llama.py``.

Gated-SiLU MLP (identity + uniform rules), RMSNorm (identity rule via
stop-grad rsqrt), uniform rule at the attention q/k/v. Config switches
handle the differences: Qwen2 adds qkv biases, Qwen3 per-head q/k RMSNorm,
Mistral and Phi-3 a sliding window; Phi-3's fused projections are split at
conversion.
"""

import dataclasses
from typing import Optional

import torch

from lxt_tpu_torch import composites
from lxt_tpu_torch.models import common
from lxt_tpu_torch.models.common import ACTIVATIONS, ModelOutputs
from lxt_tpu_torch.ops import tensor_parallel
from lxt_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    act: str = "silu"
    qkv_bias: bool = False      # Qwen2
    qk_norm: bool = False       # Qwen3
    tie_embeddings: bool = False
    #: hashable rope-scaling spec (see ``common._inv_freq``)
    rope_scaling: Optional[tuple] = None
    #: causal sliding-window size (Mistral-7B: 4096, Phi-3-mini-4k: 2047);
    #: None = full causal attention
    sliding_window: Optional[int] = None
    dtype: str = "float32"

    @property
    def hd(self):
        return self.head_dim or self.hidden_size // self.num_heads

    @classmethod
    def from_hf(cls, hf_config):
        """Build from a transformers Llama/Qwen2/Qwen3/Mistral/Phi-3 config."""
        mt = getattr(hf_config, "model_type", "llama")
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            intermediate_size=hf_config.intermediate_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            num_kv_heads=getattr(hf_config, "num_key_value_heads",
                                 hf_config.num_attention_heads),
            head_dim=getattr(hf_config, "head_dim", None),
            rope_theta=getattr(hf_config, "rope_theta", 10000.0),
            rms_eps=hf_config.rms_norm_eps,
            qkv_bias=(mt == "qwen2"),
            qk_norm=(mt == "qwen3"),
            tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
            rope_scaling=_rope_scaling_spec(
                getattr(hf_config, "rope_scaling", None), hf_config),
            sliding_window=_sliding_window_spec(hf_config),
        )


def _sliding_window_spec(hf_config):
    """The config's causal sliding window (Mistral, Phi-3, Mixtral). Qwen2/3's
    layered window (``use_sliding_window``) is refused, not ignored."""
    sw = getattr(hf_config, "sliding_window", None)
    if sw is None:
        return None
    mt = getattr(hf_config, "model_type", "llama")
    if mt in ("qwen2", "qwen3"):
        if getattr(hf_config, "use_sliding_window", False):
            raise ValueError(
                f"{mt} use_sliding_window=True (layered sliding window via "
                f"max_window_layers) is not supported yet")
        return None
    if mt in ("mistral", "phi3", "mixtral"):
        return int(sw)
    return None


def _rope_scaling_spec(rs, hf_config=None):
    """HF rope_scaling dict -> hashable tuple (linear, llama3, longrope/su,
    yarn; HF ``_compute_*_parameters``)."""
    if not rs:
        return None
    kind = rs.get("rope_type", rs.get("type"))
    if kind in (None, "default"):
        return None
    if kind == "linear":
        return ("linear", float(rs["factor"]))
    if kind == "llama3":
        return ("llama3", float(rs["factor"]),
                float(rs.get("low_freq_factor", 1.0)),
                float(rs.get("high_freq_factor", 4.0)),
                float(rs.get("original_max_position_embeddings", 8192)))
    if kind in ("longrope", "su"):
        old_ctx = rs.get("original_max_position_embeddings") or getattr(
            hf_config, "original_max_position_embeddings", None)
        max_ctx = getattr(hf_config, "max_position_embeddings", None)
        if old_ctx is None or max_ctx is None:
            raise ValueError("longrope scaling needs original/max position "
                             "embeddings in the HF config")
        af = rs.get("attention_factor", rs.get("attn_factor"))
        return ("longrope",
                tuple(float(f) for f in rs["short_factor"]),
                tuple(float(f) for f in rs["long_factor"]),
                float(old_ctx), float(max_ctx),
                float(af) if af is not None else None)
    if kind == "yarn":
        old_ctx = rs.get("original_max_position_embeddings") or getattr(
            hf_config, "original_max_position_embeddings", None) or getattr(
            hf_config, "max_position_embeddings", 4096)
        af = rs.get("attention_factor")
        return ("yarn", float(rs["factor"]),
                float(rs.get("beta_fast", 32.0)),
                float(rs.get("beta_slow", 1.0)),
                float(old_ctx),
                float(af) if af is not None else None)
    raise ValueError(f"unsupported rope scaling type: {kind}")


def _torch_dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def init_params(cfg: LlamaConfig, generator: torch.Generator, dtype=None,
                device=None, quantize_bits=None):
    """Random parameters (smoke runs and benchmarks), stacked over layers,
    drawn from ``generator`` (which must live on ``device``).

    ``quantize_bits`` (8, 4 or "nf4") quantizes each stacked projection
    right after drawing it, so the full-precision tree never coexists with
    the quantized one; embed, lm_head and norms stay full precision."""
    dtype = _torch_dtype(dtype or cfg.dtype)
    device = device if device is not None else generator.device
    L, D, I, hd = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.hd
    H, Hkv = cfg.num_heads, cfg.num_kv_heads

    def u(*shape):
        w = common.uniform_init(generator, shape, dtype=dtype, device=device)
        if quantize_bits and len(shape) >= 3:
            from lxt_tpu_torch.ops.quant import quantize
            w = quantize(w, quantize_bits)
        return w

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = {
        "ln1": ones(L, D), "ln2": ones(L, D),
        "wq": u(L, D, H * hd), "wk": u(L, D, Hkv * hd), "wv": u(L, D, Hkv * hd),
        "wo": u(L, H * hd, D),
        "wg": u(L, D, I), "wu": u(L, D, I), "wd": u(L, I, D),
    }
    if cfg.qkv_bias:
        layers.update(bq=zeros(L, H * hd), bk=zeros(L, Hkv * hd),
                      bv=zeros(L, Hkv * hd))
    if cfg.qk_norm:
        layers.update(q_norm=ones(L, hd), k_norm=ones(L, hd))
    params = {"embed": u(cfg.vocab_size, D), "final_norm": ones(D),
              "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = u(D, cfg.vocab_size)
    return params


def embed(params, input_ids):
    """The token embeddings (under tensor parallelism the table is split
    on the vocabulary: ``tensor_parallel.embedding``)."""
    return tensor_parallel.embedding(params["embed"], input_ids)


def forward(
    params,
    cfg: LlamaConfig,
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
    """Causal-LM forward. Returns :class:`ModelOutputs`.

    ``logits_at`` (optional int): compute logits only at this position —
    returns ``[B, 1, V]``. ``probes`` (optional ``[L, B, T, D]`` zeros) are
    added to each layer output; their gradients are the per-layer relevance
    hooks. Left-padded batches: ``attention_mask`` ([B, T] of 1/0, einsum
    path) or ``kv_begin`` ([B] first valid index, flash-eligible).
    ``layer_driver`` replaces the layer loop (``common.run_layers``;
    pipeline parallelism). Under tensor parallelism (an active
    ``ops.tensor_parallel`` group) ``params`` are this process's shards
    (``parallel.shard_params``) and the logits are gathered on the
    vocabulary."""
    positions, bias, kv_begin = common.padding_setup(
        attention_mask, kv_begin, positions, inputs_embeds.shape[1],
        inputs_embeds.device)
    h, hiddens = _run_layers(
        params["layers"], cfg, inputs_embeds, composite, probes=probes,
        output_hidden_states=output_hidden_states, remat=remat,
        positions=positions, bias=bias, kv_begin=kv_begin,
        attn_impl=attn_impl, layer_driver=layer_driver)
    logits = forward_head(params, cfg, h, composite, logits_at=logits_at)
    if output_hidden_states:
        hiddens = torch.cat([inputs_embeds[None], hiddens], dim=0)
    return ModelOutputs(logits=logits, hidden_states=hiddens)


def _run_layers(lp, cfg, inputs_embeds, composite, *, probes,
                output_hidden_states, remat, positions, bias, kv_begin,
                attn_impl, layer_driver=None):
    """The decoder layer stack (no embedding, final norm or lm_head)."""
    T = inputs_embeds.shape[1]
    act_fn = ACTIVATIONS[cfg.act]
    seq_len = T
    if attn_impl.partition("+")[0] == "ring":
        # T is this process's shard: longrope picks its factor schedule from
        # the global length, as the single-device run does (lxt_tpu passes
        # the shard's, ROADMAP F7)
        from lxt_tpu_torch.parallel.ring import ring_length
        seq_len = ring_length(T)
    rope = common.rope_tables(positions, cfg.hd, cfg.rope_theta,
                              rope_scaling=cfg.rope_scaling, seq_len=seq_len)
    scale = cfg.hd ** -0.5
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    probes = common.layer_probes(probes)

    def layer(h, i):
        comp = composite.for_layer(i, cfg.num_layers)

        def get(name):
            return lp[name][i] if name in lp else None

        x = tensor_parallel.copy(comp.rms_norm(h, lp["ln1"][i], cfg.rms_eps))
        q = common.split_heads(comp.linear(x, lp["wq"][i], get("bq"), site="wq"), H, hd)
        k = common.split_heads(comp.linear(x, lp["wk"][i], get("bk"), site="wk"), Hkv, hd)
        v = common.split_heads(comp.linear(x, lp["wv"][i], get("bv"), site="wv"), Hkv, hd)
        if cfg.qk_norm:
            q = comp.rms_norm(q, lp["q_norm"][i], cfg.rms_eps)
            k = comp.rms_norm(k, lp["k_norm"][i], cfg.rms_eps)
        attn = attention(q, k, v, causal=True, window=cfg.sliding_window,
                         bias=bias, composite=comp, rope=rope, scale=scale,
                         impl=attn_impl, kv_begin=kv_begin)
        h = h + comp.linear(common.merge_heads(attn), lp["wo"][i], site="wo",
                            row_parallel=True)
        x = tensor_parallel.copy(comp.rms_norm(h, lp["ln2"][i], cfg.rms_eps))
        g = comp.gated_mul(act_fn, comp.linear(x, lp["wg"][i], site="wg"),
                           comp.linear(x, lp["wu"][i], site="wu"))
        h = h + comp.linear(g, lp["wd"][i], site="wd", row_parallel=True)
        if probes is not None:
            h = h + probes[i]
        return h

    return common.run_layers(layer, inputs_embeds, cfg.num_layers, remat,
                             keep_hidden=output_hidden_states,
                             driver=layer_driver)


def forward_head(params, cfg, h, composite=composites.attnlrp, *,
                 logits_at=None):
    """Final norm + lm_head on a hidden state ``h`` (tied embeddings when
    there is no ``lm_head``)."""
    h = composite.rms_norm(h, params["final_norm"], cfg.rms_eps)
    if logits_at is not None:
        h = common.take_frontier(h, logits_at)
    return common.vocab_head(composite, h, params.get("lm_head"),
                             params["embed"])


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------

def params_from_hf(state_dict, cfg: LlamaConfig, dtype=torch.float32,
                   device="cuda", quant=None):
    """Convert an HF Llama/Qwen2/Qwen3/Mistral/Phi-3 ``state_dict`` (torch
    tensors, numpy arrays or an ``io.LazyState``) to the stacked parameter
    dict, layer by layer (``common.HFWeights``; ``quant`` quantizes the
    eligible projections as they are converted). Linear weights are
    transposed to ``[in, out]``; Phi-3's fused ``qkv_proj`` and
    ``gate_up_proj`` are split into the Llama layout."""
    hf = common.HFWeights(state_dict, dtype, device, quant=quant)
    pre = "model.layers.{}."
    leaves = {"ln1": hf.each(pre + "input_layernorm.weight"),
              "ln2": hf.each(pre + "post_attention_layernorm.weight"),
              "wo": hf.each(pre + "self_attn.o_proj.weight", transpose=True),
              "wd": hf.each(pre + "mlp.down_proj.weight", transpose=True)}
    if "model.layers.0.self_attn.qkv_proj.weight" in hf:
        # Phi-3: qkv_proj = [q; k; v], gate_up_proj = [gate; up]
        q_dim, kv_dim = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
        I = cfg.intermediate_size
        qkv = hf.each(pre + "self_attn.qkv_proj.weight", transpose=True)
        gu = hf.each(pre + "mlp.gate_up_proj.weight", transpose=True)
        leaves.update(
            wq=lambda i: qkv(i)[:, :q_dim],
            wk=lambda i: qkv(i)[:, q_dim:q_dim + kv_dim],
            wv=lambda i: qkv(i)[:, q_dim + kv_dim:],
            wg=lambda i: gu(i)[:, :I], wu=lambda i: gu(i)[:, I:])
    else:
        for ours, name in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                           ("wv", "self_attn.v_proj"), ("wg", "mlp.gate_proj"),
                           ("wu", "mlp.up_proj")):
            leaves[ours] = hf.each(pre + name + ".weight", transpose=True)
        if cfg.qkv_bias:
            for ours, name in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
                leaves[ours] = hf.each(pre + "self_attn." + name + ".bias")
        if cfg.qk_norm:
            leaves["q_norm"] = hf.each(pre + "self_attn.q_norm.weight")
            leaves["k_norm"] = hf.each(pre + "self_attn.k_norm.weight")
    params = {"embed": hf.tensor("model.embed_tokens.weight"),
              "final_norm": hf.tensor("model.norm.weight"),
              "layers": hf.stack(cfg.num_layers, leaves)}
    if not cfg.tie_embeddings and "lm_head.weight" in hf:
        params["lm_head"] = hf.tensor("lm_head.weight", lambda w: w.T)
    return params
