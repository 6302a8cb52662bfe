"""GPT-2 with LRP-aware forward — the counterpart of
``lxt_tpu/models/gpt2.py``.

The identity rule on the MLP's ``gelu_new``, LayerNorm with a stop-gradded
standard deviation, the attention rule at q/k/v; CP-LRP is the default
composite (the reference's recommendation for GPT-2: negative logits break
AttnLRP's softmax bias handling). HF's layout is kept: Conv1D weights are
already ``[in, out]``, the head is tied to ``wte``, positions are learned
embeddings added before the first layer. Attention has no rotary
embedding, so the flash kernels run without the rotation pass.
"""

import dataclasses

import numpy as np
import torch

from lxt_tpu_torch import composites
from lxt_tpu_torch.models import common
from lxt_tpu_torch.models.common import ACTIVATIONS, ModelOutputs
from lxt_tpu_torch.ops import tensor_parallel
from lxt_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 1024
    ln_eps: float = 1e-5
    act: str = "gelu_new"
    scale_attn_by_inverse_layer_idx: bool = False
    #: HF's flag for float32 scores with the scale folded in before the
    #: product: the attention here always computes its scores in float32
    #: with the scale applied after the product, the same operator in
    #: float32 (see ``lxt_tpu.models.gpt2.GPT2Config``)
    reorder_and_upcast_attn: bool = False

    @property
    def hd(self):
        return self.hidden_size // self.num_heads

    @classmethod
    def from_hf(cls, hf_config):
        """Build from a transformers ``GPT2Config`` (or a namespace with
        its attributes)."""
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.n_embd,
            num_layers=hf_config.n_layer,
            num_heads=hf_config.n_head,
            max_positions=hf_config.n_positions,
            ln_eps=hf_config.layer_norm_epsilon,
            scale_attn_by_inverse_layer_idx=getattr(
                hf_config, "scale_attn_by_inverse_layer_idx", False),
            reorder_and_upcast_attn=getattr(
                hf_config, "reorder_and_upcast_attn", False),
        )


def init_params(cfg: GPT2Config, generator: torch.Generator,
                dtype=torch.float32, device=None):
    """Random parameters (smoke runs and benchmarks), stacked over layers,
    drawn from ``generator`` (which must live on ``device``); norms at 1
    and biases at 0."""
    device = device if device is not None else generator.device
    L, D = cfg.num_layers, cfg.hidden_size

    def u(*shape):
        return common.uniform_init(generator, shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = {
        "ln1_w": ones(L, D), "ln1_b": zeros(L, D),
        "ln2_w": ones(L, D), "ln2_b": zeros(L, D),
        "w_attn": u(L, D, 3 * D), "b_attn": zeros(L, 3 * D),
        "w_proj": u(L, D, D), "b_proj": zeros(L, D),
        "w_fc": u(L, D, 4 * D), "b_fc": zeros(L, 4 * D),
        "w_out": u(L, 4 * D, D), "b_out": zeros(L, D),
    }
    return {"wte": u(cfg.vocab_size, D), "wpe": u(cfg.max_positions, D),
            "lnf_w": ones(D), "lnf_b": zeros(D), "layers": layers}


def embed(params, input_ids, positions=None):
    """``(token embeddings, position embeddings)``; attribution is with
    respect to the first, and the forward adds the second."""
    if positions is None:
        positions = torch.arange(input_ids.shape[-1], device=input_ids.device)
    return (tensor_parallel.embedding(params["wte"], input_ids),
            params["wpe"][positions])


def layer_scale(cfg: GPT2Config, i):
    """Layer ``i``'s attention scale: ``hd ** -0.5``, divided by ``i + 1``
    under ``scale_attn_by_inverse_layer_idx``, in float32 as ``lxt_tpu``
    computes it."""
    scale = np.float32(cfg.hd ** -0.5)
    if cfg.scale_attn_by_inverse_layer_idx:
        scale = scale / np.float32(i + 1)
    return float(scale)


def forward(
    params,
    cfg: GPT2Config,
    inputs_embeds,
    composite: composites.Composite = composites.cp_lrp,
    *,
    position_embeds=None,
    probes=None,
    output_hidden_states: bool = False,
    remat: bool = True,
    attention_mask=None,
    kv_begin=None,
    attn_impl: str = "auto",
    logits_at=None,
    layer_driver=None,
):
    """Causal-LM forward on token embeddings ``[B, T, D]``; the position
    embeddings are added here (``position_embeds`` replaces them, e.g. to
    attribute them too). Left padding as in ``llama.forward``; the default
    composite is CP-LRP. Returns :class:`ModelOutputs`."""
    T = inputs_embeds.shape[1]
    positions, bias, kv_begin = common.padding_setup(
        attention_mask, kv_begin, None, T, inputs_embeds.device)
    if position_embeds is None:
        position_embeds = params["wpe"][positions]
    h0 = inputs_embeds + position_embeds
    act_fn = ACTIVATIONS[cfg.act]
    H, hd = cfg.num_heads, cfg.hd
    lp = params["layers"]
    probes = common.layer_probes(probes)

    def layer(h, i):
        comp = composite.for_layer(i, cfg.num_layers)
        x = tensor_parallel.copy(
            comp.layer_norm(h, lp["ln1_w"][i], lp["ln1_b"][i], cfg.ln_eps))
        qkv = comp.linear(x, lp["w_attn"][i], lp["b_attn"][i], site="w_attn")
        # q | k | v, each this process's heads under tensor parallelism
        q, k, v = (common.split_heads(t, H, hd) for t in qkv.chunk(3, dim=-1))
        attn = attention(q, k, v, causal=True, bias=bias, composite=comp,
                         scale=layer_scale(cfg, i), impl=attn_impl,
                         kv_begin=kv_begin)
        h = h + comp.linear(common.merge_heads(attn), lp["w_proj"][i],
                            lp["b_proj"][i], site="w_proj", row_parallel=True)
        x = tensor_parallel.copy(
            comp.layer_norm(h, lp["ln2_w"][i], lp["ln2_b"][i], cfg.ln_eps))
        x = comp.act(act_fn, comp.linear(x, lp["w_fc"][i], lp["b_fc"][i],
                                         site="w_fc"))
        h = h + comp.linear(x, lp["w_out"][i], lp["b_out"][i], site="w_out",
                            row_parallel=True)
        if probes is not None:
            h = h + probes[i]
        return h

    h, hiddens = common.run_layers(layer, h0, cfg.num_layers, remat,
                                   keep_hidden=output_hidden_states,
                                   driver=layer_driver)
    logits = forward_head(params, cfg, h, composite, logits_at=logits_at)
    if output_hidden_states:
        hiddens = torch.cat([h0[None], hiddens], dim=0)
    return ModelOutputs(logits=logits, hidden_states=hiddens)


def forward_head(params, cfg: GPT2Config, h, composite=composites.cp_lrp, *,
                 logits_at=None):
    """Final LayerNorm + the head tied to ``wte`` on a hidden state ``h``."""
    h = composite.layer_norm(h, params["lnf_w"], params["lnf_b"], cfg.ln_eps)
    if logits_at is not None:
        h = common.take_frontier(h, logits_at)
    return common.vocab_head(composite, h, None, params["wte"], site="wte")


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------

def params_from_hf(state_dict, cfg: GPT2Config, dtype=torch.float32,
                   device="cuda", quant=None):
    """Convert an HF ``GPT2LMHeadModel`` (or ``GPT2Model``) state dict, with
    or without the ``transformer.`` prefix, to the stacked parameter dict,
    layer by layer (``common.HFWeights``; ``quant`` quantizes the eligible
    projections as they are converted). HF's Conv1D weights are already
    ``[in, out]``: no transpose."""
    root = "transformer." if any(k.startswith("transformer.")
                                 for k in state_dict) else ""
    hf = common.HFWeights(state_dict, dtype, device, prefix=root, quant=quant)
    leaves = {ours: hf.each("h.{}." + name) for ours, name in (
        ("ln1_w", "ln_1.weight"), ("ln1_b", "ln_1.bias"),
        ("ln2_w", "ln_2.weight"), ("ln2_b", "ln_2.bias"),
        ("w_attn", "attn.c_attn.weight"), ("b_attn", "attn.c_attn.bias"),
        ("w_proj", "attn.c_proj.weight"), ("b_proj", "attn.c_proj.bias"),
        ("w_fc", "mlp.c_fc.weight"), ("b_fc", "mlp.c_fc.bias"),
        ("w_out", "mlp.c_proj.weight"), ("b_out", "mlp.c_proj.bias"))}
    return {"wte": hf.tensor("wte.weight"), "wpe": hf.tensor("wpe.weight"),
            "lnf_w": hf.tensor("ln_f.weight"), "lnf_b": hf.tensor("ln_f.bias"),
            "layers": hf.stack(cfg.num_layers, leaves)}
