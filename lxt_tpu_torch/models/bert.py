"""BERT with LRP-aware forward (encoder + sequence-classification head) —
the counterpart of ``lxt_tpu/models/bert.py``.

The rules are the reference's: the attention rule at q/k/v (AttnLRP: q, k
/4, v /2), the identity rule on the intermediate GELU and the pooler's
tanh, LayerNorm with a stop-gradded standard deviation, dropout off.

Attention is bidirectional. Right-padded batches (the HF convention) pass
``kv_end`` ([B] real tokens per row), which the flash kernels take as a
structural mask; an arbitrary ``attention_mask`` becomes an additive bias
on the einsum path.
"""

import dataclasses

import torch

from lxt_tpu_torch import composites
from lxt_tpu_torch.models import common
from lxt_tpu_torch.models.common import ACTIVATIONS, ModelOutputs
from lxt_tpu_torch.ops import tensor_parallel
from lxt_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 512
    type_vocab_size: int = 2
    ln_eps: float = 1e-12
    act: str = "gelu_exact"
    num_labels: int = 2

    @property
    def hd(self):
        return self.hidden_size // self.num_heads

    @classmethod
    def from_hf(cls, hf_config, num_labels=None):
        """Build from a transformers ``BertConfig`` (or a namespace with its
        attributes)."""
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            intermediate_size=hf_config.intermediate_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            max_positions=hf_config.max_position_embeddings,
            type_vocab_size=hf_config.type_vocab_size,
            ln_eps=hf_config.layer_norm_eps,
            num_labels=num_labels or getattr(hf_config, "num_labels", 2),
        )


def init_params(cfg: BertConfig, generator: torch.Generator,
                dtype=torch.float32, device=None):
    """Random parameters (smoke runs and benchmarks), stacked over layers,
    drawn from ``generator`` (which must live on ``device``); LayerNorm
    weights at 1 and biases at 0."""
    device = device if device is not None else generator.device
    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size

    def u(*shape):
        return common.uniform_init(generator, shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = {
        "wq": u(L, D, D), "bq": zeros(L, D), "wk": u(L, D, D), "bk": zeros(L, D),
        "wv": u(L, D, D), "bv": zeros(L, D), "wo": u(L, D, D), "bo": zeros(L, D),
        "ln1_w": ones(L, D), "ln1_b": zeros(L, D),
        "wi": u(L, D, I), "bi": zeros(L, I), "wout": u(L, I, D), "bout": zeros(L, D),
        "ln2_w": ones(L, D), "ln2_b": zeros(L, D),
    }
    return {
        "word_emb": u(cfg.vocab_size, D), "pos_emb": u(cfg.max_positions, D),
        "type_emb": u(cfg.type_vocab_size, D),
        "emb_ln_w": ones(D), "emb_ln_b": zeros(D),
        "pooler_w": u(D, D), "pooler_b": zeros(D),
        "cls_w": u(D, cfg.num_labels), "cls_b": zeros(cfg.num_labels),
        "layers": layers,
    }


def embed(params, input_ids):
    """Word embeddings only, the attribution input: the position and type
    embeddings and the embedding LayerNorm are applied inside
    :func:`forward` (HF's ``inputs_embeds`` semantics)."""
    return params["word_emb"][input_ids]


def attention_bias_from_mask(attention_mask, dtype=torch.float32):
    """HF-style ``[B, T]`` 1/0 mask -> additive ``[B, 1, 1, T]`` bias."""
    mask = torch.as_tensor(attention_mask)
    return torch.where(mask[:, None, None, :] > 0, 0.0, float("-inf")).to(dtype)


def forward(
    params,
    cfg: BertConfig,
    inputs_embeds,
    composite: composites.Composite = composites.attnlrp,
    *,
    attention_mask=None,
    kv_end=None,
    token_type_ids=None,
    probes=None,
    output_hidden_states: bool = False,
    remat: bool = True,
    attn_impl: str = "auto",
    layer_driver=None,
):
    """Classification forward: ``logits [B, num_labels]`` from the pooled
    ``[CLS]`` state. ``hidden_states`` (when requested) is ``[L+1, B, T,
    D]``: the embedding LayerNorm's output, then each layer's. Right
    padding: ``kv_end`` keeps the flash kernels eligible; an
    ``attention_mask`` takes the einsum path."""
    T = inputs_embeds.shape[1]
    device = inputs_embeds.device
    act_fn = ACTIVATIONS[cfg.act]
    type_e = (params["type_emb"][0] if token_type_ids is None
              else params["type_emb"][torch.as_tensor(token_type_ids, device=device)])
    h = inputs_embeds + params["pos_emb"][:T] + type_e
    h = composite.layer_norm(h, params["emb_ln_w"], params["emb_ln_b"], cfg.ln_eps)
    inputs_post = h

    bias = None
    if attention_mask is not None:
        if kv_end is not None:
            raise ValueError("pass attention_mask OR kv_end, not both")
        bias = attention_bias_from_mask(
            torch.as_tensor(attention_mask, device=device), h.dtype)
    if kv_end is not None:
        kv_end = torch.as_tensor(kv_end, dtype=torch.int32, device=device)
    H, hd = cfg.num_heads, cfg.hd
    lp = params["layers"]
    probes = common.layer_probes(probes)

    def layer(h, i):
        comp = composite.for_layer(i, cfg.num_layers)
        x = tensor_parallel.copy(h)
        q = common.split_heads(comp.linear(x, lp["wq"][i], lp["bq"][i], site="wq"), H, hd)
        k = common.split_heads(comp.linear(x, lp["wk"][i], lp["bk"][i], site="wk"), H, hd)
        v = common.split_heads(comp.linear(x, lp["wv"][i], lp["bv"][i], site="wv"), H, hd)
        attn = attention(q, k, v, bias=bias, composite=comp, impl=attn_impl,
                         kv_end=kv_end)
        a = comp.linear(common.merge_heads(attn), lp["wo"][i], lp["bo"][i],
                        site="wo", row_parallel=True)
        h = comp.layer_norm(h + a, lp["ln1_w"][i], lp["ln1_b"][i], cfg.ln_eps)
        x = comp.act(act_fn, comp.linear(tensor_parallel.copy(h), lp["wi"][i],
                                         lp["bi"][i], site="wi"))
        x = comp.linear(x, lp["wout"][i], lp["bout"][i], site="wout",
                        row_parallel=True)
        h = comp.layer_norm(h + x, lp["ln2_w"][i], lp["ln2_b"][i], cfg.ln_eps)
        if probes is not None:
            h = h + probes[i]
        return h

    h, hiddens = common.run_layers(layer, inputs_post, cfg.num_layers, remat,
                                   keep_hidden=output_hidden_states,
                                   driver=layer_driver)
    pooled = composite.act(torch.tanh, composite.linear(
        h[:, 0], params["pooler_w"], params["pooler_b"], site="pooler_w"))
    logits = composite.linear(pooled, params["cls_w"], params["cls_b"], site="cls_w")
    if output_hidden_states:
        hiddens = torch.cat([inputs_post[None], hiddens], dim=0)
    return ModelOutputs(logits=logits, hidden_states=hiddens)


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------

def params_from_hf(state_dict, cfg: BertConfig, dtype=torch.float32,
                   device="cuda", quant=None):
    """Convert HF ``BertForSequenceClassification`` weights (torch tensors,
    numpy arrays or an ``io.LazyState``) to the stacked parameter dict,
    layer by layer (``common.HFWeights``; ``quant`` quantizes the eligible
    stacked projections as they are converted); linear weights are
    transposed to ``[in, out]``."""
    hf = common.HFWeights(state_dict, dtype, device, quant=quant)
    pre = "bert.encoder.layer.{}."
    leaves = {}
    for ours, name in (("q", "attention.self.query"), ("k", "attention.self.key"),
                       ("v", "attention.self.value"), ("o", "attention.output.dense"),
                       ("i", "intermediate.dense"), ("out", "output.dense")):
        leaves["w" + ours] = hf.each(pre + name + ".weight", transpose=True)
        leaves["b" + ours] = hf.each(pre + name + ".bias")
    for ours, name in (("ln1", "attention.output.LayerNorm"),
                       ("ln2", "output.LayerNorm")):
        leaves[ours + "_w"] = hf.each(pre + name + ".weight")
        leaves[ours + "_b"] = hf.each(pre + name + ".bias")
    emb = "bert.embeddings."
    return {
        "word_emb": hf.tensor(emb + "word_embeddings.weight"),
        "pos_emb": hf.tensor(emb + "position_embeddings.weight"),
        "type_emb": hf.tensor(emb + "token_type_embeddings.weight"),
        "emb_ln_w": hf.tensor(emb + "LayerNorm.weight"),
        "emb_ln_b": hf.tensor(emb + "LayerNorm.bias"),
        "pooler_w": hf.tensor("bert.pooler.dense.weight", lambda w: w.T),
        "pooler_b": hf.tensor("bert.pooler.dense.bias"),
        "cls_w": hf.tensor("classifier.weight", lambda w: w.T),
        "cls_b": hf.tensor("classifier.bias"),
        "layers": hf.stack(cfg.num_layers, leaves),
    }
