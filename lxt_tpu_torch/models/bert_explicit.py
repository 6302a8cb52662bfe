"""BERT encoder assembled from EXPLICIT relevance-propagating ops
(counterpart of ``lxt_tpu/models/bert_explicit.py``, after the reference's
vendored explicit BERT and its LayerNormEpsilon-everywhere composite):

- nn.Linear           -> ``lf.linear_epsilon``
- GELU / tanh         -> identity rule
- LayerNorm           -> ``lf.layer_norm`` (std detached)
- embeddings          -> ``lf.add2`` of the word embeddings, the DETACHED
                         type embeddings and the position embeddings
- attention           -> ``lf.matmul`` scores, ``lf.mul2(., 1/sqrt(hd), 1)``,
                         ``lf.add2`` of the mask bias, ``lf.softmax``
                         Deep-Taylor, ``lf.matmul`` probs @ v
- residual + LN       -> ``lf.layer_norm(lf.add2(x, res))``
- pooler / classifier -> dense + tanh identity on [CLS], dense head

The cotangent IS the relevance: seed the backward with the explained
logit's VALUE (:func:`lxt_tpu_torch.models.llama_explicit.explicit_input_relevance`).
Attention is einsum with float32 scores; layers run through
``common.run_layers``. Parameters and config are those of
:mod:`lxt_tpu_torch.models.bert`.
"""

import math

import torch

from lxt_tpu_torch import explicit as ex
from lxt_tpu_torch.models import common
from lxt_tpu_torch.models.common import ModelOutputs
from lxt_tpu_torch.ops import functional as lf


def forward(
    params,
    cfg,
    inputs_embeds,
    *,
    attention_mask=None,
    token_type_ids=None,
    remat: bool = True,
):
    """Explicit-path classification forward: ``cfg`` / ``params`` as in
    ``models/bert.py``; returns logits ``[B, num_labels]``.
    ``attention_mask`` ``[B, T]`` of 1/0 masks keys by an additive -inf
    bias."""
    B, T, D = inputs_embeds.shape
    device = inputs_embeds.device
    H, hd = cfg.num_heads, cfg.hd
    gelu_identity = ex.identity_rule_fn(common.ACTIVATIONS[cfg.act])
    tanh_identity = ex.identity_rule_fn(torch.tanh)
    inv_scale = 1.0 / math.sqrt(hd)

    # the type embeddings detached, the position embeddings taking their
    # share of the epsilon split, then the embedding LayerNorm
    if token_type_ids is None:
        token_type_ids = torch.zeros((B, T), dtype=torch.long, device=device)
    type_emb = params["type_emb"][torch.as_tensor(token_type_ids, device=device)]
    pos_emb = params["pos_emb"][:T][None].expand(B, T, D)
    h = lf.add2(lf.add2(inputs_embeds, type_emb.detach()), pos_emb)
    h = lf.layer_norm(h, params["emb_ln_w"], params["emb_ln_b"], cfg.ln_eps)

    bias = None
    if attention_mask is not None:
        mask = torch.as_tensor(attention_mask, device=device)
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, float("-inf"))
    lp = params["layers"]

    def layer(h, i):
        q = common.split_heads(lf.linear_epsilon(h, lp["wq"][i], lp["bq"][i]), H, hd)
        k = common.split_heads(lf.linear_epsilon(h, lp["wk"][i], lp["bk"][i]), H, hd)
        v = common.split_heads(lf.linear_epsilon(h, lp["wv"][i], lp["bv"][i]), H, hd)
        scores = lf.mul2(lf.matmul(q, k.transpose(-1, -2)), inv_scale, 1)
        if bias is not None:
            scores = lf.add2(scores.float(), bias)
        probs = lf.softmax(scores, -1).to(v.dtype)
        attn = common.merge_heads(lf.matmul(probs, v))
        x = lf.linear_epsilon(attn, lp["wo"][i], lp["bo"][i])
        h = lf.layer_norm(lf.add2(x, h), lp["ln1_w"][i], lp["ln1_b"][i], cfg.ln_eps)
        x = gelu_identity(lf.linear_epsilon(h, lp["wi"][i], lp["bi"][i]))
        x = lf.linear_epsilon(x, lp["wout"][i], lp["bout"][i])
        return lf.layer_norm(lf.add2(x, h), lp["ln2_w"][i], lp["ln2_b"][i], cfg.ln_eps)

    h, _ = common.run_layers(layer, h, cfg.num_layers, remat)
    pooled = tanh_identity(
        lf.linear_epsilon(h[:, 0], params["pooler_w"], params["pooler_b"]))
    return ModelOutputs(
        logits=lf.linear_epsilon(pooled, params["cls_w"], params["cls_b"]))
