"""GPT-2 assembled from EXPLICIT relevance-propagating ops (counterpart of
``lxt_tpu/models/gpt2_explicit.py``, after the rule placement of the
reference's vendored explicit GPT-2):

- Conv1D      -> ``lf.add2(bias, lf.linear_epsilon(x, W))`` (W ``[in, out]``)
- wte + wpe   -> ``lf.add2`` with DETACHED position embeddings
- LayerNorm   -> ``lf.layer_norm`` (std detached)
- q@k^T       -> ``lf.matmul`` + ``lf.mul2(., 1/sqrt(hd), 1)``; the
                 ``scale_attn_by_inverse_layer_idx`` factor is a second
                 ``lf.mul2``
- causal mask -> ``where(mask, scores, finfo(float32).min)`` (a select, not
                 an additive mask)
- softmax     -> ``lf.softmax`` Deep-Taylor (attnlrp) or a full stop (cp_lrp)
- probs @ v   -> ``lf.matmul`` (attnlrp) or the epsilon rule with detached
                 probabilities (cp_lrp)
- GELU        -> identity rule
- residuals   -> ``lf.add2``

``reorder_and_upcast_attn`` computes the scores as ``lf.baddbmm(0, q *
scale, k^T)`` in float32, the scale folded in by ``lf.mul2(., scale, 1)``
so the q branch's relevance is that of the plain path.

The cotangent IS the relevance: seed the backward with the explained
logit's VALUE (:func:`lxt_tpu_torch.models.llama_explicit.explicit_input_relevance`).
Attention is einsum with float32 scores; layers run through
``common.run_layers``. Parameters and config are those of
:mod:`lxt_tpu_torch.models.gpt2`.
"""

import torch

from lxt_tpu_torch import composites
from lxt_tpu_torch import explicit as ex
from lxt_tpu_torch.models import common
from lxt_tpu_torch.models.common import ModelOutputs
from lxt_tpu_torch.ops import functional as lf


def forward(
    params,
    cfg,
    inputs_embeds,
    composite: composites.Composite = composites.cp_lrp,
    *,
    position_embeds=None,
    remat: bool = True,
):
    """Explicit-path forward on token embeddings ``[B, T, D]`` (the
    position embeddings are added here, detached). ``cfg`` / ``params`` as
    in ``models/gpt2.py``."""
    T, D = inputs_embeds.shape[1:]
    device = inputs_embeds.device
    cp = composite.attention == "cp"
    H, hd = cfg.num_heads, cfg.hd
    act_identity = ex.identity_rule_fn(common.ACTIVATIONS[cfg.act])
    mask_value = torch.finfo(torch.float32).min
    causal = torch.ones(T, T, dtype=torch.bool, device=device).tril()[None, None]
    if position_embeds is None:
        position_embeds = params["wpe"][:T]
    h = lf.add2(inputs_embeds, position_embeds.detach().to(inputs_embeds.dtype))
    lp = params["layers"]

    def conv1d(x, w, b):
        # HF Conv1D keeps weights [in, out]: the epsilon rule on the
        # product, an epsilon-add of the bias
        return lf.add2(b, lf.linear_epsilon(x, w))

    def scale_for(i):
        scale = hd ** -0.5
        if cfg.scale_attn_by_inverse_layer_idx:
            scale = scale / (i + 1.0)
        return scale

    def attn_scores(q, k, i):
        if cfg.reorder_and_upcast_attn:
            # the scale folded in before the batched product, float32
            # throughout; lf.mul2(., scale, 1) passes the q branch's
            # relevance unchanged (a bare q * scale would scale it)
            zero = torch.zeros((), dtype=torch.float32, device=device)
            qs = lf.mul2(q, scale_for(i), 1)
            return lf.baddbmm(zero, qs.float(), k.transpose(-1, -2).float())
        s = lf.mul2(lf.matmul(q, k.transpose(-1, -2)), hd ** -0.5, 1)
        if cfg.scale_attn_by_inverse_layer_idx:
            s = lf.mul2(s, 1.0 / (i + 1.0), 1)
        return s

    def layer(h, i):
        x = lf.layer_norm(h, lp["ln1_w"][i], lp["ln1_b"][i], cfg.ln_eps)
        qkv = conv1d(x, lp["w_attn"][i], lp["b_attn"][i])
        q, k, v = (common.split_heads(t, H, hd) for t in qkv.split(D, dim=-1))
        if cp:
            # CP-LRP: no relevance through the softmax branch at all
            with torch.no_grad():
                scores = torch.matmul(q, k.transpose(-1, -2)).float() * scale_for(i)
                probs = torch.softmax(
                    torch.where(causal, scores, mask_value), dim=-1)
            attn = ex.epsilon_rule(torch.matmul)(probs.to(v.dtype), v)
        else:
            scores = torch.where(causal, attn_scores(q, k, i).float(), mask_value)
            probs = lf.softmax(scores, -1).to(v.dtype)
            attn = lf.matmul(probs, v)   # UniformEpsilonRule == Prop 3.3
        h = lf.add2(conv1d(common.merge_heads(attn), lp["w_proj"][i],
                           lp["b_proj"][i]), h)
        x = lf.layer_norm(h, lp["ln2_w"][i], lp["ln2_b"][i], cfg.ln_eps)
        x = act_identity(conv1d(x, lp["w_fc"][i], lp["b_fc"][i]))
        return lf.add2(h, conv1d(x, lp["w_out"][i], lp["b_out"][i]))

    h, _ = common.run_layers(layer, h, cfg.num_layers, remat)
    h = lf.layer_norm(h, params["lnf_w"], params["lnf_b"], cfg.ln_eps)
    return ModelOutputs(logits=lf.linear_epsilon(h, params["wte"].T))
