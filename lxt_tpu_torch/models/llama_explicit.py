"""Llama assembled from EXPLICIT relevance-propagating ops (counterpart of
``lxt_tpu/models/llama_explicit.py``, after the reference's vendored
explicit Llama):

- linears -> ``lf.linear_epsilon`` (Eq. 8)
- RMSNorm -> ``lf.rms_norm_identity`` (Prop 3.4)
- RoPE    -> ``lf.add2`` / ``lf.mul2`` with detached cos/sin tables; the
             rotation's half swap passes relevance as a permutation (its
             negation is not a sign on relevance; ``lxt_tpu`` negates it,
             ROADMAP F11)
- q@k^T   -> ``lf.matmul`` + ``lf.mul2(., 1/sqrt(hd), 1)``
- softmax -> ``lf.softmax`` Deep-Taylor, float32 scores
- attn@v  -> ``lf.matmul`` (Prop 3.3)
- SiLU    -> identity rule; gate*up -> ``lf.mul2`` (uniform rule)
- residuals -> ``lf.add2``

The cotangent IS the relevance: seed the backward with the explained
logit's VALUE (:func:`explicit_input_relevance`) and the input cotangent is
the input relevance, with no final Gradient*Input contraction. The cp_lrp
composite blocks relevance through the softmax (q/k detached) and the gate
branch, with the epsilon rule at the products.

Attention is einsum with float32 scores, as in ``lxt_tpu``: the Deep-Taylor
softmax needs the probabilities, which no flash kernel returns. The rope
tables are cast to the activation dtype before the rotation (HF semantics,
and the efficient path's); in float32 that is ``lxt_tpu``'s arithmetic.
Layers run in a Python loop through ``common.run_layers`` (``remat``:
non-reentrant checkpointing). Parameters and config are those of
:mod:`lxt_tpu_torch.models.llama`, so a loaded checkpoint runs on either
path.
"""

import math

import torch
import torch.nn.functional as F

from lxt_tpu_torch import composites
from lxt_tpu_torch import explicit as ex
from lxt_tpu_torch.models import common
from lxt_tpu_torch.models.common import ModelOutputs
from lxt_tpu_torch.ops import functional as lf
from lxt_tpu_torch.ops.attention import repeat_kv


class _RotateHalf(torch.autograd.Function):
    """``rotate_half`` whose backward moves each half's relevance back as a
    permutation. Plain autodiff would negate the half that the forward
    negates, flipping the sign of that half's rotary relevance (a
    conservation leak); ``lxt_tpu``'s explicit Llama, after the reference,
    does that (ROADMAP F11)."""

    @staticmethod
    def forward(ctx, x):
        return common.rotate_half(x)

    @staticmethod
    def backward(ctx, rel):
        half = rel.shape[-1] // 2
        return torch.cat([rel[..., half:], rel[..., :half]], dim=-1)


def _rope(x, cos, sin):
    """One tensor's rotation through ``lf`` ops (tables detached)."""
    return lf.add2(lf.mul2(x, cos, 1), lf.mul2(_RotateHalf.apply(x), sin, 1))


def causal_bias(T, window, device):
    """The float32 ``[1, 1, T, T]`` additive mask (0 / -inf): key k visible
    to query q iff ``q - window < k <= q`` (no window: ``k <= q``)."""
    q = torch.arange(T, device=device)[:, None]
    k = torch.arange(T, device=device)[None, :]
    visible = k <= q
    if window is not None:
        visible = visible & (k > q - window)
    return torch.where(visible, 0.0, float("-inf"))[None, None]


def forward(
    params,
    cfg,
    inputs_embeds,
    composite: composites.Composite = composites.attnlrp,
    *,
    remat: bool = True,
    positions=None,
    probes=None,
):
    """Explicit-path forward: ``cfg`` / ``params`` as in ``models/llama.py``.

    ``probes``: optional zeros ``[L, B, T, D]`` added (a plain ``+``) to
    each layer's output; the cotangent at a probe IS the relevance at that
    layer output (the reference's backward hooks on its explicit Llama)."""
    T = inputs_embeds.shape[1]
    device, dt = inputs_embeds.device, inputs_embeds.dtype
    cp = composite.attention == "cp"
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=device)
    cos, sin = common.rope_tables(positions, cfg.hd, cfg.rope_theta,
                                  rope_scaling=cfg.rope_scaling, seq_len=T)
    cos, sin = (t.to(dt)[None, None] for t in (cos, sin))
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    inv_scale = 1.0 / math.sqrt(hd)
    silu_identity = ex.identity_rule_fn(F.silu)
    causal = causal_bias(T, cfg.sliding_window, device)
    lp = params["layers"]
    probes = common.layer_probes(probes)

    def get(name, i):
        return lp[name][i] if name in lp else None

    def layer(h, i):
        x = lf.rms_norm_identity(h, lp["ln1"][i], cfg.rms_eps)
        q = common.split_heads(lf.linear_epsilon(x, lp["wq"][i], get("bq", i)), H, hd)
        k = common.split_heads(lf.linear_epsilon(x, lp["wk"][i], get("bk", i)), Hkv, hd)
        v = common.split_heads(lf.linear_epsilon(x, lp["wv"][i], get("bv", i)), Hkv, hd)
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)
        k, v = repeat_kv(k, H // Hkv), repeat_kv(v, H // Hkv)
        if cp:
            # CP-LRP: no relevance through the softmax branch at all
            with torch.no_grad():
                scores = torch.matmul(q, k.transpose(-1, -2)).float() * inv_scale
                probs = torch.softmax(scores + causal, dim=-1)
            attn = ex.epsilon_rule(torch.matmul)(probs.to(v.dtype), v)
        else:
            scores = lf.mul2(lf.matmul(q, k.transpose(-1, -2)), inv_scale, 1)
            scores = lf.add2(scores.float(), causal)
            probs = lf.softmax(scores, -1).to(v.dtype)
            attn = lf.matmul(probs, v)   # UniformEpsilonRule(n=2) == Prop 3.3
        h = lf.add2(h, lf.linear_epsilon(common.merge_heads(attn), lp["wo"][i]))

        x = lf.rms_norm_identity(h, lp["ln2"][i], cfg.rms_eps)
        if cp:
            g = F.silu(lf.linear_epsilon(x, lp["wg"][i]).detach())
            prod = ex.epsilon_rule(torch.mul)(g, lf.linear_epsilon(x, lp["wu"][i]))
        else:
            g = silu_identity(lf.linear_epsilon(x, lp["wg"][i]))
            prod = lf.mul2(g, lf.linear_epsilon(x, lp["wu"][i]))
        h = lf.add2(h, lf.linear_epsilon(prod, lp["wd"][i]))
        if probes is not None:
            # a plain add: the cotangent passes through unchanged, so the
            # probe's cotangent equals the relevance at this layer output
            h = h + probes[i]
        return h

    h, _ = common.run_layers(layer, inputs_embeds, cfg.num_layers, remat)
    h = lf.rms_norm_identity(h, params["final_norm"], cfg.rms_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return ModelOutputs(logits=lf.linear_epsilon(h, head))


def _leaf(t):
    return t.detach().requires_grad_(True)


def explicit_input_relevance(target_fn, inputs_embeds):
    """Explicit-path attribution: one backward seeded with the target's
    VALUE (the reference's ``max_logit.backward(max_logit)``). The input
    cotangent IS the relevance, summed over features: returns
    ``(value, relevance [B, T] float32)``. A target summed over a batch
    seeds every row with the total, so row b's map is its own LRP map
    scaled by ``value / (row b's logit)``."""
    x = _leaf(inputs_embeds)
    with torch.enable_grad():
        value = target_fn(x)
        (rel,) = torch.autograd.grad(value, x, value.detach())
    return value.detach(), rel.float().sum(-1)


def explicit_latent_relevance(forward_fn, inputs_embeds, probe_shape):
    """Explicit-path latent relevance: per-layer relevance taps in the same
    backward as the input relevance (the cotangent at each probe IS the
    relevance at that layer output).

    ``forward_fn(embeds, probes) -> scalar target``. Returns ``(value,
    input_rel [B, T], latent_rel [L, B, T])``, features summed, float32."""
    x = _leaf(inputs_embeds)
    probes = torch.zeros(probe_shape, dtype=x.dtype, device=x.device,
                         requires_grad=True)
    with torch.enable_grad():
        value = forward_fn(x, probes)
        rel_in, rel_latent = torch.autograd.grad(value, (x, probes),
                                                 value.detach())
    return value.detach(), rel_in.float().sum(-1), rel_latent.float().sum(-1)
