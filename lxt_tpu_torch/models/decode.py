"""KV-cached decoding for every ported causal family (Llama / Qwen /
Mistral / Phi-3, Gemma 3, GPT-2, Mixtral) — the counterpart of
``lxt_tpu/models/decode.py``.

The attribution forward is full-sequence; generation re-running it per
emitted token costs N whole-prefix forwards. Decoding splits it:

- ``*prefill`` runs one forward over the prompt (through ``attention``,
  so through K1 on the card when the call is eligible) and returns the
  frontier logits and the per-layer rotated K/V written into a cache
  ``{"k", "v"}`` of ``[L, B, Hkv, t_max, hd]``;
- ``*decode_step`` runs one token: each layer writes its K/V slot of the
  cache in place and attends over the visible slots in float32 (einsum,
  no kernel: a 1 × T attention row).

RoPE is applied before the attention here (the values of the fused path),
so the cache holds rotated keys. Each family has one layer block, shared
by its prefill and its step, which differ only in how the block attends;
the heads are the families' own ``forward_head``. ``counters`` counts the
steps and the host reads of the ``done`` flags that ``generate`` makes.
The blocks take the forwards' tensor-parallel ``copy`` / row-parallel
products, so under an active group the cache holds this process's kv
heads.
"""

import torch

from lxt_tpu_torch import composites
from lxt_tpu_torch.models import common, gemma3, gpt2, llama, mixtral
from lxt_tpu_torch.models.common import ACTIVATIONS
from lxt_tpu_torch.ops import tensor_parallel
from lxt_tpu_torch.ops.attention import attention

#: decode steps run and host reads of the ``done`` flags (one a step of a
#: generate with an ``eos_token_id``); :func:`reset_counters` zeroes them
counters = {"steps": 0, "done_reads": 0}


def reset_counters():
    for name in counters:
        counters[name] = 0


def _rope_at(positions, cfg, seq_len):
    """cos/sin for positions at a fixed total ``seq_len``: longrope picks
    its factor schedule from it, so it is the cache's capacity, not the
    frontier."""
    return common.rope_tables(positions, cfg.hd, cfg.rope_theta,
                              rope_scaling=cfg.rope_scaling, seq_len=seq_len)


def _pad_cache(kv, t_max):
    """The prefill's per-layer ``(k, v)`` ``[B, Hkv, T, hd]`` -> a cache of
    ``[L, B, Hkv, t_max, hd]`` each, zeros past T."""
    k0 = kv[0][0]
    B, Hkv, T, hd = k0.shape
    caches = {n: torch.zeros((len(kv), B, Hkv, t_max, hd), dtype=k0.dtype,
                             device=k0.device) for n in ("k", "v")}
    for i, (k, v) in enumerate(kv):
        caches["k"][i, :, :, :T] = k
        caches["v"][i, :, :, :T] = v
    return caches


def _append_and_read(caches, layer, t, k, v):
    """Write the ``[B, Hkv, 1, hd]`` K/V of layer ``layer`` into slot ``t``
    in place (no copy of the cache) and return the layer's slots up to
    ``t`` for the attend."""
    caches["k"][layer, :, :, t] = k[:, :, 0]
    caches["v"][layer, :, :, t] = v[:, :, 0]
    return caches["k"][layer, :, :, :t + 1], caches["v"][layer, :, :, :t + 1]


def _attend_1tok(q, ck, cv, valid, scale):
    """One query per row against cache slots: ``q [B, H, 1, hd]``, ``ck/cv
    [B, Hkv, Tc, hd]``, ``valid [B, Tc]``. Scores, softmax and the weighted
    sum in float32; returns ``[B, 1, H*hd]`` in q's dtype (head-major, as
    ``common.merge_heads``)."""
    B, H, _, hd = q.shape
    Hkv = ck.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, hd).float()
    scores = torch.einsum("bhgd,bhtd->bhgt", qg, ck.float()) * scale
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", probs, cv.float())
    return out.reshape(B, 1, H * hd).to(q.dtype)


def _causal_valid(t_max, t, kv_begin, window=None):
    """``[B, t_max]`` mask of the cache slots the frontier query at ``t``
    sees: ``kv_begin <= j <= t``, and ``j > t - window`` under a window."""
    j = torch.arange(t_max, device=kv_begin.device)[None]
    valid = (j >= kv_begin[:, None]) & (j <= t)
    if window is not None:
        valid &= j > t - window
    return valid


def _kv_begin_or_zeros(kv_begin, B, device):
    if kv_begin is None:
        return torch.zeros(B, dtype=torch.int32, device=device)
    return torch.as_tensor(kv_begin, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# the layer blocks: ``block(lp, cfg, comp, h, i, rope, attend) -> h``;
# ``attend(q, k, v)`` gets q and k rotated and returns [B, T, H*hd]
# ---------------------------------------------------------------------------

def _llama_block(lp, cfg, comp, h, i, rope, attend):
    """A Llama-family layer; Mixtral's (no biases or q/k norm, the mixture
    as its MLP) when the layer has a router."""
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd

    def get(name):
        return lp[name][i] if name in lp else None

    x = tensor_parallel.copy(comp.rms_norm(h, lp["ln1"][i], cfg.rms_eps))
    q = common.split_heads(comp.linear(x, lp["wq"][i], get("bq"), site="wq"), H, hd)
    k = common.split_heads(comp.linear(x, lp["wk"][i], get("bk"), site="wk"), Hkv, hd)
    v = common.split_heads(comp.linear(x, lp["wv"][i], get("bv"), site="wv"), Hkv, hd)
    if getattr(cfg, "qk_norm", False):
        q = comp.rms_norm(q, lp["q_norm"][i], cfg.rms_eps)
        k = comp.rms_norm(k, lp["k_norm"][i], cfg.rms_eps)
    q, k = common.apply_rope(q, k, *rope)
    h = h + comp.linear(attend(q, k, v), lp["wo"][i], site="wo",
                        row_parallel=True)
    x = comp.rms_norm(h, lp["ln2"][i], cfg.rms_eps)
    act_fn = ACTIVATIONS[cfg.act]
    if "w_router" in lp:
        moe = {n: lp[n][i] for n in ("w_router",) + mixtral.EXPERT_LEAVES}
        return h + mixtral.moe_block(x, moe, cfg, comp, act_fn)
    x = tensor_parallel.copy(x)
    g = comp.gated_mul(act_fn, comp.linear(x, lp["wg"][i], site="wg"),
                       comp.linear(x, lp["wu"][i], site="wu"))
    return h + comp.linear(g, lp["wd"][i], site="wd", row_parallel=True)


def _gemma_block(lp, cfg, comp, h, i, rope, attend):
    H, Hkv, hd, eps = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.rms_eps
    norm = gemma3.gemma_rms_norm
    x = tensor_parallel.copy(norm(h, lp["ln_in"][i], eps, comp))
    q = common.split_heads(comp.linear(x, lp["wq"][i], site="wq"), H, hd)
    k = common.split_heads(comp.linear(x, lp["wk"][i], site="wk"), Hkv, hd)
    v = common.split_heads(comp.linear(x, lp["wv"][i], site="wv"), Hkv, hd)
    q = norm(q, lp["q_norm"][i], eps, comp)
    k = norm(k, lp["k_norm"][i], eps, comp)
    q, k = common.apply_rope(q, k, *rope)
    out = comp.linear(attend(q, k, v), lp["wo"][i], site="wo", row_parallel=True)
    h = h + norm(out, lp["ln_post_attn"][i], eps, comp)
    x = tensor_parallel.copy(norm(h, lp["ln_pre_ff"][i], eps, comp))
    g = comp.gated_mul(ACTIVATIONS[cfg.act], comp.linear(x, lp["wg"][i], site="wg"),
                       comp.linear(x, lp["wu"][i], site="wu"))
    out = comp.linear(g, lp["wd"][i], site="wd", row_parallel=True)
    return h + norm(out, lp["ln_post_ff"][i], eps, comp)


def _gpt2_block(lp, cfg, comp, h, i, rope, attend):
    H, hd = cfg.num_heads, cfg.hd
    x = tensor_parallel.copy(
        comp.layer_norm(h, lp["ln1_w"][i], lp["ln1_b"][i], cfg.ln_eps))
    qkv = comp.linear(x, lp["w_attn"][i], lp["b_attn"][i], site="w_attn")
    q, k, v = (common.split_heads(t, H, hd) for t in qkv.chunk(3, dim=-1))
    h = h + comp.linear(attend(q, k, v), lp["w_proj"][i], lp["b_proj"][i],
                        site="w_proj", row_parallel=True)
    x = tensor_parallel.copy(
        comp.layer_norm(h, lp["ln2_w"][i], lp["ln2_b"][i], cfg.ln_eps))
    x = comp.act(ACTIVATIONS[cfg.act], comp.linear(x, lp["w_fc"][i], lp["b_fc"][i],
                                                   site="w_fc"))
    return h + comp.linear(x, lp["w_out"][i], lp["b_out"][i], site="w_out",
                           row_parallel=True)


# ---------------------------------------------------------------------------
# per family: ``layers(cfg, positions, t_max) -> i -> (rope, window,
# scale)`` and the embedding step (GPT-2 adds its learned positions)
# ---------------------------------------------------------------------------

def _llama_layers(cfg, positions, t_max):
    rope = _rope_at(positions, cfg, t_max)
    return lambda i: (rope, cfg.sliding_window, cfg.hd ** -0.5)


def _mixtral_layers(cfg, positions, t_max):
    rope = common.rope_tables(positions, cfg.hd, cfg.rope_theta)
    return lambda i: (rope, cfg.sliding_window, cfg.hd ** -0.5)


def _gemma_layers(cfg, positions, t_max):
    glob, local = gemma3.rope_table_pair(positions, cfg)
    sliding = gemma3.layer_sliding_flags(cfg)
    scale = cfg.query_pre_attn_scalar ** -0.5
    return lambda i: ((local, cfg.sliding_window, scale) if sliding[i]
                      else (glob, None, scale))


def _gpt2_layers(cfg, positions, t_max):
    return lambda i: (None, None, gpt2.layer_scale(cfg, i))


def _no_positions(params, h, positions):
    return h


def _gpt2_positions(params, h, positions):
    return h + params["wpe"][positions]


_FAMILIES = {
    "llama": (_llama_block, _llama_layers, _no_positions, llama.forward_head),
    "gemma3": (_gemma_block, _gemma_layers, _no_positions, gemma3.forward_head),
    "gpt2": (_gpt2_block, _gpt2_layers, _gpt2_positions, gpt2.forward_head),
    "mixtral": (_llama_block, _mixtral_layers, _no_positions, llama.forward_head),
}


def _prefill(family, params, cfg, inputs_embeds, t_max, kv_begin, composite):
    block, layers, add_positions, head = _FAMILIES[family]
    B, T, _ = inputs_embeds.shape
    positions, _, kv_begin = common.padding_setup(None, kv_begin, None, T,
                                                  inputs_embeds.device)
    h = add_positions(params, inputs_embeds, positions)
    at = layers(cfg, positions, t_max)
    kv = []
    for i in range(cfg.num_layers):
        rope, window, scale = at(i)

        def attend(q, k, v):
            kv.append((k, v))
            return common.merge_heads(attention(
                q, k, v, causal=True, window=window, composite=composite,
                scale=scale, kv_begin=kv_begin))

        h = block(params["layers"], cfg, composite, h, i, rope, attend)
    return head(params, cfg, h[:, T - 1:T], composite), _pad_cache(kv, t_max)


def _decode_step(family, params, cfg, tok_embeds, caches, t, kv_begin,
                 composite):
    block, layers, add_positions, head = _FAMILIES[family]
    B = tok_embeds.shape[0]
    t_max = caches["k"].shape[3]
    kv_begin = _kv_begin_or_zeros(kv_begin, B, tok_embeds.device)
    pos = torch.clamp(t - kv_begin, min=0)[:, None]                 # [B, 1]
    h = add_positions(params, tok_embeds, pos)
    at = layers(cfg, pos, t_max)
    valid = {}
    for i in range(cfg.num_layers):
        rope, window, scale = at(i)
        if window not in valid:
            valid[window] = _causal_valid(t_max, t, kv_begin, window)[:, :t + 1]

        def attend(q, k, v):
            ck, cv = _append_and_read(caches, i, t, k, v)
            return _attend_1tok(q, ck, cv, valid[window], scale)

        h = block(params["layers"], cfg, composite, h, i, rope, attend)
    counters["steps"] += 1
    return head(params, cfg, h, composite), caches


def prefill(params, cfg, inputs_embeds, t_max: int, *, kv_begin=None,
            composite=composites.attnlrp):
    """Llama family: the forward over the prompt ``inputs_embeds [B, T,
    D]``. Returns ``(logits [B, 1, V]`` at position T-1, the frontier that
    predicts the first new token, ``caches)``, the cache padded to
    ``t_max``. ``kv_begin [B]`` marks left padding."""
    return _prefill("llama", params, cfg, inputs_embeds, t_max, kv_begin,
                    composite)


def decode_step(params, cfg, tok_embeds, caches, t: int, *, kv_begin=None,
                composite=composites.attnlrp):
    """Llama family: one token at frontier index ``t``. ``tok_embeds [B, 1,
    D]`` embeds the token at position ``t``; its K/V go into the cache's
    slot ``t`` and its query attends over slots ``[kv_begin, t]`` (inside
    the window, if the config has one). Returns ``(logits [B, 1, V],
    caches)``."""
    return _decode_step("llama", params, cfg, tok_embeds, caches, t, kv_begin,
                        composite)


def gemma3_prefill(params, cfg, inputs_embeds, t_max: int, *, kv_begin=None,
                   composite=composites.attnlrp):
    """Gemma-3 counterpart of :func:`prefill`: per-layer local (windowed,
    local rope base) and global tables."""
    return _prefill("gemma3", params, cfg, inputs_embeds, t_max, kv_begin,
                    composite)


def gemma3_decode_step(params, cfg, tok_embeds, caches, t: int, *,
                       kv_begin=None, composite=composites.attnlrp):
    """Gemma-3 counterpart of :func:`decode_step`."""
    return _decode_step("gemma3", params, cfg, tok_embeds, caches, t, kv_begin,
                        composite)


def gpt2_prefill(params, cfg, inputs_embeds, t_max: int, *, kv_begin=None,
                 composite=composites.cp_lrp):
    """GPT-2 counterpart of :func:`prefill`: ``inputs_embeds`` are token
    embeddings, the learned positions are added here (from each row's
    ``kv_begin``)."""
    return _prefill("gpt2", params, cfg, inputs_embeds, t_max, kv_begin,
                    composite)


def gpt2_decode_step(params, cfg, tok_embeds, caches, t: int, *,
                     kv_begin=None, composite=composites.cp_lrp):
    """GPT-2 counterpart of :func:`decode_step` (position ``t - kv_begin``'s
    embedding added)."""
    return _decode_step("gpt2", params, cfg, tok_embeds, caches, t, kv_begin,
                        composite)


def mixtral_prefill(params, cfg, inputs_embeds, t_max: int, *, kv_begin=None,
                    composite=composites.attnlrp):
    """Mixtral counterpart of :func:`prefill`; the mixture is the forward's
    (``cfg.moe_impl``), so the cached path cannot diverge from the uncached
    one, and the config's sliding window applies."""
    return _prefill("mixtral", params, cfg, inputs_embeds, t_max, kv_begin,
                    composite)


def mixtral_decode_step(params, cfg, tok_embeds, caches, t: int, *,
                        kv_begin=None, composite=composites.attnlrp):
    """Mixtral counterpart of :func:`decode_step`."""
    return _decode_step("mixtral", params, cfg, tok_embeds, caches, t,
                        kv_begin, composite)
