"""KV-cached decoding (lxt_tpu_torch.models.decode, AttributionModel.generate)
and the response attributions against lxt_tpu, on CPU.

At tests/test_decode.py's tiny sizes, every family and variant it covers
(GQA, qkv_bias, qk_norm, a sliding window, tied embeddings, int8 weights;
Gemma-3's local/global layers, GPT-2, Mixtral), each on the same numpy
weights in both packages: the port's greedy tokens, cached and uncached,
equal lxt_tpu's on a batch with one left-padded row (and HF's generate
where tests/test_decode.py compares with it); the prefill and step logits
equal lxt_tpu.models.decode's and the port's full forward's; eos latches;
sampling keeps the reference's properties (the random streams differ, so
its tokens are not compared); attribute_response (plain and contrastive,
with kv_begin) and attribute_response_latent match lxt_tpu within
normalized L2 1e-5 in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lxt_tpu
import lxt_tpu_torch
from lxt_tpu.models import decode as jdecode
from lxt_tpu.models import gemma3 as jgemma
from lxt_tpu.models import llama as jllama
from lxt_tpu.models.registry import AttributionModel as JModel
from lxt_tpu.models.registry import _family_table
from lxt_tpu.ops import quant as jq
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import decode as tdecode
from lxt_tpu_torch.models import gemma3 as tgemma
from lxt_tpu_torch.models import llama as tllama
from lxt_tpu_torch.models.registry import AttributionModel as TModel

BAR = 1e-5
BASE = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rms_eps=1e-6)
KV_BEGIN = np.asarray([3, 0], np.int32)


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _ids(seed, T=6, B=2):
    return np.random.RandomState(seed).randint(1, 256, (B, T))


def _llama_pair(seed=0, bits=None, **kw):
    """(lxt_tpu model, port model) of one Llama config on the same weights:
    lxt_tpu's init, random qkv biases, optionally int8-quantized there and
    carried over by params_from_numpy."""
    cfg = jllama.LlamaConfig(**{**BASE, **kw})
    params = jax.tree.map(np.asarray, jllama.init_params(cfg, jax.random.PRNGKey(seed)))
    if cfg.qkv_bias:
        rng = np.random.default_rng(seed + 1)
        for name in ("bq", "bk", "bv"):
            params["layers"][name] = (0.1 * rng.standard_normal(
                params["layers"][name].shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    if bits:
        jparams = jq.quantize_params(jparams, bits=bits)
    jm = JModel("llama", cfg, jparams, lxt_tpu.attnlrp, _family_table()["llama"])
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(cfg))
    return jm, TModel("llama", tcfg, params_from_numpy(jparams, device="cpu"),
                      lxt_tpu_torch.attnlrp)


def _assert_tokens(jm, tm, ids, n, kv_begin=KV_BEGIN):
    """The port's cached and uncached tokens equal lxt_tpu's (cached)."""
    want = np.asarray(jm.generate(ids, n, kv_begin=kv_begin))
    for use_cache in (True, False):
        got = tm.generate(ids, n, kv_begin=kv_begin, use_cache=use_cache)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(use_cache))
    return want


@pytest.mark.parametrize("variant,kw", [
    ("gqa", {}), ("qkv_bias", {"qkv_bias": True}), ("qk_norm", {"qk_norm": True}),
    ("window", {"sliding_window": 4}), ("tied", {"tie_embeddings": True}),
    ("int8", {"bits": 8})])
def test_llama_generate_matches_lxt_tpu(variant, kw):
    jm, tm = _llama_pair(**kw)
    ids = _ids(1)
    out = _assert_tokens(jm, tm, ids, 5)
    # the left-padded row equals the unpadded run of its suffix
    solo = tm.generate(ids[:1, KV_BEGIN[0]:], 5).numpy()
    np.testing.assert_array_equal(out[0, KV_BEGIN[0]:], solo[0])


def test_prefill_and_steps_match_lxt_tpu_and_the_full_forward():
    """The logits themselves at every frontier: the port's prefill and
    steps against lxt_tpu.models.decode's and against the port's full
    forward over the generated ids, with a left-padded row."""
    jm, tm = _llama_pair()
    ids = _ids(4, T=7)
    T0, N = ids.shape[1], 3
    out = tm.generate(ids, N, kv_begin=KV_BEGIN)
    with torch.no_grad():
        full = tllama.forward(tm.params, tm.cfg, tm.embed(out), kv_begin=KV_BEGIN,
                              remat=False).logits.numpy()
        logits, caches = tdecode.prefill(tm.params, tm.cfg, tm.embed(ids), T0 + N,
                                         kv_begin=KV_BEGIN)
    kb = jnp.asarray(KV_BEGIN)
    jlogits, jcaches = jdecode.prefill(jm.params, jm.cfg, jm.embed(ids), T0 + N,
                                       kv_begin=kb)
    assert caches["k"].shape == (2, 2, 2, T0 + N, 16)
    for k in range(N):
        assert _nl2(logits[:, 0].numpy(), full[:, T0 + k - 1]) <= BAR, k
        assert _nl2(logits.numpy(), jlogits) <= BAR, k
        if k == N - 1:
            break
        tok = out[:, T0 + k:T0 + k + 1]
        with torch.no_grad():
            logits, caches = tdecode.decode_step(tm.params, tm.cfg, tm.embed(tok),
                                                 caches, T0 + k, kv_begin=KV_BEGIN)
        jlogits, jcaches = jdecode.decode_step(jm.params, jm.cfg,
                                               jm.embed(tok.numpy()), jcaches,
                                               T0 + k, kv_begin=kb)
    for name in ("k", "v"):
        assert _nl2(caches[name].numpy(), jcaches[name]) <= BAR, name


def test_eos_latches_and_stops_the_loop():
    jm, tm = _llama_pair()
    ids = _ids(3, T=5, B=1)
    first = int(tm.generate(ids, 1)[0, -1])
    tdecode.reset_counters()
    out = tm.generate(ids, 6, eos_token_id=first)
    assert (out[0, 5:] == first).all()
    # every row done after the first token: one read, no step
    assert tdecode.counters == {"steps": 0, "done_reads": 1}
    want = np.asarray(jm.generate(ids, 6, eos_token_id=first))
    np.testing.assert_array_equal(out.numpy(), want)
    # uncached: the same tokens
    np.testing.assert_array_equal(
        tm.generate(ids, 6, eos_token_id=first, use_cache=False).numpy(), want)


def test_sampled_generate():
    """temperature > 0 with a generator: the same seed gives the same draw,
    another seed another; top_k=1 is greedy; cached and uncached sampling
    agree; sampling without temperature is refused."""
    _, tm = _llama_pair()
    ids = _ids(11, T=5)

    def draw(seed, **kw):
        gen = torch.Generator().manual_seed(seed)
        return tm.generate(ids, 8, temperature=1.0, generator=gen, **kw).numpy()

    a = draw(0)
    np.testing.assert_array_equal(a, draw(0))
    assert not np.array_equal(a, draw(1))
    np.testing.assert_array_equal(a, draw(0, use_cache=False))
    greedy = tm.generate(ids, 6).numpy()
    top1 = tm.generate(ids, 6, temperature=0.7, top_k=1,
                       generator=torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(top1, greedy)
    with pytest.raises(ValueError, match="temperature"):
        tm.generate(ids, 2, generator=torch.Generator())
    with pytest.raises(ValueError, match="max_new_tokens"):
        tm.generate(ids, 0)


def test_gemma3_generate_matches_lxt_tpu():
    """Gemma-3's local/global alternation, sandwich norms and two rope
    bases through the cache."""
    cfg = jgemma.Gemma3Config(
        vocab_size=256, hidden_size=48, intermediate_size=96, num_layers=4,
        num_heads=4, num_kv_heads=2, head_dim=12, sliding_window=4,
        query_pre_attn_scalar=12.0,
        layer_types=("sliding_attention", "full_attention",
                     "sliding_attention", "sliding_attention"))
    params = jax.tree.map(np.asarray, jgemma.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    for name, leaf in params["layers"].items():
        if "norm" in name or name.startswith("ln"):
            params["layers"][name] = (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
    jm = JModel("gemma3_text", cfg, jax.tree.map(jnp.asarray, params),
                lxt_tpu.attnlrp, _family_table()["gemma3_text"])
    tm = TModel("gemma3_text", tgemma.Gemma3Config(**dataclasses.asdict(cfg)),
                params_from_numpy(params, device="cpu"), lxt_tpu_torch.attnlrp)
    _assert_tokens(jm, tm, _ids(7, T=9), 5, kv_begin=np.asarray([4, 0], np.int32))


def _hf_pair(family):
    from transformers import GPT2Config, GPT2LMHeadModel
    from transformers.models.mixtral.modeling_mixtral import (MixtralConfig,
                                                              MixtralForCausalLM)
    torch.manual_seed(0)
    if family == "gpt2":
        hf = GPT2LMHeadModel(GPT2Config(
            vocab_size=256, n_embd=48, n_layer=3, n_head=4, n_positions=64,
            scale_attn_by_inverse_layer_idx=True)).eval()
    else:
        hf = MixtralForCausalLM(MixtralConfig(
            vocab_size=256, hidden_size=48, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            num_local_experts=4, num_experts_per_tok=2,
            max_position_embeddings=64)).eval()
    return hf, lxt_tpu.from_hf(hf), lxt_tpu_torch.from_hf(hf, device="cpu")


@pytest.mark.parametrize("family", ["gpt2", "mixtral"])
def test_gpt2_and_mixtral_generate_match_lxt_tpu_and_hf(family):
    hf, jm, tm = _hf_pair(family)
    ids = _ids(9 if family == "gpt2" else 10)
    _assert_tokens(jm, tm, ids, 4, kv_begin=np.asarray([2, 0], np.int32))
    got = tm.generate(ids, 5).numpy()
    with torch.no_grad():
        want = hf.generate(torch.from_numpy(ids), max_new_tokens=5,
                           do_sample=False).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tm.generate(ids, 5, use_cache=False).numpy(), want)


@pytest.mark.parametrize("contrastive", [False, True])
def test_attribute_response_matches_lxt_tpu(contrastive):
    jm, tm = _llama_pair(qkv_bias=True)
    ids = _ids(5, T=6)
    out = tm.generate(ids, 4, kv_begin=KV_BEGIN).numpy()
    jv, jrel = jm.attribute_response(out, 6, kv_begin=KV_BEGIN, contrastive=contrastive)
    tv, trel = tm.attribute_response(out, 6, kv_begin=KV_BEGIN, contrastive=contrastive)
    assert trel.shape == (4, 2, 10) and tv.shape == (4, 2)
    assert _nl2(tv.numpy(), jv) <= BAR
    assert _nl2(trel.numpy(), jrel) <= BAR
    assert (trel[:, 0, :KV_BEGIN[0]] == 0).all()
    with pytest.raises(ValueError, match="response_start"):
        tm.attribute_response(out, 10)


def test_attribute_response_latent_matches_lxt_tpu():
    jm, tm = _llama_pair(qk_norm=True)
    out = tm.generate(_ids(6, T=6, B=1), 3).numpy()
    jv, jrel, jlat = jm.attribute_response_latent(out, 6)
    tv, trel, tlat = tm.attribute_response_latent(out, 6)
    assert tlat.shape == (3, 2, 1, 9)
    for got, want in ((tv, jv), (trel, jrel), (tlat, jlat)):
        assert _nl2(got.numpy(), want) <= BAR
    # map k's input relevance is attribute_response's map k
    _, rel = tm.attribute_response(out, 6)
    assert _nl2(trel.numpy(), rel.numpy()) <= BAR


def test_decode_logits_close_at_bf16():
    """bf16: the per-step logits track the full forward within 0.05
    (tests/test_decode.py's bar; reduction orders differ)."""
    jm, tm = _llama_pair()
    tm.params = dict(tm.params, layers={n: t.bfloat16() for n, t in
                                        tm.params["layers"].items()},
                     **{n: tm.params[n].bfloat16() for n in ("embed", "final_norm",
                                                             "lm_head")})
    ids = _ids(13, T=7)
    T0, N = ids.shape[1], 3
    out = tm.generate(ids, N)
    with torch.no_grad():
        full = tllama.forward(tm.params, tm.cfg, tm.embed(out), remat=False).logits.float()
        logits, caches = tdecode.prefill(tm.params, tm.cfg, tm.embed(ids), T0 + N)
        for k in range(N):
            assert logits.dtype == torch.bfloat16
            err = (logits[:, 0].float() - full[:, T0 + k - 1]).abs().max()
            assert err <= 0.05, (k, float(err))
            if k < N - 1:
                logits, caches = tdecode.decode_step(
                    tm.params, tm.cfg, tm.embed(out[:, T0 + k:T0 + k + 1]), caches,
                    T0 + k)
