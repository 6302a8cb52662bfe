"""The lxt_tpu_torch Gemma-3 text model against lxt_tpu's, on CPU.

A tiny float32 config with 6 layers (layer 5 global, the others local with
a window of 96), vocab 97, D 64, I 128, 4 q / 2 kv heads, head dim 64 and
256, linear rope scaling 8 on the global tables and norm weights away from
0, runs through both packages on the same numpy weights
(``convert.params_from_numpy``) and inputs at T 256: longer than the
window, so the local layers' mask and tables matter, and a multiple of 128,
so the port's flash path is eligible. Logits and input relevance must agree
within normalized L2 <= 1e-5 under attnlrp, cp_lrp and vanilla_gradient,
on the port's einsum path and its flash path (the kernels' plain versions
on CPU); lxt_tpu runs its einsum path. The bf16 rounding of Gemma's norm
and embedding scale is held bit-exact.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lxt_tpu
import lxt_tpu_torch
from lxt_tpu.attribution import input_relevance as j_input_relevance
from lxt_tpu.attribution import select_logit as j_select_logit
from lxt_tpu.models import gemma3 as jgemma
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import gemma3 as tgemma

BAR = 1e-5  # normalized L2, float32
T = 256
WINDOW = 96


def _cfg(head_dim):
    return jgemma.Gemma3Config(
        vocab_size=97, hidden_size=64, intermediate_size=128, num_layers=6,
        num_heads=4, num_kv_heads=2, head_dim=head_dim, sliding_window=WINDOW,
        rope_global_scaling=8.0)


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _numpy_params(cfg, seed):
    """Random numpy weights in lxt_tpu's layout; norm weights away from 0,
    so every (1 + w) multiplier is exercised."""
    rng = np.random.default_rng(seed)
    L, D, I, hd = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    H, Hkv = cfg.num_heads, cfg.num_kv_heads

    def w(*s):
        return (0.1 * rng.standard_normal(s)).astype(np.float32)

    layers = dict(ln_in=w(L, D), ln_post_attn=w(L, D), ln_pre_ff=w(L, D),
                  ln_post_ff=w(L, D), wq=w(L, D, H * hd), wk=w(L, D, Hkv * hd),
                  wv=w(L, D, Hkv * hd), wo=w(L, H * hd, D), q_norm=w(L, hd),
                  k_norm=w(L, hd), wg=w(L, D, I), wu=w(L, D, I), wd=w(L, I, D))
    return {"embed": w(cfg.vocab_size, D), "final_norm": w(D), "layers": layers}


def _setup(head_dim, seed=0):
    jcfg = _cfg(head_dim)
    jparams = _numpy_params(jcfg, seed)
    tcfg = tgemma.Gemma3Config(**dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg, params_from_numpy(jparams, device="cpu")


def _jax_run(jcfg, jparams, ids, composite, **kw):
    params = jax.tree.map(jnp.asarray, jparams)
    comp = getattr(lxt_tpu, composite)
    e = jgemma.embed(params, jnp.asarray(ids), jcfg)
    logits = jgemma.forward(params, jcfg, e, comp, remat=False,
                            attn_impl="einsum", **kw).logits
    _, rel = j_input_relevance(
        lambda x: j_select_logit(jgemma.forward(
            params, jcfg, x, comp, remat=False, logits_at=-1,
            attn_impl="einsum", **kw).logits), e)
    return np.asarray(logits), np.asarray(rel)


def _torch_run(tcfg, tparams, ids, composite, impl, remat=False, **kw):
    comp = getattr(lxt_tpu_torch, composite)
    e = tgemma.embed(tparams, torch.as_tensor(ids), tcfg)
    with torch.no_grad():
        logits = tgemma.forward(tparams, tcfg, e, comp, remat=remat,
                                attn_impl=impl, **kw).logits
    _, rel = lxt_tpu_torch.input_relevance(
        lambda x: lxt_tpu_torch.select_logit(tgemma.forward(
            tparams, tcfg, x, comp, remat=remat, logits_at=-1,
            attn_impl=impl, **kw).logits), e)
    return logits.numpy(), rel.numpy()


@pytest.mark.parametrize("composite", ["attnlrp", "cp_lrp", "vanilla_gradient"])
@pytest.mark.parametrize("head_dim", [64, 256])
def test_gemma3_matches_lxt_tpu(head_dim, composite):
    jcfg, jparams, tcfg, tparams = _setup(head_dim)
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, T))
    want_logits, want_rel = _jax_run(jcfg, jparams, ids, composite)
    for impl in ("einsum", "flash"):
        logits, rel = _torch_run(tcfg, tparams, ids, composite, impl)
        assert _nl2(logits, want_logits) <= BAR, impl
        assert _nl2(rel, want_rel) <= BAR, impl


def test_local_and_global_tables_are_not_swapped():
    """Swapping the local and global layers changes the result at T > window:
    the comparison above can tell them apart."""
    jcfg, jparams, tcfg, tparams = _setup(64)
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (1, T))
    flipped = tuple("full_attention" if s else "sliding_attention"
                    for s in tgemma.layer_sliding_flags(tcfg))
    want, _ = _jax_run(jcfg, jparams, ids, "attnlrp")
    got, _ = _torch_run(dataclasses.replace(tcfg, layer_types=flipped),
                        tparams, ids, "attnlrp", "flash")
    assert _nl2(got, want) > 1e-3


def test_left_padding_kv_begin_matches_lxt_tpu():
    """kv_begin left padding (per-example positions, rope outside the
    kernels), with remat on in the port."""
    jcfg, jparams, tcfg, tparams = _setup(64, seed=1)
    ids = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, T))
    kv_begin = np.asarray([9, 0], np.int32)
    want_logits, want_rel = _jax_run(jcfg, jparams, ids, "attnlrp",
                                     kv_begin=jnp.asarray(kv_begin))
    for impl in ("einsum", "flash"):
        logits, rel = _torch_run(tcfg, tparams, ids, "attnlrp", impl,
                                 remat=True, kv_begin=torch.as_tensor(kv_begin))
        assert _nl2(logits[0, 9:], want_logits[0, 9:]) <= BAR, impl
        assert _nl2(logits[1], want_logits[1]) <= BAR, impl
        assert _nl2(rel, want_rel) <= BAR, impl


def test_hidden_states_probes_and_untied_head_match_lxt_tpu():
    jcfg, jparams, tcfg, tparams = _setup(64, seed=2)
    jcfg = dataclasses.replace(jcfg, tie_embeddings=False)
    tcfg = dataclasses.replace(tcfg, tie_embeddings=False)
    head = (0.1 * np.random.default_rng(5).standard_normal((64, 97))).astype(np.float32)
    jparams["lm_head"], tparams["lm_head"] = head, torch.from_numpy(head)
    ids = np.random.default_rng(5).integers(0, 97, (1, 128))
    probes = 0.1 * np.random.default_rng(6).standard_normal(
        (jcfg.num_layers, 1, 128, 64)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, jparams)
    want = jgemma.forward(params, jcfg, jgemma.embed(params, jnp.asarray(ids), jcfg),
                          output_hidden_states=True, probes=jnp.asarray(probes),
                          attn_impl="einsum")
    got = tgemma.forward(tparams, tcfg, tgemma.embed(tparams, torch.as_tensor(ids), tcfg),
                         output_hidden_states=True, probes=torch.tensor(probes))
    assert got.hidden_states.shape == want.hidden_states.shape
    assert _nl2(got.hidden_states.detach(), want.hidden_states) <= BAR
    assert _nl2(got.logits.detach(), want.logits) <= BAR


def _bf16_pair(shape, seed, scale=1.0):
    """The same bf16 values for both packages (numpy float32 rounded once)."""
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    return xt, jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)


def _bf16_ulps(got, want):
    """Distance in bf16 units in the last place, element by element (the
    bf16 bits are the top half of the float32 bits)."""
    def bits(a):
        a = np.asarray(a, np.float32).view(np.int32).astype(np.int64) >> 16
        return np.where(a < 0, -(a & 0x7FFF), a)  # sign-magnitude -> ordered
    return np.abs(bits(got) - bits(want))


@pytest.mark.parametrize("composite", ["attnlrp", "vanilla_gradient"])
@pytest.mark.parametrize("shape", [(2, 16, 64), (2, 4, 16, 256)],
                         ids=["hidden", "qk_norm"])
def test_gemma_rms_norm_bf16_bit_exact(shape, composite):
    """Gemma's norm in bf16 on the hidden [B, T, D] and the per-head
    [B, H, T, 256] shapes: the (1 + w) product in float32 before the single
    cast, as lxt_tpu does it. Allowed: 1 bf16 ulp on at most 1 element in
    10^4. XLA on the CPU sums the squares of a row in another order than
    PyTorch, so the float32 rsqrt may differ in its last bit, which moves
    the bf16 result by one ulp where the float32 product lies next to a
    rounding boundary (1 of 32768 elements at head dim 256). Rounding the
    (1 + w) product in bf16 instead moves many elements."""
    xt, xj = _bf16_pair(shape, seed=len(shape))
    wt, wj = _bf16_pair(shape[-1:], seed=9, scale=0.5)
    ct, cj = _bf16_pair(shape, seed=11)
    got = tgemma.gemma_rms_norm(xt, wt, 1e-6, getattr(lxt_tpu_torch, composite))
    want = jgemma.gemma_rms_norm(xj, wj, 1e-6, getattr(lxt_tpu, composite))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    ulps = _bf16_ulps(got.float().numpy(), want)
    assert ulps.max() <= 1 and (ulps > 0).mean() <= 1e-4, (ulps.max(), (ulps > 0).sum())
    # Composite.rms_norm(offset=1) multiplies in bf16 and gives other bits
    other = lxt_tpu_torch.attnlrp.rms_norm(xt, wt, 1e-6, offset=1.0)
    assert (_bf16_ulps(other.float().numpy(), want) > 0).mean() > 1e-2
    xg = xt.clone().requires_grad_(True)
    (gt,) = torch.autograd.grad(
        tgemma.gemma_rms_norm(xg, wt, 1e-6, getattr(lxt_tpu_torch, composite)), xg, ct)
    _, vjp = jax.vjp(lambda x: jgemma.gemma_rms_norm(x, wj, 1e-6,
                                                      getattr(lxt_tpu, composite)), xj)
    (gj,) = vjp(cj)
    assert gt.dtype == torch.bfloat16
    # the identity rule's gradient is products alone (rsqrt within the
    # ulp allowance above); XLA and PyTorch reduce the vanilla variance
    # gradient in other orders
    if composite == "attnlrp":
        ulps = _bf16_ulps(gt.float().numpy(), gj)
        assert ulps.max() <= 1 and (ulps > 0).mean() <= 1e-4
    else:
        assert _nl2(gt.float().numpy(), np.asarray(gj, np.float32)) <= 1e-2


def test_embed_bf16_bit_exact():
    """sqrt(2560) rounds to 50.5 in bf16 before the product, in both."""
    cfg = jgemma.Gemma3Config(vocab_size=50, hidden_size=2560)
    tt, tj = _bf16_pair((50, 2560), seed=3, scale=0.02)
    ids = np.random.default_rng(4).integers(0, 50, (2, 9))
    got = tgemma.embed({"embed": tt}, torch.as_tensor(ids), tgemma.Gemma3Config(
        **dataclasses.asdict(cfg)))
    want = jgemma.embed({"embed": tj}, jnp.asarray(ids), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert torch.equal(got, tt[torch.as_tensor(ids)] * 50.5)


def _hf_text_config(**kw):
    base = dict(model_type="gemma3_text", vocab_size=97, hidden_size=64,
                intermediate_size=128, num_hidden_layers=6,
                num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                rope_theta=1e6, rope_local_base_freq=1e4, rms_norm_eps=1e-6,
                query_pre_attn_scalar=64, sliding_window=WINDOW,
                layer_types=["sliding_attention"] * 5 + ["full_attention"],
                tie_word_embeddings=True,
                rope_scaling={"rope_type": "linear", "factor": 8.0})
    return types.SimpleNamespace(**dict(base, **kw))


@pytest.mark.parametrize("kw", [{}, {"rope_scaling": None},
                                {"tie_word_embeddings": False,
                                 "rope_scaling": {"type": "linear", "factor": 2.0}}],
                         ids=["linear8", "unscaled", "untied_legacy_key"])
def test_config_from_hf_matches_lxt_tpu(kw):
    hf = _hf_text_config(**kw)
    assert dataclasses.asdict(tgemma.Gemma3Config.from_hf(hf)) == \
        dataclasses.asdict(jgemma.Gemma3Config.from_hf(hf))


def _hf_state_dict(cfg, params):
    """An HF-named (Gemma3ForCausalLM) numpy state dict of lxt_tpu-layout
    parameters: linear weights back to [out, in]."""
    names = {"ln_in": "input_layernorm", "ln_post_attn": "post_attention_layernorm",
             "ln_pre_ff": "pre_feedforward_layernorm",
             "ln_post_ff": "post_feedforward_layernorm",
             "q_norm": "self_attn.q_norm", "k_norm": "self_attn.k_norm",
             "wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "wg": "mlp.gate_proj", "wu": "mlp.up_proj", "wd": "mlp.down_proj"}
    sd = {"model.embed_tokens.weight": params["embed"],
          "model.norm.weight": params["final_norm"]}
    for ours, hf in names.items():
        for i in range(cfg.num_layers):
            w = params["layers"][ours][i]
            sd[f"model.layers.{i}.{hf}.weight"] = w.T if w.ndim == 2 else w
    return sd


def test_params_from_hf_round_trip_matches_lxt_tpu():
    jcfg, jparams, tcfg, tparams = _setup(64, seed=3)
    sd = _hf_state_dict(jcfg, jparams)
    got = tgemma.params_from_hf(sd, tcfg, device="cpu")
    want = jgemma.params_from_hf(sd, jcfg)
    assert "lm_head" not in got
    for name in ("embed", "final_norm"):
        assert torch.equal(got[name], tparams[name])
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    assert sorted(got["layers"]) == sorted(want["layers"])
    for name, w in got["layers"].items():
        assert torch.equal(w, tparams["layers"][name]), name
        np.testing.assert_array_equal(w.numpy(), np.asarray(want["layers"][name]))
    sd_torch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    got_bf16 = tgemma.params_from_hf(sd_torch, tcfg, dtype=torch.bfloat16, device="cpu")
    assert torch.equal(got_bf16["layers"]["wq"], tparams["layers"]["wq"].bfloat16())


def test_layer_flags_tables_and_init_match_lxt_tpu():
    cfg = jgemma.Gemma3Config(num_layers=13, head_dim=64, rope_global_scaling=8.0,
                              vocab_size=97, hidden_size=64, intermediate_size=32)
    tcfg = tgemma.Gemma3Config(**dataclasses.asdict(cfg))
    assert tgemma.layer_sliding_flags(tcfg) == [
        bool(f) for f in np.asarray(jgemma.layer_sliding_flags(cfg))]
    assert tgemma.layer_sliding_flags(tcfg).count(False) == 2  # layers 5 and 11
    pos = np.arange(200, dtype=np.int32)
    for got, want in zip(tgemma.rope_table_pair(torch.as_tensor(pos), tcfg),
                         jgemma.rope_table_pair(jnp.asarray(pos), cfg)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-6)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jgemma.init_params(cfg, jax.random.PRNGKey(0)))
    got = tgemma.init_params(tcfg, torch.Generator().manual_seed(0))
    got = {k: ({n: (tuple(t.shape), "float32") for n, t in v.items()}
               if isinstance(v, dict) else (tuple(v.shape), "float32"))
           for k, v in got.items()}
    assert got == want
    assert not any(t.any() for n, t in tgemma.init_params(
        tcfg, torch.Generator().manual_seed(0))["layers"].items() if "ln" in n)
