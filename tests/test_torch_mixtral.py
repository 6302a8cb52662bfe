"""The lxt_tpu_torch Mixtral model against lxt_tpu's, on CPU.

A tiny float32 config (2 layers, vocab 97, D 256, I 128, 4 q / 2 kv heads
of head dim 64, 4 experts, 2 per token) runs through both packages on the
same numpy weights (``convert.params_from_numpy``) and inputs at T 256, a
multiple of 128, so the port's flash path (the kernels' plain versions on
CPU) is eligible. Logits and input relevance must agree within normalized
L2 <= 1e-5 under attnlrp, cp_lrp and vanilla_gradient, for the ragged and
the dense mixture, on the port's einsum and flash paths; lxt_tpu runs its
einsum path. Both packages route every token to the same experts, NF4
codes and scales are bit-exact, and the AttributionModel methods agree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lxt_tpu
import lxt_tpu_torch
from lxt_tpu.attribution import input_relevance as j_input_relevance
from lxt_tpu.attribution import select_logit as j_select_logit
from lxt_tpu.models import common as jcommon
from lxt_tpu.models import mixtral as jmix
from lxt_tpu.models import registry as jreg
from lxt_tpu.ops import quant as jq
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import mixtral as tmix
from lxt_tpu_torch.models import registry as treg
from lxt_tpu_torch.ops import quant as tq

BAR = 1e-5  # normalized L2, float32
T = 256


def _cfg(moe_impl="ragged"):
    return jmix.MixtralConfig(
        vocab_size=97, hidden_size=256, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, num_experts=4, experts_per_token=2,
        moe_impl=moe_impl)


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _numpy_params(cfg, seed):
    """Random numpy weights in lxt_tpu's layout (norm weights away from 1,
    an untied head)."""
    rng = np.random.default_rng(seed)
    L, D, I, E, hd = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                      cfg.num_experts, cfg.hd)

    def w(*s, scale=0.05):
        return (scale * rng.standard_normal(s)).astype(np.float32)

    layers = dict(ln1=1 + w(L, D), ln2=1 + w(L, D), wq=w(L, D, cfg.num_heads * hd),
                  wk=w(L, D, cfg.num_kv_heads * hd), wv=w(L, D, cfg.num_kv_heads * hd),
                  wo=w(L, cfg.num_heads * hd, D), w_router=w(L, D, E),
                  wg=w(L, E, D, I), wu=w(L, E, D, I), wd=w(L, E, I, D))
    return {"embed": w(cfg.vocab_size, D, scale=1.0), "final_norm": 1 + w(D),
            "lm_head": w(D, cfg.vocab_size), "layers": layers}


def _setup(moe_impl="ragged", seed=0):
    jcfg = _cfg(moe_impl)
    jparams = _numpy_params(jcfg, seed)
    tcfg = tmix.MixtralConfig(**dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg, params_from_numpy(jparams, device="cpu")


def _ids(seed, B=2):
    return np.random.default_rng(seed).integers(0, 97, (B, T))


def _jax_run(jcfg, jparams, ids, composite, **kw):
    params = jax.tree.map(jnp.asarray, jparams)
    comp = getattr(lxt_tpu, composite)
    e = jmix.embed(params, jnp.asarray(ids))
    logits = jmix.forward(params, jcfg, e, comp, remat=False,
                          attn_impl="einsum", **kw).logits
    _, rel = j_input_relevance(
        lambda x: j_select_logit(jmix.forward(
            params, jcfg, x, comp, remat=False, logits_at=-1,
            attn_impl="einsum", **kw).logits), e)
    return np.asarray(logits), np.asarray(rel)


def _torch_run(tcfg, tparams, ids, composite, impl, remat=False, **kw):
    comp = getattr(lxt_tpu_torch, composite)
    e = tmix.embed(tparams, torch.as_tensor(ids))
    with torch.no_grad():
        logits = tmix.forward(tparams, tcfg, e, comp, remat=remat,
                              attn_impl=impl, **kw).logits
    _, rel = lxt_tpu_torch.input_relevance(
        lambda x: lxt_tpu_torch.select_logit(tmix.forward(
            tparams, tcfg, x, comp, remat=remat, logits_at=-1,
            attn_impl=impl, **kw).logits), e)
    return logits.numpy(), rel.numpy()


@pytest.mark.parametrize("moe_impl", ["ragged", "dense"])
@pytest.mark.parametrize("composite", ["attnlrp", "cp_lrp", "vanilla_gradient"])
def test_mixtral_matches_lxt_tpu(composite, moe_impl):
    jcfg, jparams, tcfg, tparams = _setup(moe_impl)
    ids = _ids(3)
    want_logits, want_rel = _jax_run(jcfg, jparams, ids, composite)
    for impl in ("einsum", "flash"):
        logits, rel = _torch_run(tcfg, tparams, ids, composite, impl)
        assert _nl2(logits, want_logits) <= BAR, impl
        assert _nl2(rel, want_rel) <= BAR, impl


def _routes(monkeypatch, module, run):
    """Run ``run()`` with ``module._route`` recording, per call, its
    top-K ids and the router probabilities (float64 on the host, from the
    call's own input and router weights)."""
    seen = []
    route = module._route

    def recording(x, lp, cfg, composite):
        top_w, top_idx = route(x, lp, cfg, composite)
        xs, wr = (np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
                  for a in (x, lp["w_router"]))
        z = xs @ wr
        p = np.exp(z - z.max(-1, keepdims=True))
        seen.append((np.asarray(top_idx), p / p.sum(-1, keepdims=True)))
        return top_w, top_idx

    monkeypatch.setattr(module, "_route", recording)
    run()
    monkeypatch.setattr(module, "_route", route)
    return seen


def test_routing_equal_in_both_packages(monkeypatch):
    """Every token goes to the same two experts, in the same order, in
    every layer; the smallest margin between the 2nd and 3rd probability
    is printed, so a flip shows as one."""
    jcfg, jparams, tcfg, tparams = _setup()
    ids = _ids(5)
    params = jax.tree.map(jnp.asarray, jparams)
    want = _routes(monkeypatch, jmix, lambda: jmix.forward(
        params, jcfg, jmix.embed(params, jnp.asarray(ids)), remat=False,
        attn_impl="einsum", layer_driver=jcommon.unrolled))
    got = _routes(monkeypatch, tmix, lambda: tmix.forward(
        tparams, tcfg, tmix.embed(tparams, torch.as_tensor(ids)), remat=False))
    assert len(got) == len(want) == jcfg.num_layers
    K = jcfg.experts_per_token
    for (g_idx, _), (w_idx, probs) in zip(got, want):
        np.testing.assert_array_equal(g_idx.reshape(w_idx.shape), w_idx)
        ranked = np.sort(probs, axis=-1)[..., ::-1]
        margin = (ranked[..., K - 1] - ranked[..., K]).min()
        print(f"smallest margin between the router probabilities ranked "
              f"{K} and {K + 1}: {margin:.3g}")
    # the router's sort keeps lax.top_k's order among equal probabilities
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :2]
    assert idx.tolist() == [[0, 1], [1, 3]]
    np.testing.assert_array_equal(jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1],
                                  idx.numpy())


@pytest.mark.parametrize("composite", ["attnlrp", "vanilla_gradient"])
def test_ragged_block_with_an_idle_expert_matches_lxt_tpu(composite):
    """The ragged mixture when one expert gets no token (its router column
    far below the others on positive inputs): the group is skipped, and
    the block's output and input gradient still match lxt_tpu's."""
    cfg = _cfg()
    rng = np.random.default_rng(11)
    D, I, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    lp = {"w_router": (0.05 * rng.standard_normal((D, E))).astype(np.float32),
          "wg": (0.05 * rng.standard_normal((E, D, I))).astype(np.float32),
          "wu": (0.05 * rng.standard_normal((E, D, I))).astype(np.float32),
          "wd": (0.05 * rng.standard_normal((E, I, D))).astype(np.float32)}
    lp["w_router"][:, 2] = -1.0
    x = np.abs(rng.standard_normal((2, 64, D))).astype(np.float32)
    ct = rng.standard_normal((2, 64, D)).astype(np.float32)
    jcomp, tcomp = getattr(lxt_tpu, composite), getattr(lxt_tpu_torch, composite)
    want, vjp = jax.vjp(lambda a: jmix.moe_block_ragged(
        a, jax.tree.map(jnp.asarray, lp), cfg, jcomp, jcommon.ACTIVATIONS["silu"]),
        jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(ct))
    xt = torch.tensor(x, requires_grad=True)
    tmix.reset_routing()
    got = tmix.moe_block_ragged(xt, {k: torch.tensor(v) for k, v in lp.items()},
                                tmix.MixtralConfig(**dataclasses.asdict(cfg)), tcomp,
                                torch.nn.functional.silu)
    (got_grad,) = torch.autograd.grad(got, xt, torch.tensor(ct))
    assert tmix.routing == {"host_reads": 1, "nonempty_groups": 3}
    assert _nl2(got.detach(), want) <= BAR
    assert _nl2(got_grad, want_grad) <= BAR


@pytest.mark.parametrize("composite", ["attnlrp", "cp_lrp"])
def test_nf4_codes_bit_exact_and_relevance_matches(composite):
    """quantize_params(nf4, family=mixtral): the 4-D expert stacks and the
    [L, D, E] router quantize slice by slice, as lxt_tpu's lax.map does."""
    jcfg, jparams, tcfg, tparams = _setup(seed=1)
    jqp = jq.quantize_params(jax.tree.map(jnp.asarray, jparams), bits="nf4",
                             family="mixtral")
    tqp = tq.quantize_params(tparams, bits="nf4", family="mixtral")
    for name, jl in jqp["layers"].items():
        tl = tqp["layers"][name]
        quantized = name in tq.FAMILY_QUANTIZABLE["mixtral"]
        assert isinstance(jl, jq.QuantizedTensor) == quantized, name
        assert isinstance(tl, tq.QuantizedTensor) == quantized, name
        if quantized:
            assert (tl.bits, tl.block) == (jl.bits, jl.block)
            np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
            np.testing.assert_array_equal(tl.scale.numpy(), np.asarray(jl.scale))
    assert tqp["layers"]["wg"].q.shape == (2, 4, 128, 128)
    assert tqp["layers"]["w_router"].scale.shape == (2, 4, 4)
    ids = _ids(6)
    params = jax.tree.map(jnp.asarray, jqp)
    comp = getattr(lxt_tpu, composite)
    e = jmix.embed(params, jnp.asarray(ids))
    _, want = j_input_relevance(lambda x: j_select_logit(jmix.forward(
        params, jcfg, x, comp, remat=False, logits_at=-1,
        attn_impl="einsum").logits), e)
    _, got = _torch_run(tcfg, tqp, ids, composite, "flash", remat=True)
    assert _nl2(got, want) <= BAR


def test_left_padding_hidden_states_and_probes_match_lxt_tpu():
    jcfg, jparams, tcfg, tparams = _setup(seed=2)
    ids = _ids(7)
    kv_begin = np.asarray([9, 0], np.int32)
    want_logits, want_rel = _jax_run(jcfg, jparams, ids, "attnlrp",
                                     kv_begin=jnp.asarray(kv_begin))
    logits, rel = _torch_run(tcfg, tparams, ids, "attnlrp", "flash", remat=True,
                             kv_begin=torch.as_tensor(kv_begin))
    assert _nl2(logits[0, 9:], want_logits[0, 9:]) <= BAR
    assert _nl2(logits[1], want_logits[1]) <= BAR
    assert _nl2(rel, want_rel) <= BAR
    probes = 0.1 * np.random.default_rng(8).standard_normal(
        (jcfg.num_layers, 2, T, jcfg.hidden_size)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, jparams)
    want = jmix.forward(params, jcfg, jmix.embed(params, jnp.asarray(ids)),
                        output_hidden_states=True, probes=jnp.asarray(probes),
                        attn_impl="einsum")
    got = tmix.forward(tparams, tcfg, tmix.embed(tparams, torch.as_tensor(ids)),
                       output_hidden_states=True, probes=torch.tensor(probes))
    assert got.hidden_states.shape == want.hidden_states.shape
    assert _nl2(got.hidden_states.detach(), want.hidden_states) <= BAR
    assert _nl2(got.logits.detach(), want.logits) <= BAR


def test_attribution_model_methods_match_lxt_tpu():
    """attribute_latent and attribute_topk of a Mixtral AttributionModel."""
    jcfg, jparams, tcfg, tparams = _setup(seed=4)
    jm = jreg.AttributionModel(family="mixtral", cfg=jcfg,
                               params=jax.tree.map(jnp.asarray, jparams),
                               composite=lxt_tpu.attnlrp,
                               _fns=jreg._family_table()["mixtral"])
    tm = treg.AttributionModel("mixtral", tcfg, tparams, lxt_tpu_torch.attnlrp)
    assert tm.device == torch.device("cpu")
    ids = _ids(9, B=1)
    jv, jin, jlat = jm.attribute_latent(ids)
    tv, tin, tlat = tm.attribute_latent(ids)
    assert tuple(tlat.shape) == jlat.shape == (2, 1, T, 256)
    assert _nl2(tv.detach().numpy(), jv) <= BAR
    assert _nl2(tin.numpy(), jin) <= BAR
    assert _nl2(tlat.numpy(), jlat) <= BAR
    jtok, jval, jrel = jm.attribute_topk(ids, k=3)
    ttok, tval, trel = tm.attribute_topk(ids, k=3)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert _nl2(tval.detach().numpy(), jval) <= BAR
    assert _nl2(trel.numpy(), jrel) <= BAR


def test_config_init_and_params_from_hf_match_lxt_tpu():
    cfg = _cfg()
    tcfg = tmix.MixtralConfig(**dataclasses.asdict(cfg))
    want = jax.tree.map(lambda a: tuple(a.shape),
                        jmix.init_params(cfg, jax.random.PRNGKey(0)))
    got = tmix.init_params(tcfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: tuple(a.shape), got) == want
    qp = tmix.init_params(tcfg, torch.Generator().manual_seed(0), quantize_bits="nf4")
    for name in tq.FAMILY_QUANTIZABLE["mixtral"]:
        assert isinstance(qp["layers"][name], tq.QuantizedTensor), name
        assert qp["layers"][name].shape == got["layers"][name].shape, name
    # an HF-named state dict: linear weights [out, in], experts w1/w3/w2
    _, jparams, tcfg, tparams = _setup(seed=3)
    lp, sd = jparams["layers"], {}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = lp["ln1"][i]
        sd[pre + "post_attention_layernorm.weight"] = lp["ln2"][i]
        for ours, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                         ("wo", "o_proj")):
            sd[pre + f"self_attn.{hf}.weight"] = lp[ours][i].T
        sd[pre + "block_sparse_moe.gate.weight"] = lp["w_router"][i].T
        for e in range(cfg.num_experts):
            for ours, hf in (("wg", "w1"), ("wd", "w2"), ("wu", "w3")):
                sd[pre + f"block_sparse_moe.experts.{e}.{hf}.weight"] = lp[ours][i, e].T
    sd.update({"model.embed_tokens.weight": jparams["embed"],
               "model.norm.weight": jparams["final_norm"],
               "lm_head.weight": jparams["lm_head"].T})
    got = tmix.params_from_hf(sd, tcfg, device="cpu")
    want = jmix.params_from_hf(sd, cfg)
    for name in ("embed", "final_norm", "lm_head"):
        assert torch.equal(got[name], tparams[name])
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    assert sorted(got["layers"]) == sorted(want["layers"])
    for name, w in got["layers"].items():
        assert torch.equal(w, tparams["layers"][name]), name
        np.testing.assert_array_equal(w.numpy(), np.asarray(want["layers"][name]))
