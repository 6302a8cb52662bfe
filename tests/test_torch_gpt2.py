"""The lxt_tpu_torch GPT-2 model against lxt_tpu's, on CPU.

A tiny float32 config (3 layers, vocab 97, D 256, 4 heads of head dim 64,
256 positions) runs through both packages on the same numpy weights
(``convert.params_from_numpy``) and inputs at T 256, a multiple of 128, so
the port's flash path (the kernels' plain versions on CPU) is eligible.
Logits and input relevance must agree within normalized L2 <= 1e-5 under
attnlrp, cp_lrp and vanilla_gradient, with ``scale_attn_by_inverse_layer_idx``
on and off, on the port's einsum and flash paths; lxt_tpu runs its einsum
path. Left padding (``kv_begin``), hidden states and probes too.
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
from lxt_tpu.models import gpt2 as jgpt2
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import gpt2 as tgpt2

BAR = 1e-5  # normalized L2, float32
T = 256


def _cfg(inverse_layer_scale=False):
    return jgpt2.GPT2Config(vocab_size=97, hidden_size=256, num_layers=3,
                            num_heads=4, max_positions=T,
                            scale_attn_by_inverse_layer_idx=inverse_layer_scale)


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _numpy_params(cfg, seed):
    """Random numpy weights in lxt_tpu's layout; norm weights and biases
    away from 1 and 0."""
    rng = np.random.default_rng(seed)
    L, D = cfg.num_layers, cfg.hidden_size

    def w(*s, scale=0.05):
        return (scale * rng.standard_normal(s)).astype(np.float32)

    layers = dict(ln1_w=1 + w(L, D), ln1_b=w(L, D), ln2_w=1 + w(L, D),
                  ln2_b=w(L, D), w_attn=w(L, D, 3 * D), b_attn=w(L, 3 * D),
                  w_proj=w(L, D, D), b_proj=w(L, D), w_fc=w(L, D, 4 * D),
                  b_fc=w(L, 4 * D), w_out=w(L, 4 * D, D), b_out=w(L, D))
    return {"wte": w(cfg.vocab_size, D, scale=0.5),
            "wpe": w(cfg.max_positions, D, scale=0.5), "lnf_w": 1 + w(D),
            "lnf_b": w(D), "layers": layers}


def _setup(inverse_layer_scale=False, seed=0):
    jcfg = _cfg(inverse_layer_scale)
    jparams = _numpy_params(jcfg, seed)
    tcfg = tgpt2.GPT2Config(**dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg, params_from_numpy(jparams, device="cpu")


def _ids(seed, B=2):
    return np.random.default_rng(seed).integers(0, 97, (B, T))


def _jax_run(jcfg, jparams, ids, composite, **kw):
    params = jax.tree.map(jnp.asarray, jparams)
    comp = getattr(lxt_tpu, composite)
    e = jgpt2.embed(params, jnp.asarray(ids))[0]
    logits = jgpt2.forward(params, jcfg, e, comp, remat=False,
                           attn_impl="einsum", **kw).logits
    _, rel = j_input_relevance(
        lambda x: j_select_logit(jgpt2.forward(
            params, jcfg, x, comp, remat=False, logits_at=-1,
            attn_impl="einsum", **kw).logits), e)
    return np.asarray(logits), np.asarray(rel)


def _torch_run(tcfg, tparams, ids, composite, impl, remat=False, **kw):
    comp = getattr(lxt_tpu_torch, composite)
    e = tgpt2.embed(tparams, torch.as_tensor(ids))[0]
    with torch.no_grad():
        logits = tgpt2.forward(tparams, tcfg, e, comp, remat=remat,
                               attn_impl=impl, **kw).logits
    _, rel = lxt_tpu_torch.input_relevance(
        lambda x: lxt_tpu_torch.select_logit(tgpt2.forward(
            tparams, tcfg, x, comp, remat=remat, logits_at=-1,
            attn_impl=impl, **kw).logits), e)
    return logits.numpy(), rel.numpy()


@pytest.mark.parametrize("inverse_layer_scale", [False, True],
                         ids=["scale", "inverse_layer_scale"])
@pytest.mark.parametrize("composite", ["attnlrp", "cp_lrp", "vanilla_gradient"])
def test_gpt2_matches_lxt_tpu(composite, inverse_layer_scale):
    jcfg, jparams, tcfg, tparams = _setup(inverse_layer_scale)
    ids = _ids(3)
    want_logits, want_rel = _jax_run(jcfg, jparams, ids, composite)
    for impl in ("einsum", "flash"):
        logits, rel = _torch_run(tcfg, tparams, ids, composite, impl)
        assert _nl2(logits, want_logits) <= BAR, impl
        assert _nl2(rel, want_rel) <= BAR, impl


def test_inverse_layer_scale_changes_the_result():
    """The comparison above can tell the two scales apart."""
    jcfg, jparams, tcfg, tparams = _setup(True)
    ids = _ids(3, B=1)
    want, _ = _jax_run(jcfg, jparams, ids, "cp_lrp")
    got, _ = _torch_run(dataclasses.replace(tcfg, scale_attn_by_inverse_layer_idx=False),
                        tparams, ids, "cp_lrp", "flash")
    assert _nl2(got, want) > 1e-3
    assert [tgpt2.layer_scale(tcfg, i) for i in range(3)] == [
        float(np.float32(0.125) / np.float32(i + 1)) for i in range(3)]


def test_left_padding_kv_begin_matches_lxt_tpu():
    """kv_begin left padding: positions count from each row's first real
    token, so the learned position embeddings move with it."""
    jcfg, jparams, tcfg, tparams = _setup(seed=1)
    ids = _ids(4)
    kv_begin = np.asarray([9, 0], np.int32)
    want_logits, want_rel = _jax_run(jcfg, jparams, ids, "cp_lrp",
                                     kv_begin=jnp.asarray(kv_begin))
    for impl in ("einsum", "flash"):
        logits, rel = _torch_run(tcfg, tparams, ids, "cp_lrp", impl, remat=True,
                                 kv_begin=torch.as_tensor(kv_begin))
        assert _nl2(logits[0, 9:], want_logits[0, 9:]) <= BAR, impl
        assert _nl2(logits[1], want_logits[1]) <= BAR, impl
        assert _nl2(rel, want_rel) <= BAR, impl


def test_hidden_states_probes_and_position_embeds_match_lxt_tpu():
    jcfg, jparams, tcfg, tparams = _setup(seed=2)
    ids = _ids(5, B=1)
    rng = np.random.default_rng(6)
    probes = 0.1 * rng.standard_normal((3, 1, T, 256)).astype(np.float32)
    pos = 0.1 * rng.standard_normal((1, T, 256)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, jparams)
    want = jgpt2.forward(params, jcfg, jgpt2.embed(params, jnp.asarray(ids))[0],
                         output_hidden_states=True, probes=jnp.asarray(probes),
                         position_embeds=jnp.asarray(pos), attn_impl="einsum")
    got = tgpt2.forward(tparams, tcfg, tgpt2.embed(tparams, torch.as_tensor(ids))[0],
                        output_hidden_states=True, probes=torch.tensor(probes),
                        position_embeds=torch.tensor(pos))
    assert got.hidden_states.shape == want.hidden_states.shape
    assert _nl2(got.hidden_states.detach(), want.hidden_states) <= BAR
    assert _nl2(got.logits.detach(), want.logits) <= BAR
    tok, wpe = tgpt2.embed(tparams, torch.as_tensor(ids))
    jtok, jwpe = jgpt2.embed(params, jnp.asarray(ids))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(wpe.numpy(), np.asarray(jwpe))


@pytest.mark.parametrize("prefix", ["transformer.", ""], ids=["lm_head_model", "bare"])
def test_params_from_hf_and_init_match_lxt_tpu(prefix):
    cfg = _cfg()
    _, jparams, tcfg, tparams = _setup(seed=3)
    names = {"ln1_w": "ln_1.weight", "ln1_b": "ln_1.bias", "ln2_w": "ln_2.weight",
             "ln2_b": "ln_2.bias", "w_attn": "attn.c_attn.weight",
             "b_attn": "attn.c_attn.bias", "w_proj": "attn.c_proj.weight",
             "b_proj": "attn.c_proj.bias", "w_fc": "mlp.c_fc.weight",
             "b_fc": "mlp.c_fc.bias", "w_out": "mlp.c_proj.weight",
             "b_out": "mlp.c_proj.bias"}
    sd = {prefix + "wte.weight": jparams["wte"], prefix + "wpe.weight": jparams["wpe"],
          prefix + "ln_f.weight": jparams["lnf_w"], prefix + "ln_f.bias": jparams["lnf_b"]}
    for ours, hf in names.items():
        for i in range(cfg.num_layers):
            sd[f"{prefix}h.{i}.{hf}"] = jparams["layers"][ours][i]
    got = tgpt2.params_from_hf(sd, tcfg, device="cpu")
    want = jgpt2.params_from_hf(sd, cfg)
    for name in ("wte", "wpe", "lnf_w", "lnf_b"):
        assert torch.equal(got[name], tparams[name])
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    for name, w in got["layers"].items():
        assert torch.equal(w, tparams["layers"][name]), name
        np.testing.assert_array_equal(w.numpy(), np.asarray(want["layers"][name]))
    shapes = jax.tree.map(lambda a: tuple(a.shape),
                          jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    init = tgpt2.init_params(tcfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: tuple(a.shape), init) == shapes
