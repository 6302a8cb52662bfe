"""The port's explicit rules and full Composite against lxt_tpu's, on CPU.

Each rule spec (gamma 0.25, alpha-beta (2, 1), z+, flat, w-square, z-box
(-3, 3)) runs on a linear layer and on an NHWC conv (stride 4 over an image
side that 4 does not divide, so the transpose must drop the remainder;
'VALID', 'SAME' and explicit pads) through both packages on the same numpy
inputs, bounded away from 0 (the rules read relevance as x * grad). The
forward and the relevance x * vjp(cotangent) must agree within normalized
L2 <= 1e-5 in float32. The Composite surface (with_gamma, with_rules,
override_sites, override_layers, for_layer, summary, the spec errors) must
give lxt_tpu's fields and text. One composite with site overrides and
depth overrides runs on a tiny HF model of each text family through
``from_hf`` in both packages: relevance within 1e-5. Those overrides are
rules whose denominators stay away from 0 (w-square, alpha-beta, z+): the
gamma rule's z = x (w + g w+) + b crosses 0 inside a model, where float32
sums taken in another order by the two libraries move a map by up to 1e-4
(BERT's wout); gamma is held above on inputs where z does not.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import (BertConfig, BertForSequenceClassification,
                          Gemma3ForCausalLM, Gemma3TextConfig, GPT2Config,
                          GPT2LMHeadModel, LlamaConfig, LlamaForCausalLM,
                          MixtralConfig, MixtralForCausalLM)

import lxt_tpu
import lxt_tpu_torch
from lxt_tpu import composites as jcomp
from lxt_tpu.ops import quant as jq
from lxt_tpu_torch import composites as tcomp
from lxt_tpu_torch.ops import quant as tq
from lxt_tpu_torch.ops import rules as trules

BAR = 1e-5  # normalized L2, float32
SPECS = {"gamma": ("gamma", 0.25), "alphabeta": ("alphabeta", 2.0, 1.0),
         "zplus": "zplus", "flat": "flat", "wsquare": "wsquare",
         "zbox": ("zbox", -3.0, 3.0)}


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _away_from_zero(rng, shape):
    """Values of either sign with |x| in [0.2, 1.2]."""
    return (np.sign(rng.standard_normal(shape))
            * (0.2 + rng.random(shape))).astype(np.float32)


def _both(jfn, tfn, x, cot):
    """(forward, relevance x * vjp(cot)) of each package's function of x."""
    out, g = jax.jit(lambda e, c: (lambda o, pull: (o, pull(c)[0]))(
        *jax.vjp(jfn, e)))(jnp.asarray(x), jnp.asarray(cot))
    xt = torch.tensor(x, requires_grad=True)
    tout = tfn(xt)
    (tg,) = torch.autograd.grad(tout, xt, torch.tensor(cot))
    return ((tout.detach().numpy(), np.asarray(out)),
            ((xt.detach() * tg).numpy(), x * np.asarray(g)))


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_linear_rule_matches_lxt_tpu(spec):
    rng = np.random.default_rng(1)
    x = _away_from_zero(rng, (2, 5, 12))
    w = (0.3 * rng.standard_normal((12, 7))).astype(np.float32)
    b = (0.1 * rng.standard_normal(7)).astype(np.float32)
    cot = rng.standard_normal((2, 5, 7)).astype(np.float32)
    jc = lxt_tpu.cp_lrp.with_rules(linear=SPECS[spec])
    tc = lxt_tpu_torch.cp_lrp.with_rules(linear=SPECS[spec])
    (fo, fw), (ro, rw) = _both(
        lambda e: jc.linear(e, jnp.asarray(w), jnp.asarray(b)),
        lambda e: tc.linear(e, torch.tensor(w), torch.tensor(b)), x, cot)
    assert _nl2(fo, fw) <= BAR
    assert _nl2(ro, rw) <= BAR, _nl2(ro, rw)


CONVS = {"valid_remainder": ((4, 4), "VALID", (2, 18, 19, 3)),
         "same_stride2": ((2, 2), "SAME", (1, 9, 10, 3)),
         "explicit_pads": ((3, 2), ((1, 2), (0, 1)), (1, 10, 11, 3))}


@pytest.mark.parametrize("conv", sorted(CONVS))
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_conv2d_rule_matches_lxt_tpu(spec, conv):
    strides, padding, shape = CONVS[conv]
    rng = np.random.default_rng(2)
    x = _away_from_zero(rng, shape)
    w = (0.3 * rng.standard_normal((4, 4, 3, 6))).astype(np.float32)
    b = (0.1 * rng.standard_normal(6)).astype(np.float32)
    jc = lxt_tpu.cp_lrp.with_rules(conv=SPECS[spec])
    tc = lxt_tpu_torch.cp_lrp.with_rules(conv=SPECS[spec])

    def jfn(e):
        return jc.conv2d(e, jnp.asarray(w), jnp.asarray(b), strides, padding)

    cot = rng.standard_normal(jax.eval_shape(jfn, jnp.asarray(x)).shape
                              ).astype(np.float32)
    (fo, fw), (ro, rw) = _both(
        jfn, lambda e: tc.conv2d(e, torch.tensor(w), torch.tensor(b),
                                 strides, padding), x, cot)
    assert fo.shape == fw.shape
    assert _nl2(fo, fw) <= BAR
    assert _nl2(ro, rw) <= BAR, _nl2(ro, rw)
    if conv == "valid_remainder":   # the rows and columns the conv drops
        assert np.all(ro[:, 16:] == 0) and np.all(ro[:, :, 16:] == 0)


@pytest.mark.parametrize("kind", ["linear", "conv2d"])
def test_rules_keep_bf16_and_give_weights_no_gradient(kind):
    x = torch.randn(2, 8, 8, 3, dtype=torch.bfloat16).requires_grad_(True)
    w = torch.randn(4, 4, 3, 5, dtype=torch.bfloat16).requires_grad_(True)
    if kind == "linear":
        x2 = x.reshape(2, 64, 3)
        out = trules.alphabeta_linear(x2, w[0, 0], None, 2.0, 1.0)
    else:
        out = trules.gamma_conv2d(x, w, None, (4, 4), "VALID", 0.25)
    gx, gw = torch.autograd.grad(out.sum(), (x, w), allow_unused=True)
    assert gx.dtype == torch.bfloat16 and gw is None


def test_quantized_weight_under_a_rule_is_dequantized_first():
    rng = np.random.default_rng(3)
    x = _away_from_zero(rng, (3, 64))
    w = (0.2 * rng.standard_normal((64, 16))).astype(np.float32)
    jw, tw = jq.quantize(jnp.asarray(w), 8), tq.quantize(torch.tensor(w), 8)
    cot = rng.standard_normal((3, 16)).astype(np.float32)
    jc = lxt_tpu.attnlrp.with_rules(linear=("gamma", 0.25))
    tc = lxt_tpu_torch.attnlrp.with_rules(linear=("gamma", 0.25))
    (fo, fw), (ro, rw) = _both(lambda e: jc.linear(e, jw),
                               lambda e: tc.linear(e, tw), x, cot)
    assert _nl2(fo, fw) <= BAR and _nl2(ro, rw) <= BAR
    xt = torch.tensor(x, requires_grad=True)
    want = trules.gamma_linear(xt, tq.dequantize(tw), None, 0.25)
    np.testing.assert_array_equal(tc.linear(xt, tw).detach().numpy(),
                                  want.detach().numpy())


def test_modz_reads_zero_at_zero_input():
    """The Gradient*Input caveat: flat relevance reads 0 where x is 0, and
    equal shares elsewhere."""
    x = torch.tensor([[0.0, 0.5, 1.0, 0.25]], requires_grad=True)
    out = trules.modz_linear(x, torch.ones(4, 3), None, ("flat",))
    (g,) = torch.autograd.grad(out.sum(), x)
    rel = (g * x).detach().numpy()[0]
    assert rel[0] == 0.0
    np.testing.assert_allclose(rel[1:], rel[1], rtol=1e-5)


# ---------------------------------------------------------------------------
# the Composite surface
# ---------------------------------------------------------------------------

BUILDS = {
    "with_gamma": lambda c: c.cp_lrp.with_gamma(conv_gamma=0.25, linear_gamma=0.05),
    "with_gamma_twice": lambda c: c.attnlrp.with_gamma(linear_gamma=0.1).with_gamma(
        conv_gamma=0.5),
    "with_rules": lambda c: c.attnlrp.with_rules(linear="zplus",
                                                 conv=("zbox", -1, 2)),
    "with_rules_keep": lambda c: c.attnlrp.with_rules(linear=("alphabeta", 3, 2)
                                                      ).with_rules(conv="flat"),
    "override_sites": lambda c: c.cp_lrp.with_rules(linear=("gamma", 0.5)).override_sites(
        wq=None, conv_w="wsquare").override_sites(wq=("gamma", 0.1)),
    "override_layers": lambda c: c.attnlrp.override_layers(
        (0, 2), attention="cp").override_layers(-1, linear_rule="zplus"
                                                ).override_layers((-2, None), gate="cp"),
    "everything": lambda c: c.vanilla_gradient.with_gamma(conv_gamma=0.3).with_rules(
        linear="epsilon").override_sites(w_fc=("gamma", 0.25)).override_layers(
        1, linear_gamma=0.2, norm="identity"),
}


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_composite_surface_matches_lxt_tpu(build):
    jc, tc = BUILDS[build](lxt_tpu), BUILDS[build](lxt_tpu_torch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.summary(verbose=False) == jc.summary(verbose=False)
    for i in range(4):
        assert (dataclasses.asdict(tc.for_layer(i, 4))
                == dataclasses.asdict(jc.for_layer(i, 4))), i
    hash(tc)
    assert tc.for_layer(0, 4).layer_overrides == ()


BAD = {"zbox_order": lambda c: c.attnlrp.with_rules(linear=("zbox", 1.0, 0.0)),
       "alphabeta_sum": lambda c: c.attnlrp.with_rules(conv=("alphabeta", 2, 2)),
       "unknown_spec": lambda c: c.attnlrp.override_sites(wq=("nonsense",)),
       "unknown_field": lambda c: c.attnlrp.override_layers(0, colour="red"),
       "negative_needs_L": lambda c: c.attnlrp.override_layers(
           (-2, None), gate="cp").for_layer(0)}


@pytest.mark.parametrize("case", sorted(BAD))
def test_rule_spec_errors_match_lxt_tpu(case):
    with pytest.raises(ValueError) as jerr:
        BAD[case](lxt_tpu)
    with pytest.raises(ValueError) as terr:
        BAD[case](lxt_tpu_torch)
    assert str(terr.value) == str(jerr.value)


def test_norm_rule_spec_matches_lxt_tpu():
    for spec in (None, "epsilon", "pass", ("gamma", 1), "zplus", ("alphabeta", 2, 1),
                 "flat", ("wsquare",), ("zbox", -1, 1)):
        assert tcomp._norm_rule_spec(spec) == jcomp._norm_rule_spec(spec), spec
        assert (tcomp._rule_text(tcomp._norm_rule_spec(spec))
                == jcomp._rule_text(jcomp._norm_rule_spec(spec)))


# ---------------------------------------------------------------------------
# site and depth overrides through every text family
# ---------------------------------------------------------------------------

def _hf(family):
    torch.manual_seed(5)
    if family == "llama":
        return LlamaForCausalLM(LlamaConfig(
            vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=64))
    if family == "gemma3":
        return Gemma3ForCausalLM(Gemma3TextConfig(
            vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
            head_dim=16, sliding_window=8, query_pre_attn_scalar=16,
            max_position_embeddings=64))
    if family == "gpt2":
        return GPT2LMHeadModel(GPT2Config(vocab_size=64, n_embd=32, n_layer=2,
                                          n_head=2, n_positions=64))
    if family == "bert":
        return BertForSequenceClassification(BertConfig(
            vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64, num_labels=3))
    return MixtralForCausalLM(MixtralConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64))


# family -> (base composite, a site of its layers, a site of its MLP)
FAMILY_SITES = {"llama": ("attnlrp", "wq", "wd"), "gemma3": ("attnlrp", "wk", "wu"),
                "gpt2": ("cp_lrp", "w_attn", "w_fc"), "bert": ("attnlrp", "wv", "wi"),
                "mixtral": ("attnlrp", "wo", "w_router")}


@pytest.mark.parametrize("family", sorted(FAMILY_SITES))
def test_site_and_depth_overrides_match_lxt_tpu(family):
    base, site, other = FAMILY_SITES[family]

    def comp(pkg):
        return (getattr(pkg, base)
                .override_layers(0, linear_rule=("alphabeta", 1.5, 0.5))
                .override_layers((-1, None), linear_rule=("alphabeta", 2.0, 1.0))
                .override_sites(**{site: "zplus", other: None}))

    hf = _hf(family).eval()
    jm = lxt_tpu.from_hf(hf, composite=comp(lxt_tpu))
    tm = lxt_tpu_torch.from_hf(hf, composite=comp(lxt_tpu_torch), device="cpu")
    ids = np.random.default_rng(6).integers(1, 64, (2, 12))
    jv, jrel = jm.attribute(ids)
    tv, trel = tm.attribute(ids)
    assert _nl2(tv.numpy(), jv) <= BAR
    assert _nl2(trel.numpy(), jrel) <= BAR, _nl2(trel.numpy(), jrel)
    # the overrides change the map: the plain composite gives another
    plain = tm.attribute(ids, composite=base)[1]
    assert _nl2(plain.numpy(), trel.numpy()) > 1e-3
