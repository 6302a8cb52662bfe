"""The lxt_tpu_torch BERT model against lxt_tpu's, on CPU.

A tiny float32 config (2 layers, D 64, 2 heads, vocab 97, 3 labels) runs
through both packages on the same numpy weights
(``convert.params_from_numpy``, which takes BERT's tree unchanged) and
inputs at T 128, a multiple of 128, so the port's flash path (the kernels'
plain versions on CPU) is eligible. Logits and input relevance agree
within normalized L2 1e-5 under attnlrp, cp_lrp and vanilla_gradient, with
no padding, right padding by ``kv_end`` and an ``attention_mask``, on the
port's flash and einsum paths; lxt_tpu runs its einsum path, and its flash
kernel (interpret mode) for one ``kv_end`` case. Also: token types, probes
and hidden states, HF's logits, ``from_pretrained`` and the padding rules.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import BertConfig as HFBertConfig
from transformers import BertForSequenceClassification

import lxt_tpu
import lxt_tpu_torch
from lxt_tpu.attribution import input_relevance as j_input_relevance
from lxt_tpu.attribution import latent_relevance as j_latent_relevance
from lxt_tpu.models import bert as jbert
from lxt_tpu.models import registry as jreg
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import bert as tbert
from lxt_tpu_torch.models import registry as treg

BAR = 1e-5  # normalized L2, float32
T, B, LABELS = 128, 2, 3
KV_END = [T, 77]
PADDINGS = ("none", "kv_end", "attention_mask")


def _cfg():
    return jbert.BertConfig(vocab_size=97, hidden_size=64, intermediate_size=128,
                            num_layers=2, num_heads=2, max_positions=T,
                            num_labels=LABELS)


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _numpy_params(cfg, seed=0):
    """Random numpy weights in lxt_tpu's layout; LayerNorm weights and
    biases away from 1 and 0."""
    rng = np.random.default_rng(seed)
    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size

    def w(*s, scale=0.05):
        return (scale * rng.standard_normal(s)).astype(np.float32)

    layers = {}
    for name, shape in (("q", (D, D)), ("k", (D, D)), ("v", (D, D)), ("o", (D, D)),
                        ("i", (D, I)), ("out", (I, D))):
        layers["w" + name] = w(L, *shape)
        layers["b" + name] = w(L, shape[1])
    for ln in ("ln1", "ln2"):
        layers[ln + "_w"], layers[ln + "_b"] = 1 + w(L, D), w(L, D)
    return {"word_emb": w(cfg.vocab_size, D, scale=0.5),
            "pos_emb": w(cfg.max_positions, D, scale=0.5),
            "type_emb": w(cfg.type_vocab_size, D, scale=0.5),
            "emb_ln_w": 1 + w(D), "emb_ln_b": w(D),
            "pooler_w": w(D, D, scale=0.2), "pooler_b": w(D),
            "cls_w": w(D, cfg.num_labels, scale=0.2), "cls_b": w(cfg.num_labels),
            "layers": layers}


@pytest.fixture(scope="module")
def setup():
    jcfg = _cfg()
    np_params = _numpy_params(jcfg)
    tcfg = tbert.BertConfig(**dataclasses.asdict(jcfg))
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, T))
    return (jcfg, jax.tree.map(jnp.asarray, np_params), tcfg,
            params_from_numpy(np_params, device="cpu"), ids)


def _padding(name):
    if name == "kv_end":
        return {"kv_end": np.asarray(KV_END, np.int32)}
    if name == "attention_mask":
        return {"attention_mask": (np.arange(T)[None] < np.asarray(KV_END)[:, None]
                                   ).astype(np.int32)}
    return {}


_JAX = {}


def _jax_run(setup, composite, padding, impl="einsum"):
    key = (composite, padding, impl)
    if key not in _JAX:
        jcfg, jparams, _, _, ids = setup
        comp = getattr(lxt_tpu, composite)
        kw = {k: jnp.asarray(v) for k, v in _padding(padding).items()}

        def logits(e):
            return jbert.forward(jparams, jcfg, e, comp, remat=False,
                                 attn_impl=impl, **kw).logits

        e = jbert.embed(jparams, jnp.asarray(ids))
        _, rel = j_input_relevance(lambda x: logits(x).max(axis=-1).sum(), e)
        _JAX[key] = (np.asarray(logits(e)), np.asarray(rel))
    return _JAX[key]


def _torch_run(setup, composite, padding, impl):
    _, _, tcfg, tparams, ids = setup
    comp = getattr(lxt_tpu_torch, composite)
    kw = {k: torch.as_tensor(v) for k, v in _padding(padding).items()}

    def logits(e):
        return tbert.forward(tparams, tcfg, e, comp, remat=False, attn_impl=impl,
                             **kw).logits

    e = tbert.embed(tparams, torch.as_tensor(ids))
    with torch.no_grad():
        out = logits(e)
    _, rel = lxt_tpu_torch.input_relevance(
        lambda x: logits(x).max(dim=-1).values.sum(), e)
    return out.numpy(), rel.numpy()


@pytest.mark.parametrize("impl", ["flash", "einsum"])
@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("composite", ["attnlrp", "cp_lrp", "vanilla_gradient"])
def test_forward_and_relevance_match_lxt_tpu(setup, composite, padding, impl):
    want_logits, want_rel = _jax_run(setup, composite, padding)
    logits, rel = _torch_run(setup, composite, padding, impl)
    assert _nl2(logits, want_logits) <= BAR
    assert _nl2(rel, want_rel) <= BAR
    if padding != "none":   # the padding reaches no logit through [CLS]
        assert (rel[1, KV_END[1]:] == 0).all()


def test_kv_end_matches_lxt_tpu_flash_kernel(setup):
    """lxt_tpu's flash kernel (interpret mode) with kv_end against the
    port's flash path (the kernels' plain versions)."""
    want_logits, want_rel = _jax_run(setup, "attnlrp", "kv_end", impl="flash")
    logits, rel = _torch_run(setup, "attnlrp", "kv_end", "flash")
    assert _nl2(logits, want_logits) <= BAR
    assert _nl2(rel, want_rel) <= BAR


def test_token_types_probes_and_hidden_states_match_lxt_tpu(setup):
    """token_type_ids, hidden states and per-layer relevance through the
    probes, right-padded by kv_end, against lxt_tpu."""
    jcfg, jparams, tcfg, tparams, ids = setup
    types = np.zeros((B, T), np.int64)
    types[:, 40:] = 1
    L = jcfg.num_layers

    def jf(e, probes):
        out = jbert.forward(jparams, jcfg, e, lxt_tpu.attnlrp, remat=False,
                            attn_impl="einsum", kv_end=jnp.asarray(KV_END),
                            token_type_ids=jnp.asarray(types), probes=probes,
                            output_hidden_states=True)
        return out.logits.max(axis=-1).sum(), out.hidden_states

    def tf(e, probes):
        out = tbert.forward(tparams, tcfg, e, lxt_tpu_torch.attnlrp, remat=True,
                            attn_impl="flash", kv_end=torch.as_tensor(KV_END),
                            token_type_ids=torch.as_tensor(types), probes=probes,
                            output_hidden_states=True)
        return out.logits.max(dim=-1).values.sum(), out.hidden_states

    je = jbert.embed(jparams, jnp.asarray(ids))
    te = tbert.embed(tparams, torch.as_tensor(ids))
    jv, jrel, jlat = j_latent_relevance(jf, je, (L, B, T, jcfg.hidden_size))
    tv, trel, tlat = lxt_tpu_torch.latent_relevance(tf, te, (L, B, T, tcfg.hidden_size))
    assert tlat.shape == (L, B, T, tcfg.hidden_size)
    assert abs(float(tv) - float(jv)) <= BAR * abs(float(jv))
    assert _nl2(trel.numpy(), jrel) <= BAR
    assert _nl2(tlat.numpy(), jlat) <= BAR
    with torch.no_grad():
        hid = tf(te, None)[1]
    jhid = jf(je, None)[1]
    assert hid.shape == (L + 1, B, T, tcfg.hidden_size)
    assert _nl2(hid.numpy(), jhid) <= BAR
    # the types matter: type 0 everywhere gives other logits
    with torch.no_grad():
        plain = tbert.forward(tparams, tcfg, te, kv_end=torch.as_tensor(KV_END)).logits
        typed = tbert.forward(tparams, tcfg, te, kv_end=torch.as_tensor(KV_END),
                              token_type_ids=torch.as_tensor(types)).logits
    assert (plain - typed).abs().max() > 1e-3


def test_padded_row_equals_its_tokens_unpadded(setup):
    """A right-padded row's relevance equals that of its tokens alone (the
    einsum path at T 77) and is exactly 0 on the padding."""
    _, _, tcfg, tparams, ids = setup
    model = treg.AttributionModel("bert", tcfg, tparams, lxt_tpu_torch.attnlrp)
    _, rel = model.attribute(ids, kv_end=KV_END)
    _, alone = model.attribute(ids[1:, :KV_END[1]])
    assert _nl2(rel[1, :KV_END[1]].numpy(), alone[0].numpy()) <= BAR
    assert (rel[1, KV_END[1]:] == 0).all()


def _hf_bert(seed=0, **kw):
    torch.manual_seed(seed)
    cfg = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=128,
               max_position_embeddings=T, num_labels=LABELS)
    return BertForSequenceClassification(HFBertConfig(**dict(cfg, **kw),
                                                      attn_implementation="eager")).eval()


def test_params_from_hf_matches_hf_and_lxt_tpu():
    """A loaded BertForSequenceClassification through from_hf: logits
    within atol 3e-4 of HF's (with and without its attention mask),
    relevance within 1e-5 of lxt_tpu's; the classification target."""
    hf = _hf_bert()
    ids = np.random.default_rng(2).integers(0, 97, (B, T))
    mask = (np.arange(T)[None] < np.asarray(KV_END)[:, None]).astype(np.int64)
    jm, tm = lxt_tpu.from_hf(hf), lxt_tpu_torch.from_hf(hf, device="cpu")
    assert tm.family == jm.family == "bert" and tm.composite == lxt_tpu_torch.attnlrp
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert tm.cfg.num_labels == LABELS
    with torch.no_grad():
        want = hf(input_ids=torch.as_tensor(ids)).logits.numpy()
        want_masked = hf(input_ids=torch.as_tensor(ids),
                         attention_mask=torch.as_tensor(mask)).logits.numpy()
    np.testing.assert_allclose(tm.logits(ids).numpy(), want, rtol=0, atol=3e-4)
    run = tm._forward(None, kv_end=KV_END)
    with torch.no_grad():
        got = run(tm.embed(ids)).logits.numpy()
    np.testing.assert_allclose(got, want_masked, rtol=0, atol=3e-4)
    for kw in ({}, {"kv_end": np.asarray(KV_END, np.int32)}, {"attention_mask": mask}):
        jv, jrel = jm.attribute(ids, **kw)
        tv, trel = tm.attribute(ids, **kw)
        assert _nl2(tv.numpy(), jv) <= BAR, kw
        assert _nl2(trel.numpy(), jrel) <= BAR, kw
    jv, jrel, jlat = jm.attribute_latent(ids)
    tv, trel, tlat = tm.attribute_latent(ids)
    assert _nl2(trel.numpy(), jrel) <= BAR and _nl2(tlat.numpy(), jlat) <= BAR


def test_classifier_targets_and_multi_maps():
    """token= picks a label; attribute_multi and attribute_topk run on the
    [B, num_labels] logits, each map equal to its separate attribution."""
    tm = lxt_tpu_torch.from_hf(_hf_bert(seed=1), device="cpu")
    ids = np.random.default_rng(3).integers(0, 97, (B, T))
    labels = np.asarray([2, 0])
    v, rel = tm.attribute(ids, token=labels)
    logits = tm.logits(ids)
    assert abs(float(v) - float(logits[0, 2] + logits[1, 0])) <= 1e-5
    toks, values, maps = tm.attribute_topk(ids, 2, kv_end=KV_END)
    assert toks.shape == (2, B) and maps.shape == (2, B, T)
    for k in range(2):
        _, want = tm.attribute(ids, token=toks[k], kv_end=KV_END)
        assert _nl2(maps[k].numpy(), want.numpy()) <= BAR
    _, multi = tm.attribute_multi(ids, [1, 2])
    _, want = tm.attribute(ids, token=[1, 1])
    assert _nl2(multi[0].numpy(), want.numpy()) <= BAR
    with pytest.raises(ValueError, match="causal LM head"):
        tm.generate(ids, 2)


def test_from_pretrained_matches_lxt_tpu(tmp_path):
    """A written tiny BertForSequenceClassification checkpoint: the
    config.json reader (num_labels from id2label), the weights, logits and
    right-padded relevance, against lxt_tpu's from_pretrained."""
    _hf_bert(seed=4).save_pretrained(tmp_path)
    raw = json.loads((tmp_path / "config.json").read_text())
    assert "num_labels" not in raw and len(raw["id2label"]) == LABELS
    jm = jreg.from_pretrained(tmp_path)
    tm = treg.from_pretrained(tmp_path, device="cpu")
    assert tm.family == "bert" and dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    for name, leaf in jm.params["layers"].items():
        np.testing.assert_array_equal(tm.params["layers"][name].numpy(), np.asarray(leaf))
    np.testing.assert_array_equal(tm.params["cls_w"].numpy(), np.asarray(jm.params["cls_w"]))
    ids = np.random.default_rng(5).integers(0, 97, (B, T))
    assert _nl2(tm.logits(ids).numpy(), jm.logits(ids)) <= BAR
    jv, jrel = jm.attribute(ids, kv_end=np.asarray(KV_END, np.int32))
    tv, trel = tm.attribute(ids, kv_end=KV_END)
    assert _nl2(tv.numpy(), jv) <= BAR and _nl2(trel.numpy(), jrel) <= BAR


def test_read_hf_config_bert_matches_autoconfig(tmp_path):
    """Keys left out of config.json take transformers' BertConfig defaults
    (bert-base's widths, 2 labels)."""
    from transformers import AutoConfig
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "bert"}))
    want = jbert.BertConfig.from_hf(AutoConfig.from_pretrained(tmp_path))
    got = tbert.BertConfig.from_hf(treg.read_hf_config(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == tbert.BertConfig()


def test_padding_refusals():
    """The padding rules of lxt_tpu's registry (tests/test_padding_api.py):
    BERT refuses kv_begin, the causal families refuse kv_end, and a mask
    never comes with a span."""
    with pytest.raises(ValueError, match="BERT .*right-padded"):
        treg._padding_args("bert", np.array([0]), None, None, "cpu")
    with pytest.raises(ValueError, match="kv_end is the BERT"):
        treg._padding_args("llama", None, None, np.array([6]), "cpu")
    for family, span in (("bert", {"kv_end": [6]}), ("llama", {"kv_begin": [0]})):
        with pytest.raises(ValueError, match="not both"):
            treg._padding_args(family, span.get("kv_begin"), np.ones((1, 6)),
                               span.get("kv_end"), "cpu")
    tm = lxt_tpu_torch.from_hf(_hf_bert(seed=6), device="cpu")
    with pytest.raises(ValueError, match="BERT .*right-padded"):
        tm.attribute(np.ones((1, T), np.int64), kv_begin=[0])
