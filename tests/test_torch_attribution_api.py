"""The port's attribution API (lxt_tpu_torch.attribution and the
AttributionModel methods) against lxt_tpu's, on CPU.

A tiny float32 Llama (2 layers, D 64, 4 q / 2 kv heads, vocab 97) runs
through both packages on the same numpy weights (``convert.params_from_numpy``)
at T 128, so the port's flash path is eligible: the port runs its einsum
path and its flash path (the kernels' plain versions through the flash
autograd Function, so every retained-graph pull goes through it); lxt_tpu
runs its einsum path. The multi-target functions, latent relevance and the
model methods must agree within normalized L2 <= 1e-5; top-k token ids
and the contrastive rivals exactly. The model methods run on a tiny HF
Llama and a tiny HF Gemma-3 text model through ``from_hf``, with
``kv_begin`` left padding. K pulls through one graph must equal K fresh
attributions, with and without remat.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import Gemma3ForCausalLM, Gemma3TextConfig
from transformers.models.llama.modeling_llama import LlamaConfig, LlamaForCausalLM

import lxt_tpu
import lxt_tpu_torch
from lxt_tpu import attribution as ja
from lxt_tpu.models import llama as jllama
from lxt_tpu_torch import attribution as ta
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import llama as tllama
from lxt_tpu_torch.models import registry as treg

BAR = 1e-5  # normalized L2, float32
T, B, VOCAB = 128, 2, 97
IMPLS = ["einsum", "flash"]
CFG = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
           num_layers=2, num_heads=4, num_kv_heads=2)


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _close(got, want, bar=BAR):
    """Each pair of (port, lxt_tpu) outputs within ``bar`` normalized L2."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().numpy() if torch.is_tensor(g) else g
        assert np.shape(g) == np.shape(w), (i, np.shape(g), np.shape(w))
        assert _nl2(g, w) <= bar, (i, _nl2(g, w))


@functools.lru_cache(maxsize=None)
def _tiny():
    """The tiny Llama in both packages, its embeds for one batch, and the
    packages' forwards of them."""
    rng = np.random.default_rng(0)
    jcfg = jllama.LlamaConfig(**CFG)
    L, D, I, hd = 2, 64, 128, jcfg.hd

    def w(*s):
        return (0.1 * rng.standard_normal(s)).astype(np.float32)

    params = {"embed": w(VOCAB, D), "final_norm": 1 + w(D),
              "lm_head": w(D, VOCAB),
              "layers": dict(ln1=1 + w(L, D), ln2=1 + w(L, D), wq=w(L, D, 4 * hd),
                             wk=w(L, D, 2 * hd), wv=w(L, D, 2 * hd),
                             wo=w(L, 4 * hd, D), wg=w(L, D, I), wu=w(L, D, I),
                             wd=w(L, I, D))}
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, device="cpu")
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    ids = rng.integers(0, VOCAB, (B, T))
    return (jcfg, jp, jllama.embed(jp, jnp.asarray(ids)),
            tcfg, tp, tllama.embed(tp, torch.as_tensor(ids)))


def _fwds(impl, composite="attnlrp", remat=False):
    """(lxt_tpu forward, port forward): ``f(embeds, **kw) -> ModelOutputs``."""
    jcfg, jp, _, tcfg, tp, _ = _tiny()
    jc, tc = getattr(lxt_tpu, composite), getattr(lxt_tpu_torch, composite)
    return (lambda e, **kw: jllama.forward(jp, jcfg, e, jc, remat=False,
                                           attn_impl="einsum", **kw),
            lambda e, **kw: tllama.forward(tp, tcfg, e, tc, remat=remat,
                                           attn_impl=impl, **kw))


def _embeds():
    _, _, je, _, _, te = _tiny()
    return je, te


# ---------------------------------------------------------------------------
# the functions of attribution.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sum_features", [False, True])
@pytest.mark.parametrize("impl,remat", [("einsum", False), ("flash", False),
                                        ("flash", True)])
def test_latent_relevance_matches_lxt_tpu(impl, remat, sum_features):
    jf, tf = _fwds(impl, remat=remat)
    je, te = _embeds()
    shape = (2, B, T, 64)

    def probed(f, select):
        def run(e, probes):
            out = f(e, probes=probes, output_hidden_states=True, logits_at=-1)
            return select(out.logits, position=-1), out.hidden_states
        return run

    want = ja.latent_relevance(probed(jf, ja.select_logit), je, shape,
                               sum_features=sum_features)
    got = ta.latent_relevance(probed(tf, ta.select_logit), te, shape,
                              sum_features=sum_features)
    _close(got, want)
    assert got[1].dtype == got[2].dtype == torch.float32


@pytest.mark.parametrize("via", ["scan", "vmap"])
@pytest.mark.parametrize("impl", IMPLS)
def test_multi_token_relevance_matches_lxt_tpu(impl, via):
    jf, tf = _fwds(impl)
    je, te = _embeds()
    for tokens in ([3, 50, 7], [[3, 4], [50, 60], [7, 96]]):
        want = ja.multi_token_relevance(lambda e: jf(e).logits, je,
                                        jnp.asarray(tokens), via=via)
        got = ta.multi_token_relevance(lambda e: tf(e).logits, te, tokens,
                                       via=via)
        _close(got, want)
        assert got[1].shape == (3, B, T)
    # a forward that computes only the row (logits_at) gives the same maps
    got_row = ta.multi_token_relevance(lambda e: tf(e, logits_at=-1).logits,
                                       te, tokens, via=via)
    _close(got_row, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_topk_relevance_matches_lxt_tpu(impl):
    jf, tf = _fwds(impl)
    je, te = _embeds()
    jt, jv, jr = ja.topk_relevance(lambda e: jf(e).logits, je, 4, position=70)
    tt, tv, tr = ta.topk_relevance(lambda e: tf(e).logits, te, 4, position=70)
    assert torch.equal(tt, torch.from_numpy(np.array(jt)).long())
    _close((tv, tr), (jv, jr))


def test_topk_orders_tied_logits_as_lax_top_k():
    """Exactly equal logits (identical lm_head columns) come out lower id
    first, as jax.lax.top_k orders them."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 8, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    bias = np.zeros(40, np.float32)
    for tied in (29, 3, 17, 8):
        w[:, tied] = w[:, 5]
        bias[tied] = bias[5] = 50.0
    jt, jv, jr = ja.topk_relevance(lambda e: e @ w + bias, jnp.asarray(x), 6)
    tw, tb = torch.from_numpy(w), torch.from_numpy(bias)
    tt, tv, tr = ta.topk_relevance(lambda e: e @ tw + tb, torch.from_numpy(x), 6)
    assert tt[:5, 0].tolist() == [3, 5, 8, 17, 29]
    assert torch.equal(tt, torch.from_numpy(np.array(jt)).long())
    _close((tv, tr), (jv, jr))


@pytest.mark.parametrize("contrastive", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_multi_site_relevance_matches_lxt_tpu(impl, contrastive):
    jf, tf = _fwds(impl)
    je, te = _embeds()
    positions, tokens = [5, 100, -1], [[3, 4], [50, 60], [7, 96]]
    want = ja.multi_site_relevance(lambda e: jf(e).logits, je,
                                   jnp.asarray(positions), jnp.asarray(tokens),
                                   contrastive=contrastive)
    got = ta.multi_site_relevance(lambda e: tf(e).logits, te, positions,
                                  tokens, contrastive=contrastive)
    _close(got, want)


def test_multi_site_relevance_aux_input_matches_lxt_tpu():
    """A two-input toy function: the second input's relevance too."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 6, 8)).astype(np.float32)
    aux = rng.standard_normal((B, 6, 3)).astype(np.float32)
    w = rng.standard_normal((8, 11)).astype(np.float32)
    u = rng.standard_normal((3, 11)).astype(np.float32)
    tw, tu = torch.from_numpy(w), torch.from_numpy(u)
    for sum_features in (True, False):
        want = ja.multi_site_relevance(
            lambda e, a: jnp.tanh(e @ w) * (a @ u), jnp.asarray(x),
            jnp.asarray([1, 4]), jnp.asarray([2, 9]),
            aux_input=jnp.asarray(aux), sum_features=sum_features)
        got = ta.multi_site_relevance(
            lambda e, a: torch.tanh(e @ tw) * (a @ tu), torch.from_numpy(x),
            [1, 4], [2, 9], aux_input=torch.from_numpy(aux),
            sum_features=sum_features)
        assert len(got) == 3
        _close(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_multi_site_latent_relevance_matches_lxt_tpu(impl):
    jf, tf = _fwds(impl)
    je, te = _embeds()

    def probed(f):
        def run(e, probes):
            out = f(e, probes=probes, output_hidden_states=True)
            return out.logits, out.hidden_states
        return run

    shape = (2, B, T, 64)
    want = ja.multi_site_latent_relevance(probed(jf), je, jnp.asarray([9, -1]),
                                          jnp.asarray([3, 50]), shape)
    got = ta.multi_site_latent_relevance(probed(tf), te, [9, -1], [3, 50], shape)
    _close(got, want)
    assert got[2].shape == (2, 2, B, T)


def test_contrastive_target_and_normalize_relevance_match_lxt_tpu():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 5, 13)).astype(np.float32)
    tl = torch.from_numpy(logits)
    for a, b, pos in ((4, 9, -1), ([1, 2, 3], [4, 5, 6], 2)):
        want = ja.contrastive_target(jnp.asarray(logits), a, b, position=pos)
        got = ta.contrastive_target(tl, a, b, position=pos)
        assert abs(float(got) - float(want)) <= 1e-6
    rel = rng.standard_normal((3, 7)).astype(np.float32)
    for axis in (None, -1, 0):
        want = ja.normalize_relevance(jnp.asarray(rel), axis=axis)
        got = ta.normalize_relevance(torch.from_numpy(rel), axis=axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_select_logit_broadcasts_one_token_over_the_batch():
    logits = np.random.default_rng(7).standard_normal((3, 4, 9)).astype(np.float32)
    want = ja.select_logit(jnp.asarray(logits), token=5)
    got = ta.select_logit(torch.from_numpy(logits), token=5)
    assert abs(float(got) - float(want)) <= 1e-6


def test_via_must_be_scan_or_vmap():
    _, tf = _fwds("einsum")
    _, te = _embeds()
    calls = [
        lambda via: ta.multi_token_relevance(lambda e: tf(e).logits, te, [1], via=via),
        lambda via: ta.topk_relevance(lambda e: tf(e).logits, te, 2, via=via),
        lambda via: ta.multi_site_relevance(lambda e: tf(e).logits, te, [1], [1],
                                            via=via),
        lambda via: ta.multi_site_latent_relevance(None, te, [1], [1], (2, B, T, 64),
                                                   via=via),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="via must be 'scan' or 'vmap'"):
            call("loop")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_pulls_through_one_graph_equal_fresh_attributions(impl, remat):
    """Two pulls through one retained graph (the flash Function's saved
    q, k, v, out and lse; checkpointed layers under remat) give what two
    fresh attributions give: no backward writes into a saved tensor."""
    _, tf = _fwds(impl, remat=remat)
    _, te = _embeds()
    tokens = [[3, 4], [50, 60]]
    _, rel = ta.multi_token_relevance(lambda e: tf(e, logits_at=-1).logits, te,
                                      tokens)
    for k, tok in enumerate(tokens):
        _, fresh = ta.input_relevance(lambda e: ta.select_logit(
            tf(e, logits_at=-1).logits, token=tok), te)
        torch.testing.assert_close(rel[k], fresh, rtol=0, atol=1e-6)
    sites = ta.multi_site_relevance(lambda e: tf(e).logits, te, [3, -1], tokens)
    for k, (pos, tok) in enumerate(zip([3, -1], tokens)):
        _, fresh = ta.input_relevance(lambda e: ta.select_logit(
            tf(e).logits, position=pos, token=tok), te)
        torch.testing.assert_close(sites[1][k], fresh, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the AttributionModel methods, on tiny HF models through from_hf
# ---------------------------------------------------------------------------

def _hf(family):
    torch.manual_seed(3)
    if family == "llama":
        return LlamaForCausalLM(LlamaConfig(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=VOCAB,
            max_position_embeddings=T)).eval()
    model = Gemma3ForCausalLM(Gemma3TextConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=64, sliding_window=48, query_pre_attn_scalar=64,
        max_position_embeddings=512,
        layer_types=["sliding_attention", "full_attention"])).eval()
    with torch.no_grad():   # HF initialises the norm weights to 0
        for name, p in model.named_parameters():
            if "norm" in name:
                p.normal_(0.0, 0.1)
    return model


@functools.lru_cache(maxsize=None)
def _models(family):
    hf = _hf(family)
    tm = lxt_tpu_torch.from_hf(hf, device="cpu")
    assert tm.family == family
    return lxt_tpu.from_hf(hf), tm


def _port(monkeypatch, family, impl):
    """The port's model with remat off, its forward on ``impl``'s attention
    path (the model runs 'auto', the einsum path on CPU tensors)."""
    table = treg.FAMILIES[family]
    monkeypatch.setitem(table, "forward",
                        functools.partial(table["forward"], attn_impl=impl))
    return dataclasses.replace(_models(family)[1], remat=False)


def _ids(seed=8):
    return np.random.default_rng(seed).integers(0, VOCAB, (B, T))


KV_BEGIN = np.asarray([0, 37], np.int32)
FAMILIES = ["llama", "gemma3_text"]


@functools.lru_cache(maxsize=None)
def _jax_method(family, method, padded):
    jm = _models(family)[0]
    kw = {"kv_begin": KV_BEGIN} if padded else {}
    if method == "latent":
        return jm.attribute_latent(_ids())
    if method == "multi":
        return jm.attribute_multi(_ids(), jnp.asarray([3, 50, 96]), **kw)
    if method == "topk":
        return jm.attribute_topk(_ids(), 3, position=-2, **kw)
    return jm.faithfulness(_ids(), steps=4, baseline="mean", **kw)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("family", FAMILIES)
def test_model_attribute_latent_matches_lxt_tpu(monkeypatch, family, impl):
    got = _port(monkeypatch, family, impl).attribute_latent(_ids())
    _close(got, _jax_method(family, "latent", False))
    assert got[2].shape == (2, B, T, 64)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("family", FAMILIES)
def test_model_attribute_multi_and_topk_match_lxt_tpu(monkeypatch, family, impl,
                                                      padded):
    tm = _port(monkeypatch, family, impl)
    kw = {"kv_begin": KV_BEGIN} if padded else {}
    _close(tm.attribute_multi(_ids(), [3, 50, 96], **kw),
           _jax_method(family, "multi", padded))
    tt, tv, tr = tm.attribute_topk(_ids(), 3, position=-2, **kw)
    jt, jv, jr = _jax_method(family, "topk", padded)
    assert torch.equal(tt, torch.from_numpy(np.array(jt)).long())
    _close((tv, tr), (jv, jr))


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("family", FAMILIES)
def test_model_faithfulness_matches_lxt_tpu(monkeypatch, family, impl, padded):
    kw = {"kv_begin": KV_BEGIN} if padded else {}
    got = _port(monkeypatch, family, impl).faithfulness(_ids(), steps=4,
                                                        baseline="mean", **kw)
    want = _jax_method(family, "faithfulness", padded)
    assert set(got) == set(want)
    for order in ("morf", "lerf"):
        _close((got[order].fractions, got[order].values, got[order].aopc),
               (want[order].fractions, want[order].values, want[order].aopc))
    for key in ("auc_morf", "auc_lerf", "aopc_morf", "aopc_lerf", "abpc"):
        _close((got[key],), (want[key],))
    # the random control: the same unperturbed start, its own order
    torch.testing.assert_close(got["random"].values[0], got["morf"].values[0])
    assert got["random"].values.shape == (5, B)


def test_model_latent_target_and_faithfulness_token_match_lxt_tpu():
    """attribute_latent with an explicit target (full logits), and
    faithfulness with a pinned token and an array baseline."""
    jm, tm = _models("llama")
    target = lambda lg: lg[:, -2, 5].sum() - lg[:, 3, 9].sum()  # noqa: E731
    _close(tm.attribute_latent(_ids(), target=target),
           jm.attribute_latent(_ids(), target=target))
    baseline = np.random.default_rng(9).standard_normal(64).astype(np.float32)
    got = tm.faithfulness(_ids(), steps=3, token=[4, 90], baseline=baseline)
    want = jm.faithfulness(_ids(), steps=3, token=np.asarray([4, 90]),
                           baseline=baseline)
    for key in ("auc_morf", "auc_lerf", "abpc"):
        _close((got[key],), (want[key],))


def test_model_faithfulness_attention_mask_is_the_valid_mask():
    jm, tm = _models("llama")
    mask = np.ones((B, T), np.int32)
    mask[1, :37] = 0
    got = tm.faithfulness(_ids(), steps=4, attention_mask=mask)
    want = jm.faithfulness(_ids(), steps=4, attention_mask=mask)
    for key in ("auc_morf", "auc_lerf", "abpc"):
        _close((got[key],), (want[key],))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("family", FAMILIES)
def test_cp_lrp_latent_relevance_conserves_per_layer(monkeypatch, family, impl):
    """Under CP-LRP every op of the block conserves relevance: each layer's
    total equals the explained logit (tests/test_registry.py's bar)."""
    value, _, latent = _port(monkeypatch, family, impl).attribute_latent(
        _ids(), composite="cp_lrp")
    sums = latent.sum(dim=(1, 2, 3)).numpy()
    np.testing.assert_allclose(sums, float(value), rtol=1e-3)
