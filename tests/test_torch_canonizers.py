"""The port's canonizers (lxt_tpu_torch.canonizers) and its copy of the
heatmap renderers (lxt_tpu_torch.utils.viz) against lxt_tpu's, on CPU.

``fold_norm_scales`` must give bit-equal float32 weights to lxt_tpu's on
the same numpy weights, and leave the port's logits and relevance
unchanged (the folded matmul is the same linear map of the normalized
input). It refuses tied embeddings' final norm, Gemma's layout and
quantized weights as lxt_tpu does; ``canonizers=`` works through
``from_hf`` / ``from_pretrained`` and ``AttributionModel.canonize``, as
lxt_tpu's. The HTML renderers and ``clean_tokens`` must write
byte-identical output for the same tokens and relevances (tensors on the
port's side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers.models.llama.modeling_llama import LlamaConfig, LlamaForCausalLM

import lxt_tpu
import lxt_tpu_torch
from lxt_tpu import canonizers as jc
from lxt_tpu.utils import viz as jviz
from lxt_tpu_torch import canonizers as tc
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import llama as tllama
from lxt_tpu_torch.ops.quant import quantize_params
from lxt_tpu_torch.utils import viz as tviz

BAR = 1e-5


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _numpy_params(tie=False, seed=0):
    rng = np.random.default_rng(seed)
    L, D, I, H, Hkv, hd, V = 2, 32, 64, 4, 2, 8, 64

    def w(*s):
        return (0.1 * rng.standard_normal(s)).astype(np.float32)

    def norm(*s):
        return (1.0 + 0.3 * rng.standard_normal(s)).astype(np.float32)

    params = {"embed": w(V, D), "final_norm": norm(D),
              "layers": dict(ln1=norm(L, D), ln2=norm(L, D), wq=w(L, D, H * hd),
                             wk=w(L, D, Hkv * hd), wv=w(L, D, Hkv * hd),
                             wo=w(L, H * hd, D), wg=w(L, D, I), wu=w(L, D, I),
                             wd=w(L, I, D))}
    if not tie:
        params["lm_head"] = w(D, V)
    cfg = tllama.LlamaConfig(vocab_size=V, hidden_size=D, intermediate_size=I,
                             num_layers=L, num_heads=H, num_kv_heads=Hkv,
                             tie_embeddings=tie)
    return cfg, params


def _attribute(params, cfg, ids, composite):
    comp = getattr(lxt_tpu_torch, composite)
    e = tllama.embed(params, torch.as_tensor(ids))
    return lxt_tpu_torch.input_relevance(lambda x: lxt_tpu_torch.select_logit(
        tllama.forward(params, cfg, x, comp, remat=False,
                       logits_at=-1).logits), e)


@pytest.mark.parametrize("tie", [False, True])
def test_fold_norm_scales_bit_equal_to_lxt_tpu(tie):
    cfg, params = _numpy_params(tie)
    want = jc.fold_norm_scales(jax.tree.map(jnp.asarray, params), cfg, "llama")
    got, cfg2 = tc.apply_canonizers(params_from_numpy(params, device="cpu"), cfg,
                                    "llama", [tc.fold_norm_scales])
    assert cfg2 is cfg
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for name in got["layers"]:
        np.testing.assert_array_equal(got["layers"][name].numpy(),
                                      np.asarray(want["layers"][name]))
    for name in set(got) - {"layers"}:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    # tied embeddings keep the final norm (the shared matrix stays as it is)
    assert np.allclose(got["final_norm"].numpy(), 1.0) != tie


@pytest.mark.parametrize("composite", ["attnlrp", "cp_lrp"])
@pytest.mark.parametrize("tie", [False, True])
def test_folding_leaves_logits_and_relevance_unchanged(tie, composite):
    cfg, params = _numpy_params(tie, seed=1)
    params = params_from_numpy(params, device="cpu")
    folded = tc.fold_norm_scales(params, cfg, "llama")
    assert not np.allclose(params["layers"]["ln1"].numpy(), 1.0)
    assert np.allclose(folded["layers"]["ln1"].numpy(), 1.0)
    ids = np.random.default_rng(2).integers(0, 64, (2, 8))
    v0, r0 = _attribute(params, cfg, ids, composite)
    v1, r1 = _attribute(folded, cfg, ids, composite)
    assert _nl2(v1, v0) <= BAR and _nl2(r1, r0) <= BAR


def test_fold_refuses_quantized_weights_and_other_families():
    cfg, params = _numpy_params()
    params = params_from_numpy(params, device="cpu")
    with pytest.raises(ValueError, match="BEFORE quantize_params"):
        tc.fold_norm_scales(quantize_params(params, bits=8, family="llama"),
                            cfg, "llama")
    with pytest.raises(ValueError, match="llama param family"):
        tc.fold_norm_scales(params, cfg, "gemma3_text")


def test_canonizers_through_from_hf_and_canonize_match_lxt_tpu(tmp_path):
    torch.manual_seed(0)
    hf = LlamaForCausalLM(LlamaConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=64,
        max_position_embeddings=64)).eval()
    with torch.no_grad():   # HF initialises the norm weights to 1
        for name, p in hf.named_parameters():
            if "norm" in name:
                p.normal_(1.0, 0.3)
    hf.save_pretrained(tmp_path)
    ids = np.random.default_rng(3).integers(0, 64, (2, 8))
    jcanon = lxt_tpu.from_hf(hf, canonizers=[jc.fold_norm_scales])
    _, want = jcanon.attribute(ids)
    plain = lxt_tpu_torch.from_hf(hf, device="cpu")
    models = {
        "from_hf": lxt_tpu_torch.from_hf(hf, device="cpu",
                                         canonizers=[tc.fold_norm_scales]),
        "from_pretrained": lxt_tpu_torch.from_pretrained(
            tmp_path, device="cpu", canonizers=[tc.fold_norm_scales]),
        "canonize": plain.canonize(tc.fold_norm_scales),
    }
    for how, model in models.items():
        assert np.allclose(model.params["layers"]["ln2"].numpy(), 1.0), how
        for name, leaf in model.params["layers"].items():
            np.testing.assert_array_equal(
                leaf.numpy(), np.asarray(jcanon.params["layers"][name]))
        _, got = model.attribute(ids)
        assert _nl2(got, want) <= BAR, how
    # the model it came from is untouched
    assert not np.allclose(plain.params["layers"]["ln2"].numpy(), 1.0)
    # before the quantization: the NF4 codes are those of the folded weights
    quant = lxt_tpu_torch.from_pretrained(tmp_path, device="cpu",
                                          quantize_bits="nf4",
                                          canonizers=[tc.fold_norm_scales])
    jquant = lxt_tpu.from_pretrained(tmp_path, quantize_bits="nf4",
                                     canonizers=[jc.fold_norm_scales])
    np.testing.assert_array_equal(quant.params["layers"]["wq"].q.numpy(),
                                  np.asarray(jquant.params["layers"]["wq"].q))


# ---------------------------------------------------------------------------
# utils/viz.py
# ---------------------------------------------------------------------------

WORDS = ["▁The", "▁cat", "&", "▁sat", "▁on", "▁the", "▁$mat#", "<b>"]


def test_clean_tokens_matches_lxt_tpu():
    for words in (WORDS, ["Ġa", "Ġ_b", "c"], ["a", "##b", "{c}"]):
        assert tviz.clean_tokens(words) == jviz.clean_tokens(words)
    with pytest.raises(ValueError, match="not recognized"):
        tviz.clean_tokens(["plain", "words"])


def test_html_renderers_byte_identical_to_lxt_tpu(tmp_path):
    rel = np.random.default_rng(4).uniform(-1, 1, (3, len(WORDS))).astype(np.float32)
    got = tviz.html_heatmap(WORDS, torch.from_numpy(rel[0]),
                            path=tmp_path / "t.html")
    want = jviz.html_heatmap(WORDS, jnp.asarray(rel[0]), path=tmp_path / "j.html")
    assert got.read_bytes() == want.read_bytes()
    got = tviz.html_response_heatmap(WORDS, ["a", "b", "c"], torch.from_numpy(rel),
                                     path=tmp_path / "tr.html")
    want = jviz.html_response_heatmap(WORDS, ["a", "b", "c"], jnp.asarray(rel),
                                      path=tmp_path / "jr.html")
    assert got.read_bytes() == want.read_bytes()
    # no LaTeX here or there: both fall back to the same HTML
    words = tviz.clean_tokens(WORDS)
    got = tviz.pdf_heatmap(words, torch.from_numpy(rel[1]), path=tmp_path / "t.pdf",
                           backend="no-such-latex")
    want = jviz.pdf_heatmap(words, rel[1], path=tmp_path / "j.pdf",
                            backend="no-such-latex")
    assert got.read_bytes() == want.read_bytes()
    assert tviz._latex_doc(words, torch.from_numpy(rel[1])) == jviz._latex_doc(
        words, rel[1])
