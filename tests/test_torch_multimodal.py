"""The port's SigLIP tower and Gemma-3 image + text model against lxt_tpu's
and transformers', on CPU.

A tiny HF ``SiglipVisionModel`` (D 32, 2 layers, 4 heads, image 28, patch
14) and a tiny ``Gemma3ForConditionalGeneration`` (the config of
``tests/test_multimodal.py``: text D 48, 2 layers, window 8; the same
SigLIP; one image token, the projector randomized) convert through
``from_hf`` in both packages. Float32: SigLIP's patch embeddings within
1e-5 normalized L2 of HF's and lxt_tpu's; Gemma-3's logits within 3e-4
(absolute) of HF's and 1e-5 of lxt_tpu's; ``attribute`` (value, token
relevance, pixel heatmap), ``generate`` (tokens equal, cached and not) and
``attribute_response`` against lxt_tpu's; ``from_pretrained`` of the
checkpoint HF writes, whole and ``text_only``. ROADMAP F9: with
``token_type_ids`` HF lets an image's tokens attend to each other, where
both packages stay causal; at ``mm_tokens_per_image`` 4 the gap shows.
"""

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import save_file
from transformers import AutoConfig
from transformers.models.gemma3.modeling_gemma3 import (
    Gemma3Config, Gemma3ForConditionalGeneration, Gemma3TextConfig)
from transformers.models.siglip import SiglipVisionConfig
from transformers.models.siglip.modeling_siglip import SiglipVisionModel

from lxt_tpu.models import gemma3 as jgemma
from lxt_tpu.models import registry as jreg
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import gemma3 as tgemma
from lxt_tpu_torch.models import registry as treg

BAR = 1e-5            # normalized L2, float32
HF_ATOL = 3e-4        # tests/test_multimodal.py's bar against HF
IMAGE_TOKEN = 260
VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, image_size=28, patch_size=14)


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@functools.lru_cache(maxsize=None)
def _gemma(mm_tokens=1):
    tc = Gemma3TextConfig(
        vocab_size=270, hidden_size=48, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=12, sliding_window=8, query_pre_attn_scalar=12,
        max_position_embeddings=128)
    cfg = Gemma3Config(text_config=tc, vision_config=SiglipVisionConfig(**VISION),
                       mm_tokens_per_image=mm_tokens, image_token_index=IMAGE_TOKEN,
                       boi_token_index=258, eoi_token_index=259)
    torch.manual_seed(0)
    hf = Gemma3ForConditionalGeneration(cfg).eval()
    # HF initializes the projector to zeros: images would contribute nothing
    with torch.no_grad():
        hf.model.multi_modal_projector.mm_input_projection_weight.normal_(
            0, 0.2, generator=torch.Generator().manual_seed(3))
    return hf, jreg.from_hf(hf), treg.from_hf(hf, device="cpu")


def _prompt(seed, B=1, T=10, images_at=(2,)):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 256, (B, T), generator=g)
    ids[:, list(images_at)] = IMAGE_TOKEN
    return ids.numpy(), torch.randn(B, 3, 28, 28, generator=g).numpy()


def test_siglip_matches_hf_and_lxt_tpu():
    torch.manual_seed(0)
    hf = SiglipVisionModel(SiglipVisionConfig(**VISION)).eval()
    jm, tm = jreg.from_hf(hf), treg.from_hf(hf, device="cpu")
    assert tm.kind == jm.kind == "siglip"
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    x = np.random.default_rng(1).standard_normal((2, 28, 28, 3)).astype(np.float32)
    with torch.no_grad():
        ref = hf(pixel_values=torch.tensor(x).permute(0, 3, 1, 2)).last_hidden_state
    got = tm.logits(x)
    assert got.shape == (2, 4, 32)
    assert _nl2(got.numpy(), ref.numpy()) <= BAR
    assert _nl2(got.numpy(), jm.logits(x)) <= BAR

    def target(out):
        return (out.mean(1) ** 2).sum()

    jv, jh = jm.attribute_image(x, target=target)
    tv, th = tm.attribute_image(x, target=target)
    assert th.shape == (2, 28, 28)
    assert _nl2(tv.numpy(), jv) <= BAR and _nl2(th.numpy(), jh) <= BAR
    with pytest.raises(ValueError, match="headless"):
        tm.attribute_image(x)


def test_gemma3_image_text_logits_match_hf_and_lxt_tpu():
    hf, jm, tm = _gemma()
    assert tm.family == jm.family == "gemma3_multimodal"
    # lxt_tpu's nested tree ({vision, text, mm_proj, mm_norm}, HWIO conv)
    # carries across convert.params_from_numpy unchanged
    carried = params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu")
    assert jax.tree.structure(carried) == jax.tree.structure(tm.params)
    for got, want in zip(jax.tree.leaves(carried), jax.tree.leaves(tm.params)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    ids, pix = _prompt(1)
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids), pixel_values=torch.tensor(pix),
                 use_cache=False).logits.numpy()
    got = tm.logits(ids, pix).numpy()         # NCHW pixels accepted
    np.testing.assert_allclose(got, ref, rtol=0, atol=HF_ATOL)
    assert _nl2(got, jm.logits(ids, pix)) <= BAR


@pytest.mark.parametrize("case", ["argmax", "token", "position", "target"])
def test_gemma3_attribute_matches_lxt_tpu(case):
    _, jm, tm = _gemma()
    ids, pix = _prompt(2, B=2)
    pix = pix.transpose(0, 2, 3, 1)            # NHWC
    kw = {"token": {"token": np.asarray([5, 77])},
          "position": {"position": 4},
          "target": {"target": lambda logits: logits[:, 3:, 11].sum()}}.get(case, {})
    jv, jtok, jpix = jm.attribute(ids, pix, **kw)
    tv, ttok, tpix = tm.attribute(ids, pix, **kw)
    assert ttok.shape == (2, 10) and tpix.shape == (2, 28, 28)
    assert _nl2(tv.numpy(), jv) <= BAR
    assert _nl2(ttok.numpy(), jtok) <= BAR
    assert _nl2(tpix.numpy(), jpix) <= BAR
    # the placeholder's own embedding was replaced: its relevance is in the
    # pixels
    assert np.all(ttok.numpy()[:, 2] == 0) and np.abs(tpix.numpy()).sum() > 0


@pytest.mark.parametrize("use_cache", [True, False])
def test_gemma3_generate_and_attribute_response_match_lxt_tpu(use_cache):
    _, jm, tm = _gemma()
    ids, pix = _prompt(3, B=2, T=7, images_at=(1,))
    out = tm.generate(ids, pix, 6, use_cache=use_cache)
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        jm.generate(ids, pix, 6, use_cache=use_cache)))
    if not use_cache:
        return
    jv, jtok, jpix = jm.attribute_response(out.numpy(), pix, 7)
    tv, ttok, tpix = tm.attribute_response(out, pix, 7)
    assert ttok.shape == (6, 2, 13) and tpix.shape == (6, 2, 28, 28)
    assert _nl2(tv.numpy(), jv) <= BAR
    assert _nl2(ttok.numpy(), jtok) <= BAR and _nl2(tpix.numpy(), jpix) <= BAR
    # map 0 is the attribution of the first response token alone (causal:
    # nothing after its position)
    v0, tok0, pix0 = tm.attribute(out[:, :7], pix, token=out[:, 7])
    assert _nl2(ttok[0, :, :7].numpy(), tok0.numpy()) <= BAR
    assert np.all(ttok[0, :, 7:].numpy() == 0)
    assert _nl2(tpix[0].numpy(), pix0.numpy()) <= BAR


def test_from_pretrained_image_text_matches_lxt_tpu(tmp_path):
    """A checkpoint with the module's key names (``model.vision_tower.*``,
    ``model.language_model.*``), which lxt_tpu's loader reads too."""
    hf, _, _ = _gemma()
    hf.config.save_pretrained(tmp_path)
    save_file({k: v.contiguous() for k, v in hf.state_dict().items()
               if k != "lm_head.weight"},        # tied to the embedding
              str(tmp_path / "model.safetensors"))
    tm = treg.from_pretrained(tmp_path, device="cpu")
    jm = jreg.from_pretrained(tmp_path)
    assert isinstance(tm, treg.MultimodalAttributionModel)
    assert tm.family == jm.family == "gemma3_multimodal"
    ids, pix = _prompt(4)
    jv, jtok, jpix = jm.attribute(ids, pix)
    tv, ttok, tpix = tm.attribute(ids, pix)
    assert _nl2(tv.numpy(), jv) <= BAR
    assert _nl2(ttok.numpy(), jtok) <= BAR and _nl2(tpix.numpy(), jpix) <= BAR
    with pytest.raises(ValueError, match="text models only"):
        treg.from_pretrained(tmp_path, device="cpu", quantize_bits=8)


def test_from_pretrained_of_save_pretrained_whole_and_text_only(tmp_path):
    """The checkpoint ``save_pretrained`` writes holds transformers' older
    key names (``language_model.model.*``, ``vision_tower.*``, as on the
    Hub), which lxt_tpu's loader does not read (ROADMAP F10): the port
    renames them, and loads the whole model or its language model."""
    hf, jm, tm = _gemma()
    hf.save_pretrained(tmp_path)
    loaded = treg.from_pretrained(tmp_path, device="cpu")
    assert isinstance(loaded, treg.MultimodalAttributionModel)
    assert loaded.cfg == tm.cfg
    ids, pix = _prompt(4)
    np.testing.assert_array_equal(loaded.logits(ids, pix).numpy(),
                                  tm.logits(ids, pix).numpy())
    text = treg.from_pretrained(tmp_path, device="cpu", text_only=True)
    jtext = jreg.from_hf(hf, text_only=True)
    assert isinstance(text, treg.AttributionModel)
    assert text.family == jtext.family == "gemma3_text"
    assert _nl2(text.attribute(ids)[1].numpy(), jtext.attribute(ids)[1]) <= BAR


def test_f9_image_tokens_attend_bidirectionally_in_hf_only():
    """ROADMAP F9. At four tokens per image, HF's logits equal the port's
    without token_type_ids; with them, HF lets the image's four tokens see
    each other and its logits move, where the port (as lxt_tpu) stays
    causal. If either side changes, this test says so."""
    hf, jm, tm = _gemma(mm_tokens=4)
    ids, pix = _prompt(5, T=12, images_at=(2, 3, 4, 5))
    kw = dict(input_ids=torch.tensor(ids), pixel_values=torch.tensor(pix),
              use_cache=False)
    types = torch.tensor((ids == IMAGE_TOKEN).astype(np.int64))
    with torch.no_grad():
        causal = hf(**kw).logits.numpy()
        bidirectional = hf(**kw, token_type_ids=types).logits.numpy()
    got = tm.logits(ids, pix).numpy()
    np.testing.assert_allclose(got, causal, rtol=0, atol=HF_ATOL)
    assert _nl2(got, jm.logits(ids, pix)) <= BAR
    gap = np.abs(bidirectional - got).max(-1)[0]          # per position
    assert np.all(gap[:2] <= HF_ATOL)                     # before the image
    assert gap[2:].min() > 10 * HF_ATOL, gap               # from the image on


# google/gemma-3-4b-it's config.json: the widths of both towers, the rest
# from the defaults; and a bare one
MM_CONFIGS = {
    "gemma3_4b": {"model_type": "gemma3", "mm_tokens_per_image": 256,
                  "text_config": {"hidden_size": 2560, "intermediate_size": 10240,
                                  "model_type": "gemma3_text",
                                  "num_hidden_layers": 34, "sliding_window": 1024,
                                  "rope_scaling": {"factor": 8.0,
                                                   "rope_type": "linear"}},
                  "vision_config": {"hidden_size": 1152, "image_size": 896,
                                    "intermediate_size": 4304,
                                    "model_type": "siglip_vision_model",
                                    "num_attention_heads": 16,
                                    "num_hidden_layers": 27, "patch_size": 14,
                                    "vision_use_head": False}},
    "gemma3_bare": {"model_type": "gemma3"},
}


@pytest.mark.parametrize("name", sorted(MM_CONFIGS))
def test_read_hf_config_multimodal_matches_autoconfig(tmp_path, name):
    """Keys a gemma3 config.json leaves out, in it and in its vision_config,
    take transformers' defaults, as AutoConfig gives them."""
    (tmp_path / "config.json").write_text(json.dumps(MM_CONFIGS[name]))
    want = jgemma.Gemma3MultimodalConfig.from_hf(AutoConfig.from_pretrained(tmp_path))
    got = tgemma.Gemma3MultimodalConfig.from_hf(treg.read_hf_config(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
