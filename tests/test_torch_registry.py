"""The port's loading surface (lxt_tpu_torch.models.registry, lxt_tpu_torch.io)
against lxt_tpu's, on CPU.

Tiny HF Llama checkpoints are written in ``tmp_path`` with transformers and
safetensors: plain, bitsandbytes-NF4-serialized and bitsandbytes-8-bit.
``from_pretrained`` of both packages must give the same quantized codes and
scales, and logits and input relevance (also under ``kv_begin`` and
``attention_mask`` left padding) within normalized L2 1e-5 in float32. The
port reads ``config.json`` with json alone: for every key it leaves out it
must give what transformers' ``AutoConfig`` gives. The numpy safetensors
reader must match ``lxt_tpu.io.load_safetensors``. Tiny Gemma-3 text
checkpoints (a ``gemma3_text`` one and an image + text ``gemma3`` one
holding only its language model) load as lxt_tpu loads them.
"""

import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file
from safetensors.torch import save_file as save_torch
from transformers import (AutoConfig, Gemma3ForCausalLM, Gemma3TextConfig,
                          GPT2Config, GPT2LMHeadModel, MixtralConfig,
                          MixtralForCausalLM)
from transformers.models.llama.modeling_llama import LlamaConfig, LlamaForCausalLM

import lxt_tpu
from lxt_tpu import io as jio
from lxt_tpu.models import gemma3 as jgemma
from lxt_tpu.models import gpt2 as jgpt2
from lxt_tpu.models import llama as jllama
from lxt_tpu.models import mixtral as jmix
from lxt_tpu.models import registry as jreg
from lxt_tpu.ops import quant as jq
import lxt_tpu_torch
from lxt_tpu_torch import io as tio
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import gemma3 as tgemma
from lxt_tpu_torch.models import gpt2 as tgpt2
from lxt_tpu_torch.models import llama as tllama
from lxt_tpu_torch.models import mixtral as tmix
from lxt_tpu_torch.models import registry as treg
from lxt_tpu_torch.ops import quant as tq

BAR = 1e-5
VOCAB = 256


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _hf_llama(seed):
    torch.manual_seed(seed)
    return LlamaForCausalLM(LlamaConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=VOCAB,
        max_position_embeddings=128)).eval()


def _bnb_nf4(arr):
    """bitsandbytes' 4-bit serialization of one [out, in] weight: flat
    blocks of 64, nearest NF4 code, first element in the high nibble."""
    blocks = arr.reshape(-1, 64)
    absmax = np.abs(blocks).max(axis=1).astype(np.float32)
    idx = np.argmin(np.abs((blocks / absmax[:, None])[..., None] - jq.NF4_CODE),
                    axis=-1).reshape(-1).astype(np.uint8)
    meta = {"blocksize": 64, "quant_type": "nf4", "dtype": "float32",
            "shape": list(arr.shape)}
    return {"": ((idx[0::2] << 4) | idx[1::2]).reshape(-1, 1),
            ".absmax": absmax, ".quant_map": jq.NF4_CODE.copy(),
            ".quant_state.bitsandbytes__nf4": np.frombuffer(
                json.dumps(meta).encode(), np.uint8).copy()}


def _bnb_8bit(arr):
    """bitsandbytes' Linear8bitLt serialization: int8 codes, per-row SCB."""
    scb = np.abs(arr).max(axis=1).astype(np.float32)
    cb = np.clip(np.round(arr / scb[:, None] * 127.0), -127, 127).astype(np.int8)
    return {"": cb, ".SCB": scb}


def _write_checkpoint(tmp_path, kind):
    hf = _hf_llama(seed=5)
    if kind == "plain":
        hf.save_pretrained(tmp_path)
        return
    hf.config.save_pretrained(tmp_path)
    state = {}
    for name, p in hf.state_dict().items():
        arr = p.detach().numpy().astype(np.float32)
        if not (name.endswith(".weight") and arr.ndim == 2 and "_proj" in name):
            state[name] = arr
            continue
        entries = _bnb_nf4(arr) if kind == "bnb_nf4" else _bnb_8bit(arr)
        state.update({name + suffix: v for suffix, v in entries.items()})
    save_file(state, str(tmp_path / "model.safetensors"))


CHECKPOINTS = {"plain_nf4": ("plain", "nf4"), "bnb_nf4": ("bnb_nf4", None),
               "bnb_8bit": ("bnb_8bit", None), "plain_int4": ("plain", 4)}


@pytest.mark.parametrize("case", sorted(CHECKPOINTS))
def test_from_pretrained_matches_lxt_tpu(tmp_path, case):
    kind, bits = CHECKPOINTS[case]
    _write_checkpoint(tmp_path, kind)
    jm = jreg.from_pretrained(tmp_path, quantize_bits=bits)
    tm = treg.from_pretrained(tmp_path, quantize_bits=bits, device="cpu")
    assert (tm.family, tm.composite) == (jm.family, lxt_tpu_torch.attnlrp)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    want_bits = {"bnb_8bit": 8}.get(kind, bits or "nf4")
    for name, jl in jm.params["layers"].items():
        tl = tm.params["layers"][name]
        assert isinstance(tl, tq.QuantizedTensor) == isinstance(jl, jq.QuantizedTensor)
        if isinstance(jl, jq.QuantizedTensor):
            assert (tl.bits, tl.block) == (jl.bits, jl.block) and tl.bits == want_bits
            np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
            np.testing.assert_array_equal(tl.scale.numpy(), np.asarray(jl.scale))
    assert not isinstance(tm.params["lm_head"], tq.QuantizedTensor)

    ids = np.random.RandomState(1).randint(0, VOCAB, (2, 16))
    assert _nl2(tm.logits(ids).numpy(), jm.logits(ids)) <= BAR
    mask = np.ones((2, 16), np.int32)
    mask[0, :3] = 0
    for kw in ({}, {"kv_begin": np.asarray([3, 0], np.int32)},
               {"attention_mask": mask}):
        jv, jrel = jm.attribute(ids, **kw)
        tv, trel = tm.attribute(ids, **kw)
        assert _nl2(tv.numpy(), jv) <= BAR, kw
        assert _nl2(trel.numpy(), jrel) <= BAR, kw


def test_attribute_token_and_target_match_lxt_tpu(tmp_path):
    _write_checkpoint(tmp_path, "plain")
    jm, tm = jreg.from_pretrained(tmp_path), treg.from_pretrained(tmp_path, device="cpu")
    ids = np.random.RandomState(2).randint(0, VOCAB, (2, 12))
    tok = np.asarray([5, 7])
    _, want = jm.attribute(ids, token=tok, position=4, composite="cp_lrp")
    _, got = tm.attribute(ids, token=tok, position=4, composite="cp_lrp")
    assert _nl2(got.numpy(), want) <= BAR
    _, want = jm.attribute(ids, target=lambda lg: lg[:, -2, 3].sum())
    _, got = tm.attribute(ids, target=lambda lg: lg[:, -2, 3].sum())
    assert _nl2(got.numpy(), want) <= BAR
    with pytest.raises(ValueError, match="BERT"):
        tm.attribute(ids, kv_end=[12, 12])


def test_from_hf_matches_lxt_tpu():
    hf = _hf_llama(seed=3)
    jm, tm = lxt_tpu.from_hf(hf), lxt_tpu_torch.from_hf(hf, device="cpu")
    assert tm.family == "llama"
    ids = np.random.RandomState(4).randint(0, VOCAB, (1, 10))
    assert _nl2(tm.logits(ids).numpy(), jm.logits(ids)) <= BAR
    assert _nl2(tm.attribute(ids)[1].numpy(), jm.attribute(ids)[1]) <= BAR


def test_unsupported_family_lists_the_ported_ones(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "bert"}))
    save_file({"x": np.zeros(2, np.float32)}, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="llama, qwen2, qwen3, mistral, phi3, "
                                         "gemma3, gemma3_text, gpt2, mixtral"):
        treg.from_pretrained(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="family="):
        treg.from_pretrained(tmp_path, family="bert", device="cpu")


def test_llama_clone_detected_structurally(tmp_path):
    hf = _hf_llama(seed=6)
    hf.save_pretrained(tmp_path)
    cfg = json.loads((tmp_path / "config.json").read_text())
    cfg["model_type"] = "llama_clone"
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    with pytest.warns(UserWarning, match="converting as 'llama'"):
        model = treg.from_pretrained(tmp_path, device="cpu")
    assert model.family == "llama"


_SMALL = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, vocab_size=97)
_FACTORS = [1.0 + 0.1 * i for i in range(8)]
CONFIGS = {
    "llama_bare": {"model_type": "llama"},
    "llama_small": dict(_SMALL, model_type="llama",
                        rope_scaling={"type": "llama3", "factor": 8.0,
                                      "low_freq_factor": 1.0,
                                      "high_freq_factor": 4.0,
                                      "original_max_position_embeddings": 64}),
    "qwen2_small": dict(_SMALL, model_type="qwen2"),
    "qwen2_window_off": dict(_SMALL, model_type="qwen2", sliding_window=64,
                             use_sliding_window=False),
    "qwen3_small": dict(_SMALL, model_type="qwen3"),
    "mistral_bare": {"model_type": "mistral"},
    "mistral_small": dict(_SMALL, model_type="mistral", num_key_value_heads=2),
    "phi3_bare": {"model_type": "phi3"},
    "phi3_su": dict(_SMALL, model_type="phi3", sliding_window=48,
                    max_position_embeddings=512,
                    original_max_position_embeddings=64,
                    rope_scaling={"type": "su", "short_factor": _FACTORS,
                                  "long_factor": [2 * f for f in _FACTORS]}),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_read_hf_config_matches_autoconfig(tmp_path, name):
    """Keys left out of config.json take transformers' defaults for the
    model_type (Mistral's sliding_window, Phi-3's rms_norm_eps, Qwen3's
    head_dim, ...)."""
    (tmp_path / "config.json").write_text(json.dumps(CONFIGS[name]))
    want = jllama.LlamaConfig.from_hf(AutoConfig.from_pretrained(tmp_path))
    got = tllama.LlamaConfig.from_hf(
        treg.read_hf_config(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.fixture
def st_file(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "mixed.safetensors"
    save_torch({"f32": torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32)),
                "bf16": torch.from_numpy(rng.standard_normal((3, 4, 6)).astype(
                    np.float32)).bfloat16(),
                "u8": torch.from_numpy(rng.integers(0, 256, (33,)).astype(np.uint8)),
                "i8": torch.from_numpy(rng.integers(-128, 128, (2, 9)).astype(np.int8))},
               str(path))
    return path


def test_load_safetensors_matches_lxt_tpu(st_file):
    want = jio.load_safetensors(st_file)
    got = tio.load_safetensors(st_file)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])
    assert got["bf16"].dtype == np.float32


def test_load_checkpoint_sharded_and_malformed(tmp_path, st_file):
    save_file({"x": np.arange(4, dtype=np.float32)}, str(tmp_path / "a.safetensors"))
    save_file({"y": np.ones((2, 2), np.int32)}, str(tmp_path / "b.safetensors"))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {"x": "a.safetensors", "y": "b.safetensors"}}))
    state = tio.load_checkpoint_state_dict(tmp_path)
    assert sorted(state) == ["x", "y"] and state["y"].dtype == np.int32
    np.testing.assert_array_equal(state["x"], np.arange(4, dtype=np.float32))
    raw = st_file.read_bytes()
    bad = tmp_path / "truncated.safetensors"
    bad.write_bytes(raw[:-7])
    with pytest.raises(ValueError, match="outside"):
        tio.load_safetensors(bad)
    with pytest.raises(FileNotFoundError):
        tio.load_checkpoint_state_dict(tmp_path / "nowhere")


def test_load_checkpoint_params_matches_from_hf(tmp_path):
    hf = _hf_llama(seed=8)
    hf.save_pretrained(tmp_path)
    cfg = tllama.LlamaConfig.from_hf(hf.config)
    params = tio.load_checkpoint_params(tmp_path, cfg, tllama.params_from_hf,
                                        device="cpu")
    want = lxt_tpu_torch.from_hf(hf, device="cpu").params
    for name in ("wq", "wd", "ln1"):
        assert torch.equal(params["layers"][name], want["layers"][name])
    assert torch.equal(params["embed"], want["embed"])


@pytest.mark.parametrize("name", ["from_pretrained", "from_hf", "params_from_hf",
                                  "params_from_numpy", "load_checkpoint_params",
                                  "gemma3_params_from_hf", "mixtral_params_from_hf",
                                  "gpt2_params_from_hf"])
def test_entry_points_default_to_the_card(tmp_path, name):
    """The port's loading entry points put parameters on the card unless
    the caller asks for the CPU: without a card a default call raises
    rather than returning CPU tensors."""
    fn = {"from_pretrained": treg.from_pretrained, "from_hf": treg.from_hf,
          "params_from_hf": tllama.params_from_hf,
          "params_from_numpy": params_from_numpy,
          "load_checkpoint_params": tio.load_checkpoint_params,
          "gemma3_params_from_hf": tgemma.params_from_hf,
          "mixtral_params_from_hf": tmix.params_from_hf,
          "gpt2_params_from_hf": tgpt2.params_from_hf}[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    hf = _hf_llama(seed=9)
    if name in ("from_pretrained", "load_checkpoint_params"):
        hf.save_pretrained(tmp_path)
        cfg = tllama.LlamaConfig.from_hf(hf.config)
        call = ((lambda: fn(tmp_path).params) if name == "from_pretrained"  # noqa: E731
                else (lambda: fn(tmp_path, cfg, tllama.params_from_hf)))
    elif name == "from_hf":
        call = lambda: fn(hf).params  # noqa: E731
    elif name == "params_from_hf":
        call = lambda: fn(hf.state_dict(), tllama.LlamaConfig.from_hf(hf.config))  # noqa: E731
    elif name == "gemma3_params_from_hf":
        gm = _hf_gemma3(seed=9)
        call = lambda: fn(gm.state_dict(), tgemma.Gemma3Config.from_hf(gm.config))  # noqa: E731
    elif name == "mixtral_params_from_hf":
        hm = _hf_mixtral(seed=9)
        call = lambda: fn(hm.state_dict(), tmix.MixtralConfig.from_hf(hm.config))  # noqa: E731
    elif name == "gpt2_params_from_hf":
        hm = _hf_gpt2(seed=9)
        call = lambda: {"embed": fn(hm.state_dict(),  # noqa: E731
                                    tgpt2.GPT2Config.from_hf(hm.config))["wte"]}
    else:
        call = lambda: fn({"embed": np.ones((2, 3), np.float32)})  # noqa: E731
    if torch.cuda.is_available():
        assert call()["embed"].is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            call()


# ---------------------------------------------------------------------------
# Gemma 3
# ---------------------------------------------------------------------------

_GEMMA_TEXT = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=6, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=64, sliding_window=48,
                   query_pre_attn_scalar=64, max_position_embeddings=512,
                   rope_scaling={"rope_type": "linear", "factor": 8.0})


def _hf_gemma3(seed):
    """A tiny Gemma3ForCausalLM with norm weights away from 0 (HF
    initialises them to 0, a multiplier of 1)."""
    torch.manual_seed(seed)
    model = Gemma3ForCausalLM(Gemma3TextConfig(**_GEMMA_TEXT)).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.normal_(0.0, 0.1)
    return model


def _write_gemma3(tmp_path, kind, seed=11):
    """kind: "text" (Gemma3ForCausalLM as saved), "image_text" (a gemma3
    config.json whose text_config is the model, weights under
    model.language_model.*), or "vision" (the same plus a vision weight)."""
    hf = _hf_gemma3(seed)
    if kind == "text":
        hf.save_pretrained(tmp_path)
        return
    text = hf.config.to_dict()
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "gemma3", "text_config": text, "mm_tokens_per_image": 4}))
    state = {k.replace("model.", "model.language_model.", 1): v.detach().numpy()
             for k, v in hf.state_dict().items() if k != "lm_head.weight"}
    if kind == "vision":
        state["model.vision_tower.vision_model.post_layernorm.weight"] = np.ones(
            8, np.float32)
    save_file(state, str(tmp_path / "model.safetensors"))


GEMMA_LOADS = {"text": ("text", None), "image_text": ("image_text", None),
               "text_nf4": ("text", "nf4")}


@pytest.mark.parametrize("case", sorted(GEMMA_LOADS))
def test_gemma3_from_pretrained_matches_lxt_tpu(tmp_path, case):
    kind, bits = GEMMA_LOADS[case]
    _write_gemma3(tmp_path, kind)
    jm = jreg.from_pretrained(tmp_path, quantize_bits=bits)
    tm = treg.from_pretrained(tmp_path, quantize_bits=bits, device="cpu")
    assert tm.family == jm.family == "gemma3_text"
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert tm.cfg.layer_types[5] == "full_attention" and "lm_head" not in tm.params
    for name, jl in jm.params["layers"].items():
        tl = tm.params["layers"][name]
        assert isinstance(tl, tq.QuantizedTensor) == isinstance(jl, jq.QuantizedTensor)
        if isinstance(jl, jq.QuantizedTensor):
            assert tl.bits == jl.bits == "nf4"
            np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
            np.testing.assert_array_equal(tl.scale.numpy(), np.asarray(jl.scale))
        else:
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert bits is None or isinstance(tm.params["layers"]["wq"], tq.QuantizedTensor)
    ids = np.random.RandomState(1).randint(0, VOCAB, (2, 128))
    assert _nl2(tm.logits(ids).numpy(), jm.logits(ids)) <= BAR
    for kw in ({}, {"kv_begin": np.asarray([5, 0], np.int32)}):
        jv, jrel = jm.attribute(ids, **kw)
        tv, trel = tm.attribute(ids, **kw)
        assert _nl2(tv.numpy(), jv) <= BAR, kw
        assert _nl2(trel.numpy(), jrel) <= BAR, kw


def test_gemma3_from_hf_matches_lxt_tpu():
    """A loaded Gemma3ForCausalLM through from_hf: the embedding scale and
    the Gemma forward are dispatched by family."""
    hf = _hf_gemma3(seed=12)
    jm, tm = lxt_tpu.from_hf(hf), lxt_tpu_torch.from_hf(hf, device="cpu")
    assert tm.family == jm.family == "gemma3_text"
    ids = np.random.RandomState(4).randint(0, VOCAB, (1, 64))
    np.testing.assert_array_equal(tm.embed(ids).numpy(), np.asarray(jm.embed(ids)))
    assert _nl2(tm.logits(ids).numpy(), jm.logits(ids)) <= BAR
    assert _nl2(tm.attribute(ids)[1].numpy(), jm.attribute(ids)[1]) <= BAR


def test_gemma3_vision_weights_are_refused(tmp_path):
    _write_gemma3(tmp_path, "vision")
    with pytest.raises(ValueError, match="vision weights"):
        treg.from_pretrained(tmp_path, device="cpu")


GEMMA_CONFIGS = {
    "text_bare": {"model_type": "gemma3_text"},
    "text_pattern": dict(_GEMMA_TEXT, model_type="gemma3_text",
                         sliding_window_pattern=3),
    "text_layer_types": dict(_GEMMA_TEXT, model_type="gemma3_text",
                             layer_types=["full_attention"] * 6),
    # google/gemma-3-4b-it's config.json: text_config with the widths, the
    # rest taken from the defaults
    "gemma3_4b": {"model_type": "gemma3", "text_config": {
        "hidden_size": 2560, "intermediate_size": 10240,
        "model_type": "gemma3_text", "num_hidden_layers": 34,
        "rope_scaling": {"factor": 8.0, "rope_type": "linear"},
        "sliding_window": 1024}},
    "gemma3_bare": {"model_type": "gemma3"},
}


@pytest.mark.parametrize("name", sorted(GEMMA_CONFIGS))
def test_read_hf_config_gemma3_matches_autoconfig(tmp_path, name):
    """Keys left out take transformers' Gemma3TextConfig defaults;
    layer_types comes from sliding_window_pattern when the file has only
    that; a gemma3 config's text_config is filled the same way."""
    (tmp_path / "config.json").write_text(json.dumps(GEMMA_CONFIGS[name]))
    auto = AutoConfig.from_pretrained(tmp_path)
    got = treg.read_hf_config(tmp_path)
    if auto.model_type == "gemma3":
        auto, got = auto.text_config, got.text_config
    want = jgemma.Gemma3Config.from_hf(auto)
    assert dataclasses.asdict(tgemma.Gemma3Config.from_hf(got)) == \
        dataclasses.asdict(want)
    assert got.hidden_activation == auto.hidden_activation
    if name == "text_pattern":
        assert want.layer_types.count("full_attention") == 2


# ---------------------------------------------------------------------------
# Mixtral and GPT-2
# ---------------------------------------------------------------------------

def _hf_mixtral(seed, **kw):
    torch.manual_seed(seed)
    cfg = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=96,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
               num_local_experts=4, num_experts_per_tok=2,
               max_position_embeddings=512, tie_word_embeddings=False)
    return MixtralForCausalLM(MixtralConfig(**dict(cfg, **kw),
                                            attn_implementation="eager")).eval()


def _hf_gpt2(seed, **kw):
    torch.manual_seed(seed)
    cfg = dict(vocab_size=VOCAB, n_embd=64, n_layer=2, n_head=4, n_positions=256)
    return GPT2LMHeadModel(GPT2Config(**dict(cfg, **kw),
                                      attn_implementation="eager")).eval()


_HF_TINY = {"mixtral": _hf_mixtral, "gpt2": _hf_gpt2}


def _same_cfg(tm, jm):
    """The port's config equals lxt_tpu's (whose Mixtral has no window)."""
    got = dataclasses.asdict(tm.cfg)
    if tm.family == "mixtral":
        assert got.pop("sliding_window") is None
    assert got == dataclasses.asdict(jm.cfg)


@pytest.mark.parametrize("family,kw", [
    ("mixtral", {}), ("gpt2", {}),
    ("gpt2", {"scale_attn_by_inverse_layer_idx": True})],
    ids=["mixtral", "gpt2", "gpt2_inverse_layer_scale"])
def test_mixtral_and_gpt2_from_hf_match_hf_and_lxt_tpu(family, kw):
    """A loaded HF model through from_hf: logits within atol 3e-4 of HF's,
    relevance within 1e-5 of lxt_tpu's; GPT-2 defaults to CP-LRP."""
    hf = _HF_TINY[family](seed=21, **kw)
    ids = np.random.RandomState(5).randint(0, VOCAB, (2, 128))
    with torch.no_grad():
        want = hf(input_ids=torch.as_tensor(ids), use_cache=False).logits.numpy()
    jm, tm = lxt_tpu.from_hf(hf), lxt_tpu_torch.from_hf(hf, device="cpu")
    assert tm.family == jm.family == family and tm.device == torch.device("cpu")
    assert tm.composite == (lxt_tpu_torch.cp_lrp if family == "gpt2"
                            else lxt_tpu_torch.attnlrp)
    _same_cfg(tm, jm)
    np.testing.assert_allclose(tm.logits(ids).numpy(), want, rtol=0, atol=3e-4)
    jv, jrel = jm.attribute(ids)
    tv, trel = tm.attribute(ids)
    assert _nl2(tv.numpy(), jv) <= BAR
    assert _nl2(trel.numpy(), jrel) <= BAR


@pytest.mark.parametrize("family,bits", [("mixtral", None), ("mixtral", "nf4"),
                                         ("gpt2", None)])
def test_mixtral_and_gpt2_from_pretrained_match_lxt_tpu(tmp_path, family, bits):
    _HF_TINY[family](seed=22).save_pretrained(tmp_path)
    jm = jreg.from_pretrained(tmp_path, quantize_bits=bits)
    tm = treg.from_pretrained(tmp_path, quantize_bits=bits, device="cpu")
    assert tm.family == jm.family == family and tm.composite.name == jm.composite.name
    _same_cfg(tm, jm)
    for name, jl in jm.params["layers"].items():
        tl = tm.params["layers"][name]
        assert isinstance(tl, tq.QuantizedTensor) == isinstance(jl, jq.QuantizedTensor)
        if isinstance(jl, jq.QuantizedTensor):
            np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
            np.testing.assert_array_equal(tl.scale.numpy(), np.asarray(jl.scale))
        else:
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert bits is None or isinstance(tm.params["layers"]["wg"], tq.QuantizedTensor)
    ids = np.random.RandomState(6).randint(0, VOCAB, (2, 128))
    assert _nl2(tm.logits(ids).numpy(), jm.logits(ids)) <= BAR
    for kw in ({}, {"kv_begin": np.asarray([5, 0], np.int32)}):
        jv, jrel = jm.attribute(ids, **kw)
        tv, trel = tm.attribute(ids, **kw)
        assert _nl2(tv.numpy(), jv) <= BAR, kw
        assert _nl2(trel.numpy(), jrel) <= BAR, kw


def test_mixtral_sliding_window_matches_hf():
    """A Mixtral config with a sliding window (96, below T 256) explains
    HF's model: the port applies the window on its einsum and flash paths,
    as transformers does, and without it the logits move."""
    hf = _hf_mixtral(seed=23, sliding_window=96)
    ids = np.random.RandomState(7).randint(0, VOCAB, (1, 256))
    with torch.no_grad():
        want = hf(input_ids=torch.as_tensor(ids), use_cache=False).logits.numpy()
    tm = lxt_tpu_torch.from_hf(hf, device="cpu")
    assert tm.cfg.sliding_window == 96
    e = tm.embed(ids)
    for impl in ("einsum", "flash"):
        with torch.no_grad():
            got = tmix.forward(tm.params, tm.cfg, e, attn_impl=impl).logits.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-4, err_msg=impl)
    with torch.no_grad():
        unwindowed = tmix.forward(tm.params, dataclasses.replace(
            tm.cfg, sliding_window=None), e).logits.numpy()
    assert np.abs(unwindowed - want).max() > 1e-2


MIXTRAL_GPT2_CONFIGS = {
    "mixtral_bare": {"model_type": "mixtral"},
    "mixtral_small": dict(_SMALL, model_type="mixtral", num_key_value_heads=2,
                          num_local_experts=4, num_experts_per_tok=1,
                          sliding_window=48, tie_word_embeddings=True),
    "gpt2_bare": {"model_type": "gpt2"},
    "gpt2_flags": {"model_type": "gpt2", "n_embd": 64, "n_layer": 3,
                   "n_head": 4, "n_positions": 128,
                   "scale_attn_by_inverse_layer_idx": True,
                   "reorder_and_upcast_attn": True, "layer_norm_epsilon": 1e-6},
}


@pytest.mark.parametrize("name", sorted(MIXTRAL_GPT2_CONFIGS))
def test_read_hf_config_mixtral_gpt2_matches_autoconfig(tmp_path, name):
    """Keys left out of config.json take transformers' MixtralConfig /
    GPT2Config defaults (Mixtral-8x7B's widths; GPT-2 small's)."""
    raw = MIXTRAL_GPT2_CONFIGS[name]
    (tmp_path / "config.json").write_text(json.dumps(raw))
    auto = AutoConfig.from_pretrained(tmp_path)
    got = treg.read_hf_config(tmp_path)
    if raw["model_type"] == "mixtral":
        want = dataclasses.asdict(jmix.MixtralConfig.from_hf(auto))
        ours = dataclasses.asdict(tmix.MixtralConfig.from_hf(got))
        assert ours.pop("sliding_window") == auto.sliding_window
        assert got.hidden_act == auto.hidden_act
    else:
        want = dataclasses.asdict(jgpt2.GPT2Config.from_hf(auto))
        ours = dataclasses.asdict(tgpt2.GPT2Config.from_hf(got))
        assert got.activation_function == auto.activation_function
    assert ours == want
    assert got.tie_word_embeddings == auto.tie_word_embeddings
