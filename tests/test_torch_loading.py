"""Loading at scale (lxt_tpu_torch.io's native loader, ``models/common``'s
``HFWeights`` and quantize-while-converting) against lxt_tpu, on CPU.

- The native reader (``native/safeload.cpp``, built by g++ at first use)
  is bit-equal to ``lxt_tpu.io.load_safetensors`` (lxt_tpu's own native
  reader) and to the port's plain numpy reader for F32, BF16, F16, I8 and
  U8 tensors, for float32, bfloat16 and float16 targets, one shard and an
  indexed multi-shard checkpoint; float32 and integer tensors are views of
  the mapping. Truncated and malformed files raise ``ValueError``, a
  missing one ``FileNotFoundError``, and a library g++ cannot build raises
  with the compiler's message (no fallback).
- Every family's converter, fed a ``LazyState`` of a checkpoint stored in
  float32 or bf16, gives params bit-equal to lxt_tpu's ``params_from_hf``
  (float32) cast to the target (float32, bfloat16): Llama, Phi-3's fused
  projections, Mixtral, Gemma-3 text, GPT-2, BERT and the ViT.
- ``from_pretrained(quantize_bits=8 | 4 | "nf4")`` quantizes layer by
  layer, with codes and scales bit-equal to ``quantize_params`` after a
  whole conversion and to lxt_tpu's ``from_pretrained`` (a tiny Llama in
  bf16, a tiny Mixtral with 4 experts in float32).
- The host bound: converting a 12-layer checkpoint, the lazy state never
  holds more than one layer's tensors at once.
"""

import functools
import json
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file
from transformers import (BertConfig, BertForSequenceClassification, GPT2Config,
                          GPT2LMHeadModel, MixtralConfig, MixtralForCausalLM,
                          Phi3Config, Phi3ForCausalLM)
from transformers.models.gemma3.modeling_gemma3 import Gemma3ForCausalLM, Gemma3TextConfig
from transformers.models.llama.modeling_llama import LlamaConfig, LlamaForCausalLM

from lxt_tpu import io as jio
from lxt_tpu.models import bert as jbert
from lxt_tpu.models import gemma3 as jgemma
from lxt_tpu.models import gpt2 as jgpt2
from lxt_tpu.models import llama as jllama
from lxt_tpu.models import mixtral as jmix
from lxt_tpu.models import registry as jreg
from lxt_tpu.models import vit as jvit
from lxt_tpu_torch import io as tio
from lxt_tpu_torch.models import bert as tbert
from lxt_tpu_torch.models import gemma3 as tgemma
from lxt_tpu_torch.models import gpt2 as tgpt2
from lxt_tpu_torch.models import llama as tllama
from lxt_tpu_torch.models import mixtral as tmix
from lxt_tpu_torch.models import registry as treg
from lxt_tpu_torch.models import vit as tvit
from lxt_tpu_torch.ops import quant as tq
from tests._reference_golden import _TorchViT

_STORED = {"F32": torch.float32, "BF16": torch.bfloat16}
_TARGET = {"float32": (torch.float32, jnp.float32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _bits(x):
    """float32 as uint32 bits, 16-bit types as int16 bits (torch or jnp)."""
    if torch.is_tensor(x):
        return (x.view(torch.int32) if x.element_size() == 4 else x.view(torch.int16)).numpy()
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype.itemsize == 4 else a.view(np.int16)


class _Counted(tio.LazyState):
    """A ``LazyState`` that counts the host bytes it has handed out:
    ``live_bytes`` those of the tensors still alive (a read's bytes live
    as long as any view of its tensor), ``peak_bytes`` its largest value,
    ``read_bytes`` all of them: the converters' host footprint."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.live_bytes = self.peak_bytes = self.read_bytes = 0

    def __getitem__(self, name):
        owner, t = self.read(name)
        self.live_bytes += owner.nbytes
        self.read_bytes += owner.nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(owner, self._done, owner.nbytes).atexit = False
        return t

    def _done(self, n):
        self.live_bytes -= n


# ---------------------------------------------------------------------------
# the native reader
# ---------------------------------------------------------------------------

def _mixed(seed):
    rng = np.random.default_rng(seed)

    def r(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return {"f32": r(7, 5), "bf16": r(3, 4, 6).bfloat16(), "f16": r(5, 7).half(),
            "i8": torch.from_numpy(rng.integers(-128, 128, (2, 9)).astype(np.int8)),
            "u8": torch.from_numpy(rng.integers(0, 256, (33,)).astype(np.uint8)),
            # more than 2**20 elements: the widening runs on the thread pool
            "bf16_big": r(1100, 1000).bfloat16(), "f16_big": r(1050, 1000).half(),
            "empty": r(0, 4)}


@pytest.fixture(params=["one_shard", "indexed_shards"])
def mixed_dir(request, tmp_path):
    tensors = _mixed(0)
    if request.param == "one_shard":
        save_file(tensors, str(tmp_path / "model.safetensors"))
        return tmp_path
    names = sorted(tensors)
    parts = {"model-00001-of-00002.safetensors": names[::2],
             "model-00002-of-00002.safetensors": names[1::2]}
    for shard, keys in parts.items():
        save_file({k: tensors[k] for k in keys}, str(tmp_path / shard))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: shard for shard, keys in parts.items() for k in keys}}))
    return tmp_path


@pytest.mark.parametrize("target", ["float32", "bfloat16", "float16"])
def test_native_reader_is_bit_equal_to_lxt_tpu_and_the_plain_reader(mixed_dir, target):
    dtype = getattr(torch, target)
    got = tio.load_checkpoint_state_dict(mixed_dir, dtype)
    plain = {}
    for path in tio.shard_paths(mixed_dir):
        plain.update(tio.load_safetensors_ref(path, dtype))
    want = jio.load_checkpoint_state_dict(mixed_dir, dtype=getattr(jnp, target))
    assert sorted(got) == sorted(plain) == sorted(want)
    for name, x in got.items():
        for other, what in ((plain[name], "plain"), (want[name], "lxt_tpu")):
            if name.startswith(("bf16", "f16")) and target != "float32":
                assert torch.is_tensor(x) and x.dtype == dtype, name
                np.testing.assert_array_equal(_bits(x), _bits(other), err_msg=what)
            else:
                assert isinstance(x, np.ndarray) and x.dtype == np.asarray(other).dtype
                assert x.shape == np.asarray(other).shape, (name, what)
                np.testing.assert_array_equal(x.view(np.uint8), np.asarray(other).view(
                    np.uint8), err_msg=f"{name} {what}")
    # float32 and integer tensors are views of the mapping, not copies
    for name in ("f32", "i8", "u8"):
        assert not got[name].flags.owndata, name
    if target == "bfloat16":   # a stored bf16 tensor read as its bits
        assert got["bf16"].untyped_storage().nbytes() == got["bf16"].numel() * 2


def test_bad_files_raise_and_the_build_does_not_fall_back(tmp_path, monkeypatch):
    path = tmp_path / "model.safetensors"
    save_file(_mixed(1), str(path))
    raw = path.read_bytes()
    hlen = int(np.frombuffer(raw[:8], np.uint64)[0])
    bad = {"truncated": raw[:-7], "short": raw[:5],
           "header_past_end": np.uint64(10**9).tobytes() + raw[8:],
           "bad_dtype": raw[:8] + raw[8:8 + hlen].replace(b'"I8"', b'"Q9"') + raw[8 + hlen:]}
    for name, data in bad.items():
        p = tmp_path / f"{name}.safetensors"
        p.write_bytes(data)
        for read in (tio.load_safetensors, tio.load_safetensors_ref):
            with pytest.raises(ValueError):
                read(p)
    with pytest.raises(FileNotFoundError):
        tio.load_safetensors(tmp_path / "missing.safetensors")
    with pytest.raises(FileNotFoundError):
        tio.LazyState(tmp_path / "nowhere")
    # a library g++ cannot build: the load raises with the compiler's message
    broken = tmp_path / "safeload.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tio, "_SOURCE", broken)
    monkeypatch.setattr(tio, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tio, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build safeload.cpp:\n.*error"):
        tio.load_safetensors(path)


# ---------------------------------------------------------------------------
# every family's converter through the lazy state
# ---------------------------------------------------------------------------

def _seeded(model, seed):
    """Every parameter drawn from a seed (norms away from their init)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    return model


_CONFIGS = {"llama": "LlamaConfig", "phi3": "LlamaConfig", "mixtral": "MixtralConfig",
            "gemma3": "Gemma3Config", "gpt2": "GPT2Config", "bert": "BertConfig"}


@functools.lru_cache(maxsize=None)
def _family(name):
    """(HF state dict, port converter and config, lxt_tpu's)."""
    if name == "vit":
        module = _TorchViT.build()
        return (module.state_dict(), tvit.params_from_torchvision,
                treg.from_hf(module, device="cpu").cfg, jvit.params_from_torchvision,
                jreg.from_hf(module).cfg)
    small = dict(vocab_size=96, hidden_size=64, intermediate_size=96,
                 num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                 max_position_embeddings=128)
    if name in ("llama", "phi3"):
        cls, conf = ((LlamaForCausalLM, LlamaConfig) if name == "llama"
                     else (Phi3ForCausalLM, Phi3Config))
        extra = {"pad_token_id": 0} if name == "phi3" else {}
        hf = cls(conf(**small, tie_word_embeddings=False, **extra))
        mods = (tllama, jllama)
    elif name == "mixtral":
        hf = MixtralForCausalLM(MixtralConfig(**small, num_local_experts=4,
                                              num_experts_per_tok=2))
        mods = (tmix, jmix)
    elif name == "gemma3":
        hf = Gemma3ForCausalLM(Gemma3TextConfig(**small, head_dim=16, sliding_window=8,
                                                query_pre_attn_scalar=16))
        mods = (tgemma, jgemma)
    elif name == "gpt2":
        hf = GPT2LMHeadModel(GPT2Config(vocab_size=96, n_embd=64, n_layer=2, n_head=4,
                                        n_positions=64))
        mods = (tgpt2, jgpt2)
    else:
        hf = BertForSequenceClassification(BertConfig(
            vocab_size=96, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64, num_labels=3))
        mods = (tbert, jbert)
    _seeded(hf, 5)
    conf = _CONFIGS[name]
    cfgs = [getattr(m, conf).from_hf(hf.config) for m in mods]
    return (hf.state_dict(), mods[0].params_from_hf, cfgs[0], mods[1].params_from_hf,
            cfgs[1])


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("target", sorted(_TARGET))
@pytest.mark.parametrize("stored", sorted(_STORED))
@pytest.mark.parametrize("family", ["llama", "phi3", "mixtral", "gemma3", "gpt2",
                                    "bert", "vit"])
def test_family_converters_match_lxt_tpu(tmp_path, family, stored, target):
    sd, convert, cfg, jconvert, jcfg = _family(family)
    save_file({k: v.detach().to(_STORED[stored]).contiguous().clone()
               for k, v in sd.items()}, str(tmp_path / "model.safetensors"))
    tdtype, jdtype = _TARGET[target]
    state = _Counted(tmp_path, tdtype)
    got = dict(_leaves(convert(state, cfg, dtype=tdtype, device="cpu")))
    jstate = jio.load_checkpoint_state_dict(tmp_path, dtype=np.float32)
    want = dict(_leaves(jconvert(jstate, jcfg, dtype=np.float32)))
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert leaf.dtype == tdtype and leaf.is_contiguous(), name
        np.testing.assert_array_equal(_bits(leaf), _bits(want[name].astype(jdtype)),
                                      err_msg=name)
    del got
    assert state.live_bytes == 0 and state.read_bytes > 0


# ---------------------------------------------------------------------------
# quantize while converting
# ---------------------------------------------------------------------------

def _write(tmp_path, family, dtype):
    sd = _family(family)[0]
    hf_cls = {"llama": LlamaForCausalLM, "mixtral": MixtralForCausalLM}[family]
    hf = hf_cls(_hf_config(family))
    hf.load_state_dict(sd)
    hf.to(dtype).save_pretrained(tmp_path)


def _hf_config(family):
    small = dict(vocab_size=96, hidden_size=64, intermediate_size=96,
                 num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                 max_position_embeddings=128, tie_word_embeddings=False)
    if family == "mixtral":
        return MixtralConfig(**small, num_local_experts=4, num_experts_per_tok=2)
    return LlamaConfig(**small)


@pytest.mark.parametrize("bits", [8, 4, "nf4"])
@pytest.mark.parametrize("family,target", [("llama", "bfloat16"), ("mixtral", "float32")])
def test_quantize_while_converting_matches_whole_conversion_and_lxt_tpu(
        tmp_path, family, target, bits):
    tdtype, jdtype = _TARGET[target]
    _write(tmp_path, family, tdtype)
    got = treg.from_pretrained(tmp_path, dtype=tdtype, quantize_bits=bits, device="cpu")
    whole = treg.from_pretrained(tmp_path, dtype=tdtype, device="cpu")
    after = tq.quantize_params(whole.params, bits=bits, family=family)
    want = jreg.from_pretrained(tmp_path, dtype=jdtype, quantize_bits=bits)
    names = tq.FAMILY_QUANTIZABLE[family]
    for name in names:
        leaf = got.params["layers"][name]
        assert isinstance(leaf, tq.QuantizedTensor) and leaf.bits == bits, name
        for ref in (after["layers"][name], want.params["layers"][name]):
            assert leaf.block == ref.block, name
            np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(ref.q), err_msg=name)
            np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(ref.scale),
                                          err_msg=name)
    for name, leaf in got.params["layers"].items():   # the rest as converted
        if name not in names:
            assert torch.equal(leaf, whole.params["layers"][name]), name
    assert torch.equal(got.params["lm_head"], whole.params["lm_head"])


def test_conversion_holds_one_layer_on_the_host(tmp_path, monkeypatch):
    """A 12-layer bf16 checkpoint converted to float32 (each tensor widened
    on the host): the lazy state's live bytes never pass one layer's."""
    cfg = LlamaConfig(vocab_size=32, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=12, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=64,
                      tie_word_embeddings=False)
    torch.manual_seed(0)
    LlamaForCausalLM(cfg).to(torch.bfloat16).save_pretrained(tmp_path)
    states = []

    class Recorded(_Counted):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            states.append(self)

    monkeypatch.setattr(tio, "LazyState", Recorded)
    for bits in (None, "nf4"):
        model = treg.from_pretrained(tmp_path, device="cpu", quantize_bits=bits)
        state = states[-1]
        peak, read = state.peak_bytes, state.read_bytes
        # float32 bytes of each tensor, from the shards' headers
        size = {k: 4 * count for shard in set(state._where.values())
                for k, (_, _, _, _, count) in shard.entries.items()}
        layer = sum(n for k, n in size.items() if k.startswith("model.layers.0."))
        assert peak <= layer < sum(size.values()) / 10, (peak, layer)
        assert read == sum(size.values())   # every tensor read once
        assert model.params["layers"]["wq"].shape[0] == 12
