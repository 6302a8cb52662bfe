"""The port's checkpoint reader with a 16-bit target dtype, against
lxt_tpu.io, on CPU.

``load_checkpoint_state_dict(dir, dtype=torch.bfloat16)`` keeps a stored
BF16 tensor as a view of its bits (bit-equal to lxt_tpu's
``dtype=bfloat16`` load, with no float32 tensor made for it), F16 stays
half width for a float16 target, and F32 and integer tensors stay as
stored. ``from_pretrained(..., dtype=torch.bfloat16)`` threads the dtype
into the reader, also for a bitsandbytes checkpoint whose other tensors
are bf16. The float32 default is unchanged.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file
from transformers.models.llama.modeling_llama import LlamaConfig, LlamaForCausalLM

from lxt_tpu import io as jio
from lxt_tpu.models import registry as jreg
from lxt_tpu_torch import io as tio
from lxt_tpu_torch.models import registry as treg
from lxt_tpu_torch.ops import quant as tq


def _bits(x):
    """The raw 16-bit pattern of a bf16 / f16 torch tensor or numpy array."""
    if torch.is_tensor(x):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.fixture
def mixed_dir(tmp_path):
    rng = np.random.default_rng(0)

    def r(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    save_file({"bf16": r(3, 4, 6).bfloat16(), "f16": r(5, 7).half(),
               "f32": r(7, 5), "i8": torch.from_numpy(
                   rng.integers(-128, 128, (2, 9)).astype(np.int8))},
              str(tmp_path / "model.safetensors"))
    return tmp_path


@pytest.mark.parametrize("target", ["bfloat16", "float16"])
def test_sixteen_bit_targets_match_lxt_tpu(mixed_dir, target):
    want = jio.load_checkpoint_state_dict(mixed_dir, dtype=getattr(jnp, target))
    got = tio.load_checkpoint_state_dict(mixed_dir, dtype=getattr(torch, target))
    assert sorted(got) == sorted(want)
    for name in ("bf16", "f16"):
        assert torch.is_tensor(got[name]) and got[name].dtype == getattr(torch, target)
        assert got[name].shape == want[name].shape
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]), err_msg=name)
    for name in ("f32", "i8"):   # as stored, as lxt_tpu keeps them
        assert isinstance(got[name], np.ndarray) and got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
    assert not any(torch.is_tensor(v) and v.dtype == torch.float32 for v in got.values())


def test_stored_bf16_is_read_as_its_bits(mixed_dir):
    """A BF16 tensor read for a bfloat16 target holds the file's bits:
    2 bytes an element, equal to the tensor saved."""
    saved = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 4, 6)).astype(np.float32)).bfloat16()
    got = tio.load_safetensors(mixed_dir / "model.safetensors", torch.bfloat16)["bf16"]
    assert got.element_size() == 2 and torch.equal(got, saved)
    widened = tio.load_safetensors(mixed_dir / "model.safetensors")["bf16"]
    assert widened.dtype == np.float32 and widened.nbytes == 2 * got.numel() * 2
    np.testing.assert_array_equal(widened, got.float().numpy())


def _hf_llama_bf16(tmp_path, seed=3):
    torch.manual_seed(seed)
    hf = LlamaForCausalLM(LlamaConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
        max_position_embeddings=128)).eval().to(torch.bfloat16)
    hf.save_pretrained(tmp_path)
    return hf


def test_from_pretrained_bfloat16_matches_lxt_tpu(tmp_path):
    _hf_llama_bf16(tmp_path)
    state = tio.load_checkpoint_state_dict(tmp_path, torch.bfloat16)
    assert all(torch.is_tensor(v) and v.dtype == torch.bfloat16 for v in state.values())
    jm = jreg.from_pretrained(tmp_path, dtype=jnp.bfloat16)
    tm = treg.from_pretrained(tmp_path, dtype=torch.bfloat16, device="cpu")
    for name, leaf in jm.params["layers"].items():
        got = tm.params["layers"][name]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), _bits(leaf), err_msg=name)
    np.testing.assert_array_equal(_bits(tm.params["embed"]), _bits(jm.params["embed"]))
    # the float32 default: the same values, widened
    t32 = treg.from_pretrained(tmp_path, device="cpu")
    assert t32.params["layers"]["wq"].dtype == torch.float32
    assert torch.equal(t32.params["layers"]["wq"].bfloat16(), tm.params["layers"]["wq"])


def test_bnb_checkpoint_with_bf16_tensors(tmp_path):
    """A bitsandbytes-NF4 checkpoint whose unquantized tensors are bf16:
    the reader's dict mixes numpy arrays (codes, absmax, quant maps) with
    bf16 tensors, which the ingest leaves alone; the re-quantized codes
    and scales equal lxt_tpu's bfloat16 load."""
    hf = _hf_llama_bf16(tmp_path, seed=4)
    code = tq.NF4_CODE
    state = {}
    for name, p in hf.state_dict().items():
        if not (name.endswith(".weight") and p.ndim == 2 and "_proj" in name):
            state[name] = p
            continue
        arr = p.float().numpy()
        blocks = arr.reshape(-1, 64)
        absmax = np.abs(blocks).max(axis=1).astype(np.float32)
        idx = np.argmin(np.abs((blocks / absmax[:, None])[..., None] - code),
                        axis=-1).reshape(-1).astype(np.uint8)
        meta = {"blocksize": 64, "quant_type": "nf4", "dtype": "bfloat16",
                "shape": list(arr.shape)}
        state[name] = torch.from_numpy(((idx[0::2] << 4) | idx[1::2]).reshape(-1, 1))
        state[name + ".absmax"] = torch.from_numpy(absmax)
        state[name + ".quant_map"] = torch.from_numpy(code.astype(np.float32))
        state[name + ".quant_state.bitsandbytes__nf4"] = torch.from_numpy(
            np.frombuffer(json.dumps(meta).encode(), np.uint8).copy())
    save_file(state, str(tmp_path / "model.safetensors"))
    raw = tio.load_checkpoint_state_dict(tmp_path, torch.bfloat16)
    assert isinstance(raw["model.layers.0.mlp.up_proj.weight.absmax"], np.ndarray)
    assert raw["model.norm.weight"].dtype == torch.bfloat16
    assert tq.ingest_bnb_state_dict(raw)
    assert raw["model.layers.0.mlp.up_proj.weight"].dtype == np.float32
    tm = treg.from_pretrained(tmp_path, dtype=torch.bfloat16, device="cpu")
    jm = jreg.from_pretrained(tmp_path, dtype=jnp.bfloat16)
    for name in tq.FAMILY_QUANTIZABLE["llama"]:
        got, want = tm.params["layers"][name], jm.params["layers"][name]
        assert isinstance(got, tq.QuantizedTensor) and got.bits == "nf4"
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q), err_msg=name)
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale),
                                      err_msg=name)
    assert tm.params["final_norm"].dtype == torch.bfloat16
