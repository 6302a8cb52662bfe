"""Checkpoint IO: HF safetensors checkpoints read with numpy alone
(counterpart of ``lxt_tpu/io.py``'s pure-numpy reader). Neither the
``safetensors`` package nor ``transformers`` is needed.

    state = load_checkpoint_state_dict("/path/to/llama-dir")
    params = load_checkpoint_params("/path/to/llama-dir", cfg,
                                    llama.params_from_hf)  # on the card

``dtype`` is the target of the 16-bit tensors: float32 (the default)
widens bf16 / f16 to numpy float32; a 16-bit target keeps a tensor stored
in that type as a view of its bits (no float32 on the way) and casts the
other 16-bit type to it. float32 and integer tensors stay as stored, as
``lxt_tpu.io`` keeps them.
"""

import json
from pathlib import Path

import numpy as np
import torch

_DTYPES = {
    "F32": (np.float32, 4), "F16": (np.float16, 2), "BF16": (None, 2),
    "I64": (np.int64, 8), "I32": (np.int32, 4), "I16": (np.int16, 2),
    "I8": (np.int8, 1), "U8": (np.uint8, 1), "BOOL": (np.bool_, 1),
    "F64": (np.float64, 8),
}


def _validate_tensor(name, st_dtype, shape, begin, end, data_size):
    """Bounds-check one tensor record against the data section (a
    truncated or malformed file raises instead of reading out of bounds)."""
    if st_dtype not in _DTYPES:
        raise ValueError(f"safetensors tensor '{name}': unsupported dtype "
                         f"{st_dtype}")
    count = int(np.prod(shape)) if shape else 1
    if begin < 0 or end < begin or end > data_size:
        raise ValueError(
            f"safetensors tensor '{name}': data_offsets [{begin}, {end}) "
            f"outside the {data_size}-byte data section")
    if end - begin != count * _DTYPES[st_dtype][1]:
        raise ValueError(
            f"safetensors tensor '{name}': {end - begin} bytes for "
            f"{count} x {st_dtype} elements")
    return count


def _widen(raw_u16, st_dtype):
    """bf16 / f16 bits -> float32."""
    if st_dtype == "BF16":  # the top half of a float32
        return (raw_u16.astype(np.uint32) << 16).view(np.float32)
    return raw_u16.view(np.float16).astype(np.float32)


def _half(raw_u16, st_dtype, dtype):
    """bf16 / f16 bits -> a ``dtype`` tensor: a view of the bits when the
    file stores ``dtype``, else widened and cast."""
    stored = torch.bfloat16 if st_dtype == "BF16" else torch.float16
    if stored == dtype:
        return torch.from_numpy(raw_u16.view(np.int16).copy()).view(stored)
    return torch.from_numpy(_widen(raw_u16, st_dtype)).to(dtype)


def load_safetensors(path, dtype=torch.float32):
    """Read one ``.safetensors`` file -> ``{name: array}``.

    bf16 / f16 tensors become numpy float32 for a float32 ``dtype`` (numpy
    has no bf16), else ``dtype`` tensors (see the module docstring); every
    other dtype is copied as stored into a numpy array. The file is
    memory-mapped."""
    dtype = torch.float32 if dtype is None else dtype
    mm = np.memmap(path, np.uint8, mode="r")
    if mm.size < 8:
        raise ValueError(f"{path}: truncated safetensors (< 8 bytes)")
    hlen = int(np.frombuffer(mm[:8], np.uint64)[0])
    if hlen > mm.size - 8:
        raise ValueError(f"{path}: header length {hlen} past end of file")
    meta = dict(json.loads(bytes(mm[8:8 + hlen])))
    meta.pop("__metadata__", None)
    data = mm[8 + hlen:]
    out = {}
    for name, info in meta.items():
        st_dtype = info["dtype"]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        _validate_tensor(name, st_dtype, shape, begin, end, data.size)
        raw = data[begin:end]
        if st_dtype in ("BF16", "F16") and dtype != torch.float32:
            arr = _half(raw.view(np.uint16), st_dtype, dtype).reshape(shape)
        elif st_dtype in ("BF16", "F16"):
            arr = _widen(raw.view(np.uint16), st_dtype).reshape(shape)
        else:
            arr = np.array(raw.view(_DTYPES[st_dtype][0]).reshape(shape))
        out[name] = arr
    return out


def load_checkpoint_state_dict(model_dir, dtype=torch.float32):
    """Load an HF checkpoint directory (one ``model.safetensors`` or shards
    under ``model.safetensors.index.json``) into ``{name: array}``, the
    16-bit tensors in ``dtype`` (see :func:`load_safetensors`)."""
    model_dir = Path(model_dir)
    index = model_dir / "model.safetensors.index.json"
    if index.exists():
        shards = sorted(set(json.loads(index.read_text())["weight_map"].values()))
        state = {}
        for shard in shards:
            state.update(load_safetensors(model_dir / shard, dtype))
        return state
    single = model_dir / "model.safetensors"
    if single.exists():
        return load_safetensors(single, dtype)
    raise FileNotFoundError(f"no safetensors checkpoint in {model_dir}")


def load_checkpoint_params(model_dir, cfg, converter, dtype=torch.float32,
                           device="cuda"):
    """Checkpoint directory -> parameter dict through a family converter
    (e.g. ``lxt_tpu_torch.models.llama.params_from_hf``), in ``dtype`` on
    ``device`` (the card unless the caller asks for the CPU, like the other
    loading entry points); the checkpoint's 16-bit tensors are read in
    ``dtype``."""
    state = load_checkpoint_state_dict(model_dir, dtype)
    return converter(state, cfg, dtype=dtype, device=device)
