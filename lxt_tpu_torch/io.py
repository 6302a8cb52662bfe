"""Checkpoint IO: HF safetensors checkpoints read by the port's native
loader (counterpart of ``lxt_tpu/io.py``). Neither the ``safetensors``
package nor ``transformers`` is needed.

    state = load_checkpoint_state_dict("/path/to/llama-dir")
    params = load_checkpoint_params("/path/to/llama-dir", cfg,
                                    llama.params_from_hf)  # on the card

The reader is ``native/safeload.cpp`` (the port's copy of ``lxt_tpu``'s),
built with g++ at first use into ``lxt_tpu_torch/_build/`` under a name
keyed by a hash of its source and flags, and loaded with ctypes. It maps
each tensor on its own; float32 and integer tensors are zero-copy views of
their mapping (unmapped with the last view),
and ``dtype`` is the target of the 16-bit tensors: float32 (the default)
widens bf16 / f16 on the loader's thread pool; a 16-bit target keeps a
tensor stored in that type as a view of its bits and widens, then casts
once, the other 16-bit type. If g++ cannot build the library, a load
raises with the compiler's message: there is no silent fallback (the
numpy reader :func:`load_safetensors_ref` is the plain version the tests
hold the loader against).

:class:`LazyState` is the checkpoint as a mapping that reads a tensor only
when it is asked for; ``from_pretrained`` and :func:`load_checkpoint_params`
convert through it, so the host holds about one layer's tensors at a time.
"""

import ctypes
import hashlib
import json
import os
import subprocess
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

_DTYPES = {
    "F32": (np.float32, 4), "F16": (np.float16, 2), "BF16": (None, 2),
    "I64": (np.int64, 8), "I32": (np.int32, 4), "I16": (np.int16, 2),
    "I8": (np.int8, 1), "U8": (np.uint8, 1), "BOOL": (np.bool_, 1),
    "F64": (np.float64, 8),
}
_HALF = {"BF16": torch.bfloat16, "F16": torch.float16}
_PKG_DIR = Path(__file__).resolve().parent
_SOURCE = _PKG_DIR / "native" / "safeload.cpp"
_BUILD_DIR = _PKG_DIR / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]


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


def _entries(header):
    meta = dict(json.loads(header))
    meta.pop("__metadata__", None)
    return meta


# ---------------------------------------------------------------------------
# the plain version: numpy alone
# ---------------------------------------------------------------------------

def _widen(raw_u16, st_dtype):
    """bf16 / f16 bits -> float32."""
    if st_dtype == "BF16":  # the top half of a float32
        return (raw_u16.astype(np.uint32) << 16).view(np.float32)
    return raw_u16.view(np.float16).astype(np.float32)


def _half(raw_u16, st_dtype, dtype):
    """bf16 / f16 bits -> a ``dtype`` tensor: a copy of the bits when the
    file stores ``dtype``, else widened and cast."""
    if _HALF[st_dtype] == dtype:
        return torch.from_numpy(raw_u16.view(np.int16).copy()).view(dtype)
    return torch.from_numpy(_widen(raw_u16, st_dtype)).to(dtype)


def load_safetensors_ref(path, dtype=torch.float32):
    """The plain version of :func:`load_safetensors`: numpy alone, every
    tensor copied out of an ``np.memmap`` of the file, with the same
    validation and the same output types."""
    dtype = torch.float32 if dtype is None else dtype
    mm = np.memmap(path, np.uint8, mode="r")
    if mm.size < 8:
        raise ValueError(f"{path}: truncated safetensors (< 8 bytes)")
    hlen = int(np.frombuffer(mm[:8], np.uint64)[0])
    if hlen > mm.size - 8:
        raise ValueError(f"{path}: header length {hlen} past end of file")
    meta = _entries(bytes(mm[8:8 + hlen]))
    data = mm[8 + hlen:]
    out = {}
    for name, info in meta.items():
        st_dtype = info["dtype"]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        _validate_tensor(name, st_dtype, shape, begin, end, data.size)
        raw = data[begin:end]
        if st_dtype in _HALF and dtype != torch.float32:
            arr = _half(raw.view(np.uint16), st_dtype, dtype).reshape(shape)
        elif st_dtype in _HALF:
            arr = _widen(raw.view(np.uint16), st_dtype).reshape(shape)
        else:
            arr = np.array(raw.view(_DTYPES[st_dtype][0]).reshape(shape))
        out[name] = arr
    return out


# ---------------------------------------------------------------------------
# the native loader
# ---------------------------------------------------------------------------

_lib = None


def _library_path():
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return _BUILD_DIR / f"libsafeload-{h.hexdigest()[:16]}.so"


def _native():
    """Build (if needed) and load ``native/safeload.cpp``; raises
    RuntimeError with g++'s message if it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    target = _library_path()
    if not target.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.stem}-{os.getpid()}.so")
        try:
            res = subprocess.run(["g++", *GXX_FLAGS, str(_SOURCE), "-o", str(tmp)],
                                 capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot build {_SOURCE.name}: {e}") from e
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {_SOURCE.name}:\n"
                               + res.stdout + res.stderr)
        os.replace(tmp, target)   # atomic: concurrent builds race harmlessly
    lib = ctypes.CDLL(str(target))
    lib.sl_open.restype = ctypes.c_void_p
    lib.sl_open.argtypes = [ctypes.c_char_p]
    lib.sl_header_len.restype = ctypes.c_uint64
    lib.sl_header_len.argtypes = [ctypes.c_void_p]
    lib.sl_header.restype = ctypes.c_void_p
    lib.sl_header.argtypes = [ctypes.c_void_p]
    lib.sl_file_size.restype = ctypes.c_uint64
    lib.sl_file_size.argtypes = [ctypes.c_void_p]
    lib.sl_map.restype = ctypes.c_void_p
    lib.sl_map.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.sl_unmap.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.sl_widen.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                             ctypes.c_int, ctypes.c_int]
    lib.sl_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class _Region:
    """One tensor's bytes mapped on their own; unmapped when the region and
    every view of it are gone."""

    def __init__(self, lib, handle, begin, nbytes):
        self.lib, self.nbytes = lib, nbytes
        self.ptr = lib.sl_map(handle, begin, nbytes)
        if not self.ptr:
            raise OSError(f"cannot map {nbytes} bytes at offset {begin}")

    def __del__(self):
        if getattr(self, "ptr", None):
            self.lib.sl_unmap(self.ptr, self.nbytes)
            self.ptr = None

    def view(self, np_dtype):
        """A flat zero-copy numpy view that keeps the region mapped."""
        buf = (ctypes.c_char * self.nbytes).from_address(self.ptr)
        buf._owner = self
        return np.frombuffer(buf, np_dtype)


class _Shard:
    """One ``.safetensors`` file: its validated tensor records, each read
    through a mapping of its own bytes."""

    def __init__(self, path, threads=None):
        self.lib = _native()
        self.path = str(path)
        self.threads = threads or min(8, os.cpu_count() or 1)
        self.handle = self.lib.sl_open(self.path.encode())
        if not self.handle:
            if not os.path.exists(self.path):
                raise FileNotFoundError(f"{self.path}: no such safetensors file")
            raise ValueError(f"{self.path}: truncated or malformed safetensors")
        hlen = self.lib.sl_header_len(self.handle)
        data_size = self.lib.sl_file_size(self.handle) - 8 - hlen
        self.entries = {}
        for name, info in _entries(ctypes.string_at(
                self.lib.sl_header(self.handle), hlen)).items():
            shape = tuple(info["shape"])
            begin, end = info["data_offsets"]
            count = _validate_tensor(name, info["dtype"], shape, begin, end,
                                     data_size)
            self.entries[name] = (info["dtype"], shape, begin, end - begin, count)

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.sl_close(self.handle)
            self.handle = None

    def read(self, name, dtype):
        """(owner, array): tensor ``name`` for a ``dtype`` target (numpy for
        float32 and integer tensors and for bf16 / f16 widened to a float32
        target, a torch tensor for a 16-bit target) and the numpy array that
        holds its bytes (a view of the tensor's mapping, or host memory)."""
        st_dtype, shape, begin, nbytes, count = self.entries[name]
        region = _Region(self.lib, self.handle, begin, nbytes) if nbytes else None

        def view(np_dtype):
            return region.view(np_dtype) if region else np.zeros(0, np_dtype)

        if st_dtype not in _HALF:
            arr = view(_DTYPES[st_dtype][0]).reshape(shape)
            return arr, arr
        if _HALF[st_dtype] == dtype:   # a view of the bits
            arr = view(np.int16).reshape(shape)
            return arr, torch.from_numpy(arr).view(dtype)
        wide = np.empty(count, np.float32)
        if region:
            self.lib.sl_widen(region.ptr, wide.ctypes.data, count,
                              int(st_dtype == "F16"), self.threads)
        del region   # unmapped: the copy holds the values
        wide = wide.reshape(shape)
        if dtype == torch.float32:
            return wide, wide
        # the other 16-bit type: widened, then cast once into numpy-owned
        # memory (so that the host bytes are freed with the array)
        bits = np.empty(shape, np.int16)
        torch.from_numpy(bits).view(dtype).copy_(torch.from_numpy(wide))
        return bits, torch.from_numpy(bits).view(dtype)


def load_safetensors(path, dtype=torch.float32, threads=None):
    """Read one ``.safetensors`` file -> ``{name: array}`` through the
    native loader.

    float32 and integer tensors are numpy arrays that view the mapping (a
    write copies the page and never reaches the file); bf16 / f16 tensors
    become numpy float32 for a float32 ``dtype`` (widened on ``threads``
    workers; numpy has no bf16), else ``dtype`` tensors (see the module
    docstring). Bit-equal to :func:`load_safetensors_ref`."""
    dtype = torch.float32 if dtype is None else dtype
    shard = _Shard(path, threads)
    return {name: shard.read(name, dtype)[1] for name in shard.entries}


def shard_paths(model_dir):
    """The ``.safetensors`` files of an HF checkpoint directory (one
    ``model.safetensors`` or the shards of ``model.safetensors.index.json``)."""
    model_dir = Path(model_dir)
    index = model_dir / "model.safetensors.index.json"
    if index.exists():
        return [model_dir / s for s in
                sorted(set(json.loads(index.read_text())["weight_map"].values()))]
    single = model_dir / "model.safetensors"
    if single.exists():
        return [single]
    raise FileNotFoundError(f"no safetensors checkpoint in {model_dir}")


def load_checkpoint_state_dict(model_dir, dtype=torch.float32):
    """Load an HF checkpoint directory (one ``model.safetensors`` or shards
    under ``model.safetensors.index.json``) into ``{name: array}``, the
    16-bit tensors in ``dtype`` (see :func:`load_safetensors`)."""
    state = {}
    for path in shard_paths(model_dir):
        state.update(load_safetensors(path, dtype))
    return state


class LazyState(Mapping):
    """A checkpoint directory as a read-only mapping ``name -> torch
    tensor`` over the shards: a tensor is read (viewed, or widened for a
    float32 target) only when it is asked for, and its mapping ends with
    the last view of it."""

    def __init__(self, model_dir, dtype=torch.float32):
        self.dtype = torch.float32 if dtype is None else dtype
        self._where = {}
        for path in shard_paths(model_dir):
            shard = _Shard(path)
            for name in shard.entries:
                self._where[name] = shard

    def read(self, name):
        """(owner, tensor): tensor ``name`` and the numpy array that holds
        its bytes, whose life is that of every view of the tensor."""
        owner, arr = self._where[name].read(name, self.dtype)
        return owner, torch.from_numpy(arr) if isinstance(arr, np.ndarray) else arr

    def __getitem__(self, name):
        return self.read(name)[1]

    def __iter__(self):
        return iter(self._where)

    def __len__(self):
        return len(self._where)

    def __contains__(self, name):
        return name in self._where


class Renamed(Mapping):
    """A mapping with renamed keys over another (``names``: new -> old),
    reading the other only when a value is asked for."""

    def __init__(self, state, names):
        self._state, self._names = state, dict(names)

    def __getitem__(self, name):
        return self._state[self._names[name]]

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)

    def __contains__(self, name):
        return name in self._names


def load_checkpoint_params(model_dir, cfg, converter, dtype=torch.float32,
                           device="cuda"):
    """Checkpoint directory -> parameter dict through a family converter
    (e.g. ``lxt_tpu_torch.models.llama.params_from_hf``), in ``dtype`` on
    ``device`` (the card unless the caller asks for the CPU, like the other
    loading entry points); the checkpoint is read through a
    :class:`LazyState`, its 16-bit tensors in ``dtype``."""
    return converter(LazyState(model_dir, dtype), cfg, dtype=dtype, device=device)
