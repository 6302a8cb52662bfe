"""Weight-only quantization (int8 / int4 / nf4) for attribution of models too
big to hold in bf16 — the counterpart of ``lxt_tpu/ops/quant.py``.

Weights carry no relevance under LRP, so quantization changes only the
forward values; the rules are untouched. Layouts follow ``lxt_tpu``:

- int8: ``q`` int8 ``[..., in, out]``, per-output-channel scale
  ``[..., 1, out]``;
- int4: two signed nibbles per uint8 packed **even/odd** along the input
  axis (row 2j low nibble, row 2j+1 high nibble), per-output-channel scale;
- nf4: indices into the 16-entry NF4 codebook packed **half-split** (packed
  row j holds row j in its low nibble and row j + in/2 in its high one),
  per-(input block, output channel) absmax ``[..., in/block, out]``.

K3 ``nf4_dequant`` (``csrc/nf4_dequant.cu``) dequantizes nf4 codes on the
card; on CPU tensors it runs its plain version (:func:`nf4_dequant_ref`),
on a CUDA tensor it launches the kernel or raises. ``launches`` counts its
launches. The nf4 and int4 matmuls are autograd Functions with
transpose-free backwards; the nf4 one keeps only codes and scales and
dequantizes again in its backward.

The bitsandbytes ingest and :func:`quantize_params` are host-side numpy,
copied from ``lxt_tpu``.
"""

import ctypes
import dataclasses
import json
from typing import Any

import numpy as np
import torch

#: The NF4 codebook (QLoRA): the 16 quantiles of a standard normal,
#: normalized to [-1, 1] — bitsandbytes' ``quant_type="nf4"`` map.
NF4_CODE = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0], np.float32)

#: Decision thresholds: midpoints between adjacent code entries (ties round
#: down, as bitsandbytes' strict ``>`` comparisons do).
_NF4_MID = (NF4_CODE[1:] + NF4_CODE[:-1]) / 2.0

#: float32 reciprocals that ``lxt_tpu``'s layer-stacked path scales by (see
#: :func:`_quantize_one`)
_INV = {8: np.float32(1.0) / np.float32(127.0), 4: np.float32(1.0) / np.float32(7.0)}

#: launch count of the K3 wrapper; it adds one per launch
launches = {"nf4_dequant": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0


@dataclasses.dataclass
class QuantizedTensor:
    """Weight-only quantized tensor (see the module docstring for layouts).
    ``bits`` (8, 4 or "nf4") and ``block`` (nf4 input-block size) are
    static metadata. ``qt[i]`` is the layer-``i`` slice of a layer-stacked
    tensor."""

    q: Any
    scale: Any
    bits: Any = 8
    block: int = 0

    @property
    def shape(self):
        s = list(self.q.shape)
        if self.bits in (4, "nf4"):
            s[-2] *= 2
        return tuple(s)

    def to(self, device):
        return QuantizedTensor(self.q.to(device), self.scale.to(device),
                               self.bits, self.block)

    def __getitem__(self, i):
        return QuantizedTensor(self.q[i], self.scale[i], self.bits, self.block)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def _nf4_block(K, block):
    """Largest power-of-two block <= ``block`` dividing K (real-model input
    dims are multiples of 64; tiny test geometries shrink)."""
    while block > 2 and K % block:
        block //= 2
    if K % block:
        raise ValueError(f"nf4 needs an even input dimension, got {K}")
    return block


def _quantize_one(w32, bits, block, stacked):
    """One float32 ``[in, out]`` matrix -> (codes, scale).

    ``stacked``: the matrix is a slice of a layer-stacked weight. There
    ``lxt_tpu`` quantizes under ``lax.map``, where XLA turns ``absmax /
    127`` (``/ 7``) into ``absmax * float32(1/127)`` (``1/7``) — 1 ulp off
    the division of its 2-D path in some scales. Each path's arithmetic is
    followed here, so codes and scales stay bit-exact in both. The 2-D
    division divides by a tensor on the weight's device: torch's CUDA
    division by a Python scalar also multiplies by the reciprocal."""
    if bits == "nf4":
        K, N = w32.shape
        blocks = w32.reshape(K // block, block, N)
        absmax = blocks.abs().amax(dim=-2)                     # [K/block, N]
        norm = blocks / torch.clamp(absmax[:, None, :], min=1e-12)
        mid = torch.from_numpy(_NF4_MID).to(w32.device)
        idx = torch.searchsorted(mid, norm.contiguous(), right=False,
                                 out_int32=True)
        idx = idx.reshape(K, N).to(torch.uint8)
        # half-split packing: packed row j = row j (low) | row j + K/2 (high)
        return idx[: K // 2] | (idx[K // 2:] << 4), absmax
    absmax = w32.abs().amax(dim=-2, keepdim=True)
    if stacked:
        scale = absmax * float(_INV[bits])
    else:
        scale = absmax / absmax.new_tensor(127.0 if bits == 8 else 7.0)
    r = torch.round(w32 / torch.clamp(scale, min=1e-12))
    if bits == 8:
        return torch.clamp(r, -127, 127).to(torch.int8), scale
    q = (torch.clamp(r, -7, 7) + 8).to(torch.uint8)
    return q[0::2] | (q[1::2] << 4), scale                     # even/odd


def quantize(w, bits=8, block: int = 64) -> QuantizedTensor:
    """Quantize ``[..., in, out]`` weights: per output channel for int8 /
    int4, per (input block, output channel) NF4 codebook for "nf4".
    Layer-stacked (ndim >= 3) weights are quantized one leading slice at a
    time, so the float32 intermediates never exceed one layer's matrix."""
    if bits not in (8, 4, "nf4"):
        raise ValueError(f"unsupported bits: {bits!r} (8, 4 or 'nf4')")
    if bits in (4, "nf4") and w.shape[-2] % 2:
        raise ValueError("4-bit packing needs an even input dimension")
    block = _nf4_block(w.shape[-2], block) if bits == "nf4" else 0
    w = torch.as_tensor(w)
    if w.dim() >= 3:
        lead = tuple(w.shape[:-2])
        flat = w.reshape((-1,) + tuple(w.shape[-2:]))
        parts = [_quantize_one(m.float(), bits, block, stacked=True)
                 for m in flat]
        q = torch.stack([p[0] for p in parts])
        scale = torch.stack([p[1] for p in parts])
        return QuantizedTensor(q.reshape(lead + tuple(q.shape[1:])),
                               scale.reshape(lead + tuple(scale.shape[1:])),
                               bits, block)
    q, scale = _quantize_one(w.float(), bits, block, stacked=False)
    return QuantizedTensor(q, scale, bits, block)


_CODE = {}


def _code(device):
    if device not in _CODE:
        _CODE[device] = torch.from_numpy(NF4_CODE).to(device)
    return _CODE[device]


def dequantize(qt: QuantizedTensor, dtype=torch.float32):
    """The dense ``[..., in, out]`` weight in ``dtype``: codes times scales
    in float32, rounded once to ``dtype``."""
    q = qt.q
    if qt.bits == 8:
        return (q.float() * qt.scale).to(dtype)
    if qt.bits == "nf4":
        idx = torch.cat([(q & 0xF).long(), (q >> 4).long()], dim=-2)
        vals = _code(q.device)[idx]                             # [..., K, N]
        lead = tuple(idx.shape[:-2])
        K, N = idx.shape[-2:]
        blocks = vals.reshape(lead + (K // qt.block, qt.block, N))
        w = blocks * qt.scale[..., None, :]
        return w.reshape(lead + (K, N)).to(dtype)
    lo = (q & 0xF).to(torch.int32) - 8
    hi = (q >> 4).to(torch.int32) - 8
    # un-interleave back to the input axis: row 2j = lo[j], row 2j+1 = hi[j]
    shape = list(q.shape)
    shape[-2] *= 2
    w = torch.stack([lo, hi], dim=-2).reshape(shape).float() * qt.scale
    return w.to(dtype)


# ---------------------------------------------------------------------------
# K3: nf4 dequantization
# ---------------------------------------------------------------------------

def nf4_dequant_ref(q, scale, block, dtype):
    """Plain version of K3: half-split nf4 codes ``q [..., K/2, N]`` with
    per-block ``scale [..., K/block, N]`` -> dense ``[..., K, N]`` in
    ``dtype``."""
    return dequantize(QuantizedTensor(q, scale, "nf4", block), dtype)


_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lib = None


def _library():
    global _lib
    if _lib is None:
        from lxt_tpu_torch.ops import _build
        lib = _build.library()
        lib.lxt_nf4_dequant.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.lxt_nf4_dequant.restype = ctypes.c_int
        _lib = lib
    return _lib


def nf4_dequant(q, scale, block, dtype):
    """K3. Dequantize half-split nf4 codes ``q [..., K/2, N]`` (uint8) with
    float32 ``scale [..., K/block, N]`` to ``[..., K, N]`` in ``dtype``
    (bfloat16, float16 or float32). CPU tensors take the plain version; a CUDA
    tensor launches the kernel, or raises on what it does not take."""
    if q.device.type == "cpu":
        return nf4_dequant_ref(q, scale, block, dtype)
    if not q.is_cuda:
        raise ValueError(f"nf4_dequant: unsupported device {q.device}")
    if dtype not in _OUT_CODE:
        raise ValueError(f"nf4_dequant: output dtype {dtype} not supported "
                         f"(bfloat16, float16 or float32)")
    if q.dtype != torch.uint8 or q.dim() < 2 or not q.is_contiguous():
        raise ValueError(f"nf4_dequant: codes must be a contiguous uint8 "
                         f"[..., K/2, N] tensor, got {q.dtype} "
                         f"{tuple(q.shape)}")
    Kh, N = q.shape[-2:]
    K = 2 * Kh
    lead = tuple(q.shape[:-2])
    if block <= 0 or K % block:
        raise ValueError(f"nf4_dequant: block {block} must divide K={K}")
    want = lead + (K // block, N)
    if (scale.dtype != torch.float32 or tuple(scale.shape) != want
            or not scale.is_contiguous() or scale.device != q.device):
        raise ValueError(f"nf4_dequant: scale must be a contiguous float32 "
                         f"tensor of shape {want} on {q.device}, got "
                         f"{scale.dtype} {tuple(scale.shape)} on {scale.device}")
    layers = int(np.prod(lead)) if lead else 1
    # grid limits: packed rows on grid x (int32), 512-column groups on y
    if layers * Kh >= 2**31 - 16 or N > 512 * 65535:
        raise ValueError(f"nf4_dequant: codes {tuple(q.shape)} exceed the "
                         f"kernel's grid")
    out = torch.empty(lead + (K, N), dtype=dtype, device=q.device)
    if out.numel() == 0:
        return out
    # the 16-byte vector path needs every packed row, scale row and output
    # row to start 16-byte aligned
    aligned = int(N % 16 == 0 and q.data_ptr() % 16 == 0
                  and scale.data_ptr() % 16 == 0)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.lxt_nf4_dequant(q.data_ptr(), scale.data_ptr(),
                                  out.data_ptr(), layers, Kh, N, block,
                                  _OUT_CODE[dtype], aligned, stream)
    if err != 0:
        raise RuntimeError(f"nf4_dequant: CUDA launch failed with error {err}")
    launches["nf4_dequant"] += 1
    return out


# ---------------------------------------------------------------------------
# matmuls
# ---------------------------------------------------------------------------

def _keep(ctx, q, scale):
    """Keep the codes and scales for the backward as attributes of ``ctx``.

    Not ``save_for_backward``: saved tensors pass through
    ``torch.utils.checkpoint``'s hooks, and the recompute of a checkpointed
    layer runs until every tensor saved in the layer is rebuilt. The
    backwards here need only the codes and scales, which live outside the
    layer, so kept on ``ctx`` they let the recompute stop before the
    layer's last projection (its dequantization and product), as it does
    for a dense weight's matmul. They are parameters: never outputs of the
    Function, never written in place."""
    ctx.q, ctx.scale = q, scale


class _NF4Matmul(torch.autograd.Function):
    """``x @ dequant(q, scale)``. Keeps only the codes and scales; the
    backward dequantizes again (in ``g.dtype``) and contracts the shared
    output axis, ``dx = g wᵀ``: the dense weight is never kept."""

    lrp_rule = ("linear", "epsilon rule (implicit via G*I), quantized weight")

    @staticmethod
    def forward(ctx, x, q, scale, block):
        _keep(ctx, q, scale)
        ctx.block, ctx.x_shape, ctx.x_dtype = block, x.shape, x.dtype
        return torch.matmul(x, nf4_dequant(q, scale, block, x.dtype))

    @staticmethod
    def backward(ctx, g):
        w = nf4_dequant(ctx.q, ctx.scale, ctx.block, g.dtype)
        dx = torch.matmul(g, w.transpose(-1, -2)).sum_to_size(ctx.x_shape)
        return dx.to(ctx.x_dtype), None, None, None


def _nibbles(q, dtype):
    """The signed even/odd int4 planes of ``q`` in ``dtype`` (exact)."""
    return (((q & 0xF).to(torch.int8) - 8).to(dtype),
            ((q >> 4).to(torch.int8) - 8).to(dtype))


class _Int4Matmul(torch.autograd.Function):
    """Nibble-plane int4 matmul: the even/odd planes multiply the even/odd
    input columns as two half-contraction matmuls and the per-channel scale
    applies once on the output in float32. The backward folds the scale
    into ``g``, contracts the output axis against each plane and
    re-interleaves the two halves (a stack, not a strided scatter)."""

    lrp_rule = ("linear", "epsilon rule (implicit via G*I), quantized weight")

    @staticmethod
    def forward(ctx, x, q, scale):
        _keep(ctx, q, scale)
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        lo, hi = _nibbles(q, x.dtype)
        y = torch.matmul(x[..., 0::2], lo) + torch.matmul(x[..., 1::2], hi)
        return (y * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        gs = (g * ctx.scale).to(g.dtype)
        lo, hi = _nibbles(ctx.q, gs.dtype)
        dxe = torch.matmul(gs, lo.transpose(-1, -2))           # even columns
        dxo = torch.matmul(gs, hi.transpose(-1, -2))           # odd columns
        dx = torch.stack([dxe, dxo], dim=-1).reshape(ctx.x_shape)
        return dx.to(ctx.x_dtype), None, None


def quant_matmul(x, qt: QuantizedTensor, bias=None):
    """``x @ dequant(qt) (+ bias)``. int8: dequantize to ``x.dtype`` and
    multiply; int4: the nibble-plane matmul (layer-stacked codes take the
    same math under plain autograd); nf4: K3 then the product, with the
    transpose-free backward."""
    if qt.bits == "nf4":
        y = _NF4Matmul.apply(x, qt.q, qt.scale, qt.block)
    elif qt.bits == 8:
        y = torch.matmul(x, dequantize(qt, x.dtype))
    elif qt.q.dim() == 2:
        y = _Int4Matmul.apply(x, qt.q, qt.scale)
    else:
        lo, hi = _nibbles(qt.q, x.dtype)
        y = torch.matmul(x[..., 0::2], lo) + torch.matmul(x[..., 1::2], hi)
        y = (y * qt.scale).to(x.dtype)
    return y if bias is None else y + bias


# ---------------------------------------------------------------------------
# bitsandbytes serialized-checkpoint ingest (host-side, numpy)
# ---------------------------------------------------------------------------

def dequantize_bnb_4bit(packed, absmax, shape, blocksize=64, code=None,
                        nested_absmax=None, nested_quant_map=None,
                        nested_blocksize=256, nested_offset=0.0):
    """Dequantize one bitsandbytes 4-bit tensor to float32 (numpy).

    ``packed`` uint8 holds two codebook indices per byte in flat row-major
    order of the torch ``shape``, the first element in the high nibble;
    each run of ``blocksize`` flat elements shares one ``absmax``. With
    double quantization (``nested_*``) the absmax are uint8 indices into
    ``nested_quant_map`` with a blockwise ``nested_absmax`` scale plus
    ``nested_offset``. ``code`` defaults to :data:`NF4_CODE`; pass the
    checkpoint's stored ``quant_map`` (fp4 checkpoints too)."""
    code = NF4_CODE if code is None else np.asarray(code, np.float32)
    packed = np.asarray(packed, np.uint8).reshape(-1)
    absmax = np.asarray(absmax)
    if nested_absmax is not None:
        nqm = np.asarray(nested_quant_map, np.float32)
        na = np.asarray(nested_absmax, np.float32)
        scaled = nqm[absmax.astype(np.int64).reshape(-1)]
        scaled *= np.repeat(na, nested_blocksize)[:scaled.size]
        absmax = scaled + np.float32(nested_offset)
    absmax = absmax.astype(np.float32).reshape(-1)
    n = int(np.prod(shape))
    flat = np.empty(packed.size * 2, np.float32)
    flat[0::2] = code[packed >> 4]
    flat[1::2] = code[packed & 0xF]
    flat = flat[:n] * np.repeat(absmax, blocksize)[:n]
    return flat.reshape(shape)


def dequantize_bnb_8bit(cb, scb):
    """Dequantize one bitsandbytes ``Linear8bitLt`` tensor to float32
    (numpy): int8 ``[out, in]`` codes with per-row absmax ``scb``,
    ``w = CB * SCB / 127``."""
    cb = np.asarray(cb, np.int8).astype(np.float32)
    scb = np.asarray(scb, np.float32).reshape(-1, 1)
    return cb * scb / np.float32(127.0)


def ingest_bnb_state_dict(state):
    """Rewrite the bitsandbytes-serialized 4-bit and 8-bit entries of an HF
    state dict (numpy arrays) to full-precision arrays, in place; returns
    the rewritten weight names (empty for a non-bnb checkpoint).

    4-bit: ``<w>`` (packed uint8), ``<w>.absmax``, ``<w>.quant_map``,
    ``<w>.quant_state.bitsandbytes__{nf4,fp4}`` (JSON as uint8), and
    ``<w>.nested_absmax`` / ``<w>.nested_quant_map`` under double
    quantization. 8-bit: ``<w>`` int8 codes plus ``<w>.SCB`` per-row
    absmax (and an optional ``<w>.weight_format`` / ``<w>_format``)."""
    suffixes = (".quant_state.bitsandbytes__nf4",
                ".quant_state.bitsandbytes__fp4")
    ingested = []
    for qs_key in [k for k in list(state) if k.endswith(suffixes)]:
        base = qs_key[:qs_key.index(".quant_state.bitsandbytes__")]
        meta = json.loads(np.asarray(state[qs_key], np.uint8).tobytes())
        aux = {}
        if f"{base}.nested_absmax" in state:
            aux = dict(
                nested_absmax=state.pop(f"{base}.nested_absmax"),
                nested_quant_map=state.pop(f"{base}.nested_quant_map"),
                nested_blocksize=int(meta.get("nested_blocksize", 256)),
                nested_offset=float(meta.get("nested_offset", 0.0)))
        state[base] = dequantize_bnb_4bit(
            state.pop(base), state.pop(f"{base}.absmax"), meta["shape"],
            blocksize=int(meta["blocksize"]),
            code=state.pop(f"{base}.quant_map", None), **aux)
        del state[qs_key]
        ingested.append(base)
    for scb_key in [k for k in list(state) if k.endswith(".SCB")]:
        base = scb_key[: -len(".SCB")]
        if base not in state:
            continue
        state[base] = dequantize_bnb_8bit(state.pop(base),
                                          state.pop(scb_key))
        state.pop(f"{base}.weight_format", None)
        state.pop(f"{base}_format", None)
        ingested.append(base)
    return ingested


#: Per-family quantizable leaves (the linear projections, bitsandbytes'
#: Linear-only scope). lm_head is absent everywhere: bitsandbytes leaves
#: the output head full precision, and the explained logit is what
#: attribution reads. Families the port has no model for yet keep their
#: entries, so the table stays ``lxt_tpu``'s.
FAMILY_QUANTIZABLE = {
    "llama": ("wq", "wk", "wv", "wo", "wg", "wu", "wd"),
    "gemma3": ("wq", "wk", "wv", "wo", "wg", "wu", "wd"),
    "mixtral": ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "w_router"),
    "gpt2": ("w_attn", "w_proj", "w_fc", "w_out"),
    "bert": ("wq", "wk", "wv", "wo", "wi", "wout", "pooler_w"),
    "siglip": ("wq", "wk", "wv", "wo", "w_fc", "w_out"),
    "vit": ("w_qkv", "w_proj", "w_fc", "w_out", "head_w"),
}


_ALIASES = {"qwen2": "llama", "qwen3": "llama", "mistral": "llama",
            "phi3": "llama", "gemma3_text": "gemma3"}
_SKIP = ("embed", "wte", "wpe", "word_emb", "pos_emb", "type_emb", "lm_head")


def eligibility(bits=8, family: str = None, min_ndim: int = 2, skip=_SKIP):
    """``eligible(name, shape)``: whether :func:`quantize_params` quantizes
    a leaf of that name and shape (see there); the converters ask it while
    they stack a leaf, to quantize it one layer slice at a time."""
    if family is not None:
        family = _ALIASES.get(family, family)
        if family not in FAMILY_QUANTIZABLE:
            raise ValueError(
                f"no quantizable-leaf spec for family {family!r}; "
                f"known: {sorted(FAMILY_QUANTIZABLE)}")
    spec = None if family is None else frozenset(FAMILY_QUANTIZABLE[family])

    def eligible(name, shape):
        if spec is not None:
            return (name in spec and len(shape) >= min_ndim
                    and (bits == 8 or shape[-2] % 2 == 0))
        is_norm = "ln" in name or "norm" in name
        # bias vectors stack to 2-D under the layer axis: never quantize
        is_bias = name.startswith("b") or name.endswith("_b") or "bias" in name
        return (len(shape) >= min_ndim and name not in skip and not is_norm
                and not is_bias and min(shape[-2:]) >= 16
                and shape[-2] % 2 == 0)

    return eligible


def quantize_params(params, bits=8, min_ndim: int = 2,
                    family: str = None, skip=_SKIP):
    """Quantize the weight matrices of a parameter dict (norms, biases and
    embeddings stay full precision). ``bits``: 8, 4 or "nf4".

    With ``family`` given, exactly the leaves in
    :data:`FAMILY_QUANTIZABLE` are quantized (qwen2/qwen3/mistral/phi3
    resolve to the llama spec, gemma3_text to gemma3); otherwise a name
    heuristic selects matrices and skips norms, biases and embeddings.
    Leaves that are already quantized pass through."""
    eligible = eligibility(bits, family, min_ndim, skip)

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        name = path.rsplit("/", 1)[-1]
        return (quantize(tree, bits) if hasattr(tree, "ndim")
                and eligible(name, tuple(tree.shape)) else tree)

    return walk(params)
