"""Flash attention for CUDA: hand-written Hopper kernels and their plain
PyTorch versions (counterpart of ``lxt_tpu/ops/flash_attention.py``).

The AttnLRP rules wrap *around* attention (``Composite.qkv``), so these
kernels compute standard flash attention and its standard backward:

- K1 ``flash_fwd`` (``csrc/flash_fwd.cu``): out = softmax(q kᵀ·scale + mask) v
  by online softmax, plus the natural-log logsumexp of each row;
- K2 ``flash_bwd_dq`` and ``flash_bwd_dkv`` (``csrc/flash_bwd.cu``): the
  gradients from p = exp(s − lse) and Δ = rowsum(out∘do) − dlse, dlse being
  the lse cotangent of :func:`flash_attention_lse` (none for
  :func:`flash_attention`);
- ``rope_rotate`` (``csrc/rope.cu``): the RoPE rotation pass of one tensor.

K1, ``flash_bwd_dq`` and ``flash_bwd_dkv`` have a Hopper body (wgmma, TMA,
warp-specialised) for bf16 at head dim 64, 128 and 256; float32 and
float16 run the mma.sync bodies. Each kernel's body is picked by (dtype,
head dim) alone.
``flash_bwd_dq`` also computes Δ of its rows from the forward's out and
writes it out for ``flash_bwd_dkv``: the backward runs no separate Δ pass.

Layout: q ``[B, H, Tq, D]``, k/v ``[B, Hkv, Tk, D]`` with ``Hkv`` dividing
``H`` (Tq and Tk may differ: a chunk of queries against a longer key
span, as ``lxt_tpu``'s kernels take it); the kernels read the batch, head and time strides (the last dim must
be contiguous), so head-split views of a projection need no copy. Masks are
in global positions: ``causal``, a sliding ``window`` (``k > q − window``),
and per-example ``kv_begin``/``kv_end`` [B] valid-key spans. Query row i
sits at global position ``q_start`` + i and key row j at ``k_start`` + j
(both 0 but in a ring step, ``parallel/ring.py``). Query rows with no
visible key give out 0 and lse −1e30; lse and Δ are ``[B, H, Tq]``.
Optional ``rope`` ``(cos, sin)`` [T, D] tables (Tq == Tk only) rotate q and k (HF rotate-half, in the activation dtype):
inside the kernels, except that the Hopper bodies read k (K1,
``flash_bwd_dq``) and q (``flash_bwd_dkv``) rotated once per call by
``rope_rotate``; the transposed rotation is applied to dq and dk. In bf16
that is three rotation passes per forward and backward at every head dim
(k before K1 and before ``flash_bwd_dq``, q before ``flash_bwd_dkv``); the
mma.sync bodies of float32 and float16 rotate inside the kernels.

Every kernel wrapper takes its plain version for CPU tensors (the tests);
for a CUDA tensor it launches the kernel or raises. ``launches`` counts the
kernel launches of each wrapper.
"""

import ctypes
import math
from typing import Optional

import torch

from lxt_tpu_torch.models import common as _mcommon
from lxt_tpu_torch.ops.attention import NATIVE_HEAD_DIMS, repeat_kv

NEG_INF = -1e30
LOG2E = 1.4426950408889634
#: launch count of each kernel wrapper; the wrappers add one per launch
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "rope_rotate": 0}
#: rows per tile in every kernel: CUDA calls need Tq % TILE == Tk % TILE == 0
TILE = 64


def reset_launches():
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# argument checks (lxt_tpu.ops.flash_attention._canon / _check_rope)
# ---------------------------------------------------------------------------

def _canon(q, k, window, scale, q_start=0, k_start=0):
    """(window, scale) as Python numbers: window None means no window, and
    the window is clamped to >= 1 (each row sees at least its own key) and
    to T + |q_start − k_start| + 2**20 (a window past the call's largest
    global distance masks nothing; the kernels take an int)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    no_window = max(q.shape[2], k.shape[2]) + abs(q_start - k_start) + 2**20
    window = no_window if window is None else min(max(int(window), 1), no_window)
    return window, float(scale)


def _check_rope(rope, q, k):
    """Validate in-kernel rope tables ([T, D]); cast to the activation dtype
    (HF apply_rotary_pos_emb semantics — the rotation runs in x.dtype)."""
    if rope is None:
        return None, None
    cos, sin = rope
    Tq, Tk, D = q.shape[2], k.shape[2], q.shape[-1]
    if Tq != Tk:
        raise ValueError("in-kernel rope requires Tq == Tk")
    if tuple(cos.shape) != (Tq, D) or tuple(sin.shape) != (Tq, D):
        raise ValueError(f"rope tables must be [T={Tq}, D={D}], got "
                         f"{tuple(cos.shape)}")
    return cos.to(q.dtype).contiguous(), sin.to(q.dtype).contiguous()


def _span(x, B, device):
    return None if x is None else torch.as_tensor(
        x, dtype=torch.int32, device=device).reshape(B).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch versions of the kernels
# ---------------------------------------------------------------------------

def _allowed(q, k, kv_begin, kv_end, window, causal, q_start=0, k_start=0):
    """Boolean [B|1, 1, Tq, Tk] mask in global positions."""
    dev = q.device
    qi = torch.arange(q.shape[2], device=dev)[:, None] + q_start
    kj = torch.arange(k.shape[2], device=dev)[None, :] + k_start
    ok = kj > qi - window
    if causal:
        ok = ok & (kj <= qi)
    ok = ok[None, None]
    if kv_begin is not None:
        ok = ok & (kj >= kv_begin.long()[:, None, None, None])
    if kv_end is not None:
        ok = ok & (kj < kv_end.long()[:, None, None, None])
    return ok


# ---------------------------------------------------------------------------
# work counts: what a call must compute and move, for roofline bounds
# ---------------------------------------------------------------------------

#: matrix products over the visible (query, key) pairs each kernel computes:
#: K1 s = q kᵀ and p v; dq recomputes s and dp = do vᵀ, then ds k; dkv
#: recomputes s and dp, then pᵀ do and dsᵀ q
PRODUCTS = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}


def visible_pairs(T, window=None, causal=True, kv_begin=None, kv_end=None,
                  q_start=0, k_start=0, Tk=None):
    """Number of visible (query, key) pairs of a [T, Tk] attention (Tk None:
    T), summed over the batch rows of ``kv_begin``/``kv_end`` ([B] or None;
    None is one unpadded row). Query i (global q_start + i) sees key j
    (global k_start + j) when j > i − window, kv_begin ≤ j < kv_end and, if
    causal, j ≤ i, all in global positions (the mask of the kernels)."""
    Tk = T if Tk is None else Tk
    # each query's visible keys as a span of the call's key rows
    p = torch.arange(T, dtype=torch.int64) + (q_start - k_start)
    lo = (p - window + 1).clamp(min=0) if window is not None else torch.zeros_like(p)
    hi = p.clamp(max=Tk - 1) if causal else torch.full_like(p, Tk - 1)
    begins = [0] if kv_begin is None else [int(x) - k_start for x in kv_begin]
    ends = [Tk] * len(begins) if kv_end is None else [
        min(int(x) - k_start, Tk) for x in kv_end]
    if len(begins) == 1 and len(ends) > 1:
        begins = begins * len(ends)
    return sum(int((torch.minimum(hi, torch.tensor(e - 1))
                    - torch.maximum(lo, torch.tensor(b)) + 1)
                   .clamp(min=0).sum())
               for b, e in zip(begins, ends))


def work(name, B, H, Hkv, T, D, itemsize=2, *, window=None, causal=True,
         kv_begin=None, kv_end=None, rope=False, q_start=0, k_start=0,
         dlse=False, Tk=None):
    """(FLOPs, bytes) one call of kernel ``name`` must spend: each product
    over the visible pairs costs 2·D FLOPs a pair and head, and each input
    is read once and each output written once (``dlse``: flash_bwd_dq also
    reads the lse cotangent). T is the query length and Tk the key length
    (None: T). ``rope_rotate`` is the rotation pass over a [B, H, T, D]
    tensor (three FLOPs an element)."""
    Tk = T if Tk is None else Tk
    act = B * H * T * D * itemsize          # q, do, out, dq
    kv = B * Hkv * Tk * D * itemsize        # k, v, dk, dv
    stat = B * H * T * 4                    # lse, delta (float32)
    tables = 2 * T * D * itemsize if rope else 0
    if name == "rope_rotate":
        return 3 * B * H * T * D, 2 * act + tables
    pairs = visible_pairs(T, window, causal, kv_begin, kv_end, q_start,
                          k_start, Tk)
    if kv_begin is None and kv_end is None:
        pairs *= B
    flops = PRODUCTS[name] * pairs * H * 2 * D
    moved = {"flash_fwd": 2 * act + 2 * kv + stat,
             "flash_bwd_dq": 4 * act + 2 * kv + (3 if dlse else 2) * stat,
             "flash_bwd_dkv": 2 * act + 4 * kv + 2 * stat}[name]
    return flops, moved + tables


def _rope_qk(q, k, cos, sin):
    return (q, k) if cos is None else _mcommon.apply_rope(q, k, cos, sin)


def _rope_transpose(x, cos, sin):
    """The transpose of the rope rotation (its vjp), on a float32 tensor."""
    if cos is None:
        return x
    y = x * sin.float()
    h = x.shape[-1] // 2
    return x * cos.float() + torch.cat([y[..., h:], -y[..., :h]], dim=-1)


def _scores(q, k, cos, sin, kv_begin, kv_end, window, scale, causal,
            q_start, k_start):
    """Roped float32 q, repeated float32 k, masked scores and the mask."""
    q, k = _rope_qk(q, k, cos, sin)
    n_rep = q.shape[1] // k.shape[1]
    qf, kf = q.float(), repeat_kv(k.float(), n_rep)
    ok = _allowed(q, k, kv_begin, kv_end, window, causal, q_start, k_start)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    return qf, kf, s.masked_fill(~ok, NEG_INF), ok


def flash_fwd_ref(q, k, v, cos, sin, kv_begin, kv_end, window, scale, causal,
                  *, q_start=0, k_start=0):
    """Plain version of K1: float32 softmax; returns (out, lse [B, H, T])."""
    _, _, s, ok = _scores(q, k, cos, sin, kv_begin, kv_end, window, scale,
                          causal, q_start, k_start)
    vf = repeat_kv(v.float(), q.shape[1] // k.shape[1])
    m = s.amax(-1, keepdim=True)
    empty = m <= NEG_INF / 2
    p = torch.exp(s - m).masked_fill(~ok, 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.matmul(p, vf) / torch.where(empty, 1.0, l)
    out = out.masked_fill(empty, 0.0)
    lse = torch.where(empty, NEG_INF, m + torch.log(l))
    return out.to(q.dtype), lse.squeeze(-1)


def _probs(q, k, lse, cos, sin, kv_begin, kv_end, window, scale, causal,
           q_start, k_start):
    qf, kf, s, ok = _scores(q, k, cos, sin, kv_begin, kv_end, window, scale,
                            causal, q_start, k_start)
    lse = lse[..., None]
    p = torch.exp(s - lse).masked_fill(~ok | (lse <= NEG_INF / 2), 0.0)
    return qf, kf, p


def flash_bwd_dq_ref(q, k, v, do, out, lse, cos, sin, kv_begin, kv_end,
                     window, scale, causal, *, q_start=0, k_start=0,
                     dlse=None):
    """Plain version of ``flash_bwd_dq``: Δ = rowsum(out∘do) − dlse and dq =
    (p∘(do vᵀ − Δ)) k · scale; returns (dq, Δ float32 [B, H, T])."""
    delta = (out.float() * do.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    _, kf, p = _probs(q, k, lse, cos, sin, kv_begin, kv_end, window, scale,
                      causal, q_start, k_start)
    vf = repeat_kv(v.float(), q.shape[1] // k.shape[1])
    ds = p * (torch.matmul(do.float(), vf.transpose(-1, -2)) - delta[..., None])
    dq = torch.matmul(ds, kf) * scale
    return _rope_transpose(dq, cos, sin).to(q.dtype), delta


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, cos, sin, kv_begin, kv_end,
                      window, scale, causal, *, q_start=0, k_start=0):
    """Plain version of ``flash_bwd_dkv``: dv = pᵀ do, dk = dsᵀ q · scale,
    both summed over each GQA group."""
    qf, _, p = _probs(q, k, lse, cos, sin, kv_begin, kv_end, window, scale,
                      causal, q_start, k_start)
    B, Hkv, Tk, D = k.shape
    n_rep = q.shape[1] // Hkv
    dof = do.float()
    vf = repeat_kv(v.float(), n_rep)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dk = dk.view(B, Hkv, n_rep, Tk, D).sum(2)
    dv = dv.view(B, Hkv, n_rep, Tk, D).sum(2)
    return _rope_transpose(dk, cos, sin).to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

class _FlashArgs(ctypes.Structure):
    """Mirror of ``struct FlashArgs`` in ``csrc/flash_common.cuh``."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "dout", "out", "lse", "delta", "dlse", "cos",
            "sin", "kv_begin", "kv_end", "out0", "out1", "lse_out")]
        + [(f"stride{i}", ctypes.c_longlong) for i in range(21)]
        + [(n, ctypes.c_int) for n in (
            "B", "H", "Hkv", "T", "Tk", "window", "causal", "q_start",
            "k_start")]
        + [(n, ctypes.c_float) for n in ("scale", "scale_log2")])


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ENTRY = {"flash_fwd": "lxt_flash_fwd", "flash_bwd_dq": "lxt_flash_bwd_dq",
          "flash_bwd_dkv": "lxt_flash_bwd_dkv"}
#: each kernel's mma.sync body alone (controls timed by chip_smoke.py)
_MMA = {name: entry + "_mma" for name, entry in _ENTRY.items()}
#: the kernel argument of lxt_flash_hopper
_KERNEL_CODE = {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2}
_lib = None


def _library():
    global _lib
    if _lib is None:
        from lxt_tpu_torch.ops import _build
        lib = _build.library()
        for sym in (*_ENTRY.values(), *_MMA.values()):
            fn = getattr(lib, sym)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.lxt_flash_hopper.argtypes = [ctypes.c_int] * 3
        lib.lxt_flash_hopper.restype = ctypes.c_int
        lib.lxt_rope_rotate.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.lxt_rope_rotate.restype = ctypes.c_int
        _lib = lib
    return _lib


def _aligned(t):
    """The kernels load 16-byte vectors: last dim contiguous, base and the
    batch/head/time strides 16-byte aligned."""
    e = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * e % 16 == 0 for s in t.stride()[:3]))


def _prepared(t):
    return t if _aligned(t) else t.clone(memory_format=torch.contiguous_format)


def _stat(t):
    """lse / Δ as the kernels read them: contiguous, 16-byte aligned (the
    Hopper body copies 64-row slices of them in bulk)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _hopper(name, q):
    """Whether a CUDA call of kernel ``name`` at q's dtype and head dim runs
    its Hopper body (``lxt_flash_hopper`` in csrc/flash_fwd.cu decides):
    that body reads k (K1, ``flash_bwd_dq``) or q (``flash_bwd_dkv``)
    rotated by the rotation pass instead of rotating it in the kernel."""
    code = _DTYPE_CODE.get(q.dtype)
    return code is not None and bool(
        _library().lxt_flash_hopper(_KERNEL_CODE[name], code, q.shape[-1]))


def _launch(name, q, k, v, *, dout=None, fwd_out=None, lse=None, delta=None,
            dlse=None, cos=None, sin=None, kv_begin=None, kv_end=None, outs=(),
            lse_out=None, window, scale, causal, q_start=0, k_start=0,
            entry=None):
    """Check the arguments and launch kernel ``name`` on the current stream
    (through the library's ``entry``, by default the kernel's own)."""
    if not q.is_cuda:
        raise ValueError(f"{name}: expected CUDA tensors, got {q.device}")
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         f"(bfloat16, float16 or float32)")
    if D not in NATIVE_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {NATIVE_HEAD_DIMS}")
    acts = [t for t in (q, k, v, dout, fwd_out) if t is not None]
    if (T % TILE or Tk % TILE or H % Hkv or tuple(k.shape) != (B, Hkv, Tk, D)
            or v.shape != k.shape or (cos is not None and Tk != T)
            or any(t.shape != q.shape for t in acts[3:])):
        raise ValueError(f"{name}: needs k, v [B, Hkv, Tk, D] with Hkv dividing "
                         f"H, Tq % {TILE} == Tk % {TILE} == 0 and Tq == Tk "
                         f"with rope; got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    # (tensor, dtype, shape) of every other input the kernel reads densely
    dense = [(lse, torch.float32, (B, H, T)), (delta, torch.float32, (B, H, T)),
             (dlse, torch.float32, (B, H, T)), (cos, q.dtype, (T, D)),
             (sin, q.dtype, (T, D)), (kv_begin, torch.int32, (B,)),
             (kv_end, torch.int32, (B,))]
    for t in acts + list(outs) + [x for x, _, _ in dense if x is not None]:
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on {q.device}")
    for t in acts + list(outs):
        if t.dtype != q.dtype or not _aligned(t):
            raise ValueError(f"{name}: activations must share q's dtype and "
                             f"be 16-byte aligned with a contiguous last dim")
    for t, dtype, shape in dense:
        if t is not None and (t.dtype != dtype or tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor of "
                             f"shape {shape}, got {t.dtype} {tuple(t.shape)}")

    def ptr(t):
        return None if t is None else t.data_ptr()

    strided = [q, k, v, dout, fwd_out, *outs] + [None] * (2 - len(outs))
    strides = []
    for t in strided:
        strides += list(t.stride()[:3]) if t is not None else [0, 0, 0]
    args = _FlashArgs(
        ptr(q), ptr(k), ptr(v), ptr(dout), ptr(fwd_out), ptr(lse), ptr(delta),
        ptr(dlse), ptr(cos), ptr(sin), ptr(kv_begin), ptr(kv_end),
        ptr(outs[0]) if outs else None, ptr(outs[1]) if len(outs) > 1 else None,
        ptr(lse_out), *strides, B, H, Hkv, T, Tk, window, int(causal),
        int(q_start), int(k_start), scale, scale * LOG2E)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry or _ENTRY[name])(
            ctypes.addressof(args), _DTYPE_CODE[q.dtype], D, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1


def rope_rotate_ref(x, cos, sin):
    """Plain version of the rotation pass: ``models.common.apply_rope``'s
    rotation of one [B, H, T, D] tensor by [T, D] tables."""
    return _mcommon.rotate(x, cos, sin)


def rope_rotate(x, cos, sin):
    """The RoPE rotation pass (``csrc/rope.cu``): x rotated by the [T, D]
    tables in x's dtype, into a new contiguous tensor, bit-identical to
    :func:`rope_rotate_ref`. The Hopper bodies read k (K1,
    ``flash_bwd_dq``) and q (``flash_bwd_dkv``) rotated once per call by
    it."""
    if x.device.type == "cpu":
        return rope_rotate_ref(x, cos, sin)
    if not x.is_cuda:
        raise ValueError(f"rope_rotate: expected a CUDA tensor, got {x.device}")
    B, H, T, D = x.shape
    if x.dtype not in _DTYPE_CODE or D not in NATIVE_HEAD_DIMS:
        raise ValueError(f"rope_rotate: {x.dtype} with head dim {D} not "
                         f"supported (bfloat16, float16 or float32, "
                         f"{NATIVE_HEAD_DIMS})")
    x = _prepared(x)
    for t in (cos, sin):
        if (t.device != x.device or t.dtype != x.dtype
                or tuple(t.shape) != (T, D) or not t.is_contiguous()):
            raise ValueError(f"rope_rotate: tables must be contiguous {x.dtype} "
                             f"[{T}, {D}] on {x.device}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lxt_rope_rotate(x.data_ptr(), *x.stride()[:3], cos.data_ptr(),
                                  sin.data_ptr(), out.data_ptr(), B, H, T, D,
                                  _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rope_rotate: CUDA launch failed with error {err}")
    launches["rope_rotate"] += 1
    return out


def flash_fwd(q, k, v, cos, sin, kv_begin, kv_end, window, scale, causal,
              *, q_start=0, k_start=0):
    """K1. Returns (out like q, lse float32 [B, H, T]). On the Hopper body
    (bf16, head dim 64, 128 or 256) with rope, k is rotated first by
    :func:`rope_rotate`; q is rotated inside the kernel."""
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, cos, sin, kv_begin, kv_end, window,
                             scale, causal, q_start=q_start, k_start=k_start)
    q, k, v = _prepared(q), _prepared(k), _prepared(v)
    if cos is not None and _hopper("flash_fwd", q):
        k = rope_rotate(k, cos, sin)
    return _fwd(q, k, v, cos, sin, kv_begin, kv_end, window, scale, causal,
                q_start=q_start, k_start=k_start)


def _fwd(q, k, v, cos, sin, kv_begin, kv_end, window, scale, causal,
         entry=None, q_start=0, k_start=0):
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, k, v, cos=cos, sin=sin, kv_begin=kv_begin,
            kv_end=kv_end, outs=(out,), lse_out=lse, window=window,
            scale=scale, causal=causal, q_start=q_start, k_start=k_start,
            entry=entry)
    return out, lse


def flash_fwd_mma(q, k, v, cos, sin, kv_begin, kv_end, window, scale,
                  causal):
    """K1 through its mma.sync body (not bf16 at head dim 64 or 128), q and
    k rotated inside the kernel: the body that bf16 at head dim 256 ran
    before its Hopper body, which ``chip_smoke.py`` times beside it. The
    model path never calls it."""
    q, k, v = _prepared(q), _prepared(k), _prepared(v)
    return _fwd(q, k, v, cos, sin, kv_begin, kv_end, window, scale, causal,
                entry=_MMA["flash_fwd"])


def flash_bwd_dq(q, k, v, do, out, lse, cos, sin, kv_begin, kv_end, window,
                 scale, causal, *, q_start=0, k_start=0, dlse=None):
    """K2, dq half: one CTA per (b, h, q tile), looping over kv tiles. Also
    computes Δ = rowsum(out∘do) − dlse of its rows from the forward's
    ``out`` (and the lse cotangent ``dlse`` float32 [B, H, T], if given);
    returns (dq, Δ float32 [B, H, T]). On the Hopper body (bf16, head dim
    64, 128 or 256) with rope, k is rotated first by :func:`rope_rotate`; q
    is rotated inside the kernel."""
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, out, lse, cos, sin, kv_begin,
                                kv_end, window, scale, causal, q_start=q_start,
                                k_start=k_start, dlse=dlse)
    q, k, v, do, out = (_prepared(t) for t in (q, k, v, do, out))
    if cos is not None and _hopper("flash_bwd_dq", q):
        k = rope_rotate(k, cos, sin)
    return _bwd_dq(q, k, v, do, out, lse, cos, sin, kv_begin, kv_end, window,
                   scale, causal, q_start=q_start, k_start=k_start, dlse=dlse)


def _bwd_dq(q, k, v, do, out, lse, cos, sin, kv_begin, kv_end, window, scale,
            causal, entry=None, q_start=0, k_start=0, dlse=None):
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_bwd_dq", q, k, v, dout=do, fwd_out=out, lse=_stat(lse),
            dlse=None if dlse is None else _stat(dlse), cos=cos, sin=sin,
            kv_begin=kv_begin, kv_end=kv_end, outs=(dq,), lse_out=delta,
            window=window, scale=scale, causal=causal, q_start=q_start,
            k_start=k_start, entry=entry)
    return dq, delta


def flash_bwd_dq_mma(q, k, v, do, out, lse, cos, sin, kv_begin, kv_end,
                     window, scale, causal):
    """``flash_bwd_dq`` through its mma.sync body at any dtype and head dim,
    q and k rotated inside the kernel: the body that bf16 ran before its
    Hopper body, which ``chip_smoke.py`` times beside it. The model path
    never calls it."""
    q, k, v, do, out = (_prepared(t) for t in (q, k, v, do, out))
    return _bwd_dq(q, k, v, do, out, lse, cos, sin, kv_begin, kv_end, window,
                   scale, causal, entry=_MMA["flash_bwd_dq"])


def flash_bwd_dkv(q, k, v, do, lse, delta, cos, sin, kv_begin, kv_end, window,
                  scale, causal, *, q_start=0, k_start=0):
    """K2, dk/dv half: one CTA per (b, kv head, kv tile), looping over the
    GQA group's q heads and the visible q tiles. On the Hopper body (bf16,
    head dim 64, 128 or 256) with rope, q is rotated first by
    :func:`rope_rotate` (a [B, H, T, D] scratch copy for the call); k is
    rotated inside the kernel."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, cos, sin, kv_begin,
                                 kv_end, window, scale, causal,
                                 q_start=q_start, k_start=k_start)
    q, k, v, do = (_prepared(t) for t in (q, k, v, do))
    if cos is not None and _hopper("flash_bwd_dkv", q):
        q = rope_rotate(q, cos, sin)
    return _bwd_dkv(q, k, v, do, lse, delta, cos, sin, kv_begin, kv_end,
                    window, scale, causal, q_start=q_start, k_start=k_start)


def _bwd_dkv(q, k, v, do, lse, delta, cos, sin, kv_begin, kv_end, window,
             scale, causal, entry=None, q_start=0, k_start=0):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", q, k, v, dout=do, lse=_stat(lse),
            delta=_stat(delta), cos=cos, sin=sin, kv_begin=kv_begin,
            kv_end=kv_end, outs=(dk, dv), window=window, scale=scale,
            causal=causal, q_start=q_start, k_start=k_start, entry=entry)
    return dk, dv


def flash_bwd_dkv_mma(q, k, v, do, lse, delta, cos, sin, kv_begin, kv_end,
                      window, scale, causal):
    """``flash_bwd_dkv`` through its mma.sync body (not bf16 at head dim 64
    or 128), q and k rotated inside the kernel: the body that bf16 at head
    dim 256 ran before its Hopper body, which ``chip_smoke.py`` times beside
    it. The model path never calls it."""
    q, k, v, do = (_prepared(t) for t in (q, k, v, do))
    return _bwd_dkv(q, k, v, do, lse, delta, cos, sin, kv_begin, kv_end,
                    window, scale, causal, entry=_MMA["flash_bwd_dkv"])


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _attention_function(fwd, bwd_dq, bwd_dkv):
    """An autograd Function returning (out, lse) whose forward is ``fwd``
    and whose backward runs ``bwd_dq``, which also returns Δ = rowsum(out∘do)
    − dlse, then ``bwd_dkv`` on that Δ (``_flash_lse_bwd``). Cotangents are
    not materialized: an unused lse gives dlse None, and with it the
    arithmetic of flash_attention's backward."""

    class _Attention(torch.autograd.Function):
        lrp_rule = ("attention", "flash attention (rules wrap q/k/v)")

        @staticmethod
        def forward(ctx, q, k, v, cos, sin, kv_begin, kv_end, window, scale,
                    causal, q_start, k_start):
            ctx.set_materialize_grads(False)
            out, lse = fwd(q, k, v, cos, sin, kv_begin, kv_end, window, scale,
                           causal, q_start=q_start, k_start=k_start)
            ctx.save_for_backward(q, k, v, out, lse, cos, sin, kv_begin, kv_end)
            ctx.static = (window, scale, causal)
            ctx.offsets = {"q_start": q_start, "k_start": k_start}
            return out, lse

        @staticmethod
        def backward(ctx, do, dlse):
            q, k, v, out, lse, cos, sin, kv_begin, kv_end = ctx.saved_tensors
            if do is None:  # only the lse was used
                do = torch.zeros_like(out)
            rest = (cos, sin, kv_begin, kv_end, *ctx.static)
            dq, delta = bwd_dq(q, k, v, do, out, lse, *rest, dlse=dlse,
                               **ctx.offsets)
            dk, dv = bwd_dkv(q, k, v, do, lse, delta, *rest, **ctx.offsets)
            return dq, dk, dv, *[None] * 9

    return _Attention


_Flash = _attention_function(flash_fwd, flash_bwd_dq, flash_bwd_dkv)
_FlashRef = _attention_function(flash_fwd_ref, flash_bwd_dq_ref,
                                flash_bwd_dkv_ref)


def _check_device(name, q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")


def _call(fn, q, k, v, window, scale, causal, kv_begin, kv_end, rope,
          q_start, k_start):
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"Hkv={k.shape[1]} must divide H={q.shape[1]}")
    if rope is not None and (q_start or k_start):
        # the tables are indexed by the call's own rows
        raise ValueError("in-kernel rope is incompatible with global "
                         "q_start/k_start offsets (ring): apply rope "
                         "outside instead")
    q_start, k_start = int(q_start), int(k_start)
    window, scale = _canon(q, k, window, scale, q_start, k_start)
    cos, sin = _check_rope(rope, q, k)
    B = q.shape[0]
    return fn.apply(q, k, v, cos, sin, _span(kv_begin, B, q.device),
                    _span(kv_end, B, q.device), window, scale, causal,
                    q_start, k_start)


def flash_attention(q, k, v, window=None, *, scale: Optional[float] = None,
                    causal: bool = True, kv_begin=None, kv_end=None,
                    rope=None):
    """Fused attention softmax(q kᵀ·scale + mask) v with its backward.

    q ``[B, H, Tq, D]``, k/v ``[B, Hkv, Tk, D]``. ``window``: sliding-window
    size (None = no window). ``kv_begin``/``kv_end``: optional [B] valid-key
    span. ``rope``: optional ``(cos, sin)`` [T, D] tables applied in-kernel
    (Tq == Tk only).
    CUDA tensors run K1/K2 (or raise if the call is not supported); CPU
    tensors run the plain versions."""
    _check_device("flash_attention", q)
    return _call(_Flash, q, k, v, window, scale, causal, kv_begin, kv_end,
                 rope, 0, 0)[0]


def flash_attention_ref(q, k, v, window=None, *, scale: Optional[float] = None,
                        causal: bool = True, kv_begin=None, kv_end=None,
                        rope=None):
    """The plain PyTorch version of :func:`flash_attention` on any device:
    float32 softmax, masks in global positions, empty rows give out 0 and
    lse −1e30; its backward runs the plain math of K2."""
    return _call(_FlashRef, q, k, v, window, scale, causal, kv_begin, kv_end,
                 rope, 0, 0)[0]


def flash_attention_lse(q, k, v, window=None, *, q_start=0, k_start=0,
                        kv_begin=None, kv_end=None,
                        scale: Optional[float] = None, causal: bool = True,
                        rope=None):
    """Fused attention returning ``(out, lse float32 [B, H, Tq])`` with a
    backward exact in both cotangents (``lxt_tpu``'s flash_attention_lse).

    q ``[B, H, Tq, D]``, k/v ``[B, Hkv, Tk, D]``: Tq and Tk may differ (a
    chunk of queries against a longer key span); on a CUDA device both
    are multiples of 64.

    ``q_start``/``k_start``: the global positions of the call's first query
    and first key, which shift the causal and window comparisons and place
    the keys against ``kv_begin``/``kv_end`` — a ring step's shards
    (``parallel/ring.py``). Query rows with no visible key give out 0 and
    lse −1e30 (zero weight in a logsumexp merge). The lse cotangent folds
    into Δ as Δ − dlse (∂lse/∂s = p), so merged partial attentions
    differentiate to the relevance of one attention. ``rope`` is refused
    with nonzero offsets and when Tq ≠ Tk (the tables are indexed by the
    call's rows). Other arguments as :func:`flash_attention`."""
    _check_device("flash_attention_lse", q)
    return _call(_Flash, q, k, v, window, scale, causal, kv_begin, kv_end,
                 rope, q_start, k_start)


def flash_attention_lse_ref(q, k, v, window=None, *, q_start=0, k_start=0,
                            kv_begin=None, kv_end=None,
                            scale: Optional[float] = None, causal: bool = True,
                            rope=None):
    """The plain PyTorch version of :func:`flash_attention_lse` on any
    device."""
    return _call(_FlashRef, q, k, v, window, scale, causal, kv_begin, kv_end,
                 rope, q_start, k_start)
