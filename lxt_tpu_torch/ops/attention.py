"""Attention with LRP-correct relevance flow, kernel-agnostic (counterpart
of ``lxt_tpu/ops/attention.py``).

AttnLRP needs gradient scaling only at the q/k/v inputs (q,k /4; v /2),
which ``Composite.qkv`` applies, so the attention itself runs standard
math: either the einsum path below or the hand-written flash kernels
(``ops/flash_attention.py``). Masking is structural where possible
(``causal`` + ``window`` + ``kv_begin``/``kv_end``), so the flash path never
materializes a [T, T] bias; an additive ``bias`` or ``softcap`` takes the
einsum path.

Shapes are ``[batch, heads, seq, head_dim]``; the einsum path repeats GQA
key/value heads, the kernels index them. The value head dim may differ
from the query/key one (latent attention: 192 and 128): the kernels take
one width, so the flash route zero-pads q, k and v to the smallest native
width that holds both and slices the output back to v's.
``impl="ring"`` runs the sequence-parallel ring (``parallel/ring.py``):
each process holds one shard of the sequence.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F

from lxt_tpu_torch import composites
from lxt_tpu_torch.models import common as _mcommon

NATIVE_HEAD_DIMS = (64, 128, 256)


def repeat_kv(x, n_rep: int):
    """[B, Hkv, T, D] -> [B, Hkv*n_rep, T, D] (HF repeat_kv equivalent)."""
    if n_rep == 1:
        return x
    b, h, t, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, t, d).reshape(b, h * n_rep, t, d)


def sliding_window_mask_bias(q_len: int, kv_len: int, window, device=None):
    """Causal + sliding-window additive float32 bias (0 / -inf)."""
    q_idx = torch.arange(q_len, device=device)[:, None]
    k_idx = torch.arange(kv_len, device=device)[None, :]
    pos = q_idx + (kv_len - q_len)
    allowed = (k_idx <= pos) & (k_idx > pos - window)
    return torch.zeros(allowed.shape, device=device).masked_fill_(
        ~allowed, float("-inf"))


def _einsum_attention(q, k, v, bias, causal, window, scale, softcap=None):
    """Reference attention: scores and softmax in float32."""
    dtype = q.dtype
    Tq, Tk = q.shape[2], k.shape[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    if causal:
        w = window if window is not None else Tk
        scores = scores + sliding_window_mask_bias(Tq, Tk, w, q.device)
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(dtype), v)


def route(impl, q, flash_ok):
    """The path ``attention`` takes: 'auto' picks the flash kernels for a
    CUDA tensor of any dtype (float32, bfloat16 and float16 all have
    kernels) when the call is eligible (``flash_ok``), else einsum; an
    explicit 'flash' falls back to einsum only for an ineligible call."""
    if impl == "auto":
        return "flash" if q.is_cuda and flash_ok else "einsum"
    return "einsum" if impl == "flash" and not flash_ok else impl


def _pad_head_dim(q, k, v):
    """Zero-pad q, k and v to the smallest native width that holds both
    head dims (exact: padded q/k columns add 0 to scores, padded v columns
    are sliced off)."""
    Dp = min(p for p in NATIVE_HEAD_DIMS if p >= max(q.shape[-1], v.shape[-1]))
    return tuple(t if t.shape[-1] == Dp else F.pad(t, (0, Dp - t.shape[-1]))
                 for t in (q, k, v))


def attention(
    q, k, v,
    *,
    bias=None,
    causal: bool = False,
    window=None,
    composite: composites.Composite = composites.attnlrp,
    scale: Optional[float] = None,
    impl: str = "auto",
    softcap: Optional[float] = None,
    kv_begin=None,
    kv_end=None,
    rope=None,
):
    """LRP-aware scaled dot-product attention.

    q, k, v : [B, H, Tq, D] / [B, Hkv, Tk, D] / [B, Hkv, Tk, Dv] with
        ``Hkv`` dividing ``H``; the output is [B, H, Tq, Dv].
    rope : optional ``(cos, sin)`` tables ([T, D], or [B, T, D] for
        per-example positions); the flash kernels rotate in-kernel when the
        tables are 2-D and the head dim native, every other path applies
        ``common.apply_rope`` here.
    bias : optional additive array broadcastable to [B, H, Tq, Tk] — forces
        the einsum path.
    causal, window : structural causal / sliding-window mask.
    composite : rule assignment; ``composite.qkv`` fixes the relevance flow.
    impl : 'einsum' | 'flash' | 'auto' ('auto': the flash kernels for CUDA
        tensors when eligible, the einsum path otherwise; see
        :func:`route`). 'flash' on CPU tensors runs the
        kernels' plain PyTorch version. 'ring' (any '+option' suffix is
        ignored): ring attention over the processes of the group that
        ``parallel.ring.attribute_sequence_parallel`` set (default: the
        default group); q/k/v hold this process's shard of the sequence,
        and only structural masks apply.
    softcap : optional tanh logit soft-capping (einsum path).
    kv_begin, kv_end : optional int [B] per-example valid-key span (left /
        right padding); fully padded query rows give zeros on the flash path.
    """
    if impl.partition("+")[0] == "ring":
        return _ring(q, k, v, bias=bias, causal=causal, window=window,
                     composite=composite, scale=scale, softcap=softcap,
                     kv_begin=kv_begin, kv_end=kv_end, rope=rope)
    if impl not in ("auto", "flash", "einsum"):
        raise ValueError(f"impl must be 'auto', 'flash', 'einsum' or 'ring', "
                         f"got {impl!r}")
    n_rep = q.shape[1] // k.shape[1]
    D, Dv = q.shape[-1], v.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)

    # rule scaling commutes with the GQA broadcast (the grad of a broadcast
    # sums over the group), so apply it on the unrepeated kv
    q, k, v = composite.qkv(q, k, v)

    Tq, Tk = q.shape[2], k.shape[2]
    flash_ok = (bias is None and softcap is None and Tq == Tk
                and Tq % 128 == 0 and max(D, Dv) <= max(NATIVE_HEAD_DIMS))
    impl = route(impl, q, flash_ok)

    if impl == "flash":
        from lxt_tpu_torch.ops.flash_attention import flash_attention
        # in-kernel rope needs native-width 2-D tables (padding would break
        # the rotate-half split; 3-D = per-example positions)
        rope_in_kernel = (rope is not None and rope[0].dim() == 2
                          and D in NATIVE_HEAD_DIMS and Dv <= D)
        if rope is not None and not rope_in_kernel:
            q, k = _mcommon.apply_rope(q, k, *rope)
        q, k, v = _pad_head_dim(q, k, v)
        out = flash_attention(q, k, v, window, scale=scale, causal=causal,
                              kv_begin=kv_begin, kv_end=kv_end,
                              rope=rope if rope_in_kernel else None)
        return out[..., :Dv]

    if rope is not None:
        q, k = _mcommon.apply_rope(q, k, *rope)
    if kv_begin is not None or kv_end is not None:
        k_idx = torch.arange(Tk, device=q.device)[None]
        ok = torch.ones((1, Tk), dtype=torch.bool, device=q.device)
        if kv_begin is not None:
            ok = ok & (k_idx >= torch.as_tensor(kv_begin, device=q.device)[:, None])
        if kv_end is not None:
            ok = ok & (k_idx < torch.as_tensor(kv_end, device=q.device)[:, None])
        pad_bias = torch.where(ok, 0.0, -1e30).float()[:, None, None, :]
        bias = pad_bias if bias is None else bias + pad_bias
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    return _einsum_attention(q, k, v, bias, causal, window, scale,
                             softcap=softcap)


def _ring(q, k, v, *, bias, causal, window, composite, scale, softcap,
          kv_begin, kv_end, rope):
    """The ring path (``lxt_tpu``'s ``ring:<axis>`` impl): rope applied
    here with the shard's global positions (the kernels index their tables
    by the call's rows), then ``composite.qkv``, then the ring."""
    from lxt_tpu_torch.parallel import ring
    if not (bias is None and softcap is None and kv_begin is None
            and kv_end is None):
        raise ValueError("ring attention supports structural masks only "
                         "(causal, window)")
    D, Dv = q.shape[-1], v.shape[-1]
    if max(D, Dv) > max(NATIVE_HEAD_DIMS):
        raise ValueError(f"ring attention: head dim {max(D, Dv)} above "
                         f"{max(NATIVE_HEAD_DIMS)}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if rope is not None:
        q, k = _mcommon.apply_rope(q, k, *rope)
    q, k, v = composite.qkv(q, k, v)
    out = ring.ring_flash_attention(*_pad_head_dim(q, k, v), ring.active_group(),
                                    scale=scale, causal=causal, window=window)
    return out[..., :Dv]
