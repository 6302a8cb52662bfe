"""The work a flash-attention kernel call must do, from its shapes: a
frozen copy of ``lxt_tpu_torch/ops/flash_attention.py``'s ``work`` and
``visible_pairs``, in numpy, so that the yardstick stays what it is when
the program changes."""

import numpy as np

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
    causal, j ≤ i, all in global positions."""
    Tk = T if Tk is None else Tk
    p = np.arange(T, dtype=np.int64) + (q_start - k_start)
    lo = np.maximum(p - window + 1, 0) if window is not None else np.zeros_like(p)
    hi = np.minimum(p, Tk - 1) if causal else np.full_like(p, Tk - 1)
    begins = [0] if kv_begin is None else [int(x) - k_start for x in kv_begin]
    ends = [Tk] * len(begins) if kv_end is None else [
        min(int(x) - k_start, Tk) for x in kv_end]
    if len(begins) == 1 and len(ends) > 1:
        begins = begins * len(ends)
    return int(sum(np.clip(np.minimum(hi, e - 1) - np.maximum(lo, b) + 1,
                           0, None).sum() for b, e in zip(begins, ends)))


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
