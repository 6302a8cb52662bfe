"""The work a flash-attention kernel call of latent attention needs, from
its shapes: q and k of head dim ``Dqk``, v of ``Dv``, every head its own
key head (MHA), causal, one prompt. Frozen here in numpy, with the q/k and
v widths apart, so that zero-padding both to a kernel's native width reads
as lost share and not as work."""

import numpy as np


def causal_pairs(T):
    """Visible (query, key) pairs of a causal [T, T] attention."""
    return int(np.int64(T) * (T + 1) // 2)


def work(name, H, T, Dqk, Dv, itemsize=2):
    """(FLOPs, bytes) one call of kernel ``name`` needs: each product over
    the visible pairs costs 2·D FLOPs a pair and head at its own width D
    (``flash_fwd``: s = q kᵀ at Dqk, p v at Dv; ``flash_bwd_dq``: s, dp =
    do vᵀ at Dv, ds k at Dqk; ``flash_bwd_dkv``: s, dp, pᵀ do at Dv, dsᵀ q
    at Dqk), and each input is read once and each output written once
    (lse and Δ in float32)."""
    pairs = causal_pairs(T)
    q = H * T * Dqk * itemsize              # one of q, k, dq, dk
    o = H * T * Dv * itemsize               # one of v, out, do, dv
    stat = H * T * 4                        # lse or delta
    widths, moved = {
        # q, k, v in; out, lse out
        "flash_fwd": ((Dqk, Dv), 2 * q + 2 * o + stat),
        # q, k, v, out, do, lse in; dq, delta out
        "flash_bwd_dq": ((2 * Dqk, Dv), 3 * q + 3 * o + 2 * stat),
        # q, k, v, do, lse, delta in; dk, dv out
        "flash_bwd_dkv": ((2 * Dqk, 2 * Dv), 3 * q + 3 * o + 2 * stat),
    }[name]
    return 2 * pairs * H * sum(widths), moved
