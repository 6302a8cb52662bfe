"""``flash_attention_lse`` with a query length other than the key length
(q ``[B, H, Tq, D]``, k/v ``[B, Hkv, Tk, D]``) against lxt_tpu's, on CPU.

The port's plain versions (what a CPU tensor runs) against lxt_tpu's
Pallas kernels in interpret mode: out, lse, dq, dk and dv under random
``do`` and ``dlse`` cotangents, within 1e-5 in float32. The cases cover a
chunk of queries against a longer cache (causal, ``q_start = Tk − Tq``),
keys that start later than the queries (``k_start > 0``, rows with no
visible key), a window of 96 across the kernels' 64-row tiles, a
non-causal call cut by ``kv_end``, GQA 4/2, and head dims 64 and 256.
lxt_tpu's default blocks (1024) hold each of these calls in one block, so
its window test never crosses a block here (ROADMAP F5).
"""

import functools

import numpy as np
import pytest
import torch

import lxt_tpu_torch
from lxt_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5

# name: (Tq, Tk, D, causal, window, q_start, k_start, kv_end)
CASES = {
    "chunk_on_cache": (128, 384, 64, True, None, 256, 0, None),
    "chunk_on_cache_d256": (128, 384, 256, True, None, 256, 0, None),
    "keys_start_later": (384, 128, 64, True, None, 0, 128, None),
    "window_across_tiles": (128, 384, 64, True, 96, 256, 0, None),
    "window_long_queries": (384, 128, 256, True, 96, 128, 64, None),
    "noncausal_kv_end": (384, 128, 64, False, None, 0, 0, (100, 128)),
    "noncausal_kv_end_long_keys": (128, 384, 256, False, None, 0, 0, (300, 200)),
}


@functools.lru_cache(maxsize=None)
def _jax_lse_vjp(window, causal, q_start, k_start):
    """lxt_tpu's flash_attention_lse and its vjp in both cotangents."""
    import jax
    from lxt_tpu.ops.flash_attention import flash_attention_lse

    def f(q, k, v, kv_end, do, dlse):
        (out, lse), vjp = jax.vjp(lambda q, k, v: flash_attention_lse(
            q, k, v, window, q_start=q_start, k_start=k_start, kv_end=kv_end,
            causal=causal), q, k, v)
        return (out, lse, *vjp((do, dlse)))
    return jax.jit(f)


def _inputs(Tq, Tk, D, seed):
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32)
    B, H, Hkv = 2, 4, 2
    return (r(B, H, Tq, D), r(B, Hkv, Tk, D), r(B, Hkv, Tk, D), r(B, H, Tq, D),
            r(B, H, Tq))


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_lse_tq_ne_tk_matches_lxt_tpu(name):
    Tq, Tk, D, causal, window, q_start, k_start, kv_end = CASES[name]
    arrays = _inputs(Tq, Tk, D, seed=Tq + 7 * Tk + D)
    kv = None if kv_end is None else np.asarray(kv_end, np.int32)
    want = [np.asarray(x) for x in _jax_lse_vjp(window, causal, q_start, k_start)(
        *arrays[:3], kv, *arrays[3:])]
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays[:3])
    do, dlse = (torch.from_numpy(a) for a in arrays[3:])
    out, lse = lxt_tpu_torch.flash_attention_lse(
        q, k, v, window, q_start=q_start, k_start=k_start, causal=causal,
        kv_end=None if kv is None else torch.from_numpy(kv))
    assert out.shape == q.shape and lse.shape == q.shape[:3]
    grads = torch.autograd.grad((out * do).sum() + (lse * dlse).sum(), (q, k, v))
    assert grads[1].shape == k.shape and grads[2].shape == v.shape
    for what, g, w in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads), want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=ATOL,
                                   err_msg=what)
    # rows with no visible key: out 0, lse -1e30, in both packages
    w, _ = tfa._canon(q, k, window, None, q_start, k_start)
    ok = tfa._allowed(q, k, None, None if kv is None else torch.from_numpy(kv),
                      w, causal, q_start, k_start)
    empty = ~ok.expand(2, 1, Tq, Tk).any(-1)  # [B, 1, Tq]
    assert torch.equal(lse.detach() == tfa.NEG_INF, empty.expand_as(lse))
    if name == "keys_start_later":
        assert bool(empty[:, :, :k_start].all()) and not bool(empty[:, :, k_start:].any())


def test_flash_attention_lse_without_dlse_is_flash_attention_at_tq_ne_tk():
    """With the lse unused, flash_attention_lse's backward at Tq ≠ Tk is
    flash_attention's, bit for bit."""
    arrays = _inputs(128, 256, 64, seed=5)
    do = torch.from_numpy(arrays[3])
    res = []
    for fn in (lambda *a: lxt_tpu_torch.flash_attention_lse(*a, 40)[0],
               lambda *a: tfa.flash_attention(*a, 40)):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:3]]
        out = fn(*leaves)
        res.append([out, *torch.autograd.grad((out * do).sum(), leaves)])
    for a, b in zip(*res):
        assert torch.equal(a, b)


def test_rope_is_refused_at_tq_ne_tk():
    """As lxt_tpu's _check_rope: the tables are indexed by the call's rows."""
    q, k = torch.zeros(1, 2, 128, 64), torch.zeros(1, 2, 256, 64)
    for rows in (128, 256):
        rope = (torch.ones(rows, 64), torch.zeros(rows, 64))
        for fn in (lxt_tpu_torch.flash_attention_lse, tfa.flash_attention_lse_ref):
            with pytest.raises(ValueError, match="Tq == Tk"):
                fn(q, k, k, rope=rope)
        with pytest.raises(ValueError, match="Tq == Tk"):
            tfa.flash_attention(q, k, k, rope=rope)
