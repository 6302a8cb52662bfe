"""The work counts behind each flash kernel's roofline bound
(``lxt_tpu_torch.ops.flash_attention.visible_pairs`` and ``work``), on CPU.

The visible pairs must equal a count of the mask the plain versions use
(``_allowed``) under every mask regime, and the closed form T(T+1)/2 of a
causal call that ``bench.py``'s ``attribution_flops`` uses; the FLOPs and
bytes must follow from the products and tensors each kernel touches.
"""

import numpy as np
import pytest
import torch

from lxt_tpu_torch.ops import flash_attention as tfa

# (B, T, window, causal, kv_begin, kv_end)
MASKS = {
    "causal": (2, 64, None, True, None, None),
    "bidirectional": (2, 48, None, False, None, None),
    "window": (1, 96, 17, True, None, None),
    "window_bidirectional": (1, 40, 9, False, None, None),
    "kv_begin": (3, 64, None, True, [0, 5, 63], None),
    "kv_end_bidirectional": (2, 64, None, False, None, [64, 21]),
    "window_kv_begin_kv_end": (2, 80, 30, True, [3, 40], [70, 80]),
    "empty_rows": (1, 32, None, True, [40], None),
}


@pytest.mark.parametrize("name", sorted(MASKS))
def test_visible_pairs_count_the_mask(name):
    B, T, window, causal, kv_begin, kv_end = MASKS[name]
    q = torch.zeros(B, 1, T, 8)
    w, _ = tfa._canon(q, q, window, None)
    span = lambda x: None if x is None else torch.tensor(x)  # noqa: E731
    ok = tfa._allowed(q, q, span(kv_begin), span(kv_end), w, causal)
    want = int(ok.expand(B, 1, T, T).sum())
    got = tfa.visible_pairs(T, window, causal, kv_begin, kv_end)
    if kv_begin is None and kv_end is None:
        got *= B
    assert got == want


@pytest.mark.parametrize("T", [64, 320, 1024, 4096])
def test_causal_pairs_closed_form(T):
    """bench.py's attribution_flops counts T(T+1)/2 pairs a causal head."""
    assert tfa.visible_pairs(T) == T * (T + 1) // 2


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                  "rope_rotate"])
def test_work_counts_products_and_tensors(name):
    B, H, Hkv, T, D = 2, 8, 2, 128, 64
    flops, moved = tfa.work(name, B, H, Hkv, T, D, 2, rope=True)
    q_bytes, kv_bytes, stat = B * H * T * D * 2, B * Hkv * T * D * 2, B * H * T * 4
    tables = 2 * T * D * 2
    if name == "rope_rotate":
        assert (flops, moved) == (3 * B * H * T * D, 2 * q_bytes + tables)
        return
    products = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}[name]
    assert flops == products * B * H * (T * (T + 1) // 2) * 2 * D
    # inputs read once, outputs written once
    tensors = {"flash_fwd": [q_bytes, kv_bytes, kv_bytes, q_bytes, stat],
               # q, k, v, do, out, lse read; delta and dq written
               "flash_bwd_dq": [q_bytes, kv_bytes, kv_bytes, q_bytes, q_bytes, stat,
                                stat, q_bytes],
               "flash_bwd_dkv": [q_bytes, kv_bytes, kv_bytes, q_bytes, stat, stat,
                                 kv_bytes, kv_bytes]}[name]
    assert moved == sum(tensors) + tables


def test_work_at_the_two_paths_calls():
    """The main path's and the 8B path's K1 calls: one product over the
    causal pairs is 17.2 and 68.7 GFLOP, and K1 is bound by the tensor
    cores (989 TFLOP/s bf16) rather than by its bytes (3.35 TB/s)."""
    for (B, H, Hkv, T, D), gflop in (((8, 32, 4, 1024, 64), 17.2),
                                     ((1, 32, 8, 4096, 128), 68.7)):
        flops, moved = tfa.work("flash_fwd", B, H, Hkv, T, D, 2, rope=True)
        assert np.isclose(flops / 2 / 1e9, gflop, rtol=2e-3)
        assert flops / 989e12 > moved / 3.35e12


@pytest.mark.parametrize("window,gflop,bound_ms", [(1024, 45.1, 0.0456),
                                                   (None, 103.1, 0.1043)])
def test_flash_bwd_dq_work_at_gemmas_calls(window, gflop, bound_ms):
    """flash_bwd_dq at Gemma-3-4B's local (window 1024) and global calls
    (B 1, H 8 / Hkv 4, T 4096, head dim 256, causal, RoPE): three products
    over the visible pairs, bound by the tensor cores (989 TFLOP/s bf16)
    rather than by its bytes (3.35 TB/s)."""
    flops, moved = tfa.work("flash_bwd_dq", 1, 8, 4, 4096, 256, 2, window=window,
                            rope=True)
    assert np.isclose(flops / 1e9, gflop, rtol=1e-3)
    assert np.isclose(flops / 989e12 * 1e3, bound_ms, rtol=1e-3)
    assert flops / 989e12 > moved / 3.35e12


# ring-step calls: (T, window, causal, kv_begin, kv_end, q_start, k_start),
# spans and offsets in global positions
OFFSET_MASKS = {
    "full_square": (64, None, True, None, None, 128, 0),
    "diagonal": (64, None, True, None, None, 64, 64),
    "empty_future": (64, None, True, None, None, 0, 128),
    "window_cuts_past": (64, 100, True, None, None, 128, 64),
    "window_behind": (64, 40, True, None, None, 192, 0),
    "off_grid_window_spans": (64, 30, True, [70, 100], [200, 150], 100, 37),
    "bidirectional_kv_end": (48, None, False, None, [60], 20, 30),
}


def _brute_pairs(T, window, causal, kv_begin, kv_end, q_start, k_start, Tk=None):
    """The mask counted pair by pair in global positions, summed over the
    batch rows of the spans (T queries, Tk keys; Tk None: T)."""
    B = len(kv_begin or kv_end or [0])
    n = 0
    for b in range(B):
        for i in range(q_start, q_start + T):
            for j in range(k_start, k_start + (T if Tk is None else Tk)):
                n += ((window is None or j > i - window) and (not causal or j <= i)
                      and (kv_begin is None or j >= kv_begin[b])
                      and (kv_end is None or j < kv_end[b]))
    return n


@pytest.mark.parametrize("name", sorted(OFFSET_MASKS))
def test_visible_pairs_with_offsets_count_the_mask(name):
    T, window, causal, kv_begin, kv_end, q_start, k_start = OFFSET_MASKS[name]
    want = _brute_pairs(*OFFSET_MASKS[name])
    got = tfa.visible_pairs(T, window, causal, kv_begin, kv_end, q_start, k_start)
    assert got == want
    B = len(kv_begin or kv_end or [0])
    q = torch.zeros(B, 1, T, 8)
    w, _ = tfa._canon(q, q, window, None, q_start, k_start)
    span = lambda x: None if x is None else torch.tensor(x)  # noqa: E731
    ok = tfa._allowed(q, q, span(kv_begin), span(kv_end), w, causal, q_start, k_start)
    assert int(ok.expand(B, 1, T, T).sum()) == want
    flops, _ = tfa.work("flash_fwd", B, 4, 2, T, 64, window=window, causal=causal,
                        kv_begin=kv_begin, kv_end=kv_end, q_start=q_start,
                        k_start=k_start)
    assert flops == 2 * want * 4 * 2 * 64


def test_ring_step_work_is_the_full_square():
    """A ring step whose keys lie wholly in the queries' past computes
    every pair: Llama-3-8B's step (B 1, H 32/8, T_local 2048, D 128), and
    flash_bwd_dq reads the lse cotangent too."""
    B, H, Hkv, T, D = 1, 32, 8, 2048, 128
    flops, moved = tfa.work("flash_bwd_dq", B, H, Hkv, T, D, 2, q_start=T, dlse=True)
    assert flops == 3 * T * T * H * 2 * D
    _, plain = tfa.work("flash_bwd_dq", B, H, Hkv, T, D, 2, q_start=T)
    assert moved - plain == B * H * T * 4
    assert tfa.work("flash_fwd", B, H, Hkv, T, D, k_start=T)[0] == 0


# calls with a query length other than the key length: (Tq, Tk, window,
# causal, kv_begin, kv_end, q_start, k_start)
TK_MASKS = {
    "chunk_on_cache": (128, 384, None, True, None, None, 256, 0),
    "keys_start_later": (192, 64, None, True, None, None, 0, 128),
    "window_chunk": (64, 256, 96, True, None, None, 192, 0),
    "window_spans": (128, 64, 40, True, [10, 70], [60, 120], 30, 20),
    "bidirectional_kv_end": (64, 192, None, False, None, [150, 30], 0, 0),
}


@pytest.mark.parametrize("name", sorted(TK_MASKS))
def test_visible_pairs_at_tq_ne_tk_count_the_mask(name):
    """visible_pairs and work at Tq ≠ Tk: Tq × the visible keys, against
    the mask counted pair by pair and the plain versions' mask; k, v (dk,
    dv) move Tk rows, q, do, out, dq, lse and Δ Tq rows."""
    Tq, Tk, window, causal, kv_begin, kv_end, q_start, k_start = TK_MASKS[name]
    want = _brute_pairs(Tq, window, causal, kv_begin, kv_end, q_start, k_start, Tk)
    got = tfa.visible_pairs(Tq, window, causal, kv_begin, kv_end, q_start,
                            k_start, Tk=Tk)
    assert got == want
    B = len(kv_begin or kv_end or [0])
    q, k = torch.zeros(B, 1, Tq, 8), torch.zeros(B, 1, Tk, 8)
    w, _ = tfa._canon(q, k, window, None, q_start, k_start)
    span = lambda x: None if x is None else torch.tensor(x)  # noqa: E731
    ok = tfa._allowed(q, k, span(kv_begin), span(kv_end), w, causal, q_start, k_start)
    assert int(ok.expand(B, 1, Tq, Tk).sum()) == want
    H, Hkv, D = 4, 2, 64
    act, kv, stat = B * H * Tq * D * 2, B * Hkv * Tk * D * 2, B * H * Tq * 4
    tensors = {"flash_fwd": 2 * act + 2 * kv + stat,
               "flash_bwd_dq": 4 * act + 2 * kv + 2 * stat,
               "flash_bwd_dkv": 2 * act + 4 * kv + 2 * stat}
    for kernel, moved in tensors.items():
        flops, got_moved = tfa.work(kernel, B, H, Hkv, Tq, D, window=window,
                                    causal=causal, kv_begin=kv_begin,
                                    kv_end=kv_end, q_start=q_start,
                                    k_start=k_start, Tk=Tk)
        assert flops == tfa.PRODUCTS[kernel] * want * H * 2 * D
        assert got_moved == moved
