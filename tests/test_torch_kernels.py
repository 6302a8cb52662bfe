"""K1/K2, the rotation pass and K3 against their plain PyTorch versions on
the card.

These tests need an NVIDIA GPU with nvcc and skip elsewhere. The machine
with the card has no JAX, which tests/conftest.py imports, so run them
there with ``python -m pytest --noconftest tests/test_torch_kernels.py``.
chip_smoke.py runs the full set of regimes and times each kernel.
"""

import pytest
import torch

from lxt_tpu_torch.models import common as tcommon
from lxt_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.cuda


#: (a, r) of each dtype's max|diff| bound a + r * absmax: lxt_tpu's
#: TPU-kernel criterion for bf16, an eighth of it for float16 (three more
#: mantissa bits), 1e-4 for float32
BARS = {torch.bfloat16: (0.01, 0.01171875), torch.float16: (0.00125, 0.00146484375),
        torch.float32: (1e-4, 1e-4)}


def _bound(want, dtype):
    a, r = BARS[dtype]
    return a + r * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_kernels_match_plain_versions(D, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(D)
    B, H, Hkv, T = 2, 4, 2, 256

    def r(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)

    q, k, v, do = r(B, H, T, D), r(B, Hkv, T, D), r(B, Hkv, T, D), r(B, H, T, D)
    cos, sin = (t.cuda().to(dtype) for t in tcommon.rope_tables(torch.arange(T), D))
    kv_begin = torch.tensor([0, 70], dtype=torch.int32, device="cuda")
    args = (cos, sin, kv_begin, None, 100, D ** -0.5, True)
    out, lse = tfa.flash_fwd(q, k, v, *args)
    ref_out, ref_lse = tfa.flash_fwd_ref(q, k, v, *args)
    ref_dq, delta = tfa.flash_bwd_dq_ref(q, k, v, do, ref_out, ref_lse, *args)
    bwd = (q, k, v, do, ref_lse, delta, *args)
    seen = ref_lse > -1e29  # rows with a visible key (others: -1e30 both)
    pairs = {"out": (out, ref_out),
             "lse": (torch.where(seen, lse, 0.0), torch.where(seen, ref_lse, 0.0)),
             "dq": (tfa.flash_bwd_dq(q, k, v, do, ref_out, ref_lse, *args)[0], ref_dq)}
    pairs.update(zip(("dk", "dv"), zip(tfa.flash_bwd_dkv(*bwd),
                                       tfa.flash_bwd_dkv_ref(*bwd))))
    torch.cuda.synchronize()
    assert torch.equal(lse <= -1e29, ~seen)
    for name, (got, want) in pairs.items():
        err = (got.float() - want.float()).abs().max().item()
        assert err <= _bound(want, dtype), (name, err)


# the Hopper bodies of K1, flash_bwd_dq and flash_bwd_dkv (bf16, head dim
# 64, 128 and 256): name -> (B, H, Hkv, T, D, options)
HOPPER_CASES = {
    # T 320: K1's last 128- (D 128) or 192-row (D 64) q tile is part full
    "odd_tiles_T320_hd64": (2, 4, 2, 320, 64, {"rope": True}),
    "odd_tiles_T320_hd128": (2, 4, 2, 320, 128, {"rope": True}),
    "gqa_32_8_hd128_rope": (1, 32, 8, 256, 128, {"rope": True}),
    # a window narrower than a tile, so it cuts across tiles
    "window_across_tiles_hd64": (1, 4, 2, 512, 64, {"window": 40, "rope": True}),
    "window_across_tiles_hd128": (1, 8, 2, 384, 128, {"window": 150}),
    "kv_end_bidirectional_hd128": (2, 4, 2, 256, 128, {"kv_end": [256, 77],
                                                       "causal": False}),
    "kv_begin_hd64": (2, 8, 8, 256, 64, {"kv_begin": [0, 130], "rope": True}),
    "odd_tiles_T320_hd256": (2, 8, 4, 320, 256, {"rope": True}),
    "gqa_16_2_hd256_rope": (1, 16, 2, 256, 256, {"rope": True}),
    "window_across_tiles_hd256": (1, 8, 4, 512, 256, {"window": 40, "rope": True}),
    "window1024_T2048_hd256": (1, 8, 4, 2048, 256, {"window": 1024, "rope": True}),
    "kv_begin_hd256": (2, 8, 4, 256, 256, {"kv_begin": [0, 130], "rope": True}),
    "kv_end_bidirectional_hd256": (2, 8, 4, 256, 256, {"kv_end": [256, 77],
                                                       "causal": False}),
    # causal over more kv tiles than any ring holds stages (flash_bwd_dq at
    # head dim 256: up to 32 tiles of 32 rows through 3 stages)
    "causal_T1024_hd256": (1, 8, 4, 1024, 256, {"rope": True}),
}


def _hopper_inputs(case, seed, dtype=torch.bfloat16):
    B, H, Hkv, T, D, opt = case
    gen = torch.Generator("cuda").manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)

    q, k, v, do = r(B, H, T, D), r(B, Hkv, T, D), r(B, Hkv, T, D), r(B, H, T, D)
    cos = sin = None
    if opt.get("rope"):
        cos, sin = (t.cuda().to(dtype).contiguous()
                    for t in tcommon.rope_tables(torch.arange(T), D))

    def span(key):
        return None if key not in opt else torch.tensor(opt[key], dtype=torch.int32,
                                                        device="cuda")

    args = (cos, sin, span("kv_begin"), span("kv_end"), opt.get("window", T + 2**20),
            D ** -0.5, opt.get("causal", True))
    return q, k, v, do, args


def _assert_match_plain_versions(q, k, v, do, args, dlse=None, **offsets):
    """K1, flash_bwd_dq (with the lse cotangent ``dlse``, if given) and
    flash_bwd_dkv against their plain versions on the same inputs, at the
    global ``q_start``/``k_start`` offsets, each held alone (the backward
    halves get the plain forward's out, lse and Δ)."""
    out, lse = tfa.flash_fwd(q, k, v, *args, **offsets)
    ref_out, ref_lse = tfa.flash_fwd_ref(q, k, v, *args, **offsets)
    dq_args = (q, k, v, do, ref_out, ref_lse, *args)
    ref_dq, delta = tfa.flash_bwd_dq_ref(*dq_args, dlse=dlse, **offsets)
    bwd = (q, k, v, do, ref_lse, delta, *args)
    seen = ref_lse > -1e29
    dq, got_delta = tfa.flash_bwd_dq(*dq_args, dlse=dlse, **offsets)
    pairs = {"out": (out, ref_out),
             "lse": (torch.where(seen, lse, 0.0), torch.where(seen, ref_lse, 0.0)),
             "dq": (dq, ref_dq), "delta": (got_delta, delta)}
    pairs.update(zip(("dk", "dv"), zip(tfa.flash_bwd_dkv(*bwd, **offsets),
                                       tfa.flash_bwd_dkv_ref(*bwd, **offsets))))
    torch.cuda.synchronize()
    assert torch.equal(lse <= -1e29, ~seen)
    for key, (got, want) in pairs.items():
        err = (got.float() - want.float()).abs().max().item()
        assert err <= _bound(want, q.dtype), (key, err)


@pytest.mark.parametrize("name", sorted(HOPPER_CASES))
def test_hopper_bodies_match_plain_versions(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _assert_match_plain_versions(*_hopper_inputs(HOPPER_CASES[name], seed=len(name)))


# head dim 256 (bf16: the Hopper bodies of K1, flash_bwd_dq and
# flash_bwd_dkv; float16 and float32: the mma.sync bodies) with Gemma-3's
# masks: local layers'
# window narrower than T, cutting across kv tiles, and global layers'
# causal mask without one; name -> (B, H, Hkv, T, D, options)
D256_CASES = {
    "local_T2048_window1024": (1, 8, 4, 2048, 256, {"window": 1024, "rope": True}),
    "global_T1024": (1, 8, 4, 1024, 256, {"rope": True}),
    "window200_kv_begin": (2, 8, 4, 512, 256, {"window": 200, "rope": True,
                                               "kv_begin": [0, 77]}),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("name", sorted(D256_CASES))
def test_head_dim_256_windows_match_plain_versions(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _assert_match_plain_versions(*_hopper_inputs(D256_CASES[name], seed=len(name),
                                                 dtype=dtype))


@pytest.mark.parametrize("D", [64, 128, 256])
def test_hopper_bodies_read_strided_views(D):
    """Head-split views of [B, T, heads * D] projections, as the model hands
    them over (the tensor maps read their strides), give the same bits as
    contiguous copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, H, Hkv, T = 2, 8, 2, 320
    gen = torch.Generator("cuda").manual_seed(D + 1)

    def proj(heads):
        x = torch.randn(B, T, heads * D, generator=gen, device="cuda").to(torch.bfloat16)
        return tcommon.split_heads(x, heads, D)

    q, k, v, do = proj(H), proj(Hkv), proj(Hkv), proj(H)
    cos, sin = (t.cuda().to(torch.bfloat16).contiguous()
                for t in tcommon.rope_tables(torch.arange(T), D))
    args = (cos, sin, None, None, T + 2**20, D ** -0.5, True)
    dense = [t.contiguous() for t in (q, k, v, do)]
    out, lse = tfa.flash_fwd(q, k, v, *args)
    out_c, lse_c = tfa.flash_fwd(*dense[:3], *args)
    # out as a head-split view too, as the model's attention output is not
    out_v = tcommon.split_heads(tcommon.merge_heads(out), H, D)
    dq, delta = tfa.flash_bwd_dq(q, k, v, do, out_v, lse, *args)
    dq_c, delta_c = tfa.flash_bwd_dq(*dense, out, lse, *args)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, *args)
    dk_c, dv_c = tfa.flash_bwd_dkv(*dense, lse, delta, *args)
    torch.cuda.synchronize()
    assert not q.is_contiguous() and not out_v.is_contiguous()
    for got, want in ((out, out_c), (lse, lse_c), (dq, dq_c), (delta, delta_c),
                      (dk, dk_c), (dv, dv_c)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_bwd_dq_is_deterministic(D):
    """Every dq row has one writer and Δ one lane: two launches give
    bit-equal dq and Δ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, do, args = _hopper_inputs((2, 16, 2, 512, D, {"rope": True}), seed=D)
    out, lse = tfa.flash_fwd_ref(q, k, v, *args)
    bwd = (q, k, v, do, out, lse, *args)
    dq1, delta1 = tfa.flash_bwd_dq(*bwd)
    dq2, delta2 = tfa.flash_bwd_dq(*bwd)
    torch.cuda.synchronize()
    assert torch.equal(dq1, dq2) and torch.equal(delta1, delta2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_bwd_dq_delta_matches_plain(D, dtype):
    """Δ from flash_bwd_dq (Hopper body for bf16, mma.sync for float16
    and float32) against rowsum(out∘do) of the plain version: the same float32
    products summed in another order, normalized L2 <= 1e-5; rows with no
    visible key (out 0) give Δ 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, H, Hkv, T = 2, 4, 2, 320
    gen = torch.Generator("cuda").manual_seed(D + 7)

    def r(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)

    q, k, v, do = r(B, H, T, D), r(B, Hkv, T, D), r(B, Hkv, T, D), r(B, H, T, D)
    args = (None, None, torch.tensor([0, 100], dtype=torch.int32, device="cuda"),
            None, T + 2**20, D ** -0.5, True)
    out, lse = tfa.flash_fwd_ref(q, k, v, *args)
    _, got = tfa.flash_bwd_dq(q, k, v, do, out, lse, *args)
    _, want = tfa.flash_bwd_dq_ref(q, k, v, do, out, lse, *args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (B, H, T)
    assert torch.all(got[1, :, :100] == 0)
    err = ((got.double() - want.double()).norm() / want.double().norm()).item()
    assert err <= 1e-5, err


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_bwd_dkv_is_deterministic(D):
    """The GQA sum runs inside one CTA in a fixed order (at head dim 256 the
    two warpgroups own disjoint columns): two launches give bit-equal dk and
    dv."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, do, args = _hopper_inputs((2, 16, 2, 512, D, {"rope": True}), seed=D)
    _, lse = tfa.flash_fwd_ref(q, k, v, *args)
    delta = torch.randn(lse.shape, generator=torch.Generator("cuda").manual_seed(1),
                        device="cuda")
    bwd = (q, k, v, do, lse, delta, *args)
    dk1, dv1 = tfa.flash_bwd_dkv(*bwd)
    dk2, dv2 = tfa.flash_bwd_dkv(*bwd)
    torch.cuda.synchronize()
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_rotation_pass_bit_equal_to_apply_rope(D, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(D)
    T = 320
    # a head-split view of a projection, as the model hands it over
    x = torch.randn(2, T, 4 * D, generator=gen, device="cuda").to(dtype)
    x = tcommon.split_heads(x, 4, D)
    cos, sin = (t.cuda().to(dtype).contiguous()
                for t in tcommon.rope_tables(torch.arange(T), D, theta=500000.0))
    before = tfa.launches["rope_rotate"]
    got = tfa.rope_rotate(x, cos, sin)
    want = tcommon.apply_rope(x, x, cos, sin)[0]
    torch.cuda.synchronize()
    assert tfa.launches["rope_rotate"] == before + 1
    assert got.is_contiguous() and torch.equal(got, want)


@pytest.mark.parametrize("layout", ["split_heads_view", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
def test_rotation_pass_views_and_ragged_runs(D, dtype, layout):
    """The rotation pass bit-equal to its plain version on a head-split view
    and on a contiguous tensor, with T 100 (not a multiple of any CTA's run
    of positions) and 11 heads (not a multiple of its batch of heads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, H, T = 3, 11, 100
    gen = torch.Generator("cuda").manual_seed(D + 3)
    x = torch.randn(B, T, H * D, generator=gen, device="cuda").to(dtype)
    x = tcommon.split_heads(x, H, D)
    if layout == "contiguous":
        x = x.contiguous()
    cos, sin = (t.cuda().to(dtype).contiguous()
                for t in tcommon.rope_tables(torch.arange(T), D, theta=1e6))
    got = tfa.rope_rotate(x, cos, sin)
    want = tfa.rope_rotate_ref(x, cos, sin)
    torch.cuda.synchronize()
    assert x.is_contiguous() == (layout == "contiguous")
    assert got.shape == (B, H, T, D) and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("D,passes", [(64, 3), (128, 3), (256, 3)])
def test_hopper_calls_rotate_once_per_call(D, passes):
    """K1 and flash_bwd_dq rotate k, and flash_bwd_dkv q, through one
    rotation pass each where they run their Hopper bodies: three per
    forward and backward at every head dim in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, do, args = _hopper_inputs((1, 8, 2, 256, D, {"rope": True}), seed=3)
    tfa.reset_launches()
    out, lse = tfa.flash_fwd(q, k, v, *args)
    _, delta = tfa.flash_bwd_dq(q, k, v, do, out, lse, *args)
    tfa.flash_bwd_dkv(q, k, v, do, lse, delta, *args)
    torch.cuda.synchronize()
    assert tfa.launches == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                            "rope_rotate": passes}


# ring steps: every (q_start, k_start) pair of a 4-way split of T 1024 (keys
# in the past, on the diagonal and wholly in the future) and one pair off
# the tile grid, with a nonzero lse cotangent
RING_PAIRS = [(i * 256, j * 256) for i in range(4) for j in range(4)] + [(100, 37)]


@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_offsets_and_dlse_match_plain_versions(D, dtype, window):
    """flash_attention_lse's calls on both bodies (Hopper: bf16 at D 64,
    128 and 256; mma.sync: float32 and float16): K1, flash_bwd_dq with dlse
    and flash_bwd_dkv against their plain versions at every ring-step
    pair."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = {} if window is None else {"window": window}
    q, k, v, do, args = _hopper_inputs((1, 8, 2, 256, D, opt), seed=D, dtype=dtype)
    gen = torch.Generator("cuda").manual_seed(D + 1)
    dlse = torch.randn(q.shape[:3], generator=gen, device="cuda")
    if window is None:  # unbounded at every offset of the split
        args = args[:4] + (2048 + 2**20,) + args[5:]
    for q_start, k_start in RING_PAIRS:
        _assert_match_plain_versions(q, k, v, do, args, dlse=dlse, q_start=q_start,
                                     k_start=k_start)


def test_flash_attention_lse_backward_on_the_card():
    """flash_attention_lse's autograd on the card against its plain
    version, both cotangents, at a ring step with keys in the past."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, do, _ = _hopper_inputs((1, 8, 2, 256, 128, {}), seed=5)
    dlse = torch.randn(q.shape[:3], generator=torch.Generator("cuda").manual_seed(2),
                       device="cuda")
    res = []
    for fn in (tfa.flash_attention_lse, tfa.flash_attention_lse_ref):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out, lse = fn(*leaves, 300, q_start=512, k_start=256)
        res.append([out, lse, *torch.autograd.grad(
            (out.float() * do.float()).sum() + (lse * dlse).sum(), leaves)])
    torch.cuda.synchronize()
    for got, want in zip(*res):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= _bound(want, q.dtype), err


def test_float16_runs_the_kernels_on_the_card():
    """float16 on the card: attention(impl="auto") and impl="flash" run K1
    and K2 (their mma.sync bodies, no rotation pass) and agree with the
    einsum path; an nf4 projection runs K3 in its forward and backward and
    equals the product with the plainly dequantized weight."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lxt_tpu_torch.ops import quant as tq
    from lxt_tpu_torch.ops.attention import attention
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(4)
    q, k, v, do = (torch.randn(1, h, 256, 64, generator=gen, device="cuda").half()
                   for h in (8, 2, 2, 8))
    rope = tuple(t.cuda() for t in tcommon.rope_tables(torch.arange(256), 64))
    res = {}
    for impl in ("auto", "flash", "einsum"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        tfa.reset_launches()
        out = attention(*leaves, causal=True, window=100, rope=rope, impl=impl)
        res[impl] = [out, *torch.autograd.grad((out.float() * do.float()).sum(), leaves)]
        res[impl].append(dict(tfa.launches))
    tq.reset_launches()
    qt = tq.quantize(0.02 * torch.randn(512, 256, generator=gen, device="cuda"), "nf4")
    x = torch.randn(2, 64, 512, generator=gen, device="cuda").half().requires_grad_(True)
    y = tq.quant_matmul(x, qt)
    (dx,) = torch.autograd.grad(y.float().sum(), x)
    w = tq.nf4_dequant_ref(qt.q, qt.scale, qt.block, torch.float16)
    torch.cuda.synchronize()
    kernels = {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1, "rope_rotate": 0}
    assert res["auto"][-1] == res["flash"][-1] == kernels
    assert all(n == 0 for n in res["einsum"][-1].values())
    for got, want in zip(res["auto"][:-1], res["einsum"][:-1]):
        assert got.dtype == torch.float16
        err = (got.float() - want.float()).abs().max().item()
        assert err <= _bound(want, torch.float16), err
    assert all(torch.equal(a, b) for a, b in zip(res["auto"][:-1], res["flash"][:-1]))
    assert tq.launches["nf4_dequant"] == 2
    assert y.dtype == torch.float16 and torch.equal(y, torch.matmul(x.detach(), w))
    assert torch.equal(dx, torch.matmul(torch.ones_like(y), w.transpose(0, 1)))


# K3 nf4 dequantization: the five Llama-3-8B projection shapes [K, N], a
# layer-stacked one and ragged ones (K 64 x N 40 with block 64 is a shape
# lxt_tpu's Pallas kernel refuses)
NF4_SHAPES = [((4096, 4096), 64), ((4096, 1024), 64), ((4096, 14336), 64),
              ((14336, 4096), 64), ((3, 512, 256), 64), ((128, 48), 64),
              ((64, 40), 64), ((6, 10), 2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("shape,block", NF4_SHAPES)
def test_nf4_dequant_bit_exact(shape, block, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lxt_tpu_torch.ops import quant as tq
    gen = torch.Generator("cuda").manual_seed(shape[-1])
    w = 0.02 * torch.randn(shape, generator=gen, device="cuda")
    qt = tq.quantize(w, "nf4", block=block)
    assert qt.block == block
    before = tq.launches["nf4_dequant"]
    got = tq.nf4_dequant(qt.q, qt.scale, qt.block, dtype)
    want = tq.nf4_dequant_ref(qt.q, qt.scale, qt.block, dtype)
    torch.cuda.synchronize()
    assert tq.launches["nf4_dequant"] == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_nf4_quant_matmul_matches_dense_product(dtype):
    """The nf4 matmul's forward and input gradient on the card against the
    same product with the plainly dequantized dense weight."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lxt_tpu_torch.ops import quant as tq
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)
    qt = tq.quantize(0.02 * torch.randn(1024, 768, generator=gen, device="cuda"), "nf4")
    x = torch.randn(2, 64, 1024, generator=gen, device="cuda").to(dtype)
    ct = torch.randn(2, 64, 768, generator=gen, device="cuda").to(dtype)
    xk = x.clone().requires_grad_(True)
    y = tq.quant_matmul(xk, qt)
    (dx,) = torch.autograd.grad((y * ct).sum(), xk)
    w = tq.dequantize(qt, dtype)
    xd = x.clone().requires_grad_(True)
    y_ref = torch.matmul(xd, w)
    (dx_ref,) = torch.autograd.grad((y_ref * ct).sum(), xd)
    torch.cuda.synchronize()
    # the same weight values: only the products' algorithms may differ
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    for got, want in ((y, y_ref), (dx, dx_ref)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= rel * want.float().abs().max().item(), err


# the attribution API on the card: top-k maps through one forward and K
# pulls of its graph (K1 once a layer, each K2 half K times) against K
# separate attributions, on a 2-layer bf16 Llama whose head dim runs the
# Hopper bodies at 64 and 256; float32 (mma.sync bodies) beside it
TOPK_MODELS = {64: dict(hidden_size=256, num_heads=4, num_kv_heads=2),
               256: dict(hidden_size=512, num_heads=4, num_kv_heads=2,
                         head_dim=256)}


@pytest.mark.parametrize("dtype,bar", [("bfloat16", 1e-3), ("float32", 1e-5)])
@pytest.mark.parametrize("D", [64, 256])
def test_topk_maps_match_separate_attributions(D, dtype, bar):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lxt_tpu_torch import composites
    from lxt_tpu_torch.models import llama as tllama
    from lxt_tpu_torch.models import registry as treg
    torch.backends.cuda.matmul.allow_tf32 = False
    L, K, B, T = 2, 3, 2, 256
    cfg = tllama.LlamaConfig(vocab_size=512, intermediate_size=512, num_layers=L,
                             dtype=dtype, **TOPK_MODELS[D])
    gen = torch.Generator("cuda").manual_seed(D)
    model = treg.AttributionModel("llama", cfg, tllama.init_params(cfg, gen, device="cuda"),
                                  composites.attnlrp, remat=False)
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device="cuda")
    tfa.reset_launches()
    toks, values, rel = model.attribute_topk(ids, K)
    torch.cuda.synchronize()
    counts = dict(tfa.launches)
    hopper = dtype == "bfloat16"
    assert counts == {"flash_fwd": L, "flash_bwd_dq": K * L, "flash_bwd_dkv": K * L,
                      "rope_rotate": (L + 2 * K * L) if hopper else 0}
    assert toks.shape == values.shape == (K, B) and rel.shape == (K, B, T)
    for k in range(K):
        value, want = model.attribute(ids, token=toks[k])
        err = ((rel[k].double() - want.double()).norm() / want.double().norm()).item()
        assert err <= bar, (k, err)
        # attribute's value is the batch sum in the model's dtype: one
        # rounding of it apart
        eps = torch.finfo(getattr(torch, dtype)).eps
        assert abs(float(values[k].float().sum()) - float(value)) <= (
            eps * abs(float(value)))


@pytest.mark.parametrize("weights", ["dense", "nf4"])
def test_mixtral_ragged_matches_dense_through_the_kernels(weights):
    """Mixtral's ragged mixture (per-expert products on the sorted rows;
    K3 for NF4 experts) against the dense one-hot mixture (every expert on
    every token, plainly dequantized weights), float32 through the flash
    kernels; the ragged run's launches: K1 and each K2 half once a layer,
    K3 for the four attention projections, the router and three products
    of every non-empty expert group, in the forward and the backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from lxt_tpu_torch import attribution, composites
    from lxt_tpu_torch.models import mixtral as tmix
    from lxt_tpu_torch.ops import quant as tq
    torch.backends.cuda.matmul.allow_tf32 = False
    L, B, T = 2, 2, 256
    cfg = tmix.MixtralConfig(vocab_size=512, hidden_size=512, intermediate_size=1024,
                             num_layers=L, num_heads=8, num_kv_heads=2)
    gen = torch.Generator("cuda").manual_seed(3)
    params = tmix.init_params(cfg, gen, quantize_bits=None if weights == "dense" else "nf4")
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device="cuda")

    def run(impl):
        c = dataclasses.replace(cfg, moe_impl=impl)
        return attribution.input_relevance(
            lambda e: attribution.select_logit(tmix.forward(
                params, c, e, composites.attnlrp, remat=False, logits_at=-1).logits),
            tmix.embed(params, ids))

    tfa.reset_launches()
    tq.reset_launches()
    tmix.reset_routing()
    value, rel = run("ragged")
    torch.cuda.synchronize()
    counts = {**tfa.launches, **tq.launches}
    reads, groups = tmix.routing["host_reads"], tmix.routing["nonempty_groups"]
    assert reads == L and 0 < groups <= L * cfg.num_experts
    k3 = 0 if weights == "dense" else 2 * (5 * reads + 3 * groups)
    assert counts == {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                      "rope_rotate": 0, "nf4_dequant": k3}
    value_d, rel_d = run("dense")
    err = ((rel.double() - rel_d.double()).norm() / rel_d.double().norm()).item()
    assert err <= 1e-4 and abs(float(value) - float(value_d)) <= 1e-4 * abs(float(value_d))
