"""lxt_tpu_torch attention against lxt_tpu, on CPU.

The port's ``flash_attention`` (which takes its plain PyTorch version for
CPU tensors) and its einsum path are held against
``lxt_tpu.ops.flash_attention.flash_attention`` (Pallas, interpret mode on
CPU, as tests/test_flash_attention.py runs it): forward and the q, k, v
gradients, from the same numpy inputs. Tolerances are those of
tests/test_flash_attention.py: atol 2e-5 forward, 5e-5 gradients (float32,
sums taken in another order). The port's backward takes Δ = rowsum(out∘do)
from ``flash_bwd_dq``, as ``lxt_tpu``'s ``inline_delta`` option computes it
inside its backward kernel; a few regimes hold it against that option.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lxt_tpu
import lxt_tpu_torch
from lxt_tpu.ops.attention import attention as jattention
from lxt_tpu.ops.flash_attention import _make_delta
from lxt_tpu.ops.flash_attention import flash_attention as jflash
from lxt_tpu_torch.models import common as tcommon
from lxt_tpu_torch.ops import flash_attention as tfa
from lxt_tpu_torch.ops.attention import attention as tattention

ATOL_FWD, ATOL_GRAD = 2e-5, 5e-5

# regime -> (B, H, Hkv, T, D, kwargs); multi_block runs two 128-row blocks
REGIMES = {
    "causal": (2, 2, 2, 128, 64, {}),
    "window": (1, 2, 2, 128, 64, {"window": 32}),
    "gqa": (1, 4, 2, 128, 64, {}),
    "kv_begin": (2, 2, 2, 128, 64, {"kv_begin": [40, 0]}),
    "kv_end_bidirectional": (2, 2, 1, 128, 64, {"kv_end": [128, 77],
                                                "causal": False}),
    "rope": (1, 2, 1, 128, 64, {"rope": True}),
    "multi_block": (1, 2, 1, 256, 64, {"block": 128}),
}
# regimes also run with lxt_tpu's inline_delta (its fused backward, one kv
# block): causal with rope, GQA, kv_begin with dead rows, a window
INLINE_DELTA_REGIMES = ("rope", "gqa", "kv_begin", "window")
_JAX_CACHE = {}


def _inputs(regime):
    B, H, Hkv, T, D, kw = REGIMES[regime]
    rng = np.random.default_rng(sorted(REGIMES).index(regime))
    q = rng.standard_normal((B, H, T, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, T, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, T, D), dtype=np.float32)
    ct = rng.standard_normal((B, H, T, D), dtype=np.float32)
    if "kv_begin" in kw:
        # fully padded query rows: the flash path gives 0, the einsum path
        # a uniform average; no cotangent reaches them
        for b, s in enumerate(kw["kv_begin"]):
            ct[b, :, :s] = 0.0
    rope = None
    if kw.get("rope"):
        cos, sin = tcommon.rope_tables(torch.arange(T), D)
        rope = (cos.numpy(), sin.numpy())
    return q, k, v, ct, rope, kw


def _jax_flash(regime, inline_delta=False):
    key = (regime, inline_delta)
    if key not in _JAX_CACHE:
        q, k, v, ct, rope, kw = _inputs(regime)
        blk = kw.get("block", 1024)

        def f(q, k, v):
            return jflash(q, k, v, kw.get("window"), causal=kw.get("causal", True),
                          kv_begin=None if "kv_begin" not in kw
                          else jnp.asarray(kw["kv_begin"], jnp.int32),
                          kv_end=None if "kv_end" not in kw
                          else jnp.asarray(kw["kv_end"], jnp.int32),
                          rope=None if rope is None else tuple(map(jnp.asarray, rope)),
                          block_q=blk, block_k=blk, inline_delta=inline_delta)

        out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        _JAX_CACHE[key] = (np.asarray(out),
                           [np.asarray(g) for g in vjp(jnp.asarray(ct))])
    return _JAX_CACHE[key]


def _torch_run(regime, path):
    q, k, v, ct, rope, kw = _inputs(regime)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    rope_t = None if rope is None else tuple(map(torch.tensor, rope))
    causal = kw.get("causal", True)
    if path == "flash":
        out = lxt_tpu_torch.ops.flash_attention.flash_attention(
            qt, kt, vt, kw.get("window"), causal=causal,
            kv_begin=kw.get("kv_begin"), kv_end=kw.get("kv_end"), rope=rope_t)
    else:
        out = tattention(qt, kt, vt, causal=causal, window=kw.get("window"),
                         composite=lxt_tpu_torch.vanilla_gradient,
                         impl="einsum", kv_begin=kw.get("kv_begin"),
                         kv_end=kw.get("kv_end"), rope=rope_t)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.tensor(ct))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _check_against(regime, path, inline_delta):
    want_out, want_grads = _jax_flash(regime, inline_delta)
    out, grads = _torch_run(regime, path)
    mask = _inputs(regime)[3] != 0  # rows the comparison covers
    np.testing.assert_allclose(out * mask, want_out * mask, rtol=0, atol=ATOL_FWD)
    for g, w, name in zip(grads, want_grads, "qkv"):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL_GRAD, err_msg=f"d{name}")


@pytest.mark.parametrize("path", ["flash", "einsum"])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_attention_matches_lxt_tpu_flash(regime, path):
    _check_against(regime, path, inline_delta=False)


@pytest.mark.parametrize("regime", INLINE_DELTA_REGIMES)
def test_flash_matches_lxt_tpu_inline_delta(regime):
    """The port's gradients, whose Δ comes from flash_bwd_dq, against
    lxt_tpu's flash_attention(..., inline_delta=True)."""
    _check_against(regime, "flash", inline_delta=True)


@pytest.mark.parametrize("regime", ["causal", "gqa", "kv_begin", "rope"])
def test_flash_bwd_dq_delta_matches_make_delta(regime):
    """flash_bwd_dq_ref's Δ against lxt_tpu's _make_delta on the same numpy
    out and do, float32: within 1e-6 of the largest |Δ|, since the same 64
    products are summed in another order (|Δ| reaches ~20 here, where one
    float32 ulp is 1.9e-6)."""
    q, k, v, ct, _, _ = _inputs(regime)
    out = np.random.default_rng(3).standard_normal(q.shape, dtype=np.float32)
    want = np.asarray(_make_delta(jnp.asarray(out), jnp.asarray(ct), None))[..., 0]
    _, got = tfa.flash_bwd_dq_ref(
        *(torch.tensor(a) for a in (q, k, v, ct, out)),
        torch.zeros(q.shape[:3]), None, None, None, None, 10**6, 0.125, True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_flash_empty_rows_give_zero_out_and_lse_floor():
    """Rows before kv_begin see no key: out 0, lse -1e30, and no gradient
    reaches their queries."""
    q, k, v, _, _, _ = _inputs("kv_begin")
    kvb = torch.tensor([40, 0], dtype=torch.int32)
    out, lse = tfa.flash_fwd_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                 None, None, kvb, None, 10**6, 0.125, True)
    assert torch.all(out[0, :, :40] == 0)
    assert torch.all(lse[0, :, :40] == tfa.NEG_INF)
    assert torch.all(lse[1] > -100)
    qt = torch.tensor(q, requires_grad=True)
    o = tfa.flash_attention(qt, torch.tensor(k), torch.tensor(v), kv_begin=kvb)
    (dq,) = torch.autograd.grad(o.sum(), qt)
    assert torch.all(dq[0, :, :40] == 0) and torch.any(dq[0, :, 40:] != 0)


def test_flash_window_across_blocks_matches_einsum():
    """A window wider than a block but shorter than the span of two: the
    port agrees with the einsum path of lxt_tpu. (lxt_tpu's Pallas kernel
    treats such a tile as inside the window and differs here; ROADMAP
    queue 3.)"""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((1, 2, 256, 64), dtype=np.float32)
               for _ in range(3))
    want = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=True, window=100,
                      composite=lxt_tpu.vanilla_gradient, impl="einsum")
    got = tfa.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), 100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_FWD)


def test_dispatcher_pads_head_dim_and_applies_rules():
    """attention(impl='flash') under attnlrp on CPU — head dim 48 padded to
    64, GQA, rope tables — equals lxt_tpu's einsum path with the same
    rules: output and the rule-scaled gradients."""
    B, H, Hkv, T, D = 1, 4, 2, 128, 48
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, H, T, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, T, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, T, D), dtype=np.float32)
    rel = rng.standard_normal((B, H, T, D), dtype=np.float32)
    cos, sin = tcommon.rope_tables(torch.arange(T), D)

    def jf(q, k, v):
        return jattention(q, k, v, causal=True, composite=lxt_tpu.attnlrp,
                          impl="einsum", rope=(jnp.asarray(cos.numpy()),
                                               jnp.asarray(sin.numpy())))

    want_out, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(rel))
    for impl in ("flash", "einsum"):
        qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        out = tattention(qt, kt, vt, causal=True, composite=lxt_tpu_torch.attnlrp,
                         impl=impl, rope=(cos, sin))
        grads = torch.autograd.grad(out, (qt, kt, vt), torch.tensor(rel))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                                   rtol=0, atol=ATOL_FWD, err_msg=impl)
        for g, w, name in zip(grads, want_grads, "qkv"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=ATOL_GRAD, err_msg=f"{impl} d{name}")


@pytest.mark.parametrize("scaling", [None, ("linear", 2.0),
                                     ("llama3", 8.0, 1.0, 4.0, 64.0),
                                     ("yarn", 4.0, 32.0, 1.0, 64.0, None)])
def test_rope_tables_match_lxt_tpu(scaling):
    from lxt_tpu.models.common import rope_tables as jrope
    pos = np.arange(96, dtype=np.int32)
    want = jrope(jnp.asarray(pos), 32, 10000.0, rope_scaling=scaling)
    got = tcommon.rope_tables(torch.as_tensor(pos), 32, 10000.0,
                              rope_scaling=scaling)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_einsum_bias_and_softcap_match_lxt_tpu():
    """Additive bias and tanh softcap take the einsum path in both packages."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 4, 24, 16), dtype=np.float32)
    k, v = (rng.standard_normal((2, 2, 24, 16), dtype=np.float32) for _ in range(2))
    bias = rng.standard_normal((2, 1, 24, 24), dtype=np.float32)
    ct = rng.standard_normal((2, 4, 24, 16), dtype=np.float32)
    kw = dict(causal=True, window=9, softcap=3.0)
    want, vjp = jax.vjp(
        lambda q, k, v: jattention(q, k, v, bias=jnp.asarray(bias),
                                   composite=lxt_tpu.attnlrp, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(ct))
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tattention(qt, kt, vt, bias=torch.tensor(bias),
                     composite=lxt_tpu_torch.attnlrp, impl="flash", **kw)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.tensor(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_FWD)
    for g, w, name in zip(grads, want_grads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL_GRAD, err_msg=f"d{name}")


def test_flash_wrapper_refuses_other_devices():
    q = torch.empty((1, 2, 128, 64), device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("impl", ["auto", "flash", "einsum"])
def test_route_takes_the_kernels_for_cuda_calls_of_every_dtype(impl, dtype):
    """The dispatch decision, made from the device before the call: 'auto'
    takes the kernels for a CUDA tensor of any dtype (float16 included: the
    kernels have float16 bodies) when the call is eligible, einsum
    otherwise; the kernel wrappers take every one of these dtypes."""
    from lxt_tpu_torch.ops.attention import route
    cuda = types.SimpleNamespace(is_cuda=True, dtype=dtype)
    cpu = types.SimpleNamespace(is_cuda=False, dtype=dtype)
    assert dtype in tfa._DTYPE_CODE
    want = {"auto": "flash", "flash": "flash", "einsum": "einsum"}[impl]
    assert route(impl, cuda, flash_ok=True) == want
    assert route(impl, cuda, flash_ok=False) == "einsum"
    assert route(impl, cpu, flash_ok=True) == ("einsum" if impl == "auto" else impl)


@pytest.mark.parametrize("kv_begin", [None, [40, 0]], ids=["causal", "kv_begin"])
@pytest.mark.parametrize("dqk,dv", [(192, 128), (24, 16)])
def test_flash_with_a_narrower_v_matches_einsum(dqk, dv, kv_begin):
    """Latent attention's widths (q/k 192, v 128; and 24 / 16): the flash
    route pads q, k and v to the smallest native width that holds both
    (256; 64), slices the output to v's and scales by Dqk^-0.5; forward
    and gradients under attnlrp equal the einsum path's, which pads
    nothing. Fully padded query rows take no cotangent and are not
    compared (flash gives 0 there, einsum a uniform average)."""
    rng = np.random.default_rng(dqk)
    B, H, T = 2, 2, 128
    q, k = (rng.standard_normal((B, H, T, dqk), dtype=np.float32) for _ in range(2))
    v = rng.standard_normal((B, H, T, dv), dtype=np.float32)
    ct = rng.standard_normal((B, H, T, dv), dtype=np.float32)
    live = np.ones((B, 1, T, 1), np.float32)
    for b, s in enumerate(kv_begin or ()):
        live[b, :, :s] = 0
    ct *= live
    outs = {}
    for impl in ("flash", "einsum"):
        qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        out = tattention(qt, kt, vt, causal=True, composite=lxt_tpu_torch.attnlrp,
                         impl=impl, kv_begin=kv_begin)
        assert out.shape == (B, H, T, dv)
        grads = torch.autograd.grad(out, (qt, kt, vt), torch.tensor(ct))
        outs[impl] = [out.detach().numpy() * live] + [g.numpy() for g in grads]
    np.testing.assert_allclose(outs["flash"][0], outs["einsum"][0], rtol=0,
                               atol=ATOL_FWD)
    for g, w, name in zip(outs["flash"][1:], outs["einsum"][1:], "qkv"):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL_GRAD, err_msg=f"d{name}")


@pytest.mark.parametrize("dqk,dv,width", [(48, 48, 64), (64, 64, 64), (200, 200, 256),
                                          (192, 128, 256), (24, 16, 64)])
def test_pad_head_dim_takes_the_smallest_native_width(dqk, dv, width):
    """Equal head dims pad as before (to the next native width; a native
    width is passed through untouched), and unequal ones to the smallest
    native width that holds both."""
    from lxt_tpu_torch.ops.attention import _pad_head_dim
    q, k = (torch.randn(1, 2, 8, dqk) for _ in range(2))
    v = torch.randn(1, 2, 8, dv)
    padded = _pad_head_dim(q, k, v)
    for t, p in zip((q, k, v), padded):
        assert p.shape[-1] == width
        if t.shape[-1] == width:
            assert p is t
        torch.testing.assert_close(p[..., :t.shape[-1]], t, rtol=0, atol=0)
        assert not p[..., t.shape[-1]:].any()
