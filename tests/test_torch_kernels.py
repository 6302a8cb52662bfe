"""K1/K2 and K3 against their plain PyTorch versions on the card.

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


def _bound(want, dtype):
    """max|diff| bound: lxt_tpu's TPU-kernel criterion for bf16 (0.01 +
    0.01171875 * absmax), the same form with 1e-4 for float32."""
    a, r = (0.01, 0.01171875) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    return a + r * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
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
    delta = (ref_out.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, ref_lse, delta, *args)
    seen = ref_lse > -1e29  # rows with a visible key (others: -1e30 both)
    pairs = {"out": (out, ref_out),
             "lse": (torch.where(seen, lse, 0.0), torch.where(seen, ref_lse, 0.0)),
             "dq": (tfa.flash_bwd_dq(*bwd), tfa.flash_bwd_dq_ref(*bwd))}
    pairs.update(zip(("dk", "dv"), zip(tfa.flash_bwd_dkv(*bwd),
                                       tfa.flash_bwd_dkv_ref(*bwd))))
    torch.cuda.synchronize()
    assert torch.equal(lse <= -1e29, ~seen)
    for name, (got, want) in pairs.items():
        err = (got.float() - want.float()).abs().max().item()
        assert err <= _bound(want, dtype), (name, err)


# K3 nf4 dequantization: the five Llama-3-8B projection shapes [K, N], a
# layer-stacked one and ragged ones (K 64 x N 40 with block 64 is a shape
# lxt_tpu's Pallas kernel refuses)
NF4_SHAPES = [((4096, 4096), 64), ((4096, 1024), 64), ((4096, 14336), 64),
              ((14336, 4096), 64), ((3, 512, 256), 64), ((128, 48), 64),
              ((64, 40), 64), ((6, 10), 2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
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
