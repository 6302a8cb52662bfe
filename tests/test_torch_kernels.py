"""K1/K2 against their plain PyTorch versions on the card.

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
