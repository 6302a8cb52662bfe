"""LRP rule primitives, the explicit path's relevance ops (``functional``),
the conservation and NaN checks, attention and the flash-attention kernels.
The kernel module (``flash_attention``) is imported on first use."""

from lxt_tpu_torch.ops import functional
from lxt_tpu_torch.ops.check import conservation_check, conservation_error
from lxt_tpu_torch.ops.rules import divide_gradient, identity_rule, stop_gradient

__all__ = ["functional", "conservation_check", "conservation_error",
           "divide_gradient", "identity_rule", "stop_gradient"]
