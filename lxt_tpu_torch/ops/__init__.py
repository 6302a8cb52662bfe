"""LRP rule primitives, attention and the flash-attention kernels. The
kernel module (``flash_attention``) is imported on first use."""

from lxt_tpu_torch.ops.rules import divide_gradient, identity_rule, stop_gradient

__all__ = ["divide_gradient", "identity_rule", "stop_gradient"]
