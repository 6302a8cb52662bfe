"""Multi-process attribution (counterpart of ``lxt_tpu/parallel``): the
sequence-parallel ring so far."""

from lxt_tpu_torch.parallel.ring import (attribute_sequence_parallel,
                                         ring_flash_attention)

__all__ = ["attribute_sequence_parallel", "ring_flash_attention"]
