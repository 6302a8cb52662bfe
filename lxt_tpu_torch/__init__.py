"""lxt_tpu_torch — AttnLRP attribution for transformers in PyTorch, with
hand-written Hopper (sm_90a) flash-attention kernels.

The port of ``lxt_tpu`` (JAX on a TPU), which stays in this repository as
the reference each ported part is tested against. Every LRP rule is an
autograd Function or a stop-gradient inside the model forward, so
``relevance = x * grad`` is one backward pass. Attention on CUDA tensors
runs the kernels in ``csrc/`` (built with nvcc at first use); on CPU
tensors it runs their plain PyTorch versions.
"""

__version__ = "0.1.0"

from lxt_tpu_torch.attribution import input_relevance, select_logit
from lxt_tpu_torch.composites import Composite, attnlrp, cp_lrp, vanilla_gradient

__all__ = [
    "Composite", "attnlrp", "cp_lrp", "vanilla_gradient",
    "input_relevance", "select_logit", "__version__",
]
