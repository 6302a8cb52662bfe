"""Functional LRP primitives (counterpart of ``lxt_tpu/ops/functional.py``).

Only :func:`normalize` is ported: OpenCLIP's image embedding needs it. The
rest of that module (the explicit path's softmax, linear, matmul, norms)
comes with the explicit path.
"""

import torch
import torch.nn.functional as F


class _Normalize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p, dim, eps):
        return F.normalize(x, p=p, dim=dim, eps=eps)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def normalize(x, p=2.0, dim=1, eps=1e-12):
    """``F.normalize`` (x / max(||x||_p, eps)) with the identity rule in the
    backward: the gradient passes unchanged (Prop. 3.4)."""
    return _Normalize.apply(x, float(p), dim, eps)
