"""Gradient*Input LRP rule primitives (the "efficient" path) in PyTorch.

The counterparts of ``lxt_tpu/ops/rules.py``: every AttnLRP rule is the
gradient of a slightly modified function, so one ``torch.autograd.grad``
over the patched model yields relevance as ``input * grad``.

- :func:`stop_gradient` — CP-LRP / norm-variance path: relevance stops.
- :func:`identity_rule` — identity rule (Eq. 9 of the AttnLRP paper) for
  elementwise nonlinearities: the backward multiplies the incoming gradient
  by ``fn(x) / (x + eps)``, so ``x * grad == fn(x) * grad_out``.
- :func:`divide_gradient` — uniform rule (Eq. 7): identity forward, the
  backward divides the gradient by ``factor``.

All primitives keep the input dtype; the identity ratio is computed in
float32 and stored in the input dtype, as in ``lxt_tpu``.
"""

import torch

_IDENTITY_EPS = 1e-10  # as lxt_tpu.ops.rules._IDENTITY_EPS


def stop_gradient(x):
    """Stop relevance flow (CP-LRP rule)."""
    return x.detach()


class _IdentityRule(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        out = fn(x)
        ratio = out.float() / (x.float() + _IDENTITY_EPS)
        ctx.save_for_backward(ratio.to(x.dtype))
        return out

    @staticmethod
    def backward(ctx, g):
        (ratio,) = ctx.saved_tensors
        return ratio * g, None


def identity_rule(fn, x):
    """Apply ``fn`` elementwise under the identity LRP rule (Eq. 9)."""
    return _IdentityRule.apply(x, fn)


class _DivideGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.factor, None


def divide_gradient(x, factor=2):
    """Identity forward; backward divides the relevance-gradient by ``factor``."""
    return _DivideGradient.apply(x, factor)
