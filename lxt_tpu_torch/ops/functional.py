"""Explicit LRP primitives: relevance-propagating ops (counterpart of
``lxt_tpu/ops/functional.py``).

Each op is one autograd Function whose *cotangent is relevance itself*:
seeding the backward with the output relevance (the explained logit's
value) propagates LRP relevance in one pass, and the cotangent arriving at
the input IS the input relevance (no final ``x * grad``). Weights and
biases get no gradient. The arithmetic and dtypes follow ``lxt_tpu``,
including the plain ``+ epsilon`` of :func:`stabilize`; a relevance is
returned in its input's dtype.

==================  ==========================================================
softmax             Deep-Taylor (Prop 3.1), float32; -inf positions give 0
linear_epsilon      epsilon rule (Eq. 8)
matmul              sequential epsilon + uniform rule (Prop 3.3)
baddbmm             bias + a @ b: add2 of the bias and matmul
add2                epsilon rule on an elementwise sum (Eq. 8)
mul2                uniform rule on an elementwise product (Prop 3.2)
mean                epsilon rule
layer_norm          std-detached LayerNorm (the reference's std-detach trick)
rms_norm_identity   identity rule (Prop 3.4)
normalize           identity rule (Prop 3.4)
==================  ==========================================================

Every backward passes its relevances through the check hook
(:func:`lxt_tpu_torch.ops.check.maybe_redistribute`) with the check mode
its forward kept. An input that needs no gradient (a mask, a detached rope
table, a Python scalar) gets no relevance computed; under the conservation
check it still takes its share of the uniform mean, as in ``lxt_tpu``,
where every input receives a cotangent.
"""

import torch
import torch.nn.functional as F

from lxt_tpu_torch.ops import check


def stabilize(x, epsilon=1e-6):
    """``x + epsilon``: a plain ``+``, not sign-aware (the reference's
    ``_stabilize``)."""
    return x + epsilon


def _unbroadcast(r, shape):
    """Reduce relevance ``r`` to ``shape`` by summing broadcast axes."""
    shape = tuple(shape)
    if tuple(r.shape) == shape:
        return r
    ndiff = r.dim() - len(shape)
    if ndiff:
        r = r.sum(dim=tuple(range(ndiff)))
    dims = tuple(i for i, s in enumerate(shape) if s == 1 and r.shape[i] != 1)
    if dims:
        r = r.sum(dim=dims, keepdim=True)
    return r


def _shape(t):
    """The shape with which an input counts in the conservation check (a
    Python scalar counts as one element)."""
    return t.shape if isinstance(t, torch.Tensor) else torch.Size([])


def _rel(ctx, i, fn, t):
    """Input ``i``'s relevance ``fn()`` in ``t``'s dtype when the input
    needs a gradient; else its shape, which counts it in the conservation
    check."""
    if ctx.needs_input_grad[i]:
        return fn().to(t.dtype)
    return _shape(t)


class _Softmax(torch.autograd.Function):
    lrp_rule = ("rule", "softmax Deep-Taylor (Prop 3.1)")

    @staticmethod
    def forward(ctx, x, dim, temperature):
        x32 = x.float()
        if temperature != 1.0:   # dividing by 1 is exact: skip the copy
            x32 = x32 / temperature
        p = torch.softmax(x32, dim=dim)
        ctx.save_for_backward(x32, p)
        ctx.dim, ctx.dtype, ctx.check = dim, x.dtype, check.mode()
        return p

    @staticmethod
    def backward(ctx, rel_out):
        x32, p = ctx.saved_tensors
        # -inf mask positions contribute 0 relevance
        x32 = torch.where(torch.isneginf(x32), 0.0, x32)
        rel = x32 * (rel_out - p * rel_out.sum(dim=ctx.dim, keepdim=True))
        (rel,) = check.maybe_redistribute((rel.to(ctx.dtype),), (rel_out,),
                                          "softmax", ctx.check)
        return rel, None, None


def softmax(x, dim=-1, temperature=1.0):
    """Softmax in float32 with the Deep-Taylor backward
    ``R_in = x (R - p sum(R))``."""
    return _Softmax.apply(x, dim, temperature)


class _LinearEpsilon(torch.autograd.Function):
    lrp_rule = ("rule", "linear epsilon (Eq. 8)")

    @staticmethod
    def forward(ctx, x, w, b, epsilon):
        out = torch.matmul(x, w)
        if b is not None:
            out = out + b
        ctx.save_for_backward(x, w, out)
        ctx.epsilon, ctx.check = epsilon, check.mode()
        return out

    @staticmethod
    def backward(ctx, rel_out):
        x, w, out = ctx.saved_tensors
        rel_norm = rel_out / stabilize(out, ctx.epsilon)
        rel_x = torch.matmul(rel_norm, w.transpose(-1, -2)) * x
        (rel_x,) = check.maybe_redistribute((rel_x,), (rel_out,),
                                            "linear_epsilon", ctx.check)
        return rel_x, None, None, None


def linear_epsilon(x, w, b=None, epsilon=1e-6):
    """``x @ w (+ b)`` (``w: [in, out]``) with the epsilon-LRP backward:
    all relevance goes to ``x``."""
    return _LinearEpsilon.apply(x, w, b, epsilon)


class _Matmul(torch.autograd.Function):
    lrp_rule = ("rule", "matmul uniform-epsilon (Prop 3.3)")

    @staticmethod
    def forward(ctx, a, b, epsilon):
        out = torch.matmul(a, b)
        ctx.save_for_backward(a, b, out)
        ctx.epsilon, ctx.check = epsilon, check.mode()
        return out

    @staticmethod
    def backward(ctx, rel_out):
        a, b, out = ctx.saved_tensors
        rel_norm = rel_out / stabilize(2 * out, ctx.epsilon)
        rels = (_rel(ctx, 0, lambda: torch.matmul(
                    rel_norm, b.transpose(-1, -2)) * a, a),
                _rel(ctx, 1, lambda: torch.matmul(
                    a.transpose(-1, -2), rel_norm) * b, b))
        return (*check.maybe_redistribute(rels, (rel_out,), "matmul",
                                          ctx.check), None)


def matmul(a, b, epsilon=1e-8):
    """``a @ b`` with the AttnLRP Prop 3.3 backward (each input's share of
    the epsilon rule halved)."""
    return _Matmul.apply(a, b, epsilon)


def baddbmm(bias, a, b, epsilon=1e-8):
    """``bias + a @ b``: the bias-add under the epsilon rule, the product
    under Prop 3.3 (the op the reference's explicit GPT-2 calls for its
    ``reorder_and_upcast_attn`` path)."""
    return add2(bias, matmul(a, b, epsilon), epsilon)


class _Add2(torch.autograd.Function):
    lrp_rule = ("rule", "add2 epsilon (Eq. 8)")

    @staticmethod
    def forward(ctx, a, b, epsilon):
        ctx.save_for_backward(a, b)
        ctx.epsilon, ctx.check = epsilon, check.mode()
        return a + b

    @staticmethod
    def backward(ctx, rel_out):
        a, b = ctx.saved_tensors
        rel_norm = rel_out / stabilize(a + b, ctx.epsilon)
        rels = (_rel(ctx, 0, lambda: _unbroadcast(rel_norm * a, a.shape), a),
                _rel(ctx, 1, lambda: _unbroadcast(rel_norm * b, b.shape), b))
        return (*check.maybe_redistribute(rels, (rel_out,), "add2",
                                          ctx.check), None)


def add2(a, b, epsilon=1e-8):
    """``a + b`` with the epsilon-LRP backward
    ``R_i = in_i R / (a + b + epsilon)``. Both operands are tensors."""
    return _Add2.apply(a, b, epsilon)


class _Mul2(torch.autograd.Function):
    lrp_rule = ("rule", "mul2 uniform (Prop 3.2)")

    @staticmethod
    def forward(ctx, a, b, n_inputs):
        ctx.shapes = (a.shape, _shape(b))
        ctx.dtypes = (a.dtype, b.dtype if isinstance(b, torch.Tensor) else None)
        ctx.n, ctx.check = n_inputs, check.mode()
        return a * b

    @staticmethod
    def backward(ctx, rel_out):
        rel = rel_out / ctx.n
        rels = tuple(
            _unbroadcast(rel, shape).to(dtype) if ctx.needs_input_grad[i]
            else shape
            for i, (shape, dtype) in enumerate(zip(ctx.shapes, ctx.dtypes)))
        return (*check.maybe_redistribute(rels, (rel_out,), "mul2",
                                          ctx.check), None)


def mul2(a, b, n_inputs=2):
    """``a * b`` with the uniform-LRP backward: each input receives
    ``R / n_inputs`` (``n_inputs=1`` when ``b`` is a constant: a detached
    table or a Python scalar)."""
    return _Mul2.apply(a, b, n_inputs)


class _Mean(torch.autograd.Function):
    lrp_rule = ("rule", "mean epsilon")

    @staticmethod
    def forward(ctx, x, dim, keepdim, epsilon):
        ctx.save_for_backward(x)
        ctx.args, ctx.check = (dim, keepdim, epsilon), check.mode()
        return x.mean(dim=dim, keepdim=keepdim)

    @staticmethod
    def backward(ctx, rel_out):
        (x,) = ctx.saved_tensors
        dim, keepdim, epsilon = ctx.args
        x_sum = x.sum(dim=dim, keepdim=True)
        rel_e = rel_out if keepdim else rel_out.unsqueeze(dim)
        rel = x * rel_e / stabilize(x_sum, epsilon)
        (rel,) = check.maybe_redistribute((rel,), (rel_out,), "mean",
                                          ctx.check)
        return rel, None, None, None


def mean(x, dim=-1, keepdim=False, epsilon=1e-6):
    """Mean with the epsilon-LRP backward ``R_i = x_i R / (sum(x) + eps)``."""
    return _Mean.apply(x, dim, keepdim, epsilon)


def _ln_detached_std(x, weight, bias, variance_epsilon):
    mu = x.mean(dim=-1, keepdim=True)
    std = torch.sqrt(((x - mu) ** 2).mean(dim=-1, keepdim=True)
                     + variance_epsilon)
    y = (x - mu) / std
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y, std


class _LayerNorm(torch.autograd.Function):
    lrp_rule = ("rule", "layer_norm epsilon")

    @staticmethod
    def forward(ctx, x, weight, bias, variance_epsilon, epsilon):
        y, std = _ln_detached_std(x, weight, bias, variance_epsilon)
        ctx.save_for_backward(x, weight, std, y)
        ctx.epsilon, ctx.check = epsilon, check.mode()
        return y

    @staticmethod
    def backward(ctx, rel_out):
        x, weight, std, y = ctx.saved_tensors
        # the vjp of the layer with std detached, at rel_out / (y + eps)
        t = rel_out / stabilize(y, ctx.epsilon)
        if weight is not None:
            t = t * weight
        t = t / std
        grads = t - t.mean(dim=-1, keepdim=True)
        (rel,) = check.maybe_redistribute((grads * x,), (rel_out,),
                                          "layer_norm", ctx.check)
        return rel, None, None, None, None


def layer_norm(x, weight, bias, variance_epsilon=1e-5, epsilon=1e-6):
    """LayerNorm in ``x``'s dtype whose backward is the reference's
    std-detach trick: differentiate the layer with the standard deviation
    detached at ``R / (y + eps)``, multiply by the input."""
    return _LayerNorm.apply(x, weight, bias, variance_epsilon, epsilon)


class _RMSNormIdentity(torch.autograd.Function):
    lrp_rule = ("rule", "rms_norm identity (Prop 3.4)")

    @staticmethod
    def forward(ctx, x, weight, variance_epsilon):
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + variance_epsilon)
        ctx.check = check.mode()
        return weight * y.to(x.dtype)

    @staticmethod
    def backward(ctx, rel_out):
        (rel,) = check.maybe_redistribute((rel_out,), (rel_out,),
                                          "rms_norm_identity", ctx.check)
        return rel, None, None


def rms_norm_identity(x, weight, variance_epsilon=1e-6):
    """RMSNorm (float32 statistics, as Llama) with the identity rule:
    relevance passes to the input unchanged."""
    return _RMSNormIdentity.apply(x, weight, variance_epsilon)


class _Normalize(torch.autograd.Function):
    lrp_rule = ("rule", "normalize identity")

    @staticmethod
    def forward(ctx, x, p, dim, eps):
        ctx.check = check.mode()
        return F.normalize(x, p=p, dim=dim, eps=eps)

    @staticmethod
    def backward(ctx, g):
        (g,) = check.maybe_redistribute((g,), (g,), "normalize", ctx.check)
        return g, None, None, None


def normalize(x, p=2.0, dim=1, eps=1e-12):
    """``F.normalize`` (x / max(||x||_p, eps)) with the identity rule in the
    backward: the gradient passes unchanged (Prop. 3.4)."""
    return _Normalize.apply(x, float(p), dim, eps)
