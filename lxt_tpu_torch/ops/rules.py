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

- :func:`gamma_linear` / :func:`gamma_conv2d`, :func:`alphabeta_linear` /
  :func:`alphabeta_conv2d`, :func:`modz_linear` / :func:`modz_conv2d` —
  the explicit rules (gamma, alpha-beta / z+, flat / w-square / z-box) of
  linear and NHWC conv layers, for the vision towers and the composites'
  ``linear_rule`` / ``conv_rule`` / site and layer overrides.

All primitives keep the input dtype; the identity ratio is computed in
float32 and stored in the input dtype, as in ``lxt_tpu``. Each backward
passes its gradient through the check hook
(:func:`lxt_tpu_torch.ops.check.maybe_redistribute`) with the check mode
its forward kept.
"""

import torch
import torch.nn.functional as F

from lxt_tpu_torch.ops import check, tensor_parallel

_IDENTITY_EPS = 1e-10  # as lxt_tpu.ops.rules._IDENTITY_EPS


def stop_gradient(x):
    """Stop relevance flow (CP-LRP rule)."""
    return x.detach()


class _IdentityRule(torch.autograd.Function):
    lrp_rule = ("rule", "identity rule (Eq. 9)")

    @staticmethod
    def forward(ctx, x, fn):
        out = fn(x)
        ratio = out.float() / (x.float() + _IDENTITY_EPS)
        ctx.save_for_backward(ratio.to(x.dtype))
        ctx.check = check.mode()
        return out

    @staticmethod
    def backward(ctx, g):
        (ratio,) = ctx.saved_tensors
        (grad,) = check.maybe_redistribute((ratio * g,), (g,), "identity_rule",
                                           ctx.check)
        return grad, None


def identity_rule(fn, x):
    """Apply ``fn`` elementwise under the identity LRP rule (Eq. 9)."""
    return _IdentityRule.apply(x, fn)


class _DivideGradient(torch.autograd.Function):
    lrp_rule = ("rule", "uniform rule /k (Eq. 7)")

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        ctx.check = check.mode()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (grad,) = check.maybe_redistribute((g / ctx.factor,), (g,),
                                           "divide_gradient", ctx.check)
        return grad, None


def divide_gradient(x, factor=2):
    """Identity forward; backward divides the relevance-gradient by ``factor``."""
    return _DivideGradient.apply(x, factor)


# ---------------------------------------------------------------------------
# explicit linear / conv rules: gamma, alpha-beta, flat / w-square / z-box
# ---------------------------------------------------------------------------
#
# Each is an autograd Function whose forward is the plain product or conv
# and whose backward turns the incoming gradient into relevance (g * out),
# redistributes it by the rule and divides by the stabilized input, so that
# ``x * grad`` is the rule's relevance (the grad -> relevance -> grad
# sandwich of lxt_tpu.ops.rules). The sandwich runs in float32 (float64 for
# float64 inputs) and the gradient is cast back to the input dtype; weights
# and biases get no gradient. Convolutions are NHWC with HWIO weights, as in
# lxt_tpu, permuted to NCHW / OIHW at the F.conv2d call.
#
# The zero-input caveat of lxt_tpu.ops.rules holds here too: flat, wsquare
# and zbox give relevance to inputs that are exactly 0, but relevance is
# read as x * grad, so those positions read 0.


def _stabilize(x, eps=1e-6):
    return torch.where(x >= 0, x + eps, x - eps)


def _wide(t):
    """``t`` in float32, or float64 if it is float64 (a reference run)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _same_pads(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_pads(x_shape, w_shape, strides, padding):
    """``padding`` ('VALID', 'SAME' or ``((top, bottom), (left, right))``,
    as lax.conv_general_dilated takes it) -> explicit pads."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return (0, 0), (0, 0)
        if padding.upper() == "SAME":
            return (_same_pads(x_shape[1], w_shape[0], strides[0]),
                    _same_pads(x_shape[2], w_shape[1], strides[1]))
        raise ValueError(f"padding must be 'VALID', 'SAME' or pairs, got {padding!r}")
    (t, bt), (lf, rt) = padding
    return (int(t), int(bt)), (int(lf), int(rt))


def _conv2d(x, w, b, strides, padding):
    """NHWC x, HWIO w -> NHWC, bias added after the conv."""
    (t, bt), (lf, rt) = _conv_pads(x.shape, w.shape, strides, padding)
    xc = x.permute(0, 3, 1, 2)
    if t or bt or lf or rt:
        xc = F.pad(xc, (lf, rt, t, bt))
    out = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=tuple(strides))
    out = out.permute(0, 2, 3, 1)
    return out if b is None else out + b


def _conv2d_t(g, w, x_shape, strides, padding):
    """The transpose of :func:`_conv2d` (without bias) at ``g`` -> NHWC of
    ``x_shape``. ``conv2d_input`` takes the whole (padded) input size, so a
    side that the stride does not divide gets zeros on its remainder."""
    (t, bt), (lf, rt) = _conv_pads(x_shape, w.shape, strides, padding)
    B, H, W, C = x_shape
    gx = torch.nn.grad.conv2d_input(
        (B, C, H + t + bt, W + lf + rt), w.permute(3, 2, 0, 1),
        g.permute(0, 3, 1, 2), stride=tuple(strides))
    return gx[:, :, t:t + H, lf:lf + W].permute(0, 2, 3, 1)


def _gamma_rel_in(x, w, b, rel_out, mm, mm_t, gamma):
    w_mod = w + gamma * w.clamp(min=0)
    b_mod = None if b is None else b + gamma * b.clamp(min=0)
    z = mm(x, w_mod)
    if b_mod is not None:
        z = z + b_mod
    return mm_t(rel_out / _stabilize(z), w_mod) * x


def _alphabeta_rel_in(x, w, b, rel_out, mm, mm_t, alpha, beta):
    xp, xn = x.clamp(min=0), x.clamp(max=0)
    wp, wn = w.clamp(min=0), w.clamp(max=0)
    zp = mm(xp, wp) + mm(xn, wn)
    zn = mm(xp, wn) + mm(xn, wp)
    if b is not None:
        zp = zp + b.clamp(min=0)
        zn = zn + b.clamp(max=0)
    rp = rel_out / _stabilize(zp)
    rel_in = alpha * (xp * mm_t(rp, wp) + xn * mm_t(rp, wn))
    if beta != 0.0:
        rn = rel_out / _stabilize(zn)
        rel_in = rel_in - beta * (xp * mm_t(rn, wn) + xn * mm_t(rn, wp))
    return rel_in


def _modz_rel_in(x, w, b, rel_out, mm, mm_t, kind, *extra):
    """flat / wsquare / zbox (``extra``: the zbox bounds, scalars or
    tensors broadcastable to x)."""
    if kind == "flat":
        ones_x, ones_w = torch.ones_like(x), torch.ones_like(w)
        z = mm(ones_x, ones_w)
        return ones_x * mm_t(rel_out / _stabilize(z), ones_w)
    if kind == "wsquare":
        ones_x, w_sq = torch.ones_like(x), w * w
        z = mm(ones_x, w_sq)
        if b is not None:
            z = z + b * b  # the bias absorbs its (squared) share
        return ones_x * mm_t(rel_out / _stabilize(z), w_sq)
    low, high = (torch.broadcast_to(torch.as_tensor(v, dtype=x.dtype,
                                                    device=x.device), x.shape)
                 for v in extra)
    wp, wn = w.clamp(min=0), w.clamp(max=0)
    # the bias cancels exactly in z (b = b+ + b-), so z carries none
    z = mm(x, w) - mm(low, wp) - mm(high, wn)
    s = rel_out / _stabilize(z)
    return x * mm_t(s, w) - low * mm_t(s, wp) - high * mm_t(s, wn)


_REL_IN = {"gamma": _gamma_rel_in, "alphabeta": _alphabeta_rel_in,
           "modz": _modz_rel_in}


def _row_matmul(group):
    """``x @ w``, summed over ``group`` when x and w hold one shard of the
    input features each (a row-parallel product; None: no sum)."""
    if group is None:
        return torch.matmul
    return lambda xx, ww: tensor_parallel.all_reduce(torch.matmul(xx, ww), group)


class _LinearRule(torch.autograd.Function):
    """``group``: the tensor-parallel group of a row-parallel product,
    whose x and w hold one shard of the input features: the output and the
    rule's denominators (z, or z+ and z-, over all input features) are
    summed over the group before the bias and the division."""

    lrp_rule = ("rule", "{} rule (linear)")

    @staticmethod
    def forward(ctx, x, w, b, kind, args, group=None):
        out = _row_matmul(group)(x, w)
        out = out if b is None else out + b
        ctx.save_for_backward(x, w, b, out)
        ctx.kind, ctx.args, ctx.group = kind, args, group
        ctx.check = check.mode()
        if group is not None:   # the summed output is replicated
            tensor_parallel.end_shards()
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, b, out = ctx.saved_tensors
        x32, w32, g32, out32 = (_wide(t) for t in (x, w, g, out))
        b32 = None if b is None else _wide(b)
        rel_in = _REL_IN[ctx.kind](
            x32, w32, b32, g32 * out32, _row_matmul(ctx.group),
            lambda gg, ww: torch.matmul(gg, ww.T), *ctx.args)
        # under tensor parallelism: a row-parallel product's x is a shard
        # and its output replicated; a column-parallel one (after a copy)
        # sees all of x but its share of the output
        layout = ("row" if ctx.group is not None else
                  "column" if ctx.check is not None and ctx.check.sharded else None)
        (grad_x,) = check.maybe_redistribute(
            (rel_in / _stabilize(x32),), (g,), f"{ctx.kind}_linear", ctx.check,
            layout=layout)
        return grad_x.to(x.dtype), None, None, None, None, None


class _Conv2dRule(torch.autograd.Function):
    lrp_rule = ("rule", "{} rule (conv2d)")

    @staticmethod
    def forward(ctx, x, w, b, strides, padding, kind, args):
        ctx.save_for_backward(x, w, b)
        ctx.conv, ctx.kind, ctx.args = (strides, padding), kind, args
        ctx.check = check.mode()
        return _conv2d(x, w, b, strides, padding)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        strides, padding = ctx.conv
        x32, w32, g32 = _wide(x), _wide(w), _wide(g)
        b32 = None if b is None else _wide(b)
        out = _conv2d(x32, w32, b32, strides, padding)

        def mm(xx, ww):
            return _conv2d(xx, ww, None, strides, padding)

        def mm_t(gg, ww):
            return _conv2d_t(gg, ww, x32.shape, strides, padding)

        rel_in = _REL_IN[ctx.kind](x32, w32, b32, g32 * out, mm, mm_t,
                                   *ctx.args)
        (grad_x,) = check.maybe_redistribute(
            (rel_in / _stabilize(x32),), (g,), f"{ctx.kind}_conv2d", ctx.check)
        return grad_x.to(x.dtype), None, None, None, None, None, None


def gamma_linear(x, w, b, gamma=0.25, group=None):
    """Linear layer ``x @ w + b`` (``w: [in, out]``) with the gamma-LRP
    backward: relevance redistributed by ``w + gamma * w+``. ``group``: see
    :class:`_LinearRule` (likewise for the other linear rules)."""
    return _LinearRule.apply(x, w, b, "gamma", (float(gamma),), group)


def gamma_conv2d(x, w, b, strides, padding, gamma=0.25):
    """NHWC conv2d (``w: [kh, kw, cin, cout]``) with the gamma-LRP backward."""
    return _Conv2dRule.apply(x, w, b, tuple(strides), padding, "gamma",
                             (float(gamma),))


def alphabeta_linear(x, w, b, alpha=2.0, beta=1.0, group=None):
    """Linear layer with the alpha-beta LRP backward: positive and negative
    contributions redistributed apart, ``alpha - beta = 1`` conserves;
    ``(1, 0)`` is the z+ rule."""
    return _LinearRule.apply(x, w, b, "alphabeta", (float(alpha), float(beta)),
                             group)


def alphabeta_conv2d(x, w, b, strides, padding, alpha=2.0, beta=1.0):
    """NHWC conv2d with the alpha-beta LRP backward."""
    return _Conv2dRule.apply(x, w, b, tuple(strides), padding, "alphabeta",
                             (float(alpha), float(beta)))


def modz_linear(x, w, b, spec, group=None):
    """Linear layer with a modified-z backward. ``spec``: ``('flat',)``
    (uniform over the fan-in), ``('wsquare',)`` (by w²) or ``('zbox', low,
    high)`` (the bounded-input rule)."""
    return _LinearRule.apply(x, w, b, "modz", tuple(spec), group)


def modz_conv2d(x, w, b, strides, padding, spec):
    """NHWC conv2d with a modified-z backward (see :func:`modz_linear`)."""
    return _Conv2dRule.apply(x, w, b, tuple(strides), padding, "modz",
                             tuple(spec))
