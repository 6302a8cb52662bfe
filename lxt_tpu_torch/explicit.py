"""Explicit LRP rules over arbitrary functions (counterpart of
``lxt_tpu/explicit.py``).

Where the reference wraps ``nn.Module``s, these wrap *functions*:
``epsilon_rule(fn)`` returns a function with the rule's backward. The
cotangent is relevance (the explicit convention): seed the backward with
the output relevance and the input cotangent is the input relevance.

====================  ======================================================
identity_rule_fn      relevance passes through unchanged
stop_relevance_rule   no relevance flows into any input
epsilon_rule          epsilon rule (Eq. 8) for any differentiable fn
uniform_epsilon_rule  epsilon rule with a uniform split over n inputs
uniform_rule          uniform rule (Eq. 7)
taylor_decomposition  Taylor decomposition at a reference point (Eq. 4-5)
softmax_dt            Deep-Taylor softmax with a temperature
multi_head_attention_cp  CP-LRP fused multi-head attention (value path)
====================  ======================================================

The epsilon and Taylor rules need ``fn``'s vector-Jacobian product inside
their backward (``lxt_tpu`` calls ``jax.vjp`` there). Here it is a nested
``torch.autograd.grad`` under ``torch.enable_grad()`` on detached copies of
the inputs, which the autograd engine runs on whatever thread runs the
backward (on CUDA its own device thread); the Taylor rule's directional
derivative at the reference point is ``torch.func.jvp``. ``fn`` may close
over tensors (weights); those get no gradient.
"""

import math
from typing import Callable, Optional, Sequence

import torch

from lxt_tpu_torch.ops import check
from lxt_tpu_torch.ops.functional import stabilize


def _vjp(fn, inputs, cotangent, need):
    """The gradients of ``fn`` at ``inputs`` contracted with ``cotangent``,
    for the inputs that ``need`` one (None for the others; zeros for an
    input that ``fn`` does not use)."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(n) for x, n in zip(inputs, need)]
        grads = iter(torch.autograd.grad(fn(*xs), [x for x in xs if x.requires_grad],
                                         cotangent, allow_unused=True))
    out = [next(grads) if n else None for n in need]
    return [torch.zeros_like(x) if n and g is None else g
            for x, n, g in zip(xs, need, out)]


class _IdentityFn(torch.autograd.Function):
    lrp_rule = ("rule", "identity rule (explicit)")

    @staticmethod
    def forward(ctx, fn, x):
        ctx.check = check.mode()
        return fn(x)

    @staticmethod
    def backward(ctx, rel_out):
        (rel,) = check.maybe_redistribute((rel_out,), (rel_out,),
                                          "identity_fn", ctx.check)
        return None, rel


def identity_rule_fn(fn: Callable) -> Callable:
    """``fn`` (single-input, elementwise) with the identity rule: relevance
    passes through unchanged."""
    return lambda x: _IdentityFn.apply(fn, x)


def stop_relevance_rule(fn: Callable) -> Callable:
    """``fn`` with no relevance flowing into any input (a CP-LRP block)."""
    return lambda *inputs: fn(*(x.detach() for x in inputs))


class _Epsilon(torch.autograd.Function):
    lrp_rule = ("rule", "epsilon rule (explicit)")

    @staticmethod
    def forward(ctx, fn, n_divide, epsilon, *inputs):
        out = fn(*inputs)
        ctx.save_for_backward(*inputs, out)
        ctx.args, ctx.check = (fn, n_divide, epsilon), check.mode()
        return out

    @staticmethod
    def backward(ctx, rel_out):
        *inputs, out = ctx.saved_tensors
        fn, n_divide, epsilon = ctx.args
        rel_norm = rel_out / stabilize(n_divide * out, epsilon)
        grads = _vjp(fn, inputs, rel_norm, ctx.needs_input_grad[3:])
        rels = tuple(x.shape if g is None else (g * x).to(x.dtype)
                     for g, x in zip(grads, inputs))
        return (None, None, None,
                *check.maybe_redistribute(rels, (rel_out,), "epsilon_rule",
                                          ctx.check))


def epsilon_rule(fn: Callable, epsilon: float = 1e-6) -> Callable:
    """``fn`` (tensor inputs -> one tensor) with the generic epsilon-LRP
    backward: the vjp of ``fn`` at ``R / (out + eps)``, times each input."""
    return lambda *inputs: _Epsilon.apply(fn, 1, epsilon, *inputs)


def uniform_epsilon_rule(fn: Callable, n_inputs: int,
                         epsilon: float = 1e-6) -> Callable:
    """The epsilon rule with a uniform split across ``n_inputs`` (Prop. 3.3
    as a sequential epsilon + uniform rule)."""
    return lambda *inputs: _Epsilon.apply(fn, n_inputs, epsilon, *inputs)


def _reduce_to(r, shape):
    """Sum ``r`` over the axes broadcast against ``shape``, then broadcast
    back to ``shape``."""
    ndiff = r.dim() - len(shape)
    if ndiff > 0:
        r = r.sum(dim=tuple(range(ndiff)))
    dims = tuple(i for i, s in enumerate(shape) if s == 1 and r.shape[i] != 1)
    if dims:
        r = r.sum(dim=dims, keepdim=True)
    return r.expand(shape)


class _Uniform(torch.autograd.Function):
    lrp_rule = ("rule", "uniform rule (explicit)")

    @staticmethod
    def forward(ctx, fn, n_inputs, *inputs):
        ctx.shapes = tuple(x.shape for x in inputs)
        ctx.dtypes = tuple(x.dtype for x in inputs)
        ctx.n = n_inputs if n_inputs is not None else len(inputs)
        ctx.check = check.mode()
        return fn(*inputs)

    @staticmethod
    def backward(ctx, rel_out):
        rel = rel_out / ctx.n
        rels = tuple(
            (rel if rel.shape == s else _reduce_to(rel, s)).to(dt)
            if ctx.needs_input_grad[2 + i] else s
            for i, (s, dt) in enumerate(zip(ctx.shapes, ctx.dtypes)))
        return (None, None,
                *check.maybe_redistribute(rels, (rel_out,), "uniform_rule",
                                          ctx.check))


def uniform_rule(fn: Callable, n_inputs: Optional[int] = None) -> Callable:
    """Distribute the output relevance uniformly over the inputs (Eq. 7):
    each input receives ``R / n``, summed over the axes it was broadcast
    along (``n``: ``n_inputs``, default the number of inputs)."""
    return lambda *inputs: _Uniform.apply(fn, n_inputs, *inputs)


class _Taylor(torch.autograd.Function):
    lrp_rule = ("rule", "Taylor decomposition (explicit)")

    @staticmethod
    def forward(ctx, fn, ref, bias, distribute_bias, *inputs):
        ctx.save_for_backward(*inputs)
        ctx.args = (fn, ref, bias, distribute_bias)
        ctx.check = check.mode()
        return fn(*inputs)

    @staticmethod
    def backward(ctx, rel_out):
        inputs = ctx.saved_tensors
        fn, ref, bias, distribute_bias = ctx.args
        if bias:
            denom = fn(*inputs)
        else:
            # the directional derivative J(ref) @ inputs
            _, denom = torch.func.jvp(fn, ref, inputs)
        rel_norm = rel_out / stabilize(denom)
        grads = _vjp(fn, ref, rel_norm, [True] * len(ref))
        rels = tuple(g * x for g, x in zip(grads, inputs))
        if bias and callable(distribute_bias):
            rels = distribute_bias(inputs, rels)
        rels = tuple(r.to(x.dtype) for r, x in zip(rels, inputs))
        return (None, None, None, None,
                *check.maybe_redistribute(rels, (rel_out,),
                                          "taylor_decomposition", ctx.check))


def taylor_decomposition(fn: Callable, ref: Sequence, bias: bool = False,
                         distribute_bias: Optional[Callable] = None) -> Callable:
    """Generalized Taylor decomposition at the reference point ``ref`` (Eq.
    4-5): normalize the relevance by the directional derivative
    ``J(ref) @ inputs`` (with ``bias``: by ``fn(inputs)``), pull it back
    through the Jacobian at ``ref`` and multiply by the inputs.
    ``distribute_bias(inputs, rels) -> rels`` may spread the bias's share."""
    ref = tuple(ref)
    return lambda *inputs: _Taylor.apply(fn, ref, bias, distribute_bias,
                                         *inputs)


def softmax_dt(temperature: float = 1.0, dim: int = -1) -> Callable:
    """Softmax with the Deep-Taylor backward and a temperature knob (the
    reference's ``SoftmaxDT``)."""
    from lxt_tpu_torch.ops import functional as lf
    return lambda x: lf.softmax(x, dim, temperature)


def multi_head_attention_cp(q, k, v, num_heads: int, w_qkv, b_qkv, w_out,
                            b_out, mask_bias=None, epsilon: float = 1e-6):
    """CP-LRP fused multi-head attention (``torch.nn.MultiheadAttention``'s
    layout, weights ``[in, out]``): the q/k projections and the softmax
    carry no relevance, which flows through the value path alone under the
    epsilon rule.

    q, k, v: ``[B, T, D]``; ``w_qkv``: ``[D, 3D]`` fused in-projection;
    ``w_out``: ``[D, D]``; ``mask_bias``: optional additive scores bias."""
    from lxt_tpu_torch.models import common

    D = q.shape[-1]
    hd = D // num_heads
    wq, wk, wv = w_qkv.chunk(3, dim=-1)
    bq, bk, bv = (None,) * 3 if b_qkv is None else b_qkv.chunk(3)

    def proj(x, w, b):
        y = torch.matmul(x, w)
        return y if b is None else y + b

    # the q/k path carries no relevance (CP)
    with torch.no_grad():
        qh = common.split_heads(proj(q, wq, bq), num_heads, hd)
        kh = common.split_heads(proj(k, wk, bk), num_heads, hd)
        scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(hd)
        if mask_bias is not None:
            scores = scores + mask_bias
        probs = torch.softmax(scores, dim=-1)

    # the value path under the epsilon rule
    def value_path(v_in):
        vh = common.split_heads(proj(v_in, wv, bv), num_heads, hd)
        out = torch.matmul(probs.to(vh.dtype), vh)
        return proj(common.merge_heads(out), w_out, b_out)

    return epsilon_rule(value_path, epsilon)(v)
