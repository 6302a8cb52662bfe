"""The port's generic explicit rules (lxt_tpu_torch.explicit) against
lxt_tpu.explicit, on CPU, float32, and against the closed-form ops, as
tests/test_explicit.py holds lxt_tpu's.

Each rule runs forward and backward on the same numpy inputs in both
packages: outputs and input relevances within normalized L2 1e-6 in
float32, the cotangent ``out * c`` with ``c`` standard normal, as in
tests/test_torch_functional.py. The rules whose backward pulls a nested
vector-Jacobian product of ``fn`` (the epsilon rule over any fn, the
Taylor decomposition) divide by the output or by ``J(ref) x``, where two
float32 matmuls summing in another order already differ (1.1e-6 at the
epsilon rule over tanh, 1.5e-5 at the Taylor decomposition): they are held
in float64 with an independent cotangent, within 1e-12; CP-LRP attention,
an epsilon rule over three products whose scores both packages compute in
float32 whatever the input, within 1e-5 in float32 (1.05e-6 at v). Also:
the rules' own identities (epsilon rule == linear_epsilon, the uniform
epsilon rule == lf.matmul, Taylor == epsilon on a linear fn), CP-LRP
attention's relevance reaching v alone, and the nested vector-Jacobian
product on another thread than the forward's.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lxt_tpu.explicit as jex
import lxt_tpu_torch.explicit as tex
from lxt_tpu_torch.models import common
from lxt_tpu_torch.ops import functional as tf

BAR, BAR64, MODEL_BAR = 1e-6, 1e-12, 1e-5  # normalized L2


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / (den if den > 0 else 1.0)


def _case(name, rng, dtype):
    """``(jax fn, torch fn, inputs)``, the arrays in ``dtype``."""
    def r(*s, scale=1.0):
        return (scale * rng.standard_normal(s)).astype(dtype)

    w = r(10, 5)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    if name == "epsilon_rule":
        return (jex.epsilon_rule(lambda a: jnp.tanh(a @ jw), 1e-6),
                tex.epsilon_rule(lambda a: torch.tanh(a @ tw), 1e-6), [r(16, 10)])
    if name == "uniform_epsilon_rule":
        return (jex.uniform_epsilon_rule(jnp.matmul, 2, 1e-9),
                tex.uniform_epsilon_rule(torch.matmul, 2, 1e-9),
                [r(2, 6, 8), r(2, 8, 4)])
    if name == "uniform_rule":
        return (jex.uniform_rule(lambda a, b: a * b), tex.uniform_rule(lambda a, b: a * b),
                [r(4, 3), r(4, 3)])
    if name == "uniform_rule_broadcast_n3":
        return (jex.uniform_rule(lambda a, b: a * b, 3),
                tex.uniform_rule(lambda a, b: a * b, 3), [r(4, 3), r(1, 3)])
    if name == "identity_rule_fn":
        return (jex.identity_rule_fn(jnp.tanh), tex.identity_rule_fn(torch.tanh),
                [r(3, 4)])
    if name == "taylor_decomposition":
        ref = r(8, 10, scale=0.1)
        return (jex.taylor_decomposition(lambda a: jnp.tanh(a @ jw), ref=(jnp.asarray(ref),)),
                tex.taylor_decomposition(lambda a: torch.tanh(a @ tw),
                                         ref=(torch.from_numpy(ref),)), [r(8, 10)])
    if name == "taylor_decomposition_bias":
        b = r(5)
        return (jex.taylor_decomposition(lambda a: a @ jw + jnp.asarray(b),
                                         ref=(jnp.zeros((8, 10), jw.dtype),), bias=True),
                tex.taylor_decomposition(lambda a: a @ tw + torch.from_numpy(b),
                                         ref=(torch.zeros(8, 10, dtype=tw.dtype),),
                                         bias=True),
                [r(8, 10)])
    if name == "softmax_dt":
        return jex.softmax_dt(2.0), tex.softmax_dt(2.0), [r(4, 8)]
    if name == "multi_head_attention_cp":
        B, T, D, H = 2, 6, 16, 4
        w_qkv, b_qkv = r(D, 3 * D, scale=0.3), r(3 * D, scale=0.1)
        w_out, b_out = r(D, D, scale=0.3), r(D, scale=0.1)
        mask = np.where(np.tri(T, dtype=bool), 0.0, -np.inf).astype(np.float32)
        jargs = [jnp.asarray(a) for a in (w_qkv, b_qkv, w_out, b_out, mask)]
        targs = [torch.from_numpy(a) for a in (w_qkv, b_qkv, w_out, b_out, mask)]
        return (lambda q, k, v: jex.multi_head_attention_cp(q, k, v, H, *jargs[:4],
                                                            mask_bias=jargs[4]),
                lambda q, k, v: tex.multi_head_attention_cp(q, k, v, H, *targs[:4],
                                                            mask_bias=targs[4]),
                [r(B, T, D), r(B, T, D), r(B, T, D)])
    raise KeyError(name)


CASES = ["uniform_epsilon_rule", "uniform_rule", "uniform_rule_broadcast_n3",
         "identity_rule_fn", "softmax_dt"]
NESTED = ["epsilon_rule", "taylor_decomposition", "taylor_decomposition_bias"]


def _both(name, dtype=np.float32, proportional=True):
    rng = np.random.default_rng((CASES + NESTED + ["multi_head_attention_cp"]).index(name))
    jfn, tfn, inputs = _case(name, rng, dtype)
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, inputs))
    ct = rng.standard_normal(jout.shape).astype(dtype)
    if proportional:
        ct = ct * np.asarray(jout)
    jrels = vjp(jnp.asarray(ct))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    tout = tfn(*xs)
    trels = torch.autograd.grad(tout, xs, torch.from_numpy(ct), allow_unused=True)
    return jout, tout, jrels, trels


def _check(name, bar, **kw):
    jout, tout, jrels, trels = _both(name, **kw)
    assert _nl2(tout.detach(), jout) <= bar
    for i, (jr, tr) in enumerate(zip(jrels, trels)):
        tr = torch.zeros(jr.shape) if tr is None else tr
        assert tr.shape == jr.shape and tr.dtype == tout.dtype, (i, tr.shape, jr.shape)
        assert _nl2(tr, jr) <= bar, (i, _nl2(tr, jr))


@pytest.mark.parametrize("name", CASES)
def test_rule_matches_lxt_tpu(name):
    _check(name, BAR)


@pytest.mark.parametrize("name", NESTED)
def test_nested_vjp_rule_matches_lxt_tpu_in_float64(name):
    with jax.enable_x64(True):
        _check(name, BAR64, dtype=np.float64, proportional=False)


def test_multi_head_attention_cp_matches_lxt_tpu():
    """An epsilon rule over the value path (three products), whose scores
    both packages compute in float32 whatever the input: float32, 1e-5."""
    _check("multi_head_attention_cp", MODEL_BAR)


def _rel(fn, inputs, ct):
    xs = [x.detach().requires_grad_(True) for x in inputs]
    return torch.autograd.grad(fn(*xs), xs, ct)


def test_epsilon_rule_is_linear_epsilon_and_uniform_epsilon_is_matmul():
    """The reference's tests/test_rules.py identities, in the port."""
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(16, 10, generator=g), torch.randn(10, 5, generator=g)
    ct = (x @ w) * torch.randn(16, 5, generator=g)
    (a,) = _rel(tex.epsilon_rule(lambda t: t @ w, 1e-9), [x], ct)
    (b,) = _rel(lambda t: tf.linear_epsilon(t, w, None, 1e-9), [x], ct)
    assert _nl2(a, b) <= BAR
    p, q = torch.randn(2, 6, 8, generator=g), torch.randn(2, 8, 4, generator=g)
    ct = (p @ q) * torch.randn(2, 6, 4, generator=g)
    ra = _rel(tex.uniform_epsilon_rule(torch.matmul, 2, 1e-9), [p, q], ct)
    rb = _rel(lambda s, t: tf.matmul(s, t, 1e-9), [p, q], ct)
    assert all(_nl2(u, v) <= BAR for u, v in zip(ra, rb))


def test_taylor_of_a_linear_fn_is_the_epsilon_rule_and_stop_blocks():
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(8, 6, generator=g), torch.randn(6, 6, generator=g)
    ct = (x @ w) * torch.randn(8, 6, generator=g)
    (a,) = _rel(tex.taylor_decomposition(lambda t: t @ w, ref=(torch.zeros(8, 6),)), [x], ct)
    (b,) = _rel(tex.epsilon_rule(lambda t: t @ w, 1e-6), [x], ct)
    assert _nl2(a, b) <= 1e-5
    y = torch.linspace(-1, 1, 12).reshape(3, 4).requires_grad_(True)
    out = tex.stop_relevance_rule(torch.tanh)(y)
    assert not out.requires_grad
    (r,) = _rel(tex.identity_rule_fn(torch.tanh), [y], torch.ones(3, 4))
    assert torch.equal(r, torch.ones(3, 4))


def test_multi_head_attention_cp_forward_and_relevance_on_v_alone():
    """The forward equals plain fused attention; relevance reaches v only."""
    g = torch.Generator().manual_seed(4)
    B, T, D, H = 2, 6, 16, 4
    q = torch.randn(B, T, D, generator=g)
    w_qkv, b_qkv = 0.3 * torch.randn(D, 3 * D, generator=g), 0.1 * torch.randn(3 * D, generator=g)
    w_out, b_out = 0.3 * torch.randn(D, D, generator=g), 0.1 * torch.randn(D, generator=g)
    wq, wk, wv = w_qkv.chunk(3, -1)
    bq, bk, bv = b_qkv.chunk(3)
    hd = D // H
    qh, kh, vh = (common.split_heads(q @ a + c, H, hd)
                  for a, c in ((wq, bq), (wk, bk), (wv, bv)))
    p = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(hd), -1)
    want = common.merge_heads(p @ vh) @ w_out + b_out
    xs = [q.clone().requires_grad_(True) for _ in range(3)]
    out = tex.multi_head_attention_cp(*xs, H, w_qkv, b_qkv, w_out, b_out)
    assert _nl2(out.detach(), want) <= BAR
    rq, rk, rv = torch.autograd.grad(out, xs, torch.randn(B, T, D, generator=g),
                                     allow_unused=True)
    assert rq is None and rk is None and rv.abs().sum() > 0


def test_nested_vjp_runs_on_another_thread():
    """The epsilon and Taylor rules pull a nested vjp inside their backward,
    which the autograd engine may run on a thread of its own (on CUDA it
    does): the same relevance from a backward on another thread."""
    g = torch.Generator().manual_seed(2)
    x, w = torch.randn(4, 6, generator=g), torch.randn(6, 3, generator=g)
    ct = torch.tanh(x @ w) * torch.randn(4, 3, generator=g)
    for rule in (tex.epsilon_rule(lambda t: torch.tanh(t @ w)),
                 tex.taylor_decomposition(lambda t: torch.tanh(t @ w),
                                          ref=(0.1 * torch.ones(4, 6),))):
        here = _rel(rule, [x], ct)[0]
        xs = x.clone().requires_grad_(True)
        out, got = rule(xs), {}
        th = threading.Thread(target=lambda: got.update(
            r=torch.autograd.grad(out, xs, ct)[0]))
        th.start()
        th.join(timeout=60)
        assert not th.is_alive() and torch.equal(got["r"], here)
