"""lxt_tpu_torch rule primitives and composite sites against lxt_tpu, on CPU.

Each rule's forward and backward (the vjp with a random cotangent) is held
against ``jax.vjp`` of the lxt_tpu rule on the same numpy inputs, in
float32 and bfloat16 (as tests/test_rules.py checks the rules).
Tolerances: float32 1e-6 relative to the largest value (the same math,
other libraries); bfloat16 2**-7 of the largest value — two units in the
last place, since the two frameworks may round an intermediate differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lxt_tpu
import lxt_tpu_torch
from lxt_tpu.models.common import ACTIVATIONS as JACT
from lxt_tpu.ops import rules as jrules
from lxt_tpu_torch.models.common import ACTIVATIONS as TACT
from lxt_tpu_torch.ops import rules as trules

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7)}
COMPOSITES = ["attnlrp", "cp_lrp", "vanilla_gradient"]


def _arrays(seed, *shapes, shift=0.0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) + shift for s in shapes]


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def _vjp_both(jfn, tfn, inputs, ct, dtype):
    """(out, grads) of jfn under jax.vjp and of tfn under autograd, with
    the same inputs and cotangent cast to ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    jin = [jnp.asarray(a).astype(jdt) for a in inputs]
    jout, vjp = jax.vjp(jfn, *jin)
    jgrads = vjp(jnp.asarray(ct).astype(jdt))
    tin = [torch.tensor(a).to(tdt).requires_grad_(True) for a in inputs]
    tout = tfn(*tin)
    tgrads = [None] * len(tin)
    if tout.requires_grad:
        tgrads = torch.autograd.grad(tout, tin, torch.tensor(ct).to(tdt),
                                     allow_unused=True)
    tgrads = [torch.zeros_like(t) if g is None else g for g, t in zip(tgrads, tin)]
    return (jout, jgrads), (tout, tgrads)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_exact", "gelu_new",
                                 "relu", "tanh", "quick_gelu"])
def test_identity_rule_matches_jax(act, dtype):
    x, ct = _arrays(0, (8, 32), (8, 32), shift=0.5)
    (jo, jg), (to, tg) = _vjp_both(
        lambda a: jrules.identity_rule(JACT[act], a),
        lambda a: trules.identity_rule(TACT[act], a), [x], ct, dtype)
    tol = DTYPES[dtype][2]
    _close(to, jo, tol, "out")
    _close(tg[0], jg[0], tol, "grad")
    assert tg[0].dtype == DTYPES[dtype][1]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("factor", [2, 4])
def test_divide_gradient_matches_jax(factor, dtype):
    x, ct = _arrays(1, (4, 16), (4, 16))
    (jo, jg), (to, tg) = _vjp_both(
        lambda a: jrules.divide_gradient(a, factor),
        lambda a: trules.divide_gradient(a, factor), [x], ct, dtype)
    _close(to, jo, 0.0, "out")
    _close(tg[0], jg[0], 0.0, "grad")


def test_stop_gradient_matches_jax():
    x, ct = _arrays(2, (3, 5), (3, 5))
    (jo, jg), (to, tg) = _vjp_both(jrules.stop_gradient, trules.stop_gradient,
                                   [x], ct, "float32")
    _close(to, jo, 0.0)
    assert not np.any(np.asarray(jg[0])) and not torch.any(tg[0])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", COMPOSITES)
def test_composite_rms_norm_matches_jax(name, dtype):
    x, w, ct = _arrays(3, (2, 5, 64), (64,), (2, 5, 64))
    jc, tc = getattr(lxt_tpu, name), getattr(lxt_tpu_torch, name)
    (jo, jg), (to, tg) = _vjp_both(
        lambda a, b: jc.rms_norm(a, b, 1e-5), lambda a, b: tc.rms_norm(a, b, 1e-5),
        [x, w], ct, dtype)
    tol = DTYPES[dtype][2]
    _close(to, jo, tol, "out")
    for g, j, what in zip(tg, jg, ("dx", "dweight")):
        _close(g, j, tol if dtype == "bfloat16" else 1e-5, what)


@pytest.mark.parametrize("name", COMPOSITES)
def test_composite_gated_mul_and_qkv_match_jax(name):
    jc, tc = getattr(lxt_tpu, name), getattr(lxt_tpu_torch, name)
    g, u, ct = _arrays(4, (3, 40), (3, 40), (3, 40))
    (jo, jg), (to, tg) = _vjp_both(
        lambda a, b: jc.gated_mul(JACT["silu"], a, b),
        lambda a, b: tc.gated_mul(TACT["silu"], a, b), [g, u], ct, "float32")
    _close(to, jo, 1e-6, "gated_mul out")
    for t, j, what in zip(tg, jg, ("dgate", "dup")):
        _close(t, j, 1e-6, what)

    q, k, v = _arrays(5, (2, 4, 8), (2, 4, 8), (2, 4, 8))
    cts = _arrays(6, (2, 4, 8), (2, 4, 8), (2, 4, 8))
    jout, vjp = jax.vjp(jc.qkv, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(tuple(map(jnp.asarray, cts)))
    tin = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tout = tc.qkv(*tin)
    live = [(o, c) for o, c in zip(tout, cts) if o.requires_grad]
    tgrads = torch.autograd.grad([o for o, _ in live], tin,
                                 [torch.tensor(c) for _, c in live],
                                 allow_unused=True)
    for t, j, what in zip(tgrads, jgrads, "qkv"):
        t = torch.zeros(q.shape) if t is None else t
        _close(t, j, 0.0, f"d{what}")


@pytest.mark.parametrize("name", COMPOSITES)
def test_composite_layer_norm_and_mul_uniform_match_jax(name):
    jc, tc = getattr(lxt_tpu, name), getattr(lxt_tpu_torch, name)
    x, w, b, ct = _arrays(7, (3, 4, 32), (32,), (32,), (3, 4, 32))
    (jo, jg), (to, tg) = _vjp_both(
        lambda a, c, d: jc.layer_norm(a, c, d, 1e-5),
        lambda a, c, d: tc.layer_norm(a, c, d, 1e-5), [x, w, b], ct, "float32")
    _close(to, jo, 1e-6, "layer_norm out")
    for t, j, what in zip(tg, jg, ("dx", "dweight", "dbias")):
        _close(t, j, 1e-5, what)
    a, c, ct = _arrays(8, (5, 6), (5, 6), (5, 6))
    (jo, jg), (to, tg) = _vjp_both(jc.mul_uniform, tc.mul_uniform, [a, c], ct,
                                   "float32")
    _close(to, jo, 1e-6, "mul_uniform out")
    for t, j, what in zip(tg, jg, ("da", "db")):
        _close(t, j, 1e-6, what)


def test_select_logit_and_feature_relevance_match_jax():
    from lxt_tpu.attribution import input_relevance, select_logit
    logits, x = _arrays(9, (2, 3, 7), (2, 3, 7))
    tok = np.asarray([4, 1])
    for kw in ({}, {"token": tok}, {"position": 0}):
        want = select_logit(jnp.asarray(logits), **kw)
        got = lxt_tpu_torch.select_logit(torch.tensor(logits), **kw)
        _close(got, want, 1e-7, str(kw))
    # relevance of a quadratic target, per feature: x * d/dx (x**2 . logits)
    _, want = input_relevance(lambda e: (e * e * jnp.asarray(logits)).sum(),
                              jnp.asarray(x), sum_features=False)
    _, got = lxt_tpu_torch.input_relevance(
        lambda e: (e * e * torch.tensor(logits)).sum(), torch.tensor(x),
        sum_features=False)
    _close(got, want, 1e-6)


def test_linear_rejects_non_tensor_weights():
    with pytest.raises(NotImplementedError):
        lxt_tpu_torch.attnlrp.linear(torch.ones(2, 3), np.ones((3, 4)))
