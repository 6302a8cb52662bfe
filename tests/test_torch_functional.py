"""The port's explicit relevance ops (lxt_tpu_torch.ops.functional) against
lxt_tpu.ops.functional, on CPU, in float32.

Each op runs forward on the same numpy inputs (seeded) in both packages,
then its backward with one random cotangent (the output relevance): the
outputs and every input relevance must agree within normalized L2 1e-6,
including the softmax's -inf mask positions (relevance exactly 0 there),
broadcast operands of add2 / mul2 and a Python-scalar factor of mul2.

In float32 the cotangent is ``out * c`` with ``c`` standard normal: the
shape in which relevance arrives at an op (proportional to the output's
contributions). The epsilon rules divide by ``out + eps``; a cotangent
independent of ``out`` puts entries with ``|out|`` near 1e-3 into that
division, where the two libraries' float32 matmuls, summing in another
order, already differ (6.3e-6 normalized L2 at ``linear_epsilon``). The
independent cotangent is held in float64, where the same formulas agree
within 1e-12 (the ops that compute in float32 whatever their input, the
softmax and the RMSNorm, hold it in float32 at 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lxt_tpu.ops.functional as jf
import lxt_tpu_torch.ops.functional as tf

BAR = 1e-6  # normalized L2, float32
BAR64 = 1e-12  # normalized L2, float64


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / (den if den > 0 else 1.0)


_DTYPE = {np.float32: (jnp.float32, torch.float32),
          np.float64: (jnp.float64, torch.float64)}


def _case(name, rng, dtype):
    """``(jax fn, torch fn, inputs, which inputs carry relevance)``, the
    arrays (inputs and closed-over weights) in ``dtype``."""

    def _randn(rng, *shape):
        return rng.standard_normal(shape).astype(dtype)

    if name == "softmax":
        return (lambda x: jf.softmax(x, -1), lambda x: tf.softmax(x, -1),
                [_randn(rng, 3, 5, 9)], [0])
    if name == "softmax_neg_inf_mask":
        x = _randn(rng, 2, 4, 7)
        x[..., 2] = -np.inf
        x[1, :, 5] = -np.inf
        return (lambda x: jf.softmax(x, -1), lambda x: tf.softmax(x, -1), [x], [0])
    if name == "softmax_temperature_dim1":
        return (lambda x: jf.softmax(x, 1, 2.0), lambda x: tf.softmax(x, 1, 2.0),
                [_randn(rng, 3, 6, 4)], [0])
    if name == "linear_epsilon":
        w, b = _randn(rng, 8, 6), _randn(rng, 6)
        return (lambda x: jf.linear_epsilon(x, jnp.asarray(w), jnp.asarray(b)),
                lambda x: tf.linear_epsilon(x, torch.from_numpy(w), torch.from_numpy(b)),
                [_randn(rng, 2, 5, 8)], [0])
    if name == "linear_epsilon_no_bias":
        w = _randn(rng, 8, 6)
        return (lambda x: jf.linear_epsilon(x, jnp.asarray(w)),
                lambda x: tf.linear_epsilon(x, torch.from_numpy(w)),
                [_randn(rng, 4, 8)], [0])
    if name == "matmul":
        return (jf.matmul, tf.matmul,
                [_randn(rng, 2, 3, 5, 8), _randn(rng, 2, 3, 8, 4)], [0, 1])
    if name == "baddbmm":
        return (jf.baddbmm, tf.baddbmm,
                [_randn(rng, 4), _randn(rng, 2, 5, 8), _randn(rng, 2, 8, 4)],
                [0, 1, 2])
    if name == "add2":
        return (jf.add2, tf.add2, [_randn(rng, 3, 5, 8), _randn(rng, 3, 5, 8)], [0, 1])
    if name == "add2_broadcast":
        return (jf.add2, tf.add2, [_randn(rng, 3, 5, 8), _randn(rng, 3, 1, 8)], [0, 1])
    if name == "mul2":
        return (jf.mul2, tf.mul2, [_randn(rng, 4, 6), _randn(rng, 4, 6)], [0, 1])
    if name == "mul2_one_input_broadcast":
        return (lambda a, b: jf.mul2(a, b, 1), lambda a, b: tf.mul2(a, b, 1),
                [_randn(rng, 2, 4, 6), _randn(rng, 1, 6)], [0, 1])
    if name == "mul2_python_scalar":
        return (lambda a: jf.mul2(a, 0.125, 1), lambda a: tf.mul2(a, 0.125, 1),
                [_randn(rng, 3, 7)], [0])
    if name == "mean":
        return (lambda x: jf.mean(x, -1), lambda x: tf.mean(x, -1),
                [_randn(rng, 3, 5, 6)], [0])
    if name == "mean_keepdim_dim1":
        return (lambda x: jf.mean(x, 1, True), lambda x: tf.mean(x, 1, True),
                [_randn(rng, 3, 5, 6)], [0])
    if name == "layer_norm":
        w, b = 1 + 0.1 * _randn(rng, 8), 0.1 * _randn(rng, 8)
        return (lambda x: jf.layer_norm(x, jnp.asarray(w), jnp.asarray(b)),
                lambda x: tf.layer_norm(x, torch.from_numpy(w), torch.from_numpy(b)),
                [_randn(rng, 2, 5, 8)], [0])
    if name == "layer_norm_no_affine":
        return (lambda x: jf.layer_norm(x, None, None, 1e-6),
                lambda x: tf.layer_norm(x, None, None, 1e-6),
                [_randn(rng, 4, 8)], [0])
    if name == "rms_norm_identity":
        w = 1 + 0.1 * _randn(rng, 8)
        return (lambda x: jf.rms_norm_identity(x, jnp.asarray(w)),
                lambda x: tf.rms_norm_identity(x, torch.from_numpy(w)),
                [_randn(rng, 2, 5, 8)], [0])
    if name == "normalize":
        return (lambda x: jf.normalize(x, 2.0, 1),
                lambda x: tf.normalize(x, 2.0, 1), [_randn(rng, 4, 6)], [0])
    raise KeyError(name)


CASES = ["softmax", "softmax_neg_inf_mask", "softmax_temperature_dim1",
         "linear_epsilon", "linear_epsilon_no_bias", "matmul", "baddbmm", "add2",
         "add2_broadcast", "mul2", "mul2_one_input_broadcast",
         "mul2_python_scalar", "mean", "mean_keepdim_dim1", "layer_norm",
         "layer_norm_no_affine", "rms_norm_identity", "normalize"]


def vjp_pair(name, seed, dtype=np.float32, proportional=True):
    """Both packages' outputs and input relevances for ``name``: the
    cotangent ``out * c`` (``proportional``) or ``c``, ``c`` standard
    normal."""
    rng = np.random.default_rng(seed)
    jfn, tfn, inputs, rel_idx = _case(name, rng, dtype)
    jdt = _DTYPE[dtype][0]
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, inputs))
    ct = rng.standard_normal(jout.shape).astype(dtype)
    if proportional:
        ct = ct * np.asarray(jout)
    jrels = vjp(jnp.asarray(ct, jdt))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    tout = tfn(*xs)
    trels = torch.autograd.grad(tout, xs, torch.from_numpy(ct))
    return (jout, tout), [(np.asarray(jrels[i]), trels[i]) for i in rel_idx]


def _check(name, dtype, proportional, bar):
    (jout, tout), rels = vjp_pair(name, CASES.index(name), dtype, proportional)
    assert tuple(tout.shape) == jout.shape and tout.dtype == _DTYPE[dtype][1]
    assert _nl2(tout.detach(), jout) <= bar
    for i, (jr, tr) in enumerate(rels):
        assert tr.shape == jr.shape and tr.dtype == tout.dtype, (i, tr.shape, jr.shape)
        assert _nl2(tr, jr) <= bar, (i, _nl2(tr, jr))


@pytest.mark.parametrize("name", CASES)
def test_op_forward_and_vjp_match_lxt_tpu(name):
    _check(name, np.float32, True, BAR)


@pytest.mark.parametrize("name", CASES)
def test_op_vjp_of_an_independent_cotangent_matches_lxt_tpu(name):
    """float64, but the ops that compute in float32 whatever the input
    (the softmax, the RMSNorm statistics), which keep float32 and BAR."""
    if name.startswith(("softmax", "rms_norm")):
        _check(name, np.float32, False, BAR)
        return
    with jax.enable_x64(True):
        _check(name, np.float64, False, BAR64)


def test_softmax_mask_positions_get_zero_relevance():
    _, [(_, tr)] = vjp_pair("softmax_neg_inf_mask", 1, proportional=False)
    assert torch.isfinite(tr).all()
    assert (tr[..., 2] == 0).all() and (tr[1, :, 5] == 0).all()


def test_weights_get_no_gradient():
    """Weights and biases receive no relevance (lxt_tpu returns zeros)."""
    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(4, 5, requires_grad=True)
    b = torch.randn(5, requires_grad=True)
    tf.linear_epsilon(x, w, b).sum().backward()
    assert x.grad is not None and w.grad is None and b.grad is None


def test_bf16_relevance_keeps_the_input_dtype():
    """A bf16 input's relevance comes back in bf16, also where the op
    computes in float32 (the softmax) or promotes (a float32 table)."""
    x = torch.randn(2, 3, 8, dtype=torch.bfloat16, requires_grad=True)
    table = torch.randn(3, 8)
    out = tf.mul2(tf.softmax(x, -1).to(x.dtype), table, 1)
    (g,) = torch.autograd.grad(out.sum(), x)
    assert out.dtype == torch.float32 and g.dtype == torch.bfloat16
