"""The port's conservation and NaN checks (lxt_tpu_torch.ops.check and the
AttributionModel methods' ``check=``) against lxt_tpu's, on CPU, float32.

- Under ``conservation_check()`` every rule's backward (the explicit ops,
  the generic explicit rules, the Gradient*Input rules) returns the same
  uniform redistribution as lxt_tpu's, within normalized L2 1e-6, also
  where an input is a constant (it takes its share of the mean).
- The mode is the one in force when a rule's forward ran (lxt_tpu reads
  its flags while tracing), whatever thread runs the backward.
- ``nan_check`` / ``checked`` raise "NaN/Inf relevance at rule backward"
  after one host read, and read nothing when every site is finite.
- ``conservation_error`` and ``assert_finite_relevance`` as lxt_tpu's; the
  explicit Llama's conservation error under the check (0.24 to 0.42 at
  this size: the causal mask, the rope tables and the scale take their
  shares, as in lxt_tpu) equals lxt_tpu's within 1e-4 (the fills' float32
  sums, see CONSERVATION_BAR).
- ``check=`` on attribute, attribute_multi, attribute_topk and
  attribute_response of a tiny Llama: maps within normalized L2 1e-5 of
  lxt_tpu's under ``'nan'`` and ``'conservation+nan'`` (whose maps are
  ``'conservation'``'s), ``'nan'`` bit-equal to ``None``, one host
  read a call, a NaN written into one ``wq`` raises, a bogus mode raises
  lxt_tpu's ValueError; remat on and off.
"""

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import lxt_tpu
import lxt_tpu_torch
from lxt_tpu import explicit as jex
from lxt_tpu.models import llama as jllama
from lxt_tpu.models import llama_explicit as jlex
from lxt_tpu.models import registry as jreg
from lxt_tpu.ops import check as jck
from lxt_tpu.ops import functional as jf
from lxt_tpu.ops import rules as jr
from lxt_tpu_torch import explicit as tex
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import llama as tllama
from lxt_tpu_torch.models import llama_explicit as tlex
from lxt_tpu_torch.models import registry as treg
from lxt_tpu_torch.ops import check as tck
from lxt_tpu_torch.ops import functional as tf
from lxt_tpu_torch.ops import rules as tr

BAR, MODEL_BAR = 1e-6, 1e-5  # normalized L2, float32
# the explicit Llama under the conservation check: each rule's fill is a
# float32 sum of the incoming fill, equal positive terms, which XLA's CPU
# reduction adds with a drift of ~4e-6 per op (torch's pairwise sum ~1e-7);
# over the model's ~20 rules the maps part by 1.5e-5
CONSERVATION_BAR = 1e-4
T, B, VOCAB = 16, 2, 97


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _rule(name, rng):
    """``(jax fn, torch fn, inputs, constant inputs)``: the constants are
    closed over on the JAX side and need no gradient on the port's."""
    def r(*s):
        return rng.standard_normal(s).astype(np.float32)

    w, b = r(8, 6), r(6)
    jw, jb, tw, tb = jnp.asarray(w), jnp.asarray(b), torch.from_numpy(w), torch.from_numpy(b)
    if name == "identity_rule":
        return (lambda x: jr.identity_rule(jax.nn.silu, x),
                lambda x: tr.identity_rule(F.silu, x), [r(3, 8)], [])
    if name == "divide_gradient":
        return (lambda x: jr.divide_gradient(x, 4), lambda x: tr.divide_gradient(x, 4),
                [r(3, 8)], [])
    if name == "gamma_linear":
        return (lambda x: jr.gamma_linear(x, jw, jb, 0.25),
                lambda x: tr.gamma_linear(x, tw, tb, 0.25), [r(3, 8)], [])
    if name == "alphabeta_linear":
        return (lambda x: jr.alphabeta_linear(x, jw, jb, 2.0, 1.0),
                lambda x: tr.alphabeta_linear(x, tw, tb, 2.0, 1.0), [r(3, 8)], [])
    if name == "modz_linear":
        return (lambda x: jr.modz_linear(x, jw, jb, ("flat",)),
                lambda x: tr.modz_linear(x, tw, tb, ("flat",)), [r(3, 8)], [])
    if name == "gamma_conv2d":
        cw, cb = r(3, 3, 2, 4), r(4)
        return (lambda x: jr.gamma_conv2d(x, jnp.asarray(cw), jnp.asarray(cb), (1, 1), "SAME"),
                lambda x: tr.gamma_conv2d(x, torch.from_numpy(cw), torch.from_numpy(cb),
                                          (1, 1), "SAME"), [r(1, 5, 5, 2)], [])
    if name == "softmax":
        return (lambda x: jf.softmax(x, -1), lambda x: tf.softmax(x, -1), [r(3, 8)], [])
    if name == "linear_epsilon":
        return (lambda x: jf.linear_epsilon(x, jw, jb),
                lambda x: tf.linear_epsilon(x, tw, tb), [r(3, 8)], [])
    if name == "matmul":
        return jf.matmul, tf.matmul, [r(2, 3, 4), r(2, 4, 5)], []
    if name == "add2_constant_mask":
        mask = np.where(np.tri(5, dtype=bool), 0.0, -np.inf).astype(np.float32)
        return (lambda x: jf.add2(x, jnp.asarray(mask)),
                lambda x: tf.add2(x, torch.from_numpy(mask)), [r(2, 5, 5)], [mask])
    if name == "mul2_constant_table":
        table = r(1, 6)
        return (lambda x: jf.mul2(x, jnp.asarray(table), 1),
                lambda x: tf.mul2(x, torch.from_numpy(table), 1), [r(3, 6)], [table])
    if name == "mean":
        return (lambda x: jf.mean(x, -1), lambda x: tf.mean(x, -1), [r(3, 8)], [])
    if name == "layer_norm":
        return (lambda x: jf.layer_norm(x, jb, jb),
                lambda x: tf.layer_norm(x, tb, tb), [r(3, 6)], [])
    if name == "rms_norm_identity":
        return (lambda x: jf.rms_norm_identity(x, jb),
                lambda x: tf.rms_norm_identity(x, tb), [r(3, 6)], [])
    if name == "normalize":
        return (lambda x: jf.normalize(x), lambda x: tf.normalize(x), [r(3, 6)], [])
    if name == "epsilon_rule":
        return (jex.epsilon_rule(lambda x: jnp.tanh(x @ jw)),
                tex.epsilon_rule(lambda x: torch.tanh(x @ tw)), [r(3, 8)], [])
    if name == "uniform_rule":
        return (jex.uniform_rule(lambda a, c: a * c),
                tex.uniform_rule(lambda a, c: a * c), [r(3, 6), r(3, 6)], [])
    if name == "taylor_decomposition":
        return (jex.taylor_decomposition(lambda x: x @ jw, ref=(jnp.zeros((3, 8)),)),
                tex.taylor_decomposition(lambda x: x @ tw, ref=(torch.zeros(3, 8),)),
                [r(3, 8)], [])
    if name == "identity_rule_fn":
        return (jex.identity_rule_fn(jnp.tanh), tex.identity_rule_fn(torch.tanh),
                [r(3, 8)], [])
    raise KeyError(name)


RULES = ["identity_rule", "divide_gradient", "gamma_linear", "alphabeta_linear",
         "modz_linear", "gamma_conv2d", "softmax", "linear_epsilon", "matmul",
         "add2_constant_mask", "mul2_constant_table", "mean", "layer_norm",
         "rms_norm_identity", "normalize", "epsilon_rule", "uniform_rule",
         "taylor_decomposition", "identity_rule_fn"]


@pytest.mark.parametrize("name", RULES)
def test_rule_redistribution_matches_lxt_tpu(name):
    rng = np.random.default_rng(RULES.index(name))
    jfn, tfn, inputs, _ = _rule(name, rng)
    with jck.conservation_check():
        jout, vjp = jax.vjp(jfn, *map(jnp.asarray, inputs))
        ct = rng.standard_normal(jout.shape).astype(np.float32)
        jrels = vjp(jnp.asarray(ct))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    with tck.conservation_check():
        tout = tfn(*xs)
        trels = torch.autograd.grad(tout, xs, torch.from_numpy(ct))
    for jrel, trel in zip(jrels, trels):
        assert trel.shape == jrel.shape and trel.dtype == torch.float32
        assert _nl2(trel, jrel) <= BAR, _nl2(trel, jrel)
        # a uniform fill: every element the same
        assert bool((trel == trel.flatten()[0]).all())


def _poisoned_linear(x):
    """A relevance that turns NaN at the linear_epsilon backward: at x = 0
    the output is exactly -epsilon, which makes the denominator 0."""
    return tf.linear_epsilon(x, torch.ones(4, 1), torch.tensor([-1e-6]))


def test_nan_check_raises_after_one_host_read():
    x = torch.zeros(1, 4, requires_grad=True)
    reads = tck.counters["host_reads"]
    with pytest.raises(RuntimeError, match="NaN/Inf relevance at rule backward: "
                                           "linear_epsilon"):
        with tck.nan_check():
            tck.checked(lambda: torch.autograd.grad(_poisoned_linear(x).sum(), x))()
    assert tck.counters["host_reads"] == reads + 1
    # no check: the NaN passes silently, and nothing is read
    (g,) = torch.autograd.grad(_poisoned_linear(x).sum(), x)
    assert not torch.isfinite(g).all() and tck.counters["host_reads"] == reads + 1


def test_nan_check_passes_finite_relevance_and_the_context_exit_reads_once():
    x = torch.randn(2, 6, requires_grad=True)
    reads = tck.counters["host_reads"]
    with tck.nan_check():
        (g,) = torch.autograd.grad(tf.softmax(tf.mean(x, -1, True) * x).sum(), x)
    assert torch.isfinite(g).all() and tck.counters["host_reads"] == reads + 1
    # nested contexts share the outer record: still one read
    with tck.nan_check(), tck.conservation_check(raise_on_nan=True):
        tck.checked(lambda: torch.autograd.grad(tf.softmax(x).sum(), x))()
    assert tck.counters["host_reads"] == reads + 2
    # the conservation check alone records nothing
    with tck.conservation_check():
        tck.checked(lambda: torch.autograd.grad(tf.softmax(x).sum(), x))()
    assert tck.counters["host_reads"] == reads + 2


def test_lxt_tpu_nan_check_raises_the_same_way():
    """The same poisoned linear under lxt_tpu's check raises its message."""
    def f(x):
        return jf.linear_epsilon(x, jnp.ones((4, 1)), jnp.asarray([-1e-6])).sum()

    with jck.nan_check(), pytest.raises(Exception, match="NaN/Inf relevance"):
        jck.checked(jax.grad(f))(jnp.zeros((1, 4)))


def test_mode_is_the_one_in_force_when_the_forward_ran():
    """Forward under the check, backward outside it (and on another
    thread): redistributed; forward outside, backward inside: not."""
    x = torch.randn(3, 5, requires_grad=True)
    ct = torch.randn(3, 5)
    with tck.conservation_check():
        out = tf.softmax(x)
    result = {}
    th = threading.Thread(target=lambda: result.update(
        g=torch.autograd.grad(out, x, ct)[0]))
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    assert torch.allclose(result["g"], torch.full_like(x, float(ct.sum()) / x.numel()))
    out = tf.softmax(x)
    with tck.conservation_check():
        (g,) = torch.autograd.grad(out, x, ct)
    assert not bool((g == g.flatten()[0]).all())


def test_conservation_error_and_assert_finite_match_lxt_tpu():
    rng = np.random.default_rng(3)
    rel, seed = rng.standard_normal((2, 7)).astype(np.float32), np.float32(2.5)
    got = tck.conservation_error(torch.from_numpy(rel), torch.tensor(seed))
    assert abs(float(got) - float(jck.conservation_error(rel, seed))) <= 1e-7
    assert float(tck.conservation_error(torch.ones(4), torch.tensor(4.0))) == 0.0
    bad = rel.copy()
    bad[0, 3] = np.nan
    bad[1, 1] = np.inf
    for check in (jck.assert_finite_relevance, tck.assert_finite_relevance):
        with pytest.raises(ValueError, match="NaN/Inf in relevance: 2/14 elements"):
            check(torch.from_numpy(bad) if check is tck.assert_finite_relevance else bad)
    assert tck.assert_finite_relevance(torch.from_numpy(rel)) is not None


# ---------------------------------------------------------------------------
# models: the explicit Llama's conservation error, and check= on the methods
# ---------------------------------------------------------------------------

CFG = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
           num_layers=2, num_heads=4, num_kv_heads=2)


@functools.lru_cache(maxsize=None)
def _tiny():
    rng = np.random.default_rng(0)
    L, D, I, hd = 2, 64, 128, 16

    def w(*s):
        return (0.1 * rng.standard_normal(s)).astype(np.float32)

    params = {"embed": w(VOCAB, D), "final_norm": 1 + w(D), "lm_head": w(D, VOCAB),
              "layers": dict(ln1=1 + w(L, D), ln2=1 + w(L, D), wq=w(L, D, 4 * hd),
                             wk=w(L, D, 2 * hd), wv=w(L, D, 2 * hd),
                             wo=w(L, 4 * hd, D), wg=w(L, D, I), wu=w(L, D, I),
                             wd=w(L, I, D))}
    return params, rng.integers(0, VOCAB, (B, T))


def _models(params, remat):
    jcfg = jllama.LlamaConfig(**CFG)
    jm = jreg.AttributionModel(family="llama", cfg=jcfg,
                               params=jax.tree.map(jnp.asarray, params),
                               composite=lxt_tpu.attnlrp,
                               _fns=jreg._family_table()["llama"])
    tm = treg.AttributionModel("llama", tllama.LlamaConfig(**dataclasses.asdict(jcfg)),
                               params_from_numpy(params, device="cpu"),
                               lxt_tpu_torch.attnlrp, remat=remat)
    return jm, tm


@pytest.mark.parametrize("composite", ["attnlrp", "cp_lrp"])
def test_explicit_llama_conservation_error_matches_lxt_tpu(composite, monkeypatch):
    """lxt_tpu's rotate_half given the port's permutation vjp (ROADMAP
    F11), as in tests/test_torch_explicit_models.py."""
    from tests.test_torch_explicit_models import _permuting_rotate_half
    monkeypatch.setattr(jlex, "_rotate_half", _permuting_rotate_half())
    params, ids = _tiny()
    jcfg = jllama.LlamaConfig(**CFG)
    jp = jax.tree.map(jnp.asarray, params)
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    tp = params_from_numpy(params, device="cpu")
    jc, tc = getattr(lxt_tpu, composite), getattr(lxt_tpu_torch, composite)
    with jck.conservation_check():
        jv, jrel = jlex.explicit_input_relevance(
            lambda e: lxt_tpu.select_logit(jlex.forward(jp, jcfg, e, jc).logits),
            jllama.embed(jp, jnp.asarray(ids)))
    with tck.conservation_check():
        tv, trel = tlex.explicit_input_relevance(
            lambda e: lxt_tpu_torch.select_logit(tlex.forward(tp, tcfg, e, tc).logits),
            tllama.embed(tp, torch.as_tensor(ids)))
    jerr = float(jck.conservation_error(jrel, jv))
    terr = float(tck.conservation_error(trel, tv))
    assert abs(terr - jerr) <= CONSERVATION_BAR, (terr, jerr)
    assert _nl2(trel, jrel) <= CONSERVATION_BAR


def _call(model, method, ids, check):
    if method == "attribute":
        return model.attribute(ids, check=check)
    if method == "attribute_multi":
        return model.attribute_multi(ids, [3, 41, 7], check=check)
    if method == "attribute_topk":
        return model.attribute_topk(ids, 3, check=check)
    return model.attribute_response(ids, T - 4, check=check)


METHODS = ["attribute", "attribute_multi", "attribute_topk", "attribute_response"]


@pytest.mark.parametrize("method", METHODS)
def test_check_modes_match_lxt_tpu(method):
    params, ids = _tiny()
    jm, tm = _models(params, remat=False)
    for check in ("nan", "conservation+nan"):   # 'conservation' maps: the same
        want = _call(jm, method, ids, check)
        got = _call(tm, method, ids, check)
        assert _nl2(got[-1], np.asarray(want[-1])) <= MODEL_BAR, (check, method)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_check_on_the_port_methods(method, remat):
    """'nan' gives check=None's map bit for bit with one host read; a NaN
    written into one wq raises; a bogus mode raises lxt_tpu's message."""
    params, ids = _tiny()
    _, tm = _models(params, remat)
    plain = _call(tm, method, ids, None)
    reads = tck.counters["host_reads"]
    nan = _call(tm, method, ids, "nan")
    assert tck.counters["host_reads"] == reads + 1
    assert torch.equal(nan[-1], plain[-1])
    cons = _call(tm, method, ids, "conservation")
    assert torch.isfinite(cons[-1]).all() and cons[-1].shape == plain[-1].shape
    with pytest.raises(ValueError, match=r"check must be one of \('nan', "
                                         r"'conservation', 'conservation\+nan'\) "
                                         r"or None, got 'nans'"):
        _call(tm, method, ids, "nans")
    wq = tm.params["layers"]["wq"]
    saved = wq[1, 5, 7].clone()
    wq[1, 5, 7] = float("nan")
    try:
        with pytest.raises(RuntimeError, match="NaN/Inf relevance at rule backward"):
            _call(tm, method, ids, "nan")
    finally:
        wq[1, 5, 7] = saved
    assert not tck.NAN_CHECK_FLAG[0] and not tck.CONSERVATION_CHECK_FLAG[0]
