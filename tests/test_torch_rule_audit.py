"""The port's rule audit (lxt_tpu_torch.rule_audit, an autograd-graph walk)
against lxt_tpu.audit (a jaxpr walk), on CPU: the cases of
tests/test_audit.py, each run through both packages on the same function
(and, for the models, the same numpy weights).

The verdicts are held, not the rows: which sites are unruled (their count
and ops, lxt_tpu's scanned layer body counting once per layer here, where
the layers are a Python loop), and whether ``on_unruled`` warns or raises.
Where the two differ by design it is said: the port has no "blocked"
entry (a detached value is no node of the graph) and judges a product as
a product wherever it stands, so a hand-written activation with a
product of two activation-derived factors is unruled in the port and
passes in lxt_tpu inside a jitted function of its own (the module
docstring's decision).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import lxt_tpu
import lxt_tpu_torch
from lxt_tpu.models import llama as jllama
from lxt_tpu.ops.rules import divide_gradient as j_divide
from lxt_tpu.ops.rules import identity_rule as j_identity
from lxt_tpu.rule_audit import audit as j_audit
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import llama as tllama
from lxt_tpu_torch.models import llama_explicit as tlex
from lxt_tpu_torch.ops.rules import divide_gradient as t_divide
from lxt_tpu_torch.ops.rules import identity_rule as t_identity
from lxt_tpu_torch.rule_audit import UnruledOpError, audit

# jaxpr primitive -> the port's autograd op of the same product
_OPS = {"mul": "mul", "div": "div", "dot_general": "bmm"}
L = 2


def _bad(entries):
    return [e for e in entries if not e.ok]


def _jbad(entries, layers=L):
    """lxt_tpu's unruled ops as the port counts them: the scanned body's
    once per layer."""
    ops = []
    for e in _bad(entries):
        ops += [_OPS.get(e.op, e.op)] * (layers if "scan" in e.site else 1)
    return sorted(ops)


def _run(fn, *args):
    return audit(fn, *args, on_unruled="ignore", verbose=False)


def _jrun(fn, *args):
    return j_audit(fn, *args, on_unruled="ignore", verbose=False)


def _llama(T=8, hd=None):
    jcfg = jllama.LlamaConfig(vocab_size=64, hidden_size=32 if hd is None else 2 * hd,
                              intermediate_size=64, num_layers=L, num_heads=2,
                              num_kv_heads=2)
    params = jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    e = np.random.default_rng(0).standard_normal((1, T, jcfg.hidden_size)).astype(np.float32)
    return (jcfg, jax.tree.map(jnp.asarray, params), jnp.asarray(e),
            tcfg, params_from_numpy(params, device="cpu"), torch.from_numpy(e))


@pytest.mark.parametrize("composite,impl,remat",
                         [("attnlrp", "einsum", False), ("attnlrp", "einsum", True),
                          ("cp_lrp", "einsum", False), ("vanilla_gradient", "einsum", False),
                          ("attnlrp", "flash", False), ("vanilla_gradient", "flash", True)])
def test_llama_verdicts_match_lxt_tpu(composite, impl, remat):
    """The unruled sites (none under attnlrp and cp_lrp; under
    vanilla_gradient the norms' products, the gated product and, on the
    einsum path, the two attention products) match lxt_tpu's, with remat
    on too; on the flash path (T 128, head dim 64) the attention is one
    "attention" site."""
    T, hd = (128, 64) if impl == "flash" else (8, None)
    jcfg, jp, je, tcfg, tp, te = _llama(T, hd)
    jc, tc = getattr(lxt_tpu, composite), getattr(lxt_tpu_torch, composite)
    want = _jrun(lambda x: jllama.forward(jp, jcfg, x, jc, attn_impl=impl).logits, je)
    got = _run(lambda x: tllama.forward(tp, tcfg, x, tc, remat=remat,
                                        attn_impl=impl).logits, te)
    assert sorted(e.op for e in _bad(got)) == _jbad(want)
    kinds = {e.kind for e in got}
    assert "linear" in kinds and ("rule" in kinds or composite != "attnlrp")
    if impl == "flash":
        assert sum(e.kind == "attention" for e in got) == L
    if composite == "vanilla_gradient" and impl == "flash":
        # chip_smoke.py phase 18 (d) holds the card to this count
        assert len(_bad(got)) == 12
    if composite == "attnlrp" and impl == "einsum":
        rules = " | ".join(e.rule for e in got)
        assert "uniform rule /k" in rules and "identity rule" in rules
        assert "operands rule-corrected" in rules and "product downstream" in rules
        assert "softmax Deep-Taylor" in rules


@pytest.mark.parametrize("family", ["gpt2", "bert", "mixtral", "vit"])
def test_family_default_composites_clean(family):
    """No unruled site in any family under its default composite, in
    either package."""
    if family == "gpt2":
        from lxt_tpu.models import gpt2 as jm
        from lxt_tpu_torch.models import gpt2 as tm
        cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                   max_positions=16)
        shape, comp = (1, 8, 32), "cp_lrp"
    elif family == "bert":
        from lxt_tpu.models import bert as jm
        from lxt_tpu_torch.models import bert as tm
        cfg = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                   num_layers=2, num_heads=2)
        shape, comp = (1, 8, 32), "attnlrp"
    elif family == "mixtral":
        from lxt_tpu.models import mixtral as jm
        from lxt_tpu_torch.models import mixtral as tm
        cfg = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
                   num_heads=2, num_kv_heads=2, num_experts=4, experts_per_token=2)
        shape, comp = (1, 8, 32), "attnlrp"
    else:
        from lxt_tpu.models import vit as jm
        from lxt_tpu_torch.models import vit as tm
        cfg = dict(image_size=32, patch_size=8, hidden_size=32, intermediate_size=64,
                   num_layers=2, num_heads=2, num_classes=10)
        shape, comp = (1, 32, 32, 3), "cp_lrp"
    jcfg = getattr(jm, [n for n in dir(jm) if n.endswith("Config")][0])(**cfg)
    tcfg = getattr(tm, [n for n in dir(tm) if n.endswith("Config")][0])(**cfg)
    params = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = params_from_numpy(params, device="cpu")
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = _jrun(lambda a: jm.forward(jax.tree.map(jnp.asarray, params), jcfg, a,
                                      getattr(lxt_tpu, comp)).logits, jnp.asarray(x))
    got = _run(lambda a: tm.forward(tp, tcfg, a, getattr(lxt_tpu_torch, comp)).logits,
               torch.from_numpy(x))
    assert got and not _bad(got) and not _bad(want)


@pytest.mark.parametrize("composite", ["attnlrp", "cp_lrp"])
def test_explicit_path_rules_recognized(composite):
    jcfg, jp, je, tcfg, tp, te = _llama()
    from lxt_tpu.models import llama_explicit as jlex
    want = _jrun(lambda x: jlex.forward(jp, jcfg, x, getattr(lxt_tpu, composite)).logits, je)
    got = _run(lambda x: tlex.forward(tp, tcfg, x, getattr(lxt_tpu_torch, composite)).logits, te)
    assert not _bad(got) and not _bad(want)
    rules = " | ".join(e.rule for e in got)
    assert "Prop 3.4" in rules and "Eq. 8" in rules
    if composite == "attnlrp":
        assert "Prop 3.3" in rules and "Prop 3.1" in rules
    else:
        assert "epsilon rule (explicit)" in rules


def _raw(x, w, lib):
    if lib == "jax":
        return ((x @ w) * jnp.tanh(x @ w)).sum()
    return ((x @ w) * torch.tanh(x @ w)).sum()


def test_raw_bilinear_flagged_warns_and_raises():
    w = np.ones((8, 8), np.float32)
    x = np.ones((4, 8), np.float32)
    want = _jrun(lambda a: _raw(a, jnp.asarray(w), "jax"), jnp.asarray(x))
    got = _run(lambda a: _raw(a, torch.from_numpy(w), "torch"), torch.from_numpy(x))
    assert [e.op for e in _bad(got)] == _jbad(want) == ["mul"]
    f = (lambda a: _raw(a, torch.from_numpy(w), "torch"))
    with pytest.raises(UnruledOpError, match="mul"):
        audit(f, torch.from_numpy(x), on_unruled="raise", verbose=False)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        audit(f, torch.from_numpy(x), on_unruled="warn", verbose=False)
    assert any("no LRP rule" in str(r.message) for r in rec)
    with pytest.raises(ValueError, match="on_unruled"):
        audit(f, torch.from_numpy(x), on_unruled="loud")


CASES = {
    # operands governed upstream
    "corrected_by_operands": (
        lambda x: (j_divide(x, 2) * j_divide(jnp.tanh(x), 2)).sum(),
        lambda x: (t_divide(x, 2) * t_divide(torch.tanh(x), 2)).sum(),
        "operands rule-corrected"),
    # the gated-MLP shape: the rule on the product
    "corrected_downstream": (
        lambda x: j_divide(j_identity(jax.nn.silu, x) * x, 2).sum(),
        lambda x: t_divide(t_identity(F.silu, x) * x, 2).sum(),
        "product downstream"),
    # a chained a*b*c with one /2 keeps the inner product flagged
    "chained_bilinear": (
        lambda x: j_divide(jnp.tanh(x) * jnp.sin(x) * jnp.cos(x), 2).sum(),
        lambda x: t_divide(torch.tanh(x) * torch.sin(x) * torch.cos(x), 2).sum(),
        None),
    "direct_pair_corrected": (
        lambda x: j_divide(jnp.tanh(x) * jnp.sin(x), 2).sum(),
        lambda x: t_divide(torch.tanh(x) * torch.sin(x), 2).sum(),
        "product downstream"),
    # x*x feeding only a stop-gradient path: dead to relevance
    "dead_to_relevance": (
        lambda x: (x * jax.lax.rsqrt(jax.lax.stop_gradient(
            (x * x).mean(-1, keepdims=True)) + 1e-6)).sum(),
        lambda x: (x * torch.rsqrt((x * x).mean(-1, keepdim=True).detach()
                                   + 1e-6)).sum(),
        None),
    # x * x.sum(): a product through a reduction
    "structural_product": (
        lambda x: jax.jit(lambda a: a * a.sum())(x).sum(),
        lambda x: (x * x.sum()).sum(), None),
    "softmax_written_out": (
        lambda x: (lambda e: e / e.sum(-1, keepdims=True))(jnp.exp(x)).sum(),
        lambda x: (lambda e: e / e.sum(-1, keepdim=True))(torch.exp(x)).sum(),
        "softmax Deep-Taylor"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_primitive_verdicts_match_lxt_tpu(name):
    jfn, tfn, rule = CASES[name]
    x = np.linspace(-1, 1, 32, dtype=np.float32).reshape(4, 8)
    want = _jrun(jfn, jnp.asarray(x))
    got = _run(tfn, torch.from_numpy(x))
    assert sorted(e.op for e in _bad(got)) == _jbad(want), (got, want)
    if rule is not None:
        assert any(rule in e.rule for e in got), got


def test_linear_with_weight_is_implicit_epsilon_and_exports():
    w = torch.ones(8, 4)
    entries = lxt_tpu_torch.audit(lambda x: (x @ w).sum(), torch.ones(2, 8),
                                  verbose=False)
    want = _jrun(lambda x: (x @ jnp.ones((8, 4))).sum(), jnp.ones((2, 8)))
    assert [e.kind for e in entries] == [e.kind for e in want] == ["linear"]
    e = entries[0]
    assert e.ok and e.op == "mm" and e.shape == "float32[2, 4]"
    assert e.site.startswith("test_torch_rule_audit.py:")
    assert {f.name for f in dataclasses.fields(e)} == {"site", "op", "shape", "kind",
                                                       "rule", "ok"}
    assert isinstance(e.row(), str)
    assert lxt_tpu_torch.UnruledOpError is UnruledOpError
    assert lxt_tpu_torch.AuditEntry is type(e)


@pytest.mark.parametrize("spec", ["flat", "wsquare", ("zbox", 0.0, 1.0), ("gamma", 0.25),
                                  ("alphabeta", 2.0, 1.0)])
def test_linear_rules_recognized(spec):
    from lxt_tpu.composites import Composite as JComposite
    w = np.ones((8, 4), np.float32)
    jc = JComposite(name="t").with_rules(linear=spec)
    tc = lxt_tpu_torch.Composite(name="t").with_rules(linear=spec)
    want = _jrun(lambda x: jc.linear(x, jnp.asarray(w)).sum(), jnp.ones((2, 8)))
    got = _run(lambda x: tc.linear(x, torch.from_numpy(w)).sum(), torch.ones(2, 8))
    assert [(e.kind, e.rule) for e in got] == [(e.kind, e.rule) for e in want]


def test_hand_written_activation_is_a_product_in_the_port():
    """The decision of the module docstring: lxt_tpu passes a jitted
    x * tanh(softplus(x) + 0.3) as a nonlinearity; the port flags its
    product, and passes it under identity_rule."""
    w = np.full((8, 8), 0.1, np.float32)

    @jax.jit
    def act(x):
        return x * jnp.tanh(jax.nn.softplus(x) + 0.3)

    def t_act(x):
        return x * torch.tanh(F.softplus(x) + 0.3)

    want = _jrun(lambda x: act(x @ jnp.asarray(w)).sum(), jnp.ones((2, 8)))
    assert not _bad(want) and any(e.kind == "nonlinearity" for e in want)
    tw = torch.from_numpy(w)
    assert [e.op for e in _bad(_run(lambda x: t_act(x @ tw).sum(), torch.ones(2, 8)))] == ["mul"]
    assert not _bad(_run(lambda x: t_identity(t_act, x @ tw).sum(), torch.ones(2, 8)))


def test_a_rule_is_known_by_its_function_not_its_name():
    """The audit reads the ``lrp_rule`` a Function declares, so a rule
    Function under another name is still a rule, and a Function that
    declares none is judged by the products it leaves in the graph."""
    from lxt_tpu_torch.ops import functional as lf

    class RenamedMul2(lf._Mul2):
        pass

    class Undeclared(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return a * b

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensors
            return g * b, g * a

    w = torch.full((8, 8), 0.1)
    ruled = _run(lambda x: RenamedMul2.apply(x @ w, torch.tanh(x @ w), 2).sum(),
                 torch.ones(2, 8))
    assert not _bad(ruled)
    assert [(e.op, e.rule) for e in ruled if e.kind == "rule"] == [
        ("RenamedMul2", lf._Mul2.lrp_rule[1])]
    unruled = _run(lambda x: (x @ w * torch.tanh(x @ w)).sum(), torch.ones(2, 8))
    assert [e.op for e in _bad(unruled)] == ["mul"]
    plain = _run(lambda x: Undeclared.apply(x @ w, torch.tanh(x @ w)).sum(),
                 torch.ones(2, 8))
    assert all(e.kind != "rule" for e in plain)
