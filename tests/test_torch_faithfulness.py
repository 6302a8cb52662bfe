"""The port's faithfulness evaluation (lxt_tpu_torch.utils.faithfulness)
against lxt_tpu.utils.faithfulness, on CPU.

Both packages get the same logit function (a tiny float32 Llama, 2 layers,
D 64, T 128, on the same numpy weights; the port on its einsum and flash
paths) and the SAME relevance array, so they rank the tokens identically:
MoRF / LeRF curves, AUC, AOPC and the report's ABPC must agree within
normalized L2 <= 1e-5; the fractions must be bit-equal to
``jnp.linspace``. The random order comes from a torch.Generator (JAX's PRNG
stream cannot be reproduced) and is held by its contract. Also: padding is
never ablated, the mean baseline averages valid positions only, exact ties
keep token order, and k = round(frac * n_valid) rounds half to even as
JAX does (n_valid 5, steps 10).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lxt_tpu
import lxt_tpu_torch
from lxt_tpu.models import llama as jllama
from lxt_tpu.utils import faithfulness as jf
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import llama as tllama
from lxt_tpu_torch.utils import faithfulness as tf

BAR = 1e-5
T, B = 128, 2


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@functools.lru_cache(maxsize=None)
def _tiny():
    rng = np.random.default_rng(2)
    jcfg = jllama.LlamaConfig(vocab_size=97, hidden_size=64,
                              intermediate_size=128, num_layers=2,
                              num_heads=4, num_kv_heads=2)
    L, D, I, hd = 2, 64, 128, jcfg.hd

    def w(*s):
        return (0.1 * rng.standard_normal(s)).astype(np.float32)

    params = {"embed": w(97, D), "final_norm": 1 + w(D), "lm_head": w(D, 97),
              "layers": dict(ln1=1 + w(L, D), ln2=1 + w(L, D), wq=w(L, D, 4 * hd),
                             wk=w(L, D, 2 * hd), wv=w(L, D, 2 * hd),
                             wo=w(L, 4 * hd, D), wg=w(L, D, I), wu=w(L, D, I),
                             wd=w(L, I, D))}
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_numpy(params, device="cpu")
    ids = rng.integers(0, 97, (B, T))
    rel = rng.standard_normal((B, T)).astype(np.float32)
    return (jcfg, jp, jllama.embed(jp, jnp.asarray(ids)), tllama.LlamaConfig(
        **dataclasses.asdict(jcfg)), tp, tllama.embed(tp, torch.as_tensor(ids)), rel)


def _logit_fns(impl):
    """(lxt_tpu, port) ``embeds -> [B]`` logits of token 7 at the last
    position, under attnlrp."""
    jcfg, jp, _, tcfg, tp, _, _ = _tiny()

    def j(e):
        return jllama.forward(jp, jcfg, e, lxt_tpu.attnlrp, remat=False,
                              attn_impl="einsum", logits_at=-1).logits[:, -1, 7]

    def t(e):
        return tllama.forward(tp, tcfg, e, lxt_tpu_torch.attnlrp, remat=False,
                              attn_impl=impl, logits_at=-1).logits[:, -1, 7]

    return j, t


def _curve_close(got, want):
    assert torch.equal(got.fractions, torch.from_numpy(np.array(want.fractions)))
    assert _nl2(got.values, want.values) <= BAR
    assert _nl2(got.aopc, want.aopc) <= BAR


@pytest.mark.parametrize("order", ["morf", "lerf"])
@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_perturbation_curve_matches_lxt_tpu(impl, order):
    j, t = _logit_fns(impl)
    _, _, je, _, _, te, rel = _tiny()
    mask = np.ones((B, T), bool)
    mask[1, :40] = False
    for kw in ({}, {"baseline": "mean", "valid_mask": mask}):
        want = jf.perturbation_curve(j, je, jnp.asarray(rel), steps=6,
                                     order=order, **kw)
        got = tf.perturbation_curve(t, te, torch.from_numpy(rel), steps=6,
                                    order=order, **kw)
        _curve_close(got, want)


def test_random_order_contract():
    """The random control: the unperturbed start equals MoRF's, the curve's
    shape, and the same generator seed giving the same curve."""
    _, t = _logit_fns("einsum")
    _, _, _, _, _, te, rel = _tiny()
    rel = torch.from_numpy(rel)

    def curve(seed=None):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return tf.perturbation_curve(t, te, rel, steps=5, order="random",
                                     generator=gen)

    morf = tf.perturbation_curve(t, te, rel, steps=5, order="morf")
    a, b, c, default = curve(3), curve(3), curve(4), curve()
    assert a.values.shape == (6, B) and a.aopc.shape == (B,)
    assert torch.equal(a.values[0], morf.values[0])
    assert torch.equal(a.values, b.values)
    assert not torch.equal(a.values, c.values)
    assert torch.equal(default.values, curve().values)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_report_and_aopc_scores_match_lxt_tpu(impl):
    j, t = _logit_fns(impl)
    _, _, je, _, _, te, rel = _tiny()
    want = jf.faithfulness_report(j, je, jnp.asarray(rel), steps=4)
    got = tf.faithfulness_report(t, te, torch.from_numpy(rel), steps=4)
    assert set(got) == set(want)
    for order in ("morf", "lerf"):
        _curve_close(got[order], want[order])
    for key in ("auc_morf", "auc_lerf", "aopc_morf", "aopc_lerf", "abpc"):
        assert _nl2(got[key], want[key]) <= BAR, key
    torch.testing.assert_close(got["random"].values[0], got["morf"].values[0])
    scores = tf.aopc_scores(t, te, torch.from_numpy(rel), steps=4)
    jscores = jf.aopc_scores(j, je, jnp.asarray(rel), steps=4)
    for g, w in zip(scores[:2], jscores[:2]):
        assert _nl2(g, w) <= BAR
    assert scores[2].shape == (B,)


def test_auc_matches_lxt_tpu():
    vals = np.random.default_rng(3).standard_normal((7, 3)).astype(np.float32)
    for v in (vals, vals[:, 0]):
        np.testing.assert_allclose(tf.auc(torch.from_numpy(v)).numpy(),
                                   np.asarray(jf.auc(jnp.asarray(v))),
                                   rtol=1e-6)


@pytest.mark.parametrize("steps", [1, 3, 7, 10, 64])
def test_fractions_bit_equal_to_jnp_linspace(steps):
    got = tf._fractions(steps)
    want = np.asarray(jnp.linspace(0.0, 1.0, steps + 1))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _counting_fns():
    """(lxt_tpu, port) logit functions of a toy model that returns the
    number of ablated tokens (embeddings of ones; the baseline is zero)."""
    return (lambda e: (e[..., 0] == 0).sum(-1).astype(jnp.float32),
            lambda e: (e[..., 0] == 0).sum(-1).float())


def test_half_rounding_at_n_valid_5_steps_10():
    """frac * n_valid lands on .5 (0.1 * 5, 0.3 * 5, ...): k rounds half to
    even in both packages, so the curves count the same ablated tokens."""
    x = np.ones((1, 8, 4), np.float32)
    mask = np.zeros((1, 8), bool)
    mask[0, 3:] = True                       # n_valid 5
    rel = np.arange(8, dtype=np.float32)[None]
    j, t = _counting_fns()
    want = jf.perturbation_curve(j, jnp.asarray(x), jnp.asarray(rel), steps=10,
                                 valid_mask=jnp.asarray(mask))
    got = tf.perturbation_curve(t, torch.from_numpy(x), torch.from_numpy(rel),
                                steps=10, valid_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert got.values[:, 0].tolist() == [0, 0, 1, 2, 2, 2, 3, 4, 4, 4, 5]


def test_padding_never_ablated_and_mean_over_valid_positions():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 3)).astype(np.float32)
    mask = np.ones((2, 6), bool)
    mask[0, :2] = False
    rel = rng.standard_normal((2, 6)).astype(np.float32)
    seen = []

    def t(e):
        seen.append(e.clone())
        return e.sum((1, 2))

    for order in ("morf", "lerf", "random"):
        seen.clear()
        tf.perturbation_curve(t, torch.from_numpy(x), torch.from_numpy(rel),
                              steps=3, order=order, baseline="mean",
                              valid_mask=torch.from_numpy(mask))
        last = seen[-1]
        # padding is untouched at every step; at fraction 1 every valid
        # token holds the mean of the valid embeddings
        assert all(torch.equal(e[0, :2], torch.from_numpy(x[0, :2])) for e in seen)
        mean0 = torch.from_numpy(x[0, 2:].mean(0))
        torch.testing.assert_close(last[0, 2:], mean0.expand(4, 3))
    j = lambda e: e.sum((1, 2))  # noqa: E731
    want = jf.perturbation_curve(j, jnp.asarray(x), jnp.asarray(rel), steps=3,
                                 baseline="mean", valid_mask=jnp.asarray(mask))
    got = tf.perturbation_curve(lambda e: e.sum((1, 2)), torch.from_numpy(x),
                                torch.from_numpy(rel), steps=3, baseline="mean",
                                valid_mask=torch.from_numpy(mask))
    assert _nl2(got.values, want.values) <= BAR


def test_exact_ties_keep_token_order():
    """Equal relevances ablate in token order (stable sorts), as jnp.argsort
    orders them."""
    x = np.ones((1, 6, 2), np.float32)
    rel = np.asarray([[1.0, 2.0, 2.0, 0.5, 2.0, 0.5]], np.float32)
    order = []

    def t(e):
        order.append((e[0, :, 0] == 0).nonzero().flatten().tolist())
        return e.sum((1, 2))

    for mode in ("morf", "lerf"):
        order.clear()
        tf.perturbation_curve(t, torch.from_numpy(x), torch.from_numpy(rel),
                              steps=6, order=mode)
        ranks = np.asarray(jf._rank_order(jnp.asarray(rel),
                                          descending=mode == "morf"))[0]
        want = [sorted(np.flatnonzero(ranks < k).tolist()) for k in range(7)]
        assert order == want
    assert tf._rank_order(torch.from_numpy(rel), True)[0].tolist() == [3, 0, 1, 4, 2, 5]


def test_unknown_order_and_baseline_raise():
    x, rel = torch.ones(1, 4, 2), torch.zeros(1, 4)
    with pytest.raises(ValueError):
        tf.perturbation_curve(lambda e: e.sum((1, 2)), x, rel, order="up")
    with pytest.raises(ValueError, match="baseline must be"):
        tf.perturbation_curve(lambda e: e.sum((1, 2)), x, rel, baseline="blur")
