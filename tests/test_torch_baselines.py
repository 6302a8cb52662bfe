"""The port's gradient baselines (lxt_tpu_torch.baselines) against
lxt_tpu.baselines, on CPU.

A tiny float32 Llama (2 layers, D 64, T 128) under vanilla_gradient is the
target, on the same numpy weights in both packages; the port runs its
einsum and its flash path. Integrated Gradients (zero, mean and array
baselines, midpoint rule) and Gradient*Input must agree within normalized
L2 <= 1e-5. SmoothGrad's noise comes from a torch.Generator, which cannot
reproduce JAX's PRNG stream: it is held by its contract (sigma 0 equals
Gradient*Input, the same seed gives the same map, the shapes). IG is
complete for a linear target at any step count.
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
from lxt_tpu import baselines as jb
from lxt_tpu.models import llama as jllama
from lxt_tpu_torch import baselines as tb
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import llama as tllama

BAR = 1e-5
T, B = 128, 2


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@functools.lru_cache(maxsize=None)
def _tiny():
    rng = np.random.default_rng(1)
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
    return (jcfg, jp, jllama.embed(jp, jnp.asarray(ids)), tllama.LlamaConfig(
        **dataclasses.asdict(jcfg)), tp, tllama.embed(tp, torch.as_tensor(ids)))


TOKENS = np.asarray([5, 60])


def _targets(impl):
    """(lxt_tpu target, port target): embeds -> [B] logits of TOKENS at the
    last position under vanilla_gradient."""
    jcfg, jp, _, tcfg, tp, _ = _tiny()

    def jt(e):
        row = jllama.forward(jp, jcfg, e, lxt_tpu.vanilla_gradient, remat=False,
                             attn_impl="einsum", logits_at=-1).logits[:, -1]
        return jnp.take_along_axis(row, jnp.asarray(TOKENS)[:, None], -1)[:, 0]

    def tt(e):
        row = tllama.forward(tp, tcfg, e, lxt_tpu_torch.vanilla_gradient,
                             remat=False, attn_impl=impl,
                             logits_at=-1).logits[:, -1]
        return torch.gather(row, -1, torch.as_tensor(TOKENS)[:, None])[:, 0]

    return jt, tt


def _baseline_arrays():
    return {"zero": "zero", "mean": "mean",
            "array": np.random.default_rng(2).standard_normal(64).astype(np.float32)}


@pytest.mark.parametrize("baseline", ["zero", "mean", "array"])
@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_integrated_gradients_matches_lxt_tpu(impl, baseline):
    jt, tt = _targets(impl)
    _, _, je, _, _, te = _tiny()
    bl = _baseline_arrays()[baseline]
    want = jb.integrated_gradients(jt, je, steps=4, baseline=bl)
    got = tb.integrated_gradients(tt, te, steps=4, baseline=bl)
    assert got.shape == (B, T) and got.dtype == torch.float32
    assert _nl2(got, want) <= BAR
    want = jb.integrated_gradients(jt, je, steps=3, baseline=bl,
                                   sum_features=False)
    got = tb.integrated_gradients(tt, te, steps=3, baseline=bl,
                                  sum_features=False)
    assert got.shape == (B, T, 64) and _nl2(got, want) <= BAR


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_gradient_x_input_matches_lxt_tpu(impl):
    jt, tt = _targets(impl)
    _, _, je, _, _, te = _tiny()
    for sum_features in (True, False):
        want = jb.gradient_x_input(jt, je, sum_features=sum_features)
        got = tb.gradient_x_input(tt, te, sum_features=sum_features)
        assert _nl2(got, want) <= BAR


def test_ig_rejects_an_unknown_baseline():
    _, tt = _targets("einsum")
    with pytest.raises(ValueError, match="baseline must be"):
        tb.integrated_gradients(tt, _tiny()[5], baseline="blur")


def test_smoothgrad_sigma_zero_is_gradient_x_input():
    _, tt = _targets("einsum")
    te = _tiny()[5]
    gen = torch.Generator().manual_seed(0)
    got = tb.smoothgrad(tt, te, gen, samples=2, sigma=0.0)
    want = tb.gradient_x_input(tt, te)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    raw = tb.smoothgrad(tt, te, gen, samples=2, sigma=0.0, times_input=False,
                        sum_features=False)
    torch.testing.assert_close(raw * te, tb.gradient_x_input(
        tt, te, sum_features=False), rtol=1e-6, atol=1e-7)


def test_smoothgrad_same_seed_same_map_and_shapes():
    _, tt = _targets("einsum")
    te = _tiny()[5]

    def run(seed, **kw):
        return tb.smoothgrad(tt, te, torch.Generator().manual_seed(seed),
                             samples=3, **kw)

    a, b, c = run(7), run(7), run(8)
    assert a.shape == (B, T) and a.dtype == torch.float32
    assert bool(torch.isfinite(a).all())
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert run(7, sum_features=False).shape == (B, T, 64)


def test_smoothgrad_noise_is_sigma_times_the_population_std():
    """With f(e) = |e|^2 / 2 the raw gradient is e + noise, so one sample
    shows the noise: the generator's normal draws times sigma times each
    example's standard deviation over (T, D), ddof 0 as jnp.std."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, 6, 8)).astype(np.float32)) * torch.tensor([1.0, 3.0])[:, None, None]
    raw = tb.smoothgrad(lambda e: 0.5 * (e * e).sum((1, 2)), x,
                        torch.Generator().manual_seed(11), samples=1,
                        sigma=0.25, times_input=False, sum_features=False)
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(11))
    scale = 0.25 * torch.from_numpy(np.asarray(x).std(axis=(1, 2)))[:, None, None]
    torch.testing.assert_close(raw - x, noise * scale, rtol=1e-5, atol=1e-6)


def test_ig_complete_for_a_linear_target():
    """rel.sum(1) == f(x) - f(x0) exactly (to float32) for a linear f, at
    any step count and baseline."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((B, 6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))

    def f(e):
        return (e * w).sum((1, 2))

    bl = torch.full((8,), 0.3)
    for steps, baseline, x0 in ((1, "zero", torch.zeros_like(x)),
                                (5, "mean", x.mean(-2, keepdim=True).expand_as(x)),
                                (3, bl, bl.expand_as(x))):
        rel = tb.integrated_gradients(f, x, steps=steps, baseline=baseline)
        torch.testing.assert_close(rel.sum(1), f(x) - f(x0), rtol=1e-5,
                                   atol=1e-5)
