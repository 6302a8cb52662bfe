"""``flash_attention_lse`` and the sequence-parallel ring of lxt_tpu_torch
against lxt_tpu, on CPU.

- ``flash_attention_lse`` (the kernels' plain versions on CPU) against
  lxt_tpu's (Pallas in interpret mode): every (q_start, k_start) pair of a
  4-way split of T 512 (past, diagonal and wholly-future shards) and one
  pair off the tile grid, window none and 96, GQA 4/2, head dim 64 and 256,
  random ``do`` and ``dlse`` cotangents; out, lse, dq, dk, dv within 1e-5.
- ``ring_flash_attention`` over gloo at world 2 and 4 against lxt_tpu's
  under ``shard_map`` (as tests/test_ring_attention.py): value rtol 1e-5,
  dq/dk/dv (and the AttnLRP-scaled relevances) atol 5e-5.
- ``attribute_sequence_parallel`` on the tiny Llama and Gemma-3 configs of
  tests/test_ring_attention.py at world 4, against lxt_tpu's on a 4-device
  CPU mesh and the port's single-process ``input_relevance``: value rtol
  1e-5, relevance atol 2e-4. A longrope Llama whose shards are shorter than
  its original context and whose sequence is longer: lxt_tpu's ring picks
  the short schedule on every shard (ROADMAP F7), the port's the global one.

Ranks are spawned by ``tests/_torch_ranks.py`` (multiprocessing "spawn",
a ``file://`` store under ``tmp_path``, so no ports clash between test
workers; a rank that hangs is terminated and fails its test). jax is
imported inside the test functions only: each spawned rank imports this
module to find its entry and must not load it.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import lxt_tpu_torch
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import gemma3 as tgemma
from lxt_tpu_torch.models import llama as tllama
from lxt_tpu_torch.ops import flash_attention as tfa
from lxt_tpu_torch.ops.rules import divide_gradient
from lxt_tpu_torch.parallel import attribute_sequence_parallel, ring_flash_attention
from tests._torch_ranks import spawn as _spawn

LSE_ATOL, RING_ATOL, REL_ATOL = 1e-5, 5e-5, 2e-4

# ---------------------------------------------------------------------------
# spawned ranks
# ---------------------------------------------------------------------------


def _shard(a, rank, world, axis):
    n = a.shape[axis] // world
    return np.take(a, np.arange(rank * n, (rank + 1) * n), axis=axis)


def _gather(t, world, dim):
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=dim).numpy()


def _ring_rank(rank, world, arrays, window, scaled):
    """This rank's shard through ring_flash_attention; the summed target
    (out∘rel), the gathered gradients of q, k, v and each rank's
    flash_attention_lse calls."""
    from lxt_tpu_torch.parallel import ring
    calls = []
    step = ring.flash_attention_lse

    def counted(*args, **kw):
        calls.append(kw["k_start"])
        return step(*args, **kw)

    ring.flash_attention_lse = counted
    q, k, v = (torch.from_numpy(_shard(a, rank, world, 2)).requires_grad_(True)
               for a in arrays[:3])
    rel = torch.from_numpy(_shard(arrays[3], rank, world, 2))
    qq, kk, vv = q, k, v
    if scaled:  # AttnLRP's rule at the attention inputs
        qq, kk, vv = divide_gradient(q, 4), divide_gradient(k, 4), divide_gradient(v, 2)
    local = (ring_flash_attention(qq, kk, vv, window=window) * rel).sum()
    grads = torch.autograd.grad(local, (q, k, v))
    value = local.detach().clone()
    dist.all_reduce(value)
    return {"value": value.item(), "grads": [_gather(g, world, 2) for g in grads],
            "calls": _gather(torch.tensor([len(calls)]), world, 0).tolist()}


_FAMILIES = {"llama": (tllama, tllama.LlamaConfig),
             "gemma3": (tgemma, tgemma.Gemma3Config)}


def _embed(family, params, ids, cfg):
    mod = _FAMILIES[family][0]
    return mod.embed(params, ids, cfg) if family == "gemma3" else mod.embed(params, ids)


def _attribute_rank(rank, world, family, cfg_kw, params_np, ids):
    mod, config = _FAMILIES[family]
    cfg = config(**cfg_kw)
    params = params_from_numpy(params_np, device="cpu")
    e = _embed(family, params, torch.from_numpy(ids), cfg)
    value, rel = attribute_sequence_parallel(mod.forward, params, cfg, e,
                                             lxt_tpu_torch.attnlrp)
    return {"value": value.item(), "rel": rel.numpy()}


# ---------------------------------------------------------------------------
# flash_attention_lse
# ---------------------------------------------------------------------------

TL = 128  # a shard of a 4-way split of T 512
OFFSETS = [(i * TL, j * TL) for i in range(4) for j in range(4)] + [(100, 37)]


@functools.lru_cache(maxsize=None)
def _jax_lse_vjp(window):
    """lxt_tpu's flash_attention_lse and its vjp, jitted once per window
    with the offsets as runtime scalars."""
    import jax
    from lxt_tpu.ops.flash_attention import flash_attention_lse

    def f(q, k, v, q_start, k_start, do, dlse):
        (out, lse), vjp = jax.vjp(lambda q, k, v: flash_attention_lse(
            q, k, v, window, q_start=q_start, k_start=k_start), q, k, v)
        return (out, lse, *vjp((do, dlse)))
    return jax.jit(f)


def _lse_inputs(D, seed):
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32)
    return r(1, 4, TL, D), r(1, 2, TL, D), r(1, 2, TL, D), r(1, 4, TL, D), r(1, 4, TL)


@pytest.mark.parametrize("offsets", OFFSETS, ids=[f"q{a}_k{b}" for a, b in OFFSETS])
@pytest.mark.parametrize("window", [None, 96])
@pytest.mark.parametrize("D", [64, 256])
def test_flash_attention_lse_matches_lxt_tpu(D, window, offsets):
    q_start, k_start = offsets
    arrays = _lse_inputs(D, seed=D + (window or 0))
    want = [np.asarray(x) for x in _jax_lse_vjp(window)(
        *arrays[:3], q_start, k_start, *arrays[3:])]
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays[:3])
    do, dlse = (torch.from_numpy(a) for a in arrays[3:])
    out, lse = lxt_tpu_torch.flash_attention_lse(q, k, v, window, q_start=q_start,
                                                 k_start=k_start)
    grads = torch.autograd.grad((out * do).sum() + (lse * dlse).sum(), (q, k, v))
    got = [out, lse, *grads]
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=LSE_ATOL,
                                   err_msg=name)
    # every key in the queries' future or behind their window
    empty = tfa.visible_pairs(TL, window, q_start=q_start, k_start=k_start) == 0
    assert bool((lse == tfa.NEG_INF).all()) == empty
    assert bool((out == 0).all()) == empty


def test_flash_attention_lse_refuses_rope_with_offsets():
    q = torch.zeros(1, 2, 128, 64)
    rope = (torch.ones(128, 64), torch.zeros(128, 64))
    with pytest.raises(ValueError, match="offsets"):
        lxt_tpu_torch.flash_attention_lse(q, q, q, q_start=128, rope=rope)
    out, _ = lxt_tpu_torch.flash_attention_lse(q, q, q, rope=rope)
    assert out.shape == q.shape


def test_flash_attention_lse_without_dlse_is_flash_attention():
    """With the lse unused (a zero cotangent) the backward is
    flash_attention's, bit for bit."""
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, 4, 128, 64), (2, 2, 128, 64), (2, 2, 128, 64))]
    do = torch.from_numpy(rng.standard_normal((2, 4, 128, 64)).astype(np.float32))
    res = []
    for fn in (lambda *a: lxt_tpu_torch.flash_attention_lse(*a, 40)[0],
               lambda *a: tfa.flash_attention(*a, 40)):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        out = fn(*leaves)
        res.append([out, *torch.autograd.grad((out * do).sum(), leaves)])
    for a, b in zip(*res):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# ring_flash_attention
# ---------------------------------------------------------------------------

def _jax_ring(arrays, world, window, scaled):
    """lxt_tpu's ring under shard_map on ``world`` of the conftest's CPU
    devices: the psum'd target and its gradients."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from lxt_tpu.ops.rules import divide_gradient as jdivide
    from lxt_tpu.parallel.ring import ring_flash_attention as jring

    mesh = Mesh(np.asarray(jax.devices()[:world]), ("sp",))
    spec = P(None, None, "sp", None)

    @functools.partial(shard_map, mesh=mesh, in_specs=(spec,) * 4,
                       out_specs=P(), check_vma=False)
    def target(q, k, v, rel):
        if scaled:
            q, k, v = jdivide(q, 4), jdivide(k, 4), jdivide(v, 2)
        out = jring(q, k, v, "sp", window=window)
        return jax.lax.psum((out * rel).astype(jnp.float32).sum(), "sp")

    value, grads = jax.value_and_grad(target, argnums=(0, 1, 2))(
        *map(jnp.asarray, arrays))
    return float(value), [np.asarray(g) for g in grads]


def _ring_arrays(H, Hkv, T, D, seed):
    rng = np.random.default_rng(seed)
    shapes = [(1, H, T, D), (1, Hkv, T, D), (1, Hkv, T, D), (1, H, T, D)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("window", [None, 96])
@pytest.mark.parametrize("world", [2, 4])
def test_ring_matches_lxt_tpu(world, window, tmp_path):
    arrays = _ring_arrays(4, 2, 512, 64, seed=world)
    got = _spawn(_ring_rank, world, tmp_path, arrays, window, False)
    value, grads = _jax_ring(arrays, world, window, scaled=False)
    np.testing.assert_allclose(got["value"], value, rtol=1e-5)
    for g, w, name in zip(got["grads"], grads, "qkv"):
        np.testing.assert_allclose(g, w, rtol=0, atol=RING_ATOL, err_msg=f"d{name}")
    # a rank attends only to the kv shards the mask leaves some pair of
    Tl = 512 // world
    assert got["calls"] == [
        sum(tfa.visible_pairs(Tl, window, q_start=r * Tl, k_start=((r - s) % world) * Tl) > 0
            for s in range(world)) for r in range(world)]


@pytest.mark.parametrize("window", [None, 1, 96, 128, 129, 200, 384])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_skips_exactly_the_steps_the_mask_hides(causal, window):
    """A ring step is skipped exactly when the mask leaves no visible pair
    between the local queries and the kv shard (brute-force count)."""
    from lxt_tpu_torch.parallel.ring import _hidden
    Tl = 128
    for idx in range(4):
        for src in range(4):
            empty = tfa.visible_pairs(Tl, window, causal, q_start=idx * Tl,
                                      k_start=src * Tl) == 0
            assert _hidden(idx, src, Tl, causal, window) == empty, (idx, src)


def test_ring_attnlrp_relevance_matches_lxt_tpu(tmp_path):
    """AttnLRP's q, k /4 and v /2 around the ring: the relevances
    x ∘ dx equal lxt_tpu's."""
    arrays = _ring_arrays(2, 2, 256, 64, seed=1)
    got = _spawn(_ring_rank, 4, tmp_path, arrays, None, True)
    _, grads = _jax_ring(arrays, 4, None, scaled=True)
    for x, g, w, name in zip(arrays, got["grads"], grads, "qkv"):
        np.testing.assert_allclose(x * g, x * w, rtol=0, atol=RING_ATOL,
                                   err_msg=f"R_{name}")


# ---------------------------------------------------------------------------
# attribute_sequence_parallel
# ---------------------------------------------------------------------------

def _configs():
    from lxt_tpu.models import gemma3 as jgemma
    from lxt_tpu.models import llama as jllama
    hd = 16
    return {
        "llama": jllama.LlamaConfig(
            vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, rms_eps=1e-6),
        "gemma3": jgemma.Gemma3Config(
            vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=hd, sliding_window=64,
            query_pre_attn_scalar=16.0,
            layer_types=("sliding_attention", "full_attention")),
        # shards of 128 <= the original context 256 < the sequence 512
        "llama_longrope": jllama.LlamaConfig(
            vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, rms_eps=1e-6,
            rope_scaling=("longrope", (1.0,) * (hd // 2),
                          tuple(1.0 + 0.5 * i for i in range(hd // 2)),
                          256.0, 1024.0, None)),
    }


def _setup_family(name):
    """lxt_tpu's config and random params (from its own init, as
    tests/test_ring_attention.py), their numpy copy, and ids [1, 512]."""
    import jax
    from lxt_tpu.models import gemma3 as jgemma
    from lxt_tpu.models import llama as jllama
    jcfg = _configs()[name]
    jmod = jgemma if name == "gemma3" else jllama
    jparams = jmod.init_params(jcfg, jax.random.PRNGKey(0))
    if name == "llama_longrope":  # sharper attention, so the rope schedule shows
        lp = jparams["layers"]
        jparams = dict(jparams, layers=dict(lp, wq=4 * lp["wq"], wk=4 * lp["wk"]))
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (1, 512), 0, 128))
    params_np = jax.tree.map(np.asarray, jparams)
    return jcfg, jmod, jparams, params_np, ids


def _jax_attributions(jcfg, jmod, jparams, ids, family):
    """lxt_tpu's single-device (einsum) and ring (4-device mesh) results."""
    import jax
    import jax.numpy as jnp
    import lxt_tpu
    from jax.sharding import Mesh
    from lxt_tpu.attribution import input_relevance, select_logit
    from lxt_tpu.parallel.ring import attribute_sequence_parallel as jasp

    e = (jmod.embed(jparams, jnp.asarray(ids), jcfg) if family == "gemma3"
         else jmod.embed(jparams, jnp.asarray(ids)))
    single = input_relevance(lambda x: select_logit(jmod.forward(
        jparams, jcfg, x, lxt_tpu.attnlrp, attn_impl="einsum").logits), e)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("sp",))
    ring = jasp(jmod.forward, jparams, jcfg, e, mesh, lxt_tpu.attnlrp)
    return [(float(v), np.asarray(r)) for v, r in (single, ring)]


def _port_single(family, cfg_kw, params_np, ids):
    mod, config = _FAMILIES[family]
    cfg = config(**cfg_kw)
    params = params_from_numpy(params_np, device="cpu")
    e = _embed(family, params, torch.from_numpy(ids), cfg)
    value, rel = lxt_tpu_torch.input_relevance(lambda x: lxt_tpu_torch.select_logit(
        mod.forward(params, cfg, x, lxt_tpu_torch.attnlrp,
                    attn_impl="einsum").logits), e)
    return value.item(), rel.numpy()


@pytest.mark.parametrize("family", ["llama", "gemma3"])
def test_attribute_sequence_parallel_matches_lxt_tpu(family, tmp_path):
    jcfg, jmod, jparams, params_np, ids = _setup_family(family)
    cfg_kw = dataclasses.asdict(jcfg)
    got = _spawn(_attribute_rank, 4, tmp_path, family, cfg_kw, params_np, ids)
    (_, rel_single), (val_ring, rel_ring) = _jax_attributions(
        jcfg, jmod, jparams, ids, family)
    val_port, rel_port = _port_single(family, cfg_kw, params_np, ids)
    assert got["rel"].shape == (1, 512)
    for val, rel in ((val_ring, rel_ring), (val_port, rel_port)):
        np.testing.assert_allclose(got["value"], val, rtol=1e-5)
        np.testing.assert_allclose(got["rel"], rel, rtol=0, atol=REL_ATOL)
    np.testing.assert_allclose(got["rel"], rel_single, rtol=0, atol=REL_ATOL)


def test_longrope_ring_uses_the_global_length(tmp_path):
    """Shards of 128 tokens, original context 256, sequence 512: lxt_tpu's
    ring hands each shard's length to longrope, which then picks the short
    factors where the single-device run picks the long ones (ROADMAP F7);
    the port's ring passes the global length and equals the single-device
    relevance."""
    jcfg, jmod, jparams, params_np, ids = _setup_family("llama_longrope")
    cfg_kw = dataclasses.asdict(jcfg)
    got = _spawn(_attribute_rank, 4, tmp_path, "llama", cfg_kw, params_np, ids)
    (val_single, rel_single), (val_jring, rel_jring) = _jax_attributions(
        jcfg, jmod, jparams, ids, "llama")
    val_port, rel_port = _port_single("llama", cfg_kw, params_np, ids)
    np.testing.assert_allclose(got["value"], val_single, rtol=1e-5)
    np.testing.assert_allclose(got["rel"], rel_single, rtol=0, atol=REL_ATOL)
    np.testing.assert_allclose(got["rel"], rel_port, rtol=0, atol=REL_ATOL)
    # F7: lxt_tpu's own ring is off its single-device result
    assert abs(val_jring / val_single - 1) > 1e-3
    assert np.abs(rel_jring - rel_single).max() > 5 * REL_ATOL


def test_ring_of_one_process_explains_a_given_token():
    """Without a process group the ring is one process holding the whole
    sequence; ``token`` picks the explained logits as select_logit does
    (one token per example)."""
    cfg = tllama.LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                             num_layers=2, num_heads=4, num_kv_heads=2)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    ids = torch.randint(0, 64, (2, 128), generator=torch.Generator().manual_seed(1))
    e = tllama.embed(params, ids)
    token = torch.tensor([3, 7])
    assert not dist.is_initialized()
    value, rel = attribute_sequence_parallel(tllama.forward, params, cfg, e,
                                             lxt_tpu_torch.attnlrp, token=token)
    want_value, want_rel = lxt_tpu_torch.input_relevance(
        lambda x: lxt_tpu_torch.select_logit(tllama.forward(
            params, cfg, x, lxt_tpu_torch.attnlrp, attn_impl="einsum").logits,
            token=token), e)
    np.testing.assert_allclose(value.item(), want_value.item(), rtol=1e-5)
    np.testing.assert_allclose(rel.numpy(), want_rel.numpy(), rtol=0, atol=1e-6)
