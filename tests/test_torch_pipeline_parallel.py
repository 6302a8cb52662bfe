"""Pipeline parallelism of lxt_tpu_torch (``parallel/pipeline_parallel.py``)
against lxt_tpu, on CPU.

Four gloo ranks are spawned once for the module (``tests/_torch_ranks.py``)
and run every case; the tests hold rank 0's results:

- Llama at pp 4 (one layer a stage), ``n_micro`` 2, against lxt_tpu's
  ``attribute_pipeline_parallel`` on a 4-device CPU mesh and its
  single-device ``input_relevance``;
- Gemma-3 at pp 2 (its local layer on stage 0, its global layer on stage 1;
  a ``("x", "pp")`` mesh of the four processes, the two pipelines alike)
  against lxt_tpu's single-device run;
- a per-depth rule override (CP-LRP's attention and gate rules) spanning
  layers 1-2, across the boundary of stages 1 and 2
  (``Composite.override_layers``), against the port's
  unsharded run and lxt_tpu's unrolled one: every stage resolves the rules
  of its layers' global depth. lxt_tpu's pipeline refuses depth overrides.

Tolerances: value rtol 1e-5, relevance atol 1e-4, as tests/test_parallel.py.
jax is imported inside the test functions only: each spawned rank imports
this module.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh

import lxt_tpu_torch
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import gemma3 as tgemma
from lxt_tpu_torch.models import llama as tllama
from lxt_tpu_torch.parallel import attribute_pipeline_parallel
from tests._torch_ranks import spawn

VAL_RTOL, REL_ATOL = 1e-5, 1e-4
#: CP-LRP's attention and gate rules on layers 1 and 2 (stages 1 and 2 at
#: pp 4); well conditioned in float32, unlike the gamma rule
OVERRIDE = (1, 3)


def _override(package):
    return package.attnlrp.override_layers(OVERRIDE, attention="cp", gate="cp")


def _pp_rank(rank, world, cases):
    out = {}
    pp4 = init_device_mesh("cpu", (4,), mesh_dim_names=("pp",))
    c = cases["llama"]
    cfg, params = tllama.LlamaConfig(**c["cfg"]), params_from_numpy(c["params"], device="cpu")
    e = tllama.embed(params, torch.from_numpy(c["ids"]))
    for name, comp in (("llama", lxt_tpu_torch.attnlrp),
                       ("override", _override(lxt_tpu_torch))):
        value, rel = attribute_pipeline_parallel(tllama.forward, params, cfg, e,
                                                 pp4, comp, n_micro=2)
        out[name] = (float(value), rel.numpy())
    # the unsharded override, on this process alone
    value, rel = lxt_tpu_torch.input_relevance(lambda x: lxt_tpu_torch.select_logit(
        tllama.forward(params, cfg, x, _override(lxt_tpu_torch)).logits), e)
    out["override_single"] = (float(value), rel.numpy())
    g = cases["gemma3"]
    gcfg, gparams = tgemma.Gemma3Config(**g["cfg"]), params_from_numpy(g["params"], device="cpu")
    ge = tgemma.embed(gparams, torch.from_numpy(g["ids"]), gcfg)
    pp2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("x", "pp"))
    value, rel = attribute_pipeline_parallel(tgemma.forward, gparams, gcfg, ge, pp2,
                                             lxt_tpu_torch.attnlrp)
    out["gemma3"] = (float(value), rel.numpy())
    return out


def _cases():
    import jax
    from lxt_tpu.models import gemma3 as jgemma
    from lxt_tpu.models import llama as jllama
    lcfg = jllama.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                              num_layers=4, num_heads=4, num_kv_heads=2, rms_eps=1e-6)
    gcfg = jgemma.Gemma3Config(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, sliding_window=4,
        query_pre_attn_scalar=16, layer_types=("sliding_attention", "full_attention"))
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, 128))
    out = {}
    for name, mod, cfg in (("llama", jllama, lcfg), ("gemma3", jgemma, gcfg)):
        params = jax.tree.map(np.asarray, mod.init_params(cfg, jax.random.PRNGKey(0)))
        out[name] = {"cfg": dataclasses.asdict(cfg), "params": params,
                     "ids": ids.astype(np.int64), "jcfg": cfg, "mod": mod}
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cases = _cases()
    port = {k: {kk: vv for kk, vv in v.items() if kk not in ("jcfg", "mod")}
            for k, v in cases.items()}
    return cases, spawn(_pp_rank, 4, tmp_path_factory.mktemp("pp"), port)


def _jax_single(case, composite):
    import jax
    import jax.numpy as jnp
    from lxt_tpu.attribution import input_relevance, select_logit
    mod, cfg = case["mod"], case["jcfg"]
    params = jax.tree.map(jnp.asarray, case["params"])
    ids = jnp.asarray(case["ids"])
    e = mod.embed(params, ids, cfg) if "Gemma" in type(cfg).__name__ else mod.embed(params, ids)
    value, rel = input_relevance(lambda x: select_logit(
        mod.forward(params, cfg, x, composite).logits), e)
    return float(value), np.asarray(rel)


def _check(got, want, what=""):
    np.testing.assert_allclose(got[0], want[0], rtol=VAL_RTOL, err_msg=what)
    assert got[1].shape == want[1].shape
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=REL_ATOL, err_msg=what)


def test_llama_pp4_matches_lxt_tpu_pipeline(run):
    import jax
    import jax.numpy as jnp
    import lxt_tpu
    from jax.sharding import Mesh
    from lxt_tpu.parallel import attribute_pipeline_parallel as jpp
    cases, got = run
    c = cases["llama"]
    params = jax.tree.map(jnp.asarray, c["params"])
    e = c["mod"].embed(params, jnp.asarray(c["ids"]))
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("pp",))
    value, rel = jpp(c["mod"].forward, params, c["jcfg"], e, mesh, lxt_tpu.attnlrp,
                     n_micro=2)
    _check(got["llama"], (float(value), np.asarray(rel)), "llama pp4")
    _check(got["llama"], _jax_single(c, lxt_tpu.attnlrp), "llama single")


def test_gemma3_pp2_matches_lxt_tpu(run):
    """Stage 1 runs Gemma-3's global layer: the layer type and rope table
    follow the global depth."""
    import lxt_tpu
    cases, got = run
    _check(got["gemma3"], _jax_single(cases["gemma3"], lxt_tpu.attnlrp), "gemma3 pp2")


def test_depth_override_across_a_stage_boundary(run):
    import lxt_tpu
    cases, got = run
    _check(got["override"], got["override_single"], "override vs unsharded")
    _check(got["override"], _jax_single(cases["llama"], _override(lxt_tpu)),
           "override vs lxt_tpu")
    # the override moves the map: the stages did not run attnlrp alone
    assert np.abs(got["override"][1] - got["llama"][1]).max() > 10 * REL_ATOL
