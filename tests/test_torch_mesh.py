"""Data, tensor and expert parallelism of lxt_tpu_torch (``parallel/mesh.py``,
``ops/tensor_parallel.py``) and sequence × tensor parallelism
(``parallel/ring.py`` with ``param_shardings``) against lxt_tpu, on CPU.

Four gloo ranks are spawned once for the module (``tests/_torch_ranks.py``)
on a ``make_mesh(data=2, model=2)`` mesh and run every case; each test then
holds rank 0's results against lxt_tpu on the same numpy weights (the
port's init from a seed, every bias drawn at random so that a row-parallel
bias added on each shard would show; quantized by the port, whose codes and
scales equal lxt_tpu's bit for bit):

- Llama at dp 2 × tp 2 against lxt_tpu's own ``attribute_sharded`` on
  ``make_mesh(data=4, model=2)`` over the 8 virtual CPU devices;
- Gemma-3, GPT-2 (fused q|k|v split by head groups), BERT (``kv_end``),
  SigLIP and the ViT at tp 2 against lxt_tpu's single-device
  ``input_relevance``;
- the ViT under ``with_gamma`` at tp 2 in float64 against the port's
  unsharded float64 map (the gamma rule's denominators cross 0, so only
  float64 holds it to 1e-8; its row-parallel products divide by summed
  denominators);
- int8, int4 and NF4 (block 32) at tp 2 against lxt_tpu's quantized
  single-device run; NF4 with blocks of 64 split off its blocks is refused;
- Mixtral at ep 2 (ragged and dense mixtures) against lxt_tpu;
- a config whose kv heads do not divide over tp is refused (local heads);
- sp 2 × tp 2 (a ``("sp", "model")`` mesh) against lxt_tpu's
  ``attribute_sequence_parallel`` with ``param_shardings`` on a 2 × 2 mesh;
- the conservation and NaN checks under ``attribute_sharded`` at dp 2 × tp
  2: the Llama under a gamma composite and the ViT under ``with_gamma``
  give the gathered input relevance and ``conservation_error`` of the
  port's single process, and a NaN in one process's head shard raises the
  same site on all four; the ring and the pipeline driver still refuse
  both checks. The Llama's conservation run is also held against
  lxt_tpu's ``attribute_sharded`` under its conservation check on
  ``make_mesh(data=4, model=2)`` (relevance within 2e-5 of its largest
  value: lxt_tpu's own sharded and single-device maps differ by 1.2e-5).

Tolerances: values rtol 1e-5, relevance atol 1e-4 (sp × tp 2e-4, the
float64 gamma map 1e-8), as tests/test_parallel.py. jax is imported inside
the test functions only: each spawned rank imports this module.
"""

import dataclasses

import numpy as np
import pytest
import torch

import lxt_tpu_torch
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import bert as tbert
from lxt_tpu_torch.models import gemma3 as tgemma
from lxt_tpu_torch.models import gpt2 as tgpt2
from lxt_tpu_torch.models import llama as tllama
from lxt_tpu_torch.models import mixtral as tmix
from lxt_tpu_torch.models import siglip as tsiglip
from lxt_tpu_torch.models import vit as tvit
from lxt_tpu_torch.parallel import (attribute_sequence_parallel, attribute_sharded,
                                    family_param_shardings, make_mesh,
                                    mixtral_param_shardings, shard_params)
from lxt_tpu_torch.parallel.mesh import data_rows, gather_rows, model_parallel
from tests._torch_ranks import spawn

VAL_RTOL, REL_ATOL, SPTP_ATOL, F64_ATOL = 1e-5, 1e-4, 2e-4, 1e-8
B, T = 4, 16

_PORT = {"llama": (tllama, tllama.LlamaConfig), "gemma3": (tgemma, tgemma.Gemma3Config),
         "gpt2": (tgpt2, tgpt2.GPT2Config), "bert": (tbert, tbert.BertConfig),
         "siglip": (tsiglip, tsiglip.SiglipConfig), "vit": (tvit, tvit.ViTConfig),
         "mixtral": (tmix, tmix.MixtralConfig)}
_COMPOSITE = {"gpt2": "cp_lrp", "vit": "cp_lrp"}


def _target(family, out):
    """The explained scalar: the argmax logit at the last position (causal
    LMs), the argmax class logit (BERT, ViT), one feature of every patch
    (SigLIP), each summed over the batch."""
    if family in ("bert", "vit"):
        return out.logits.max(-1).values.sum()
    if family == "siglip":
        return out[..., 0].sum()
    return lxt_tpu_torch.select_logit(out.logits)


def _port_forward(family, params, cfg, comp, kw):
    mod = _PORT[family][0]
    return lambda x: _target(family, mod.forward(params, cfg, x, comp, **kw))


def _port_inputs(family, params, cfg, inputs):
    x = torch.from_numpy(inputs)
    if family in ("siglip", "vit"):
        return x.to(next(iter(params.values())).dtype)
    if family == "gpt2":
        return tgpt2.embed(params, x)[0]
    if family == "gemma3":
        return tgemma.embed(params, x, cfg)
    return _PORT[family][0].embed(params, x)


# ---------------------------------------------------------------------------
# spawned ranks
# ---------------------------------------------------------------------------

def _tp_case(mesh, case):
    """``(value, relevance)`` of one case at the mesh's dp × tp."""
    family, mod_cfg = case["family"], _PORT[case["family"]][1]
    cfg = mod_cfg(**case["cfg"])
    params = params_from_numpy(case["params"], device="cpu")
    comp = getattr(lxt_tpu_torch, _COMPOSITE.get(family, "attnlrp"))
    shardings = (mixtral_param_shardings(mesh) if family == "mixtral"
                 else family_param_shardings(family, params, mesh))
    local, _ = shard_params(params, shardings)
    # the embedding lookup under tensor parallelism: the vocabulary split
    with model_parallel(mesh):
        x = _port_inputs(family, local, cfg, case["inputs"])
    # per-example keywords (BERT's kv_end) take the rows of this data rank
    kw = {k: data_rows(mesh, torch.from_numpy(v)) for k, v in case.get("kw", {}).items()}
    value, rel = attribute_sharded(_port_forward(family, local, cfg, comp, kw), mesh)(x)
    return float(value), rel.numpy()


def _gamma_f64(mesh, case):
    """The ViT's gamma map in float64 at tp 2 and unsharded (both rows of
    the batch split over data)."""
    cfg = tvit.ViTConfig(**case["cfg"])
    params = params_from_numpy(case["params"], device="cpu", dtype=torch.float64)
    comp = lxt_tpu_torch.cp_lrp.with_gamma(conv_gamma=0.25, linear_gamma=0.25)
    images = torch.from_numpy(case["inputs"]).double()

    def grad_x_input(p, x):
        x = x.detach().requires_grad_(True)
        out = tvit.forward(p, cfg, x, comp)
        (g,) = torch.autograd.grad(_target("vit", out), x)
        return (x.detach() * g).sum(-1)

    want = grad_x_input(params, images)
    local, _ = shard_params(params, family_param_shardings("vit", params, mesh))
    with model_parallel(mesh):
        got = gather_rows(mesh, grad_x_input(local, data_rows(mesh, images)))
    return got.numpy(), want.numpy()


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _check_refusals(mesh, case):
    """The conservation and NaN checks under the ring and the pipeline
    driver: each refuses, on every process alike (the cases after these
    run in step)."""
    from lxt_tpu_torch.ops.check import conservation_check, nan_check
    from lxt_tpu_torch.parallel.pipeline_parallel import PipelineDriver
    cfg = tllama.LlamaConfig(**case["cfg"])
    params = params_from_numpy(case["params"], device="cpu")
    e = tllama.embed(params, torch.from_numpy(case["inputs"]))
    out = []
    for check in (conservation_check, nan_check):
        with check():
            out.append(_refusal(lambda: attribute_sequence_parallel(
                tllama.forward, params, cfg, e, lxt_tpu_torch.attnlrp,
                group=mesh.get_group("data"))))
            out.append(_refusal(lambda: PipelineDriver(mesh.get_group("data"))(
                None, e, cfg.num_layers, False)))
    return out


def _check_composite(family):
    """The explicit-rule composite of a family's checks: gamma at every
    linear (and conv) site."""
    base = getattr(lxt_tpu_torch, _COMPOSITE.get(family, "attnlrp"))
    return base.with_gamma(conv_gamma=0.25 if family in ("vit", "siglip") else None,
                           linear_gamma=0.25)


def _checked_runs(mesh, case, dtype=torch.float32, poison=False):
    """One family's conservation run at dp 2 x tp 2 (Mixtral: dp 2 x ep 2)
    and, on rank 0, on one process with the whole batch: ``(value,
    relevance, conservation error)`` each. ``poison``: the NaN check
    instead, a NaN written into one element of global rank 1's head shard;
    returns the message every rank raised (gathered)."""
    import torch.distributed as dist
    from lxt_tpu_torch.ops.check import conservation_check, conservation_error, nan_check
    family = case["family"]
    cfg = _PORT[family][1](**case["cfg"])
    params = params_from_numpy(case["params"], device="cpu", dtype=dtype)
    comp = _check_composite(family)
    shardings = (mixtral_param_shardings(mesh) if family == "mixtral"
                 else family_param_shardings(family, params, mesh))
    local, _ = shard_params(params, shardings)
    with model_parallel(mesh):
        x = _port_inputs(family, local, cfg, case["inputs"])
    kw = {k: data_rows(mesh, torch.from_numpy(v)) for k, v in case.get("kw", {}).items()}
    step = attribute_sharded(_port_forward(family, local, cfg, comp, kw), mesh)
    if poison:
        if dist.get_rank() == 1:
            local["lm_head"][0, 0] = float("nan")
        msg = None
        try:
            with nan_check():
                step(x)
        except RuntimeError as e:
            msg = str(e)
        msgs = [None] * dist.get_world_size()
        dist.all_gather_object(msgs, msg)
        return msgs
    with conservation_check():
        value, rel = step(x)
    out = {"mesh": (float(value), rel.numpy(), float(conservation_error(rel, value)))}
    if dist.get_rank() == 0:
        whole = _port_inputs(family, params, cfg, case["inputs"])
        kw = {k: torch.from_numpy(v) for k, v in case.get("kw", {}).items()}
        with conservation_check():
            value, rel = lxt_tpu_torch.input_relevance(
                _port_forward(family, params, cfg, comp, kw), whole)
        out["single"] = (float(value), rel.numpy(),
                         float(conservation_error(rel, value)))
    return out


#: the cases whose checks are held at dp 2 x tp 2: every tensor-parallel
#: family, Mixtral at ep 2 and the NF4 Llama
_CHECKED = ("llama", "gemma3", "gpt2", "bert", "siglip", "vit", "mixtral", "quant_nf4")
#: the dense Llama and the ViT are held in float32; the other cases in
#: float64, where the check sums in float64 too, so that the
#: 1e-6 bar sees the fill alone and not float32's order of summation (in
#: float32 Gemma-3's relevance of ~550 parts by 11 ulp, and Mixtral's and
#: the NF4 Llama's conservation_error of ~76 and ~115 by 2 and 1)
_CHECK_DTYPE = {f: torch.float64 for f in ("gemma3", "gpt2", "bert", "siglip", "mixtral",
                                           "quant_nf4")}


def _mesh_rank(rank, world, cases):
    mesh = make_mesh(data=2, model=2)
    out = {name: _tp_case(mesh, case) for name, case in cases.items()
           if "family" in case and name != "one_kv_head_case"}
    out["vit_gamma_f64"] = _gamma_f64(mesh, cases["vit"])
    nf4 = cases["nf4_block64"]
    out["nf4_block64"] = _refusal(lambda: shard_params(
        params_from_numpy(nf4["params"], device="cpu"),
        family_param_shardings("llama", params_from_numpy(nf4["params"],
                                                          device="cpu"), mesh)))
    out["one_kv_head"] = _refusal(lambda: _tp_case(mesh, cases["one_kv_head_case"]))
    out["check_refusals"] = _check_refusals(mesh, cases["llama"])
    for name in _CHECKED:
        out[f"checked_{name}"] = _checked_runs(
            mesh, cases[name], _CHECK_DTYPE.get(name, torch.float32))
    out["nan_llama"] = _checked_runs(mesh, cases["llama"], poison=True)
    # sp x tp on a ("sp", "model") mesh of the same four processes
    from torch.distributed.device_mesh import init_device_mesh
    sp = cases["sp_tp"]
    spm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("sp", "model"))
    cfg = tllama.LlamaConfig(**sp["cfg"])
    params = params_from_numpy(sp["params"], device="cpu")
    e = tllama.embed(params, torch.from_numpy(sp["inputs"]))
    value, rel = attribute_sequence_parallel(
        tllama.forward, params, cfg, e, lxt_tpu_torch.attnlrp,
        group=spm.get_group("sp"),
        param_shardings=family_param_shardings("llama", params, spm))
    out["sp_tp"] = (float(value), rel.numpy())
    return out


# ---------------------------------------------------------------------------
# the cases (lxt_tpu's configs and init) and lxt_tpu's results
# ---------------------------------------------------------------------------

def _jax_modules():
    from lxt_tpu.models import bert, gemma3, gpt2, llama, mixtral, siglip, vit
    return {"llama": llama, "gemma3": gemma3, "gpt2": gpt2, "bert": bert,
            "siglip": siglip, "vit": vit, "mixtral": mixtral}


def _configs(J):
    llama_cfg = J["llama"].LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, rms_eps=1e-6)
    return {
        "llama": llama_cfg,
        "gemma3": J["gemma3"].Gemma3Config(
            vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, sliding_window=4,
            query_pre_attn_scalar=16, layer_types=("sliding_attention",
                                                   "full_attention")),
        "gpt2": J["gpt2"].GPT2Config(vocab_size=128, hidden_size=64, num_layers=2,
                                     num_heads=4, max_positions=64),
        "bert": J["bert"].BertConfig(vocab_size=128, hidden_size=64,
                                     intermediate_size=128, num_layers=2,
                                     num_heads=4, max_positions=64, num_labels=3),
        "siglip": J["siglip"].SiglipConfig(image_size=32, patch_size=8,
                                           hidden_size=32, intermediate_size=64,
                                           num_layers=2, num_heads=2),
        "vit": J["vit"].ViTConfig(image_size=32, patch_size=8, hidden_size=32,
                                  intermediate_size=64, num_layers=2, num_heads=2,
                                  num_classes=6),
        "mixtral": J["mixtral"].MixtralConfig(
            vocab_size=128, hidden_size=64, intermediate_size=96, num_layers=2,
            num_heads=4, num_kv_heads=2, num_experts=4, experts_per_token=2),
        "one_kv_head": dataclasses.replace(llama_cfg, num_kv_heads=1),
    }


def _random_biases(tree, rng):
    """Every bias leaf (``b*``, ``*_b`` under the layers, ``conv_b``,
    ``head_b``, the pooler and classifier biases) drawn at random; norms
    keep their init."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_biases(v, rng)
        elif (k.startswith("b") or k.endswith("_b")) and "ln" not in k:
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


def _numpy(tree):
    """A parameter tree of tensors (and QuantizedTensors) as numpy."""
    from lxt_tpu_torch.ops.quant import QuantizedTensor
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(tree.q.numpy(), tree.scale.numpy(), tree.bits, tree.block)
    return tree.numpy()


def _build_cases():
    """Each case's config (lxt_tpu's), weights (the port's init from a seed,
    as numpy; quantized by the port, whose codes and scales are lxt_tpu's
    bit for bit) and inputs."""
    from lxt_tpu_torch.ops.quant import quantize, quantize_params
    cfgs = _configs(_jax_modules())
    rng = np.random.default_rng(0)
    cases = {}
    for i, fam in enumerate(("llama", "gemma3", "gpt2", "bert", "siglip", "vit",
                             "mixtral", "one_kv_head")):
        family = "llama" if fam == "one_kv_head" else fam
        mod, config = _PORT[family]
        params = _numpy(mod.init_params(config(**dataclasses.asdict(cfgs[fam])),
                                        torch.Generator().manual_seed(i)))
        params = _random_biases(params, rng)
        if fam in ("siglip", "vit"):
            inputs = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
        else:
            inputs = rng.integers(1, 100, (B, T)).astype(np.int64)
        case = {"family": family, "cfg": dataclasses.asdict(cfgs[fam]),
                "params": params, "inputs": inputs, "jcfg": cfgs[fam]}
        if fam == "bert":
            case["kw"] = {"kv_end": np.array([16, 11, 16, 7], np.int32)}
        cases[fam] = case
    cases["one_kv_head_case"] = cases.pop("one_kv_head")
    dense = params_from_numpy(cases["llama"]["params"], device="cpu")
    for bits in (8, 4, "nf4"):
        if bits == "nf4":   # absmax blocks of 32, so that tp 2 splits whole blocks
            q = dict(dense, layers={k: quantize(v, "nf4", block=32) if v.dim() == 3
                                    else v for k, v in dense["layers"].items()})
        else:
            q = quantize_params(dense, bits=bits)
        cases[f"quant_{bits}"] = dict(cases["llama"], params=_numpy(q))
    cases["nf4_block64"] = {"params": _numpy(quantize_params(dense, bits="nf4"))}
    cases["sp_tp"] = {"cfg": dataclasses.asdict(cfgs["llama"]),
                      "params": cases["llama"]["params"],
                      "inputs": rng.integers(0, 128, (1, 256)).astype(np.int64),
                      "jcfg": cfgs["llama"]}
    return cases


def _jax_params(tree):
    """The numpy weights as lxt_tpu takes them (jnp arrays, its
    QuantizedTensor)."""
    import jax.numpy as jnp
    from lxt_tpu.ops.quant import QuantizedTensor
    if isinstance(tree, dict):
        return {k: _jax_params(v) for k, v in tree.items()}
    if hasattr(tree, "bits"):
        return QuantizedTensor(jnp.asarray(tree.q), jnp.asarray(tree.scale),
                               tree.bits, tree.block)
    return jnp.asarray(tree)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cases = _build_cases()
    port_cases = {k: {kk: vv for kk, vv in v.items() if kk != "jcfg"}
                  for k, v in cases.items()}
    got = spawn(_mesh_rank, 4, tmp_path_factory.mktemp("mesh"), port_cases)
    return cases, got


def _jax_single(case):
    """lxt_tpu's single-device ``input_relevance`` of a case."""
    import jax
    import jax.numpy as jnp
    import lxt_tpu
    from lxt_tpu.attribution import input_relevance, select_logit
    J = _jax_modules()
    family, cfg = case["family"], case["jcfg"]
    mod = J[family]
    params = _jax_params(case["params"])
    comp = getattr(lxt_tpu, _COMPOSITE.get(family, "attnlrp"))
    kw = {k: jnp.asarray(v) for k, v in case.get("kw", {}).items()}
    x = jnp.asarray(case["inputs"])
    if family == "gpt2":
        x = mod.embed(params, x)[0]
    elif family == "gemma3":
        x = mod.embed(params, x, cfg)
    elif family not in ("siglip", "vit"):
        x = mod.embed(params, x)

    def target(e):
        out = mod.forward(params, cfg, e, comp, **kw)
        if family in ("bert", "vit"):
            return out.logits.max(-1).sum()
        if family == "siglip":
            return out[..., 0].sum()
        return select_logit(out.logits)

    value, rel = jax.jit(lambda e: input_relevance(target, e))(x)
    return float(value), np.asarray(rel)


def _check(got, want, atol=REL_ATOL, what=""):
    np.testing.assert_allclose(got[0], want[0], rtol=VAL_RTOL, err_msg=what)
    assert got[1].shape == want[1].shape, what
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_llama_dp2_tp2_matches_lxt_tpu_attribute_sharded(run):
    import jax.numpy as jnp
    import lxt_tpu
    from lxt_tpu.attribution import select_logit
    from lxt_tpu.parallel import (attribute_sharded as jsharded,
                                  llama_param_shardings, make_mesh as jmesh,
                                  shard_params as jshard)
    cases, got = run
    case = cases["llama"]
    cfg, J = case["jcfg"], _jax_modules()
    mesh = jmesh(data=4, model=2)
    params = _jax_params(case["params"])
    sharded, _ = jshard(params, llama_param_shardings(mesh))
    e = J["llama"].embed(params, jnp.asarray(case["inputs"]))
    step = jsharded(lambda x: select_logit(J["llama"].forward(
        sharded, cfg, x, lxt_tpu.attnlrp).logits), mesh)
    value, rel = step(e)
    _check(got["llama"], (float(value), np.asarray(rel)), what="llama")
    _check(got["llama"], _jax_single(case), what="llama single")


@pytest.mark.parametrize("family", ["gemma3", "gpt2", "bert", "siglip", "vit"])
def test_family_tp2_matches_lxt_tpu(run, family):
    """Column- and row-parallel products, the row-parallel biases added once
    after the reduction (GPT-2 b_proj/b_out, BERT bo/bout, SigLIP, ViT),
    the fused q|k|v of GPT-2 and the ViT split by head groups, the
    vocabulary-split embedding and head (Gemma-3 tied, GPT-2's wte) and
    the ViT's class-split head."""
    cases, got = run
    _check(got[family], _jax_single(cases[family]), what=family)


def test_vit_gamma_tp2_float64(run):
    """The gamma rule at row-parallel products divides by the denominators
    summed over the shards (a shard's own z would cross 0 elsewhere)."""
    _, got = run
    tp_map, want = got["vit_gamma_f64"]
    assert tp_map.dtype == np.float64 and np.abs(want).max() > 0
    np.testing.assert_allclose(tp_map, want, rtol=0, atol=F64_ATOL)


@pytest.mark.parametrize("bits", [8, 4, "nf4"])
def test_quantized_tp2_matches_lxt_tpu(run, bits):
    """int8's per-output-channel scale stays replicated under the row split,
    int4's even/odd pairs stay together, NF4's codes are repacked per shard
    on whole absmax blocks (no re-quantization)."""
    cases, got = run
    _check(got[f"quant_{bits}"], _jax_single(cases[f"quant_{bits}"]),
           what=str(bits))


def test_nf4_split_off_its_blocks_is_refused(run):
    _, got = run
    assert got["nf4_block64"] is not None
    assert "absmax blocks of 64" in got["nf4_block64"]


def test_check_modes_are_refused_under_the_mesh(run):
    """The ring and the pipeline driver refuse the conservation and the NaN
    check alike on every process: their rule sites see one ring step's or
    one microbatch's relevance. (attribute_sharded and a tensor-parallel
    forward run both checks: the tests below.)"""
    _, got = run
    where = ["sequence parallelism", "pipeline parallelism"] * 2
    assert len(got["check_refusals"]) == len(where)
    for msg, what in zip(got["check_refusals"], where):
        assert msg is not None and msg.startswith(
            "the conservation and NaN checks do not run under"), msg
        assert what in msg, (msg, what)


@pytest.mark.parametrize("name", _CHECKED)
def test_conservation_check_dp2_tp2_matches_one_process(run, name):
    """Under conservation_check at dp 2 x tp 2 every rule site sums its
    incoming relevance and counts its inputs over the world (a shard over
    model adds up, a replicated tensor counts once, a column-parallel
    product's input fills its share): the gathered input relevance and
    conservation_error are those of one process running the whole batch
    (each tensor-parallel family, Mixtral at ep 2 and the NF4 Llama, under
    gamma at every linear and conv site)."""
    _, got = run
    res = got[f"checked_{name}"]
    (v_mesh, r_mesh, e_mesh), (v_one, r_one, e_one) = res["mesh"], res["single"]
    np.testing.assert_allclose(v_mesh, v_one, rtol=1e-6)
    assert r_mesh.shape == r_one.shape
    np.testing.assert_allclose(r_mesh, r_one, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(r_one).max()))
    np.testing.assert_allclose(e_mesh, e_one, rtol=0, atol=1e-6)


def test_nan_check_dp2_tp2_raises_the_same_site_on_every_rank(run):
    """A NaN in one process's head shard: that process's first non-finite
    site is the head's rule, the other model rank's comes later (after the
    copy's all-reduce) and the other data rank's never. The flags are
    reduced over the world before the one host read, so all four raise
    the head's site, and none waits in a collective another has left."""
    _, got = run
    msgs = got["nan_llama"]
    assert len(msgs) == 4 and all(m is not None for m in msgs), msgs
    assert len(set(msgs)) == 1, msgs
    assert msgs[0].startswith("NaN/Inf relevance at rule backward: gamma_linear "
                              "(site 1 of "), msgs[0]


def test_kv_heads_must_divide_over_tp(run):
    """A process runs whole heads: one kv head cannot split over tp 2."""
    _, got = run
    assert got["one_kv_head"] == "1 heads do not divide over 2 tensor-parallel processes"


def test_mixtral_ep2_matches_lxt_tpu(run):
    """Each process runs its two experts on the rows routed to them; the
    router is replicated, the combine a reduce."""
    cases, got = run
    _check(got["mixtral"], _jax_single(cases["mixtral"]), what="mixtral")


def test_sp2_tp2_matches_lxt_tpu(run):
    """The ring shifts over ``sp`` while each ring step runs on the local
    heads of ``model`` (replaces the refusal of ``param_shardings``)."""
    import jax
    import jax.numpy as jnp
    import lxt_tpu
    from jax.sharding import Mesh
    from lxt_tpu.attribution import input_relevance, select_logit
    from lxt_tpu.parallel import family_param_shardings as jshardings
    from lxt_tpu.parallel.ring import attribute_sequence_parallel as jasp
    cases, got = run
    case = cases["sp_tp"]
    cfg, jl = case["jcfg"], _jax_modules()["llama"]
    params = _jax_params(case["params"])
    e = jl.embed(params, jnp.asarray(case["inputs"]))
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("sp", "model"))
    value, rel = jasp(jl.forward, params, cfg, e, mesh, lxt_tpu.attnlrp,
                      param_shardings=jshardings("llama", params, mesh))
    _check(got["sp_tp"], (float(value), np.asarray(rel)), atol=SPTP_ATOL,
           what="sp x tp")
    single = input_relevance(lambda x: select_logit(jl.forward(
        params, cfg, x, lxt_tpu.attnlrp, attn_impl="einsum").logits), e)
    _check(got["sp_tp"], (float(single[0]), np.asarray(single[1])),
           atol=SPTP_ATOL, what="sp x tp single")


def test_conservation_check_dp2_tp2_matches_lxt_tpu_attribute_sharded(run):
    """lxt_tpu's attribute_sharded is one GSPMD program over global arrays,
    so its conservation check sums over the whole batch: the port's dp 2 x
    tp 2 run gives its value, map and conservation_error."""
    import jax.numpy as jnp
    import lxt_tpu
    from lxt_tpu.attribution import select_logit
    from lxt_tpu.ops.check import conservation_check as jconservation
    from lxt_tpu.ops.check import conservation_error as jerror
    from lxt_tpu.parallel import (attribute_sharded as jsharded,
                                  llama_param_shardings, make_mesh as jmesh,
                                  shard_params as jshard)
    cases, got = run
    case = cases["llama"]
    cfg, jl = case["jcfg"], _jax_modules()["llama"]
    params = _jax_params(case["params"])
    sharded, _ = jshard(params, llama_param_shardings(jmesh(data=4, model=2)))
    comp = lxt_tpu.attnlrp.with_gamma(linear_gamma=0.25)
    e = jl.embed(params, jnp.asarray(case["inputs"]))
    with jconservation():
        value, rel = jsharded(lambda x: select_logit(jl.forward(
            sharded, cfg, x, comp).logits), jmesh(data=4, model=2))(e)
    want = np.asarray(rel)
    v_mesh, r_mesh, e_mesh = got["checked_llama"]["mesh"]
    np.testing.assert_allclose(v_mesh, float(value), rtol=VAL_RTOL)
    np.testing.assert_allclose(r_mesh, want, rtol=0, atol=2e-5 * np.abs(want).max())
    np.testing.assert_allclose(e_mesh, float(jerror(rel, value)), rtol=2e-5)
