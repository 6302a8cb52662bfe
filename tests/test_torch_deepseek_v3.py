"""The lxt_tpu_torch DeepSeek-V3 family (latent attention, a dense first
layer, then a sigmoid-routed mixture of small experts beside shared ones)
on CPU, against transformers' ``DeepseekV3ForCausalLM`` and the
benchmark's plain reference (``bench_port/reference/deepseek_v3.py``).
``lxt_tpu`` has no such model, so these are its ground truths.

A tiny float32 config (D 64, 4 heads of q/k 16 + 8 and v 16, kv rank 32,
8 experts top 3 and 2 shared of width 32, 1 dense layer of width 96 then 2
mixture layers, vocab 128), every case converted through ``from_hf``:

- logits equal transformers' within 3e-4 (the bar of the Mixtral and
  GPT-2 checks against transformers), with ``q_lora_rank`` null and set
  and with group-limited routing;
- relevance equals the plain reference's within 1e-5 normalized L2 under
  attnlrp and cp_lrp, on the einsum path and the flash path's plain CPU
  version (T 128, on the kernels' grid);
- the ragged mixture equals the dense one; a selection bias that changes
  the choice leaves the chosen experts' weights at their scores; a
  left-padded batch equals its rows run alone; CP-LRP conserves the target
  at every layer;
- the registry: ``detect_family``, ``from_pretrained`` of a checkpoint the
  test writes, ``read_hf_config``'s defaults against ``AutoConfig``, and
  the refusals (``generate``, quantization, tensor parallelism,
  ``rope_scaling``, ``scoring_func``).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lxt_tpu_torch
from lxt_tpu_torch.models import deepseek_v3 as dsv3
from lxt_tpu_torch.models import mixtral, registry

transformers = pytest.importorskip("transformers")

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.reference import deepseek_v3 as ref  # noqa: E402
from bench_port.reference import plain  # noqa: E402

BAR = 1e-5      # normalized L2, float32
HF_ATOL = 3e-4
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
            moe_intermediate_size=32, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4, n_shared_experts=2,
            n_routed_experts=8, num_experts_per_tok=3,
            routed_scaling_factor=2.446, kv_lora_rank=32, q_lora_rank=None,
            qk_rope_head_dim=8, v_head_dim=16, qk_nope_head_dim=16, n_group=1,
            topk_group=1, first_k_dense_replace=1, rope_theta=50000.0,
            rms_norm_eps=1e-5, max_position_embeddings=256)
_MODELS = {}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: one intra-op thread, restored after the module (the
    parallel test run's workers would otherwise contend for the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf(**kw):
    """A tiny transformers model with weights N(0, 0.1), norm gains
    1 + N(0, 0.1) and selection biases N(0, 0.05), cached per config."""
    key = tuple(sorted(kw.items()))
    if key not in _MODELS:
        torch.manual_seed(len(_MODELS))
        cfg = transformers.DeepseekV3Config(**dict(TINY, **kw),
                                            attn_implementation="eager")
        m = transformers.DeepseekV3ForCausalLM(cfg).eval()
        with torch.no_grad():
            for name, p in m.named_parameters():
                p.normal_(1.0 if "norm" in name else 0.0, 0.1)
            for name, b in m.named_buffers():
                if "e_score_correction_bias" in name:
                    b.normal_(0.0, 0.05)
        _MODELS[key] = m
    return _MODELS[key]


def _ids(seed, B, T):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 128, (B, T)))


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _relevance(model, ids, impl, composite=None, **kw):
    run = model._forward(composite, attn_impl=impl, **kw)
    return lxt_tpu_torch.input_relevance(
        lambda e: lxt_tpu_torch.select_logit(run(e, logits_at=-1).logits),
        model.embed(ids))


@pytest.mark.parametrize("kw", [{}, {"q_lora_rank": 24},
                                {"n_group": 2, "topk_group": 1}],
                         ids=["q_lora_null", "q_lora_24", "n_group_2"])
def test_logits_match_transformers(kw):
    hf = _hf(**kw)
    model = lxt_tpu_torch.from_hf(hf, device="cpu")
    assert model.family == "deepseek_v3"
    ids = _ids(1, 2, 128)
    with torch.no_grad():
        want = hf(ids).logits
        for impl in ("einsum", "flash"):
            got = model._forward(attn_impl=impl)(model.embed(ids)).logits
            torch.testing.assert_close(got, want, rtol=0, atol=HF_ATOL)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("composite", ["attnlrp", "cp_lrp"])
def test_relevance_matches_the_plain_reference(composite, impl):
    hf = _hf(q_lora_rank=24)
    model = lxt_tpu_torch.from_hf(hf, composite=getattr(lxt_tpu_torch, composite),
                                  device="cpu")
    ids = _ids(2, 1, 128)
    value, rel = _relevance(model, ids, impl)
    sd = hf.state_dict()
    reference = ref.Model({"config": hf.config.to_dict()}, sd.__getitem__, "cpu")
    reference.cp = composite == "cp_lrp"
    res = plain.explain(reference, ids[0])
    assert abs(float(value) - res["logit"]) <= 1e-4
    assert _nl2(rel[0], res["relevance"]) <= BAR


def _block(seed, E=8):
    rng = np.random.default_rng(seed)
    D, I = 64, 32

    def w(*s):
        return torch.from_numpy((0.1 * rng.standard_normal(s)).astype(np.float32))

    lp = {"w_router": w(D, E), "e_bias": w(E), "wg": w(E, D, I), "wu": w(E, D, I),
          "wd": w(E, I, D), "s_wg": w(D, 2 * I), "s_wu": w(D, 2 * I),
          "s_wd": w(2 * I, D)}
    x = torch.from_numpy(rng.standard_normal((2, 40, D)).astype(np.float32))
    return lp, x


def test_ragged_mixture_equals_dense():
    cfg = dsv3.DeepseekV3Config(hidden_size=64, num_experts=8, experts_per_token=3,
                                n_group=1, topk_group=1, routed_scaling_factor=2.446)
    lp, x = _block(3)
    ct = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    outs = []
    for impl in ("ragged", "dense"):
        c = dsv3.DeepseekV3Config(**{**cfg.__dict__, "moe_impl": impl})
        xt = x.clone().requires_grad_()
        mixtral.reset_routing()
        out = dsv3.moe_block(xt, lp, c, lxt_tpu_torch.attnlrp, torch.nn.functional.silu)
        outs.append((out.detach(), torch.autograd.grad(out, xt, ct)[0]))
        if impl == "ragged":
            assert mixtral.routing["host_reads"] == 1
    assert _nl2(outs[0][0], outs[1][0]) <= BAR
    assert _nl2(outs[0][1], outs[1][1]) <= BAR


def test_selection_bias_moves_the_choice_not_the_weights():
    cfg = dsv3.DeepseekV3Config(hidden_size=64, num_experts=8, experts_per_token=3,
                                n_group=1, topk_group=1, routed_scaling_factor=2.446)
    lp, x = _block(4)
    xf = x.reshape(-1, 64)
    scores = torch.sigmoid(xf @ lp["w_router"])
    _, plain_ids = dsv3._route(xf, dict(lp, e_bias=torch.zeros(8)), cfg,
                               lxt_tpu_torch.attnlrp)
    lp["e_bias"] = torch.zeros(8).index_fill_(0, torch.tensor([5]), 1.0)
    w, ids = dsv3._route(xf, lp, cfg, lxt_tpu_torch.attnlrp)
    assert (ids == 5).any(-1).all() and not (plain_ids == 5).any(-1).all()
    chosen = scores.gather(-1, ids)
    torch.testing.assert_close(w, chosen / chosen.sum(-1, keepdim=True) * 2.446,
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_left_padded_batch_equals_its_rows(impl):
    model = lxt_tpu_torch.from_hf(_hf(), device="cpu")
    ids = _ids(5, 2, 128)
    kv_begin = torch.tensor([0, 37], dtype=torch.int32)
    value, rel = _relevance(model, ids, impl, kv_begin=kv_begin)
    for b in range(2):
        s = int(kv_begin[b])
        _, r = _relevance(model, ids[b:b + 1, s:], "einsum")
        assert _nl2(rel[b, s:], r[0]) <= BAR
        assert float(rel[b, :s].abs().sum()) == 0.0
    alone = sum(float(_relevance(model, ids[b:b + 1, int(kv_begin[b]):], "einsum")[0])
                for b in range(2))
    assert abs(float(value) - alone) <= 1e-4


def test_cp_lrp_conserves_the_target_at_every_layer():
    model = lxt_tpu_torch.from_hf(_hf(), composite=lxt_tpu_torch.cp_lrp, device="cpu")
    value, rel, latent = model.attribute_latent(_ids(6, 1, 24))
    totals = [float(rel.sum())] + [float(layer.sum()) for layer in latent]
    np.testing.assert_allclose(totals, float(value), rtol=1e-4)


def test_registry_detects_loads_and_refuses(tmp_path):
    hf = _hf()
    assert registry.detect_family(hf.config) == "deepseek_v3"
    assert list(registry.FAMILIES)[-1] == "deepseek_v3"
    hf.save_pretrained(tmp_path, safe_serialization=True)
    model = lxt_tpu_torch.from_pretrained(tmp_path, device="cpu")
    ids = _ids(7, 1, 20)
    with torch.no_grad():
        torch.testing.assert_close(model.logits(ids), hf(ids).logits, rtol=0,
                                   atol=HF_ATOL)
    with pytest.raises(NotImplementedError, match="deepseek_v3"):
        model.generate(ids, 2)
    with pytest.raises(ValueError, match="quantize_bits"):
        lxt_tpu_torch.from_pretrained(tmp_path, device="cpu", quantize_bits="nf4")
    from lxt_tpu_torch.parallel import mesh
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        mesh.model_param_shardings(model, None)
    for key, value in (("rope_scaling", {"rope_type": "yarn", "factor": 4.0}),
                       ("scoring_func", "softmax"),
                       ("quantization_config", {"quant_method": "fp8"})):
        raw = json.loads((tmp_path / "config.json").read_text())
        (tmp_path / "config.json").write_text(json.dumps(dict(raw, **{key: value})))
        with pytest.raises(ValueError, match=key):
            lxt_tpu_torch.from_pretrained(tmp_path, device="cpu")
        (tmp_path / "config.json").write_text(json.dumps(raw))


def test_read_hf_config_fills_as_autoconfig(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "deepseek_v3"}))
    got = registry.read_hf_config(tmp_path)
    want = transformers.AutoConfig.from_pretrained(tmp_path)
    for key in registry._HF_DEFAULTS["deepseek_v3"]:
        assert getattr(got, key) == getattr(want, key), key
    assert dsv3.DeepseekV3Config.from_hf(got) == dsv3.DeepseekV3Config.from_hf(want)
