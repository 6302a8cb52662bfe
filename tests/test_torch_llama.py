"""The lxt_tpu_torch Llama slice against lxt_tpu, on CPU, end to end.

Tiny 2-layer float32 configs of each family the forward covers — Llama,
Qwen2 (qkv bias), Qwen3 (qk norm), Mistral (sliding window) and Phi-3
(fused projections from an HF-named state dict, longrope) — run through
both packages on the same weights (``convert.params_from_numpy``) and
inputs. Logits and input relevance (Gradient*Input of the last position's
top logit) must agree within normalized L2 <= 1e-5 under attnlrp, cp_lrp
and vanilla_gradient, for the port's einsum path and its flash path (the
kernels' plain versions on CPU). lxt_tpu runs its einsum path.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lxt_tpu
import lxt_tpu_torch
from lxt_tpu.attribution import input_relevance as j_input_relevance
from lxt_tpu.attribution import select_logit as j_select_logit
from lxt_tpu.models import llama as jllama
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import llama as tllama

REPO = pathlib.Path(__file__).resolve().parent.parent
BAR = 1e-5  # normalized L2, ROADMAP queue 1 item 5
T = 128     # a multiple of 128, so the port's flash path is eligible
BASE = dict(vocab_size=97, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2)
CONFIGS = {
    "llama": jllama.LlamaConfig(**BASE),
    "qwen2": jllama.LlamaConfig(**BASE, qkv_bias=True),
    "qwen3": jllama.LlamaConfig(**BASE, qk_norm=True, head_dim=32),
    "mistral": jllama.LlamaConfig(**BASE, sliding_window=40),
}
COMPOSITES = ["attnlrp", "cp_lrp", "vanilla_gradient"]


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _numpy_params(cfg, seed):
    """Random numpy weights in lxt_tpu's layout (norm weights near 1,
    nonzero biases so every term is exercised)."""
    rng = np.random.default_rng(seed)
    L, D, I, hd = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.hd
    H, Hkv = cfg.num_heads, cfg.num_kv_heads

    def w(*s):
        return (0.1 * rng.standard_normal(s)).astype(np.float32)

    def norm(*s):
        return (1.0 + 0.1 * rng.standard_normal(s)).astype(np.float32)

    layers = dict(ln1=norm(L, D), ln2=norm(L, D), wq=w(L, D, H * hd),
                  wk=w(L, D, Hkv * hd), wv=w(L, D, Hkv * hd),
                  wo=w(L, H * hd, D), wg=w(L, D, I), wu=w(L, D, I),
                  wd=w(L, I, D))
    if cfg.qkv_bias:
        layers.update(bq=w(L, H * hd), bk=w(L, Hkv * hd), bv=w(L, Hkv * hd))
    if cfg.qk_norm:
        layers.update(q_norm=norm(L, hd), k_norm=norm(L, hd))
    return {"embed": w(cfg.vocab_size, D), "final_norm": norm(D),
            "layers": layers, "lm_head": w(D, cfg.vocab_size)}


def _phi3():
    """Tiny Phi-3 (longrope) from an HF-named numpy state dict with fused
    qkv_proj / gate_up_proj, converted by each package's params_from_hf."""
    hd, L = 16, 2
    factors = tuple(1.0 + 0.1 * i for i in range(hd // 2))
    hf_cfg = types.SimpleNamespace(
        model_type="phi3", vocab_size=97, hidden_size=64,
        intermediate_size=128, num_hidden_layers=L, num_attention_heads=4,
        num_key_value_heads=4, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, sliding_window=96,
        max_position_embeddings=512, original_max_position_embeddings=64,
        rope_scaling={"type": "longrope", "short_factor": factors,
                      "long_factor": tuple(2 * f for f in factors)})
    rng = np.random.default_rng(7)

    def w(*s):
        return (0.1 * rng.standard_normal(s)).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(97, 64), "lm_head.weight": w(97, 64),
          "model.norm.weight": 1 + w(64)}
    for i in range(L):
        p = f"model.layers.{i}."
        sd.update({p + "self_attn.qkv_proj.weight": w(3 * 64, 64),
                   p + "self_attn.o_proj.weight": w(64, 64),
                   p + "mlp.gate_up_proj.weight": w(2 * 128, 64),
                   p + "mlp.down_proj.weight": w(64, 128),
                   p + "input_layernorm.weight": 1 + w(64),
                   p + "post_attention_layernorm.weight": 1 + w(64)})
    return hf_cfg, sd


def _setup(family):
    if family == "phi3":
        hf_cfg, sd = _phi3()
        jcfg = jllama.LlamaConfig.from_hf(hf_cfg)
        tcfg = tllama.LlamaConfig.from_hf(hf_cfg)
        jparams = jllama.params_from_hf(sd, jcfg)
        tparams = tllama.params_from_hf(sd, tcfg, device="cpu")
        return jcfg, jparams, tcfg, tparams
    jcfg = CONFIGS[family]
    jparams = _numpy_params(jcfg, sorted(CONFIGS).index(family))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg, params_from_numpy(jparams, device="cpu")


def _jax_run(jcfg, jparams, ids, composite, **kw):
    params = jax.tree.map(jnp.asarray, jparams)
    comp = getattr(lxt_tpu, composite)
    e = jllama.embed(params, jnp.asarray(ids))
    logits = jllama.forward(params, jcfg, e, comp, remat=False, **kw).logits
    _, rel = j_input_relevance(
        lambda x: j_select_logit(jllama.forward(
            params, jcfg, x, comp, remat=False, logits_at=-1, **kw).logits), e)
    return np.asarray(logits), np.asarray(rel)


def _torch_run(tcfg, tparams, ids, composite, impl, remat=False, **kw):
    comp = getattr(lxt_tpu_torch, composite)
    e = tllama.embed(tparams, torch.as_tensor(ids))
    with torch.no_grad():
        logits = tllama.forward(tparams, tcfg, e, comp, remat=remat,
                                attn_impl=impl, **kw).logits
    _, rel = lxt_tpu_torch.input_relevance(
        lambda x: lxt_tpu_torch.select_logit(tllama.forward(
            tparams, tcfg, x, comp, remat=remat, logits_at=-1,
            attn_impl=impl, **kw).logits), e)
    return logits.numpy(), rel.numpy()


@pytest.mark.parametrize("composite", COMPOSITES)
@pytest.mark.parametrize("family", sorted(CONFIGS) + ["phi3"])
def test_llama_slice_matches_lxt_tpu(family, composite):
    jcfg, jparams, tcfg, tparams = _setup(family)
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, T))
    want_logits, want_rel = _jax_run(jcfg, jparams, ids, composite)
    for impl in ("einsum", "flash"):
        logits, rel = _torch_run(tcfg, tparams, ids, composite, impl)
        assert _nl2(logits, want_logits) <= BAR, impl
        assert _nl2(rel, want_rel) <= BAR, impl


def test_left_padding_kv_begin_matches_lxt_tpu():
    """kv_begin left padding: per-example positions (rope outside the
    kernels), padded keys masked; real positions agree, with remat on."""
    jcfg, jparams, tcfg, tparams = _setup("llama")
    ids = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, T))
    kv_begin = np.asarray([9, 0], np.int32)
    want_logits, want_rel = _jax_run(jcfg, jparams, ids, "attnlrp",
                                     kv_begin=jnp.asarray(kv_begin))
    for impl in ("einsum", "flash"):
        logits, rel = _torch_run(tcfg, tparams, ids, "attnlrp", impl,
                                 remat=True, kv_begin=torch.as_tensor(kv_begin))
        assert _nl2(logits[0, 9:], want_logits[0, 9:]) <= BAR, impl
        assert _nl2(logits[1], want_logits[1]) <= BAR, impl
        assert _nl2(rel, want_rel) <= BAR, impl


def test_attention_mask_padding_matches_lxt_tpu():
    """A [B, T] attention_mask (additive bias, einsum path in both)."""
    jcfg, jparams, tcfg, tparams = _setup("qwen2")
    ids = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 32))
    mask = np.ones((2, 32), np.int32)
    mask[0, :5] = 0
    want_logits, want_rel = _jax_run(jcfg, jparams, ids, "cp_lrp",
                                     attention_mask=jnp.asarray(mask))
    logits, rel = _torch_run(tcfg, tparams, ids, "cp_lrp", "auto",
                             attention_mask=torch.as_tensor(mask))
    assert _nl2(logits[0, 5:], want_logits[0, 5:]) <= BAR
    assert _nl2(logits[1], want_logits[1]) <= BAR
    assert _nl2(rel, want_rel) <= BAR


def test_hidden_states_and_tied_head_match_lxt_tpu():
    """Tied embeddings, per-layer probes and the stacked hidden states."""
    jcfg, jparams, tcfg, tparams = _setup("llama")
    jcfg = dataclasses.replace(jcfg, tie_embeddings=True)
    tcfg = dataclasses.replace(tcfg, tie_embeddings=True)
    del jparams["lm_head"], tparams["lm_head"]
    ids = np.random.default_rng(5).integers(0, jcfg.vocab_size, (1, 16))
    probes = 0.1 * np.random.default_rng(6).standard_normal(
        (jcfg.num_layers, 1, 16, jcfg.hidden_size)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, jparams)
    want = jllama.forward(params, jcfg, jllama.embed(params, jnp.asarray(ids)),
                          output_hidden_states=True, probes=jnp.asarray(probes))
    got = tllama.forward(tparams, tcfg, tllama.embed(tparams, torch.as_tensor(ids)),
                         output_hidden_states=True, probes=torch.tensor(probes))
    assert got.hidden_states.shape == want.hidden_states.shape
    assert _nl2(got.hidden_states.detach(), want.hidden_states) <= BAR
    assert _nl2(got.logits.detach(), want.logits) <= BAR


@pytest.mark.parametrize("model_type", ["llama", "qwen2", "mistral"])
def test_config_from_hf_matches_lxt_tpu(model_type):
    hf = types.SimpleNamespace(
        model_type=model_type, vocab_size=11, hidden_size=8,
        intermediate_size=16, num_hidden_layers=1, num_attention_heads=2,
        num_key_value_heads=1, rms_norm_eps=1e-6, rope_theta=5e5,
        sliding_window=4, use_sliding_window=False,
        rope_scaling={"rope_type": "llama3", "factor": 8.0})
    assert dataclasses.asdict(tllama.LlamaConfig.from_hf(hf)) == \
        dataclasses.asdict(jllama.LlamaConfig.from_hf(hf))


def test_init_params_shapes_match_lxt_tpu():
    cfg = jllama.LlamaConfig(**BASE, qkv_bias=True, qk_norm=True)
    want = jllama.init_params(cfg, jax.random.PRNGKey(0))
    got = tllama.init_params(tllama.LlamaConfig(**dataclasses.asdict(cfg)),
                             torch.Generator().manual_seed(0))

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(shapes(v, prefix + k + "/"))
            else:
                out[prefix + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
        return out

    assert shapes(got) == shapes(want)


def _imports_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] in ("jax", "lxt_tpu") for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module.split(".")[0] in ("jax", "lxt_tpu"):
                return True
    return False


def test_port_imports_no_jax():
    """No module of lxt_tpu_torch, nor chip_smoke.py, imports jax or the
    JAX package (the card's machine has no jax)."""
    files = sorted((REPO / "lxt_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"lxt_tpu_torch/ops/quant.py", "lxt_tpu_torch/io.py",
            "lxt_tpu_torch/models/registry.py", "lxt_tpu_torch/models/vit.py",
            "lxt_tpu_torch/models/siglip.py",
            "lxt_tpu_torch/ops/functional.py"} <= names
    offenders = [str(f.relative_to(REPO)) for f in files if _imports_jax(f)]
    assert not offenders, offenders


def test_chip_smoke_fails_without_cuda():
    """chip_smoke.py exits non-zero and prints no result line on a machine
    with no CUDA device."""
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
