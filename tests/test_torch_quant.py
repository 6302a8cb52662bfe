"""The port's quantized path (lxt_tpu_torch.ops.quant) against lxt_tpu's, on
CPU.

Inputs are made by numpy from a seed and handed to both packages. Codes,
scales and dequantized weights must be bit-exact (int8 / int4 / nf4, 2-D
and layer-stacked); the plain version of K3 is bit-exact against lxt_tpu's
Pallas nf4 kernel in interpret mode; ``quant_matmul`` forward and input
gradient agree within rtol 1e-5; the bitsandbytes ingest is bit-exact; and a
quantized tiny Llama attributes within normalized L2 1e-5 of lxt_tpu in
float32. On CPU tensors K3's wrapper runs its plain version, so its launch
count stays 0.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lxt_tpu
from lxt_tpu.attribution import input_relevance as j_input_relevance
from lxt_tpu.attribution import select_logit as j_select_logit
from lxt_tpu.models import llama as jllama
from lxt_tpu.ops import quant as jq
import lxt_tpu_torch
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import llama as tllama
from lxt_tpu_torch.ops import quant as tq

BITS = [8, 4, "nf4"]
BAR = 1e-5  # normalized L2 of relevance, as for the unquantized slice
# 2-D, layer-stacked, and a tiny input dim where the nf4 block shrinks to 2
SHAPES = {"2d": (256, 96), "stacked": (3, 256, 96), "tiny_k": (2, 6, 10)}


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _weight(shape, seed=0, scale=0.1):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _both(w, bits):
    return jq.quantize(jnp.asarray(w), bits), tq.quantize(torch.from_numpy(w), bits)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("bits", BITS)
def test_quantize_bit_exact(bits, shape):
    jqt, tqt = _both(_weight(SHAPES[shape]), bits)
    assert (tqt.bits, tqt.block, tqt.shape) == (jqt.bits, jqt.block, jqt.shape)
    assert tqt.q.dtype == {8: torch.int8}.get(bits, torch.uint8)
    np.testing.assert_array_equal(tqt.q.numpy(), np.asarray(jqt.q))
    np.testing.assert_array_equal(tqt.scale.numpy(), np.asarray(jqt.scale))
    if shape == "tiny_k" and bits == "nf4":
        assert tqt.block == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", BITS)
def test_dequantize_bit_exact(bits, dtype):
    for shape in SHAPES.values():
        jqt, tqt = _both(_weight(shape, seed=1), bits)
        got = tq.dequantize(tqt, getattr(torch, dtype))
        want = jq.dequantize(jqt, getattr(jnp, dtype))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))


def test_bf16_weights_quantize_bit_exact():
    w = _weight((2, 128, 64), seed=2, scale=0.02)
    for bits in BITS:
        jqt = jq.quantize(jnp.asarray(w, jnp.bfloat16), bits)
        tqt = tq.quantize(torch.from_numpy(w).bfloat16(), bits)
        np.testing.assert_array_equal(tqt.q.numpy(), np.asarray(jqt.q))
        np.testing.assert_array_equal(tqt.scale.numpy(), np.asarray(jqt.scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nf4_dequant_plain_matches_pallas_kernel(dtype):
    """K3's plain version against lxt_tpu's Pallas kernel (interpret mode)
    on codes q (128, 256)."""
    jqt, tqt = _both(_weight((256, 256), seed=3), "nf4")
    assert tuple(tqt.q.shape) == (128, 256)
    want = jq.nf4_dequant(jqt.q, jqt.scale, jqt.block, getattr(jnp, dtype))
    assert want is not None  # the Pallas kernel ran, not lxt_tpu's fallback
    tq.reset_launches()
    got = tq.nf4_dequant(tqt.q, tqt.scale, tqt.block, getattr(torch, dtype))
    assert tq.launches["nf4_dequant"] == 0
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))
    np.testing.assert_array_equal(
        got.float().numpy(), tq.nf4_dequant_ref(tqt.q, tqt.scale, tqt.block,
                                                getattr(torch, dtype)).float().numpy())


def test_nf4_dequant_raises_off_cpu_and_cuda():
    """A tensor neither on the CPU nor on a CUDA device is refused, not
    silently dequantized by the plain version."""
    tqt = tq.quantize(torch.from_numpy(_weight((128, 64))), "nf4")
    with pytest.raises(ValueError, match="unsupported device"):
        tq.nf4_dequant(tqt.q.to("meta"), tqt.scale.to("meta"), tqt.block,
                       torch.float32)


@pytest.mark.parametrize("x_shape", [(8, 128), (2, 5, 128)])
@pytest.mark.parametrize("bits", BITS)
def test_quant_matmul_matches_lxt_tpu(bits, x_shape):
    """Forward and input gradient of ``x @ dequant(qt)`` (with a bias), 2-D
    and 3-D x, against lxt_tpu's quant_matmul and its custom backwards."""
    w = _weight((128, 48), seed=4)
    x = _weight(x_shape, seed=5, scale=1.0)
    ct = _weight(x_shape[:-1] + (48,), seed=6, scale=1.0)
    b = _weight((48,), seed=7)
    jqt, tqt = _both(w, bits)

    def jf(xx):
        return jnp.sum(jq.quant_matmul(xx, jqt, jnp.asarray(b)) * ct)

    want_y = jq.quant_matmul(jnp.asarray(x), jqt, jnp.asarray(b))
    want_dx = jax.grad(jf)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tq.quant_matmul(xt, tqt, torch.from_numpy(b))
    (dx,) = torch.autograd.grad((y * torch.from_numpy(ct)).sum(), xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_layer_stacked_matches_lxt_tpu(bits):
    """Layer-stacked weights with a batched x (the int4 branch that keeps
    plain autograd)."""
    w = _weight((3, 64, 32), seed=8)
    x = _weight((3, 7, 64), seed=9, scale=1.0)
    jqt, tqt = _both(w, bits)
    want_y = jq.quant_matmul(jnp.asarray(x), jqt)
    want_dx = jax.grad(lambda xx: jnp.sum(jq.quant_matmul(xx, jqt) ** 2))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tq.quant_matmul(xt, tqt)
    (dx,) = torch.autograd.grad((y ** 2).sum(), xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx),
                               rtol=1e-5, atol=1e-6)


def test_quantized_tensor_slicing_and_device():
    tqt = tq.quantize(torch.from_numpy(_weight((3, 64, 32))), "nf4")
    one = tqt[1]
    assert one.shape == (64, 32) and one.block == tqt.block == 64
    assert torch.equal(one.q, tqt.q[1]) and torch.equal(one.scale, tqt.scale[1])
    moved = tqt.to("cpu")
    assert moved.q.device.type == moved.scale.device.type == "cpu"
    assert (moved.bits, moved.block) == ("nf4", 64)


def _np_params(cfg, seed):
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
                  wd=w(L, I, D), bq=w(L, H * hd), bk=w(L, Hkv * hd),
                  bv=w(L, Hkv * hd))
    return {"embed": w(cfg.vocab_size, D), "final_norm": norm(D),
            "layers": layers, "lm_head": w(D, cfg.vocab_size)}


def _kinds(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_kinds(v, prefix + k + "/"))
        else:
            out[prefix + k] = (type(v).__name__ == "QuantizedTensor",
                               getattr(v, "bits", None), tuple(v.shape))
    return out


@pytest.mark.parametrize("family", [None, "llama", "qwen2"])
@pytest.mark.parametrize("bits", BITS)
def test_quantize_params_selects_same_leaves(bits, family):
    cfg = jllama.LlamaConfig(vocab_size=97, hidden_size=64,
                             intermediate_size=128, num_layers=2, num_heads=4,
                             num_kv_heads=2, qkv_bias=True)
    params = _np_params(cfg, 0)
    want = jq.quantize_params(jax.tree.map(jnp.asarray, params), bits=bits,
                              family=family)
    got = tq.quantize_params(params_from_numpy(params, device="cpu"), bits=bits,
                             family=family)
    assert _kinds(got) == _kinds(want)
    assert isinstance(got["layers"]["wq"], tq.QuantizedTensor)
    assert not isinstance(got["lm_head"], tq.QuantizedTensor)
    assert tq.FAMILY_QUANTIZABLE == jq.FAMILY_QUANTIZABLE


def test_quantize_params_unknown_family_raises():
    with pytest.raises(ValueError, match="no quantizable-leaf spec"):
        tq.quantize_params({}, family="nope")


def _bnb_4bit_state(seed, prefix, nested):
    """A bitsandbytes 4-bit serialized entry (flat blocks of 64, nearest
    code, first element in the high nibble), optionally double-quantized."""
    rng = np.random.default_rng(seed)
    shape = (16, 128)
    blocks = rng.standard_normal(shape).astype(np.float32).reshape(-1, 64)
    absmax = np.abs(blocks).max(axis=1).astype(np.float32)
    idx = np.argmin(np.abs((blocks / absmax[:, None])[..., None] - jq.NF4_CODE),
                    axis=-1).reshape(-1).astype(np.uint8)
    packed = ((idx[0::2] << 4) | idx[1::2]).reshape(-1, 1)
    meta = {"blocksize": 64, "quant_type": "nf4", "dtype": "bfloat16",
            "shape": list(shape)}
    state = {prefix: packed, f"{prefix}.quant_map": jq.NF4_CODE.copy()}
    if nested:
        offset = np.float32(absmax.mean())
        centered = (absmax - offset).reshape(-1, 16)
        nmap = np.linspace(-1.0, 1.0, 256).astype(np.float32)
        nabs = np.abs(centered).max(axis=1).astype(np.float32)
        aidx = np.argmin(np.abs((centered / nabs[:, None])[..., None] - nmap),
                         axis=-1).astype(np.uint8)
        state.update({f"{prefix}.absmax": aidx.reshape(-1),
                      f"{prefix}.nested_absmax": nabs,
                      f"{prefix}.nested_quant_map": nmap})
        meta.update(nested_blocksize=16, nested_offset=float(offset))
    else:
        state[f"{prefix}.absmax"] = absmax
    state[f"{prefix}.quant_state.bitsandbytes__nf4"] = np.frombuffer(
        json.dumps(meta).encode(), np.uint8).copy()
    return state


def test_ingest_bnb_state_dict_matches_lxt_tpu():
    """4-bit (plain and nested absmax) and 8-bit (int8 codes + SCB)
    entries, side by side with a plain tensor: the same rewritten names,
    the same remaining keys, bit-exact values."""
    rng = np.random.default_rng(12)
    cb = rng.integers(-127, 128, (16, 32)).astype(np.int8)
    state = {"other": np.ones(3, np.float32),
             "c.weight": cb, "c.weight.SCB": rng.uniform(0.5, 2, 16).astype(np.float32),
             "c.weight.weight_format": np.zeros((), np.int64)}
    state.update(_bnb_4bit_state(0, "a.weight", nested=False))
    state.update(_bnb_4bit_state(1, "b.weight", nested=True))
    jstate = {k: v.copy() for k, v in state.items()}
    want = jq.ingest_bnb_state_dict(jstate)
    got = tq.ingest_bnb_state_dict(state)
    assert got == want == ["a.weight", "b.weight", "c.weight"]
    assert sorted(state) == sorted(jstate) == ["a.weight", "b.weight",
                                               "c.weight", "other"]
    for k in state:
        assert state[k].dtype == jstate[k].dtype
        np.testing.assert_array_equal(state[k], jstate[k])
    assert tq.ingest_bnb_state_dict({"w": np.ones(2, np.float32)}) == []


QCFG = jllama.LlamaConfig(vocab_size=97, hidden_size=64, intermediate_size=128,
                          num_layers=2, num_heads=4, num_kv_heads=2)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("bits", BITS)
def test_quantized_llama_attribution_matches_lxt_tpu(bits, remat):
    """Weights quantized by lxt_tpu, carried across by params_from_numpy
    (integer codes keep their dtype, scales stay float32): logits and
    relevance within normalized L2 1e-5 of lxt_tpu in float32. On CPU K3's
    launch count stays 0."""
    params = _np_params(dataclasses.replace(QCFG), 1)
    for k in ("bq", "bk", "bv"):
        del params["layers"][k]
    jparams = jq.quantize_params(jax.tree.map(jnp.asarray, params), bits=bits,
                                 family="llama")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    twq, jwq = tparams["layers"]["wq"], jparams["layers"]["wq"]
    assert isinstance(twq, tq.QuantizedTensor) and twq.bits == jwq.bits
    assert twq.q.dtype == {8: torch.int8}.get(bits, torch.uint8)
    assert twq.scale.dtype == torch.float32
    np.testing.assert_array_equal(twq.q.numpy(), np.asarray(jwq.q))

    ids = np.random.default_rng(3).integers(0, QCFG.vocab_size, (2, 32))
    e = jllama.embed(jparams, jnp.asarray(ids))
    want_logits = jllama.forward(jparams, QCFG, e, lxt_tpu.attnlrp,
                                 remat=False).logits
    _, want_rel = j_input_relevance(
        lambda x: j_select_logit(jllama.forward(
            jparams, QCFG, x, lxt_tpu.attnlrp, remat=False,
            logits_at=-1).logits), e)

    tcfg = tllama.LlamaConfig(**dataclasses.asdict(QCFG))
    te = tllama.embed(tparams, torch.as_tensor(ids))
    tq.reset_launches()
    with torch.no_grad():
        logits = tllama.forward(tparams, tcfg, te, remat=remat).logits
    _, rel = lxt_tpu_torch.input_relevance(
        lambda x: lxt_tpu_torch.select_logit(tllama.forward(
            tparams, tcfg, x, lxt_tpu_torch.attnlrp, remat=remat,
            logits_at=-1).logits), te)
    assert tq.launches["nf4_dequant"] == 0
    assert _nl2(logits.numpy(), want_logits) <= BAR
    assert _nl2(rel.numpy(), want_rel) <= BAR


@pytest.mark.parametrize("bits", BITS)
def test_init_params_quantized_matches_lxt_tpu_layout(bits):
    """init_params(quantize_bits=...) quantizes exactly the stacked
    projections, with lxt_tpu's code and scale shapes and dtypes."""
    cfg = dataclasses.replace(QCFG, qk_norm=True)
    want = jllama.init_params(cfg, jax.random.PRNGKey(0), quantize_bits=bits)
    got = tllama.init_params(tllama.LlamaConfig(**dataclasses.asdict(cfg)),
                             torch.Generator().manual_seed(0),
                             quantize_bits=bits)

    def layout(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(layout(v, prefix + k + "/"))
            elif hasattr(v, "q"):
                out[prefix + k] = (v.bits, v.block, tuple(v.q.shape),
                                   str(v.q.dtype).split(".")[-1],
                                   tuple(v.scale.shape),
                                   str(v.scale.dtype).split(".")[-1])
            else:
                out[prefix + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
        return out

    assert layout(got) == layout(want)


@pytest.mark.parametrize("remat", [False, True])
def test_nf4_dequantizations_per_layer(monkeypatch, remat):
    """Each layer dequantizes its 7 projections in the forward and again in
    the backward; with remat the recompute dequantizes 6 more: it stops
    before the last projection (wd), whose backward needs only the codes
    and scales. Relevance is the same either way."""
    params = tllama.init_params(tllama.LlamaConfig(**dataclasses.asdict(QCFG)),
                                torch.Generator().manual_seed(0),
                                quantize_bits="nf4")
    calls = []
    plain = tq.nf4_dequant_ref
    monkeypatch.setattr(tq, "nf4_dequant_ref",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(QCFG))
    e = tllama.embed(params, torch.arange(16)[None])
    rels = {}
    for r in (False, remat):
        calls.clear()
        _, rels[r] = lxt_tpu_torch.input_relevance(
            lambda x: lxt_tpu_torch.select_logit(tllama.forward(
                params, tcfg, x, remat=r, logits_at=-1).logits), e)
    assert len(calls) == (20 if remat else 14) * QCFG.num_layers
    assert torch.equal(rels[remat], rels[False])


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_nf4_projection_dequantizes_through_k3_in_every_dtype(monkeypatch, dtype):
    """An nf4 projection calls K3's wrapper in the activation dtype in its
    forward and its backward, float16 included (K3 writes float16 on the
    card; on the CPU the wrapper runs its plain version); the product and
    the input gradient equal the dense ones."""
    calls = []
    k3 = tq.nf4_dequant

    def counted(q, scale, block, out_dtype):
        calls.append(out_dtype)
        return k3(q, scale, block, out_dtype)

    monkeypatch.setattr(tq, "nf4_dequant", counted)
    assert dtype in tq._OUT_CODE
    gen = torch.Generator().manual_seed(0)
    qt = tq.quantize(0.02 * torch.randn(128, 48, generator=gen), "nf4")
    x = torch.randn(2, 3, 128, generator=gen).to(dtype).requires_grad_(True)
    y = tq.quant_matmul(x, qt)
    (dx,) = torch.autograd.grad(y.sum(), x)
    w = tq.dequantize(qt, dtype)
    assert calls == [dtype, dtype]
    assert y.dtype == dtype and torch.equal(y, torch.matmul(x.detach(), w))
    assert torch.equal(dx, torch.matmul(torch.ones_like(y), w.transpose(0, 1)))
