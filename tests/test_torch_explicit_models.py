"""The port's explicit Llama, GPT-2 and BERT (models/*_explicit.py) against
lxt_tpu's, on CPU, float32.

Tiny configs (2 layers, D 64, T 128, batch 2) run through both packages on
the same numpy weights (``convert.params_from_numpy``) and ids; nothing is
built from the reference LXT. Logits and the explicit input relevance (one
backward seeded with the target's value) must agree within normalized L2
1e-5 in float32, or, where float32 misses it, in float64: the epsilon
rules divide by layer outputs near 0, where two float32 libraries part
(2.1e-5 for Llama under cp_lrp, 6.5e-5 for BERT here; lxt_tpu's own
jitted and eager runs of the BERT map part by 2.1e-4), while in float64
both read within 6e-6 (the softmax and the RMSNorm statistics stay
float32 in both). Under attnlrp and cp_lrp (BERT has one composite),
with Llama's sliding window, BERT's attention_mask and token types, and
GPT-2's inverse-layer scale and reorder_and_upcast_attn (``lf.baddbmm``)
path. Inside the port, the explicit relevance and the efficient
Gradient*Input relevance (attention through the flash Function, the
kernels' plain versions on CPU) must have cosine > 0.999, one row at a
time (the explicit seed is the summed target's value, so in a batch each
row's map is scaled by the batch total over its own logit), as
tests/test_explicit_model.py holds lxt_tpu's; the latent relevance too.
remat on and off agree.

ROADMAP F11: lxt_tpu's explicit Llama passes RoPE's half swap through plain
autodiff, which negates the relevance of the negated half; the port passes
it as a permutation. Where the rope's backward runs (attnlrp), the port is
held against lxt_tpu with its ``_rotate_half`` given that permutation as
its vjp (patched in the test process); ``test_f11_...`` shows the gap.
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
from lxt_tpu.models import bert as jbert
from lxt_tpu.models import bert_explicit as jbex
from lxt_tpu.models import gpt2 as jgpt2
from lxt_tpu.models import gpt2_explicit as jgex
from lxt_tpu.models import llama as jllama
from lxt_tpu.models import llama_explicit as jlex
from lxt_tpu_torch.attribution import input_relevance, latent_relevance
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import bert as tbert
from lxt_tpu_torch.models import bert_explicit as tbex
from lxt_tpu_torch.models import gpt2 as tgpt2
from lxt_tpu_torch.models import gpt2_explicit as tgex
from lxt_tpu_torch.models import llama as tllama
from lxt_tpu_torch.models import llama_explicit as tlex

BAR, COS = 1e-5, 0.999  # normalized L2 against lxt_tpu; cosine across paths
T, B, VOCAB = 128, 2, 97


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


def _w(rng, *s, scale=0.1):
    return (scale * rng.standard_normal(s)).astype(np.float32)


def _llama_params(cfg, rng):
    L, D, I, hd = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.hd
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    return {"embed": _w(rng, VOCAB, D), "final_norm": 1 + _w(rng, D),
            "lm_head": _w(rng, D, VOCAB),
            "layers": dict(ln1=1 + _w(rng, L, D), ln2=1 + _w(rng, L, D),
                           wq=_w(rng, L, D, H * hd), wk=_w(rng, L, D, Hkv * hd),
                           wv=_w(rng, L, D, Hkv * hd), wo=_w(rng, L, H * hd, D),
                           wg=_w(rng, L, D, I), wu=_w(rng, L, D, I),
                           wd=_w(rng, L, I, D))}


def _gpt2_params(cfg, rng):
    L, D = cfg.num_layers, cfg.hidden_size

    def w(*s, scale=0.05):
        return _w(rng, *s, scale=scale)

    layers = dict(ln1_w=1 + w(L, D), ln1_b=w(L, D), ln2_w=1 + w(L, D),
                  ln2_b=w(L, D), w_attn=w(L, D, 3 * D), b_attn=w(L, 3 * D),
                  w_proj=w(L, D, D), b_proj=w(L, D), w_fc=w(L, D, 4 * D),
                  b_fc=w(L, 4 * D), w_out=w(L, 4 * D, D), b_out=w(L, D))
    return {"wte": w(VOCAB, D, scale=0.5), "wpe": w(cfg.max_positions, D, scale=0.5),
            "lnf_w": 1 + w(D), "lnf_b": w(D), "layers": layers}


def _bert_params(cfg, rng):
    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size

    def w(*s, scale=0.05):
        return _w(rng, *s, scale=scale)

    layers = {}
    for name, shape in (("q", (D, D)), ("k", (D, D)), ("v", (D, D)), ("o", (D, D)),
                        ("i", (D, I)), ("out", (I, D))):
        layers["w" + name], layers["b" + name] = w(L, *shape), w(L, shape[1])
    for ln in ("ln1", "ln2"):
        layers[ln + "_w"], layers[ln + "_b"] = 1 + w(L, D), w(L, D)
    return {"word_emb": w(VOCAB, D, scale=0.5), "pos_emb": w(cfg.max_positions, D, scale=0.5),
            "type_emb": w(cfg.type_vocab_size, D, scale=0.5), "emb_ln_w": 1 + w(D),
            "emb_ln_b": w(D), "pooler_w": w(D, D, scale=0.2), "pooler_b": w(D),
            "cls_w": w(D, cfg.num_labels, scale=0.2), "cls_b": w(cfg.num_labels),
            "layers": layers}


@functools.lru_cache(maxsize=None)
def _family(family, window=None, upcast=False):
    """``(jax cfg, jax params, port cfg, port params, ids)``."""
    rng = np.random.default_rng(["llama", "gpt2", "bert"].index(family))
    if family == "llama":
        jcfg = jllama.LlamaConfig(vocab_size=VOCAB, hidden_size=64,
                                  intermediate_size=128, num_layers=2,
                                  num_heads=4, num_kv_heads=2, sliding_window=window)
        params, tcls = _llama_params(jcfg, rng), tllama.LlamaConfig
    elif family == "gpt2":
        jcfg = jgpt2.GPT2Config(vocab_size=VOCAB, hidden_size=64, num_layers=2,
                                num_heads=4, max_positions=T,
                                scale_attn_by_inverse_layer_idx=upcast,
                                reorder_and_upcast_attn=upcast)
        params, tcls = _gpt2_params(jcfg, rng), tgpt2.GPT2Config
    else:
        jcfg = jbert.BertConfig(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
                                num_layers=2, num_heads=2, max_positions=T,
                                num_labels=3)
        params, tcls = _bert_params(jcfg, rng), tbert.BertConfig
    ids = rng.integers(0, VOCAB, (B, T))
    return (jcfg, jax.tree.map(jnp.asarray, params),
            tcls(**dataclasses.asdict(jcfg)), params_from_numpy(params, device="cpu"), ids)


def _bert_kw(padded):
    if not padded:
        return {}
    mask = (np.arange(T)[None] < np.asarray([T, 77])[:, None]).astype(np.int32)
    types = (np.arange(T)[None] >= 40).astype(np.int32).repeat(B, 0)
    return {"attention_mask": mask, "token_type_ids": types}


def _permuting_rotate_half():
    """lxt_tpu's ``_rotate_half`` whose vjp moves each half back as a
    permutation (the port's, ROADMAP F11)."""
    rotate = jlex._rotate_half

    @jax.custom_vjp
    def rot(x):
        return rotate(x)

    def bwd(_, r):
        half = r.shape[-1] // 2
        return (jnp.concatenate([r[..., half:], r[..., :half]], -1),)

    rot.defvjp(lambda x: (rotate(x), None), bwd)
    return rot


@pytest.fixture
def f11(monkeypatch):
    monkeypatch.setattr(jlex, "_rotate_half", _permuting_rotate_half())


def _jax_explicit(family, composite, setup=None, f64=False, **kw):
    """lxt_tpu's explicit (logits, relevance), jitted; ``f64``: the
    weights in float64 (under ``jax.enable_x64``)."""
    jcfg, jp, _, _, ids = _family(family, **(setup or {}))
    if f64:
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)
    comp = getattr(lxt_tpu, composite)
    kw = {k: jnp.asarray(v) for k, v in kw.items()}

    def logits_of(e):
        if family == "llama":
            return jlex.forward(jp, jcfg, e, comp, remat=False).logits
        if family == "gpt2":
            return jgex.forward(jp, jcfg, e, comp, remat=False).logits
        return jbex.forward(jp, jcfg, e, remat=False, **kw).logits

    def run(e):
        logits = logits_of(e)
        return logits, jlex.explicit_input_relevance(
            lambda x: _target(logits_of(x)), e)[1]

    embed = {"llama": lambda: jllama.embed(jp, jnp.asarray(ids)),
             "gpt2": lambda: jp["wte"][jnp.asarray(ids)],
             "bert": lambda: jbert.embed(jp, jnp.asarray(ids))}[family]()
    return jax.jit(run)(embed)


def _target(logits):
    """The argmax logit at the last position (summed over the batch), or a
    classifier's argmax label."""
    row = logits if logits.ndim == 2 else logits[:, -1]
    if isinstance(row, torch.Tensor):
        return row.max(dim=-1).values.sum()
    return row.max(axis=-1).sum()


def _port_explicit(family, composite, remat=False, setup=None, row=None, f64=False,
                   **kw):
    """The port's explicit (logits, relevance), of one ``row`` if given;
    ``f64``: the weights in float64."""
    _, _, tcfg, tp, ids = _family(family, **(setup or {}))
    if f64:
        tp = jax.tree.map(lambda t: t.double(), tp)
    comp = getattr(lxt_tpu_torch, composite)
    kw = {k: torch.as_tensor(v) for k, v in kw.items()}
    if row is not None:
        ids = ids[row:row + 1]
        kw = {k: v[row:row + 1] for k, v in kw.items()}

    def logits_of(e):
        if family == "llama":
            return tlex.forward(tp, tcfg, e, comp, remat=remat).logits
        if family == "gpt2":
            return tgex.forward(tp, tcfg, e, comp, remat=remat).logits
        return tbex.forward(tp, tcfg, e, remat=remat, **kw).logits

    e = {"llama": lambda: tllama.embed(tp, torch.as_tensor(ids)),
         "gpt2": lambda: tp["wte"][torch.as_tensor(ids)],
         "bert": lambda: tbert.embed(tp, torch.as_tensor(ids))}[family]()
    with torch.no_grad():
        logits = logits_of(e)
    _, rel = tlex.explicit_input_relevance(lambda x: _target(logits_of(x)), e)
    return logits, rel


CASES = [("llama", "attnlrp", {}), ("llama", "cp_lrp", {}),
         ("llama", "attnlrp", {"setup": {"window": 40}}),
         ("gpt2", "cp_lrp", {}), ("gpt2", "attnlrp", {}),
         ("gpt2", "attnlrp", {"setup": {"upcast": True}}),
         ("bert", "attnlrp", {}), ("bert", "attnlrp", _bert_kw(True))]
IDS = ["llama-attnlrp", "llama-cp_lrp", "llama-window40", "gpt2-cp_lrp",
       "gpt2-attnlrp", "gpt2-upcast-baddbmm", "bert", "bert-mask-types"]


@pytest.mark.parametrize("family,composite,kw", CASES, ids=IDS)
def test_explicit_model_matches_lxt_tpu(family, composite, kw, f11):
    jl, jr = _jax_explicit(family, composite, **kw)
    tl, tr = _port_explicit(family, composite, **kw)
    assert tuple(tr.shape) == jr.shape and tr.dtype == torch.float32
    assert torch.isfinite(tr).all() and _nl2(tl, jl) <= BAR
    if _nl2(tr, jr) > BAR:   # float32 rounding at an epsilon division: float64
        with jax.enable_x64(True):
            jl, jr = _jax_explicit(family, composite, f64=True, **kw)
        tl, tr = _port_explicit(family, composite, f64=True, **kw)
        assert _nl2(tl, jl) <= BAR and _nl2(tr, jr) <= BAR, (_nl2(tl, jl), _nl2(tr, jr))


@pytest.mark.parametrize("family", ["llama", "gpt2", "bert"])
def test_remat_on_and_off_agree(family):
    composite = "cp_lrp" if family == "gpt2" else "attnlrp"
    kw = _bert_kw(True) if family == "bert" else {}
    off = _port_explicit(family, composite, **kw)
    on = _port_explicit(family, composite, remat=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(off, on))


def test_llama_window_and_bert_mask_change_the_result():
    assert _nl2(_port_explicit("llama", "attnlrp", setup={"window": 40})[0],
                _port_explicit("llama", "attnlrp")[0]) > 1e-4
    assert _nl2(_port_explicit("bert", "attnlrp", **_bert_kw(True))[0],
                _port_explicit("bert", "attnlrp")[0]) > 1e-4


def test_gpt2_baddbmm_path_is_relevance_neutral():
    """reorder_and_upcast_attn (scale folded, lf.baddbmm) against the same
    model with the plain scores path and the inverse-layer scale: same
    logits and relevance (lxt_tpu's test_explicit_gpt2_upcast_reorder_baddbmm)."""
    up = _port_explicit("gpt2", "attnlrp", setup={"upcast": True})
    _, _, tcfg, tp, ids = _family("gpt2", upcast=True)
    plain_cfg = dataclasses.replace(tcfg, reorder_and_upcast_attn=False)
    e = tp["wte"][torch.as_tensor(ids)]
    _, rel = tlex.explicit_input_relevance(
        lambda x: _target(tgex.forward(tp, plain_cfg, x, lxt_tpu_torch.attnlrp).logits), e)
    assert _nl2(up[1], rel) <= 2e-5


def _efficient(family, composite, padded, row):
    """The port's efficient map of ``row`` through the flash Function (the
    kernels' plain versions)."""
    _, _, tcfg, tp, ids = _family(family)
    ids = ids[row:row + 1]
    comp = getattr(lxt_tpu_torch, composite)
    fwd = {"llama": tllama.forward, "gpt2": tgpt2.forward, "bert": tbert.forward}[family]
    e = {"llama": lambda: tllama.embed(tp, torch.as_tensor(ids)),
         "gpt2": lambda: tp["wte"][torch.as_tensor(ids)],
         "bert": lambda: tbert.embed(tp, torch.as_tensor(ids))}[family]()
    kw = {"kv_end": torch.tensor([T, 77][row:row + 1], dtype=torch.int32)} if padded else {}
    return input_relevance(
        lambda x: _target(fwd(tp, tcfg, x, comp, remat=False, attn_impl="flash",
                              **kw).logits), e)[1]


@pytest.mark.parametrize("family,composite,padded",
                         [("llama", "attnlrp", False), ("llama", "cp_lrp", False),
                          ("gpt2", "cp_lrp", False), ("gpt2", "attnlrp", False),
                          ("bert", "attnlrp", True)])
def test_explicit_matches_efficient_path(family, composite, padded):
    """Cross-path equivalence inside the port (BERT's padding: the explicit
    mask against the flash path's kv_end)."""
    kw = _bert_kw(True) if padded else {}
    kw.pop("token_type_ids", None)
    for row in range(B):
        _, rel_ex = _port_explicit(family, composite, row=row, **kw)
        rel_gi = _efficient(family, composite, padded, row)
        assert _cos(rel_ex, rel_gi) > COS, (row, _cos(rel_ex, rel_gi))


def test_f11_lxt_tpu_explicit_rope_negates_relevance():
    """Unpatched, lxt_tpu's explicit Llama map parts from the port's (the
    same logits) and from its own efficient path; the port's agrees with
    the efficient path to 1e-6 in cosine."""
    jl, jr = _jax_explicit("llama", "attnlrp")
    tl, tr = _port_explicit("llama", "attnlrp")
    assert _nl2(tl, jl) <= BAR and _nl2(tr, jr) > 1e-3
    rel_gi = _efficient("llama", "attnlrp", False, 1)
    assert _cos(_port_explicit("llama", "attnlrp", row=1)[1], rel_gi) > 1 - 1e-6


def test_latent_relevance_matches_lxt_tpu_and_the_efficient_path(f11):
    jcfg, jp, tcfg, tp, ids = _family("llama")
    ids, B = ids[:1], 1
    L, D = jcfg.num_layers, jcfg.hidden_size
    je = jllama.embed(jp, jnp.asarray(ids))
    te = tllama.embed(tp, torch.as_tensor(ids))
    jv, jin, jlat = jax.jit(lambda e: jlex.explicit_latent_relevance(
        lambda x, p: _target(jlex.forward(jp, jcfg, x, lxt_tpu.attnlrp,
                                          remat=False, probes=p).logits),
        e, (L, B, T, D)))(je)
    tv, tin, tlat = tlex.explicit_latent_relevance(
        lambda x, p: _target(tlex.forward(tp, tcfg, x, lxt_tpu_torch.attnlrp,
                                          remat=True, probes=p).logits),
        te, (L, B, T, D))
    assert tuple(tlat.shape) == jlat.shape == (L, B, T)
    assert _nl2(tin, jin) <= BAR and _nl2(tlat, jlat) <= BAR
    assert abs(float(tv) - float(jv)) <= 1e-5 * abs(float(jv))

    def fwd(x, p):
        out = tllama.forward(tp, tcfg, x, lxt_tpu_torch.attnlrp, probes=p,
                             output_hidden_states=True, remat=False, attn_impl="flash")
        return _target(out.logits), out.hidden_states

    _, gin, glat = latent_relevance(fwd, te, (L, B, T, D), sum_features=True)
    assert _cos(tlat, glat) > COS and _cos(tin, gin) > COS
