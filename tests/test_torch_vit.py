"""The port's ViT (torchvision layout), OpenCLIP visual tower and vision
registry surface against lxt_tpu's, on CPU.

The torchvision and OpenCLIP layouts are torch modules written by hand
(``tests/_reference_golden.py``: image 32, patch 8, D 64, 2 layers, 4
heads; no torchvision or open_clip), converted by ``from_hf`` in both
packages. Float32 logits must match the module's own forward and
lxt_tpu's, and ``logits``, ``attribute_image`` (argmax, labels, NCHW
input, an OpenCLIP direction, gamma and per-site / per-depth composites)
and ``attribute_topk`` must match lxt_tpu's within normalized L2 <= 1e-5.
Logits are bit-equal across composites (the rules touch only the
backward). The gamma rule on the linears is ill-conditioned in a random
ViT: its denominators z = x (w + g w+) + b cross 0, and float32 runs of
either package land ~3e-3 from a float64 run of the port. That case is
held against float64 instead: the port in float32 no farther from it than
twice lxt_tpu's distance.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import lxt_tpu
import lxt_tpu_torch
from lxt_tpu.models import registry as jreg
from lxt_tpu.models import vit as jvit
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import registry as treg
from lxt_tpu_torch.models import vit as tvit
from tests._reference_golden import _TorchOpenCLIP, _TorchViT

BAR = 1e-5  # normalized L2, float32


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@functools.lru_cache(maxsize=None)
def _vit():
    """The torchvision-layout module and both packages' models of it."""
    module = _TorchViT.build()
    return module, jreg.from_hf(module), treg.from_hf(module, device="cpu")


@functools.lru_cache(maxsize=None)
def _openclip():
    module = _TorchOpenCLIP.build()
    return (module, jreg.from_hf(module, dtype=None),
            treg.from_hf(module, device="cpu"))


def _images(seed, n=2, size=32):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def test_from_hf_dispatches_config_less_modules():
    module, jm, tm = _vit()
    assert tm.kind == jm.kind == "vit"
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert (tm.cfg.image_size, tm.cfg.patch_size, tm.cfg.num_heads) == (32, 8, 4)
    # the weights carry across unchanged (HWIO conv weight included)
    want = params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu")
    for name in ("conv_w", "head_w", "pos_emb"):
        np.testing.assert_array_equal(tm.params[name].numpy(), want[name].numpy())
    np.testing.assert_array_equal(tm.params["layers"]["w_qkv"].numpy(),
                                  want["layers"]["w_qkv"].numpy())
    _, jo, to = _openclip()
    assert to.kind == jo.kind == "openclip"
    assert dataclasses.asdict(to.cfg) == dataclasses.asdict(jo.cfg)
    assert "conv_b" not in to.params and to.cfg.act == "quick_gelu"
    with pytest.raises(ValueError, match="not a recognized vision layout"):
        treg.from_hf({"foo.weight": np.ones(3)}, device="cpu")


def test_bare_state_dict_needs_num_heads():
    module, _, _ = _vit()
    sd = module.state_dict()
    with pytest.raises(ValueError, match="num_heads") as terr:
        treg.from_torchvision(sd, device="cpu")
    with pytest.raises(ValueError) as jerr:
        jreg.from_torchvision(sd)
    assert str(terr.value) == str(jerr.value)
    assert treg.from_torchvision(sd, num_heads=4, device="cpu").cfg.num_heads == 4


@pytest.mark.parametrize("shape", [(1, 4, 8, 8), (1, 8, 8), (1, 8, 8, 1)])
def test_canon_images_errors_match_lxt_tpu(shape):
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError) as terr:
        treg._canon_images(x, "cpu")
    with pytest.raises(ValueError) as jerr:
        jreg._canon_images(x)
    assert str(terr.value) == str(jerr.value)


COMPOSITES = {
    "cp_lrp": lambda p: p.cp_lrp,
    "attnlrp": lambda p: p.attnlrp,
    "gamma_conv": lambda p: p.cp_lrp.with_gamma(conv_gamma=0.25),
    "sites_and_depth": lambda p: p.cp_lrp.override_sites(
        conv_w=("zbox", -3.0, 3.0), w_fc="zplus").override_layers(
        -1, linear_rule=("alphabeta", 2.0, 1.0)),
}
GAMMA = lambda p: p.cp_lrp.with_gamma(conv_gamma=0.25, linear_gamma=0.05)  # noqa: E731


def test_vit_logits_match_module_and_lxt_tpu():
    module, jm, tm = _vit()
    x = _images(1)
    with torch.no_grad():
        ref = module(torch.tensor(x).permute(0, 3, 1, 2)).numpy()
    got = {name: tm.logits(x, composite=c(lxt_tpu_torch)).numpy()
           for name, c in dict(COMPOSITES, gamma=GAMMA).items()}
    for name, logits in got.items():
        np.testing.assert_array_equal(logits, got["cp_lrp"], err_msg=name)
    assert _nl2(got["cp_lrp"], ref) <= BAR
    assert _nl2(got["cp_lrp"], jm.logits(x)) <= BAR


@pytest.mark.parametrize("case", ["argmax", "label", "nchw"] + sorted(COMPOSITES))
def test_vit_attribute_image_matches_lxt_tpu(case):
    _, jm, tm = _vit()
    x = _images(2)
    kw = {}
    if case == "label":
        kw["label"] = np.asarray([3, 7])
    elif case == "nchw":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    elif case in COMPOSITES:
        kw = {"composite": COMPOSITES[case]}
    jkw = {k: (v(lxt_tpu) if k == "composite" else v) for k, v in kw.items()}
    tkw = {k: (v(lxt_tpu_torch) if k == "composite" else v) for k, v in kw.items()}
    jv, jh = jm.attribute_image(x, **jkw)
    tv, th = tm.attribute_image(x, **tkw)
    assert th.shape == (2, 32, 32)
    assert _nl2(tv.numpy(), jv) <= BAR
    assert _nl2(th.numpy(), jh) <= BAR, _nl2(th.numpy(), jh)


def test_vit_gamma_linears_as_close_to_float64_as_lxt_tpu():
    _, jm, tm = _vit()
    x = _images(2)
    tm64 = dataclasses.replace(tm, params=jax.tree.map(torch.Tensor.double, tm.params))
    _, h64 = tm64.attribute_image(x.astype(np.float64), composite=GAMMA(lxt_tpu_torch))
    _, jh = jm.attribute_image(x, composite=GAMMA(lxt_tpu))
    _, th = tm.attribute_image(x, composite=GAMMA(lxt_tpu_torch))
    assert _nl2(th.numpy(), h64) <= 2 * _nl2(jh, h64), (_nl2(th.numpy(), h64),
                                                         _nl2(jh, h64))


def test_vit_attribute_topk_matches_lxt_tpu_and_per_label_maps():
    _, jm, tm = _vit()
    x = _images(3)
    jl, jv, jh = jm.attribute_topk(x, k=3)
    tl, tv, th = tm.attribute_topk(x, k=3)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert _nl2(tv.numpy(), jv) <= BAR and _nl2(th.numpy(), jh) <= BAR
    for k in range(3):
        vk, hk = tm.attribute_image(x, label=tl[k])
        assert _nl2(th[k].numpy(), hk.numpy()) <= BAR
        np.testing.assert_allclose(float(tv[k].sum()), float(vk), rtol=1e-6)


def test_vit_forward_hidden_states_and_patch_relevance_match_lxt_tpu():
    """The forward's probes / hidden states and ``patch_relevance``, at an
    image side that the patch does not divide (38: the conv drops 6 rows
    and columns, and their relevance is 0)."""
    cfg = jvit.ViTConfig(image_size=32, patch_size=8, hidden_size=32,
                         intermediate_size=64, num_layers=2, num_heads=2,
                         num_classes=5)
    jparams = jax.tree.map(np.asarray, jvit.init_params(cfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jparams, device="cpu")
    tcfg = tvit.ViTConfig(**dataclasses.asdict(cfg))
    x = np.random.default_rng(4).standard_normal((1, 38, 38, 3)).astype(np.float32)
    comp = lxt_tpu_torch.cp_lrp.with_gamma(conv_gamma=0.25)
    xt = torch.tensor(x, requires_grad=True)
    out = tvit.forward(tparams, tcfg, xt, comp, output_hidden_states=True)
    (g,) = torch.autograd.grad(out.logits.max(-1).values.sum(), xt)
    heat = tvit.patch_relevance(xt.detach(), g)

    def target(e):
        return jvit.forward(jparams, cfg, e, lxt_tpu.cp_lrp.with_gamma(
            conv_gamma=0.25)).logits.max(-1).sum()

    jg = jax.jit(jax.grad(target))(x)
    jhidden = jax.jit(lambda e: jvit.forward(jparams, cfg, e, lxt_tpu.cp_lrp,
                                             output_hidden_states=True).hidden_states)(x)
    assert out.hidden_states.shape == (3, 1, 17, 32)
    assert _nl2(out.hidden_states.detach().numpy(), jhidden) <= BAR
    assert _nl2(heat.numpy(), jvit.patch_relevance(x, jg)) <= BAR
    assert np.all(heat.numpy()[:, 32:] == 0) and np.all(heat.numpy()[:, :, 32:] == 0)


def test_openclip_embedding_and_direction_match_module_and_lxt_tpu():
    module, jo, to = _openclip()
    x = _images(5)
    exact = treg.from_openclip(module, act="gelu_exact", device="cpu")
    with torch.no_grad():
        ref = module(torch.tensor(x).permute(0, 3, 1, 2)).numpy()
    assert _nl2(exact.logits(x).numpy(), ref) <= BAR
    assert _nl2(to.logits(x).numpy(), jo.logits(x)) <= BAR
    direction = np.random.default_rng(6).standard_normal(32).astype(np.float32)
    jv, jh = jo.attribute_image(x, target=direction)
    tv, th = to.attribute_image(x, target=direction)
    assert _nl2(tv.numpy(), jv) <= BAR and _nl2(th.numpy(), jh) <= BAR
    with pytest.raises(ValueError, match="classification head"):
        to.attribute_topk(x, k=2)
    _, _, tm = _vit()
    with pytest.raises(ValueError, match="only meaningful for openclip"):
        tm.attribute_image(x, target=direction)
