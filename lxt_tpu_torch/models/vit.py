"""Vision Transformer (torchvision layout, and OpenCLIP's visual tower) with
LRP-aware forward — the counterpart of ``lxt_tpu/models/vit.py``.

torchvision ``VisionTransformer``: conv patch embedding, class token
prepended, learned position embeddings, pre-norm encoder blocks, the class
head on the class token after the final norm. OpenCLIP adds a LayerNorm
before the encoder (``ln_pre``), has no conv bias, uses QuickGELU and
projects the class token (``proj``) to an L2-normalized embedding.

The default composite is CP-LRP, the reference's only ViT map; compose it
with ``.with_gamma(conv_gamma=..., linear_gamma=...)`` (the explicit rules
of ``ops/rules.py``) for denoised heatmaps. Attention runs on the einsum
path, as in ``lxt_tpu``: 197 (ViT-B/16) or 257 (ViT-L/14) tokens are off
the flash kernels' 128-row grid.
"""

import dataclasses
from typing import Optional

import torch

from lxt_tpu_torch import composites
from lxt_tpu_torch.models import common
from lxt_tpu_torch.models.common import ModelOutputs
from lxt_tpu_torch.ops import tensor_parallel
from lxt_tpu_torch.ops.attention import attention
from lxt_tpu_torch.ops.functional import normalize


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    num_classes: int = 1000
    ln_eps: float = 1e-6
    act: str = "gelu_exact"
    #: OpenCLIP's visual tower: ``ln_pre``, no conv bias, the projected and
    #: L2-normalized class token instead of a classification head
    openclip: bool = False
    proj_dim: Optional[int] = None

    @property
    def hd(self):
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2


def init_params(cfg: ViTConfig, generator: torch.Generator,
                dtype=torch.float32, device=None):
    """Random parameters (smoke runs and benchmarks), stacked over layers,
    drawn from ``generator`` (which must live on ``device``); torchvision's
    layout, or OpenCLIP's when ``cfg.openclip``."""
    device = device if device is not None else generator.device
    L, D, I, P = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.patch_size

    def u(*shape):
        return common.uniform_init(generator, shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = {
        "ln1_w": ones(L, D), "ln1_b": zeros(L, D),
        "ln2_w": ones(L, D), "ln2_b": zeros(L, D),
        "w_qkv": u(L, D, 3 * D), "b_qkv": zeros(L, 3 * D),
        "w_proj": u(L, D, D), "b_proj": zeros(L, D),
        "w_fc": u(L, D, I), "b_fc": zeros(L, I),
        "w_out": u(L, I, D), "b_out": zeros(L, D),
    }
    params = {
        "conv_w": u(P, P, 3, D),   # HWIO
        "cls_token": u(1, 1, D),
        "pos_emb": u(1, cfg.num_patches + 1, D),
        "lnf_w": ones(D), "lnf_b": zeros(D),
        "layers": layers,
    }
    if cfg.openclip:
        params.update(ln_pre_w=ones(D), ln_pre_b=zeros(D),
                      proj=u(D, cfg.proj_dim))
    else:
        params.update(conv_b=zeros(D), head_w=u(D, cfg.num_classes),
                      head_b=zeros(cfg.num_classes))
    return params


def forward(
    params,
    cfg: ViTConfig,
    images,
    composite: composites.Composite = composites.cp_lrp,
    *,
    probes=None,
    output_hidden_states: bool = False,
    remat: bool = True,
):
    """``images``: NHWC ``[B, H, W, 3]``. Returns :class:`ModelOutputs` with
    class logits ``[B, num_classes]`` (OpenCLIP: the normalized embedding
    ``[B, proj_dim]``). ``probes`` (``[L, B, T, D]`` zeros) are added to
    each layer output, as in the language models."""
    B = images.shape[0]
    D, H, hd = cfg.hidden_size, cfg.num_heads, cfg.hd
    act_fn = common.ACTIVATIONS[cfg.act]

    x = composite.conv2d(images, params["conv_w"], params.get("conv_b"),
                         strides=(cfg.patch_size, cfg.patch_size),
                         padding="VALID", site="conv_w")
    x = x.reshape(B, -1, D)
    cls = params["cls_token"].to(x.dtype).expand(B, 1, D)
    h = torch.cat([cls, x], dim=1) + params["pos_emb"]
    if cfg.openclip:
        h = composite.layer_norm(h, params["ln_pre_w"], params["ln_pre_b"],
                                 cfg.ln_eps)
    inputs_post = h
    lp = params["layers"]
    probes = common.layer_probes(probes)

    def layer(h, i):
        comp = composite.for_layer(i, cfg.num_layers)
        x = tensor_parallel.copy(
            comp.layer_norm(h, lp["ln1_w"][i], lp["ln1_b"][i], cfg.ln_eps))
        qkv = comp.linear(x, lp["w_qkv"][i], lp["b_qkv"][i], site="w_qkv")
        # q | k | v, each this process's heads under tensor parallelism
        q, k, v = (common.split_heads(t, H, hd) for t in qkv.chunk(3, dim=-1))
        attn = attention(q, k, v, composite=comp, impl="einsum")
        h = h + comp.linear(common.merge_heads(attn), lp["w_proj"][i],
                            lp["b_proj"][i], site="w_proj", row_parallel=True)
        x = tensor_parallel.copy(
            comp.layer_norm(h, lp["ln2_w"][i], lp["ln2_b"][i], cfg.ln_eps))
        x = comp.act(act_fn, comp.linear(x, lp["w_fc"][i], lp["b_fc"][i],
                                         site="w_fc"))
        h = h + comp.linear(x, lp["w_out"][i], lp["b_out"][i], site="w_out",
                            row_parallel=True)
        if probes is not None:
            h = h + probes[i]
        return h

    h, hiddens = common.run_layers(layer, inputs_post, cfg.num_layers, remat,
                                   keep_hidden=output_hidden_states)
    h = composite.layer_norm(h, params["lnf_w"], params["lnf_b"], cfg.ln_eps)
    if cfg.openclip:
        # the CLIP image embedding: the projected class token, L2-normalized
        # under the identity rule
        emb = composite.linear(h[:, 0], params["proj"], site="proj")
        logits = normalize(emb, 2.0, -1)
    else:
        # head_w (and head_b with it) split on the classes under tensor
        # parallelism: the logits are gathered
        logits = tensor_parallel.gather_last(composite.linear(
            tensor_parallel.copy(h[:, 0]), params["head_w"], params["head_b"],
            site="head_w"))
    if output_hidden_states:
        hiddens = torch.cat([inputs_post[None], hiddens], dim=0)
    return ModelOutputs(logits=logits, hidden_states=hiddens)


def patch_relevance(images, grad):
    """Input heatmap: ``(x * grad)`` summed over channels -> ``[B, H, W]``."""
    return (images.float() * grad.float()).sum(-1)


# ---------------------------------------------------------------------------
# checkpoint conversion (torch tensors or numpy arrays)
# ---------------------------------------------------------------------------

def _hwio(w):
    """A conv weight OIHW -> HWIO."""
    return w.permute(2, 3, 1, 0)


def _stacked(hf, layer_fmt, num_layers, names):
    """The stacked layer dict: ours -> (HF name, transpose)."""
    return hf.stack(num_layers, {ours: hf.each(layer_fmt + name, tr)
                                 for ours, (name, tr) in names.items()})


def params_from_torchvision(state_dict, cfg: ViTConfig, dtype=torch.float32,
                            device="cuda"):
    """Convert a torchvision ``VisionTransformer`` state dict (``conv_proj``,
    ``class_token``, ``encoder.*``, ``heads.head``; MHA's fused
    ``in_proj`` [3D, D]); linear weights transposed to ``[in, out]``, the
    conv weight OIHW -> HWIO."""
    hf = common.HFWeights(state_dict, dtype, device)
    layers = _stacked(hf, "encoder.layers.encoder_layer_{}.", cfg.num_layers, {
        "ln1_w": ("ln_1.weight", False), "ln1_b": ("ln_1.bias", False),
        "ln2_w": ("ln_2.weight", False), "ln2_b": ("ln_2.bias", False),
        "w_qkv": ("self_attention.in_proj_weight", True),
        "b_qkv": ("self_attention.in_proj_bias", False),
        "w_proj": ("self_attention.out_proj.weight", True),
        "b_proj": ("self_attention.out_proj.bias", False),
        "w_fc": ("mlp.0.weight", True), "b_fc": ("mlp.0.bias", False),
        "w_out": ("mlp.3.weight", True), "b_out": ("mlp.3.bias", False)})
    return {
        "conv_w": hf.tensor("conv_proj.weight", _hwio),
        "conv_b": hf.tensor("conv_proj.bias"),
        "cls_token": hf.tensor("class_token"),
        "pos_emb": hf.tensor("encoder.pos_embedding"),
        "lnf_w": hf.tensor("encoder.ln.weight"),
        "lnf_b": hf.tensor("encoder.ln.bias"),
        "head_w": hf.tensor("heads.head.weight", lambda w: w.T),
        "head_b": hf.tensor("heads.head.bias"),
        "layers": layers,
    }


def params_from_openclip(state_dict, cfg: ViTConfig, dtype=torch.float32,
                         device="cuda"):
    """Convert an OpenCLIP ``VisualTransformer`` state dict (the ``visual.``
    subtree of a CLIP checkpoint: ``conv1``, ``class_embedding``,
    ``positional_embedding``, ``ln_pre``, ``transformer.resblocks.N.*``,
    ``ln_post``, ``proj``)."""
    hf = common.HFWeights(state_dict, dtype, device)
    layers = _stacked(hf, "transformer.resblocks.{}.", cfg.num_layers, {
        "ln1_w": ("ln_1.weight", False), "ln1_b": ("ln_1.bias", False),
        "ln2_w": ("ln_2.weight", False), "ln2_b": ("ln_2.bias", False),
        "w_qkv": ("attn.in_proj_weight", True),
        "b_qkv": ("attn.in_proj_bias", False),
        "w_proj": ("attn.out_proj.weight", True),
        "b_proj": ("attn.out_proj.bias", False),
        "w_fc": ("mlp.c_fc.weight", True), "b_fc": ("mlp.c_fc.bias", False),
        "w_out": ("mlp.c_proj.weight", True),
        "b_out": ("mlp.c_proj.bias", False)})
    D = cfg.hidden_size
    return {
        "conv_w": hf.tensor("conv1.weight", _hwio),
        "cls_token": hf.tensor("class_embedding", lambda w: w.reshape(1, 1, D)),
        "pos_emb": hf.tensor("positional_embedding", lambda w: w[None]),
        "ln_pre_w": hf.tensor("ln_pre.weight"),
        "ln_pre_b": hf.tensor("ln_pre.bias"),
        "lnf_w": hf.tensor("ln_post.weight"),
        "lnf_b": hf.tensor("ln_post.bias"),
        "proj": hf.tensor("proj"),   # [D, proj_dim], applied as-is
        "layers": layers,
    }
