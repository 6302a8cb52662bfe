"""SigLIP vision tower with LRP-aware forward (Gemma 3's image encoder) —
the counterpart of ``lxt_tpu/models/siglip.py``.

HF ``modeling_siglip`` (``SiglipVisionModel``): conv patch embedding with
bias, learned position embeddings (no class token), pre-norm encoder
blocks with bidirectional attention and gelu-tanh MLPs, a final
post-layernorm. Rules: identity on GELU, stop-grad-std LayerNorm, uniform
at attention q/k/v.

Attention runs on the einsum path, as in ``lxt_tpu``: so400m's head dim 72
is not a kernel width. At 896² (4096 patches, 16 heads) one layer's
float32 scores take 1 GiB per image, so ``remat`` is on by default: only
one layer's scores live at a time.
"""

import dataclasses

import torch

from lxt_tpu_torch import composites
from lxt_tpu_torch.models import common
from lxt_tpu_torch.models.vit import _hwio, _stacked
from lxt_tpu_torch.ops import tensor_parallel
from lxt_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class SiglipConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    ln_eps: float = 1e-6
    act: str = "gelu"  # gelu_pytorch_tanh

    @property
    def hd(self):
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def from_hf(cls, hf_config):
        """Build from a transformers ``SiglipVisionConfig`` (or a namespace
        with its attributes)."""
        return cls(
            image_size=hf_config.image_size,
            patch_size=hf_config.patch_size,
            hidden_size=hf_config.hidden_size,
            intermediate_size=hf_config.intermediate_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            ln_eps=hf_config.layer_norm_eps,
        )


def init_params(cfg: SiglipConfig, generator: torch.Generator,
                dtype=torch.float32, device=None):
    """Random parameters, stacked over layers, drawn from ``generator``
    (which must live on ``device``)."""
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
        "wq": u(L, D, D), "bq": zeros(L, D),
        "wk": u(L, D, D), "bk": zeros(L, D),
        "wv": u(L, D, D), "bv": zeros(L, D),
        "wo": u(L, D, D), "bo": zeros(L, D),
        "w_fc": u(L, D, I), "b_fc": zeros(L, I),
        "w_out": u(L, I, D), "b_out": zeros(L, D),
    }
    return {
        "conv_w": u(P, P, 3, D),
        "conv_b": zeros(D),
        "pos_emb": u(cfg.num_patches, D),
        "lnf_w": ones(D), "lnf_b": zeros(D),
        "layers": layers,
    }


def forward(params, cfg: SiglipConfig, pixels,
            composite: composites.Composite = composites.attnlrp,
            *, remat: bool = True):
    """``pixels``: NHWC ``[B, H, W, 3]`` -> patch features ``[B, P, D]``.
    Every layer runs under ``composite`` itself (``lxt_tpu`` scans SigLIP's
    layers with one body, so depth overrides do not reach them)."""
    B = pixels.shape[0]
    D, H, hd = cfg.hidden_size, cfg.num_heads, cfg.hd
    act_fn = common.ACTIVATIONS[cfg.act]
    comp, lp = composite, params["layers"]

    x = comp.conv2d(pixels, params["conv_w"], params["conv_b"],
                    strides=(cfg.patch_size, cfg.patch_size),
                    padding="VALID", site="conv_w")
    h = x.reshape(B, -1, D) + params["pos_emb"]

    def layer(h, i):
        x = tensor_parallel.copy(
            comp.layer_norm(h, lp["ln1_w"][i], lp["ln1_b"][i], cfg.ln_eps))
        q, k, v = (common.split_heads(comp.linear(x, lp[w][i], lp[b][i], site=w),
                                      H, hd)
                   for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        attn = attention(q, k, v, composite=comp, impl="einsum")
        h = h + comp.linear(common.merge_heads(attn), lp["wo"][i], lp["bo"][i],
                            site="wo", row_parallel=True)
        x = tensor_parallel.copy(
            comp.layer_norm(h, lp["ln2_w"][i], lp["ln2_b"][i], cfg.ln_eps))
        x = comp.act(act_fn, comp.linear(x, lp["w_fc"][i], lp["b_fc"][i],
                                         site="w_fc"))
        return h + comp.linear(x, lp["w_out"][i], lp["b_out"][i], site="w_out",
                               row_parallel=True)

    h, _ = common.run_layers(layer, h, cfg.num_layers, remat)
    return comp.layer_norm(h, params["lnf_w"], params["lnf_b"], cfg.ln_eps)


def params_from_hf(state_dict, cfg: SiglipConfig, dtype=torch.float32,
                   device="cuda", prefix="vision_tower.vision_model."):
    """Convert HF SigLIP vision weights found under ``prefix`` (torch
    tensors or numpy arrays); linear weights transposed to ``[in, out]``,
    the conv weight OIHW -> HWIO."""
    hf = common.HFWeights(state_dict, dtype, device, prefix=prefix)
    layers = _stacked(hf, "encoder.layers.{}.", cfg.num_layers, {
        "ln1_w": ("layer_norm1.weight", False),
        "ln1_b": ("layer_norm1.bias", False),
        "ln2_w": ("layer_norm2.weight", False),
        "ln2_b": ("layer_norm2.bias", False),
        "wq": ("self_attn.q_proj.weight", True), "bq": ("self_attn.q_proj.bias", False),
        "wk": ("self_attn.k_proj.weight", True), "bk": ("self_attn.k_proj.bias", False),
        "wv": ("self_attn.v_proj.weight", True), "bv": ("self_attn.v_proj.bias", False),
        "wo": ("self_attn.out_proj.weight", True),
        "bo": ("self_attn.out_proj.bias", False),
        "w_fc": ("mlp.fc1.weight", True), "b_fc": ("mlp.fc1.bias", False),
        "w_out": ("mlp.fc2.weight", True), "b_out": ("mlp.fc2.bias", False)})
    return {
        "conv_w": hf.tensor("embeddings.patch_embedding.weight", _hwio),
        "conv_b": hf.tensor("embeddings.patch_embedding.bias"),
        "pos_emb": hf.tensor("embeddings.position_embedding.weight"),
        "lnf_w": hf.tensor("post_layernorm.weight"),
        "lnf_b": hf.tensor("post_layernorm.bias"),
        "layers": layers,
    }
