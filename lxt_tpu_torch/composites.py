"""Composites: declarative rule assignments for model forward passes.

The counterpart of ``lxt_tpu/composites.py``. A :class:`Composite` is a
frozen config object passed into the model forward; model code calls its
methods (``act``, ``qkv``, ``gated_mul``, ``mul_uniform``, ``rms_norm``,
``layer_norm``, ``linear``) at each rule site.

Presets mirror ``lxt_tpu``: :data:`attnlrp`, :data:`cp_lrp` and
:data:`vanilla_gradient`. The explicit linear rules (gamma, alpha-beta,
modified-z) and per-site and per-layer overrides are not ported yet and
raise :class:`NotImplementedError`. Quantized weights
(:class:`~lxt_tpu_torch.ops.quant.QuantizedTensor`) go through
:func:`~lxt_tpu_torch.ops.quant.quant_matmul`.
"""

import dataclasses
from typing import Optional

import torch

from lxt_tpu_torch.ops.quant import QuantizedTensor, quant_matmul
from lxt_tpu_torch.ops.rules import divide_gradient, identity_rule, stop_gradient


@dataclasses.dataclass(frozen=True)
class Composite:
    """Static assignment of LRP rules to model rule-sites (see
    ``lxt_tpu.composites.Composite`` for the meaning of each field)."""

    name: str = "attnlrp"
    #: 'identity' -> identity rule on elementwise nonlinearities; 'vanilla'.
    activation: str = "identity"
    #: 'uniform' -> gate*up gets the uniform rule (/2); 'cp'; 'vanilla'.
    gate: str = "uniform"
    #: 'attnlrp' -> q,k grads /4 and v grads /2 around any attention
    #: kernel; 'cp' -> stop-grad q,k; 'vanilla'.
    attention: str = "attnlrp"
    #: 'identity' -> stop-grad through std/rsqrt in norms; 'vanilla'.
    norm: str = "identity"
    linear_rule: Optional[tuple] = None
    site_rules: tuple = ()
    layer_overrides: tuple = ()

    def __post_init__(self):
        if self.linear_rule is not None or self.site_rules or self.layer_overrides:
            raise NotImplementedError(
                "explicit linear rules, site_rules and layer_overrides are "
                "not ported to lxt_tpu_torch yet")

    # -- rule sites ---------------------------------------------------------

    def act(self, fn, x):
        """Elementwise nonlinearity (SiLU/GELU/tanh...)."""
        if self.activation == "identity":
            return identity_rule(fn, x)
        return fn(x)

    def qkv(self, q, k, v):
        """Relevance flow at the attention inputs; wraps ANY attention
        implementation (einsum or the flash kernels)."""
        if self.attention == "attnlrp":
            return divide_gradient(q, 4), divide_gradient(k, 4), divide_gradient(v, 2)
        if self.attention == "cp":
            return stop_gradient(q), stop_gradient(k), v
        return q, k, v

    def gated_mul(self, act_fn, gate_out, up_out):
        """Gated-MLP joint: act(gate) * up."""
        if self.gate == "uniform":
            g = self.act(act_fn, gate_out)
            return divide_gradient(g * up_out, 2)
        if self.gate == "cp":
            return act_fn(stop_gradient(gate_out)) * up_out
        return act_fn(gate_out) * up_out

    def mul_uniform(self, a, b):
        """Generic bilinear elementwise product (e.g. MoE routing weights)."""
        if self.gate == "cp":
            return stop_gradient(a) * b
        if self.gate == "uniform":
            return divide_gradient(a * b, 2)
        return a * b

    def rms_norm(self, x, weight, eps, offset=0.0):
        """RMSNorm with the identity rule via stop-grad through rsqrt(var).
        Statistics in float32, cast back; the ``(offset + weight) * y`` step
        runs in the activation dtype."""
        dt = x.dtype
        x32 = x.float()
        rs = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
        if self.norm == "identity":
            rs = stop_gradient(rs)
        y = (x32 * rs).to(dt)
        return (offset + weight) * y

    def layer_norm(self, x, weight, bias, eps):
        """LayerNorm with stop-grad through std; statistics in float32."""
        dt = x.dtype
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
        std = torch.sqrt(var + eps)
        if self.norm == "identity":
            std = stop_gradient(std)
        y = ((x32 - mu) / std).to(dt)
        if weight is not None:
            y = y * weight
        if bias is not None:
            y = y + bias
        return y

    def linear(self, x, w, b=None, site=None):
        """Dense layer, ``w: [in, out]``. Under Gradient*Input a plain linear
        already implements the epsilon rule. int8/int4/nf4
        :class:`~lxt_tpu_torch.ops.quant.QuantizedTensor` weights go through
        :func:`~lxt_tpu_torch.ops.quant.quant_matmul` (weights carry no
        relevance, so the rules are untouched). ``site`` names the call site
        (the parameter leaf name), for the site rules still to be ported."""
        if isinstance(w, QuantizedTensor):
            return quant_matmul(x, w, b)
        if not isinstance(w, torch.Tensor):
            raise NotImplementedError(
                f"weights of type {type(w).__name__} are not supported "
                f"(a torch.Tensor or a QuantizedTensor)")
        y = torch.matmul(x, w)
        return y if b is None else y + b


attnlrp = Composite(name="attnlrp")
cp_lrp = Composite(name="cp_lrp", attention="cp", gate="cp")
vanilla_gradient = Composite(
    name="vanilla_gradient", activation="vanilla", gate="vanilla",
    attention="vanilla", norm="vanilla")


def resolve(composite) -> Composite:
    """Accept a :class:`Composite` or one of the predefined names."""
    if isinstance(composite, Composite):
        return composite
    by_name = {"attnlrp": attnlrp, "cp_lrp": cp_lrp,
               "vanilla_gradient": vanilla_gradient}
    if isinstance(composite, str):
        if composite in by_name:
            return by_name[composite]
        raise ValueError(
            f"unknown composite name {composite!r}; predefined names are "
            f"{sorted(by_name)} (or pass a lxt_tpu_torch.Composite instance)")
    raise TypeError(
        f"composite must be a lxt_tpu_torch.Composite or one of "
        f"{sorted(by_name)}, got {type(composite).__name__}")
