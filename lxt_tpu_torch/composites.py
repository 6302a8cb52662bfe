"""Composites: declarative rule assignments for model forward passes.

The counterpart of ``lxt_tpu/composites.py``. A :class:`Composite` is a
frozen config object passed into the model forward; model code calls its
methods (``act``, ``qkv``, ``gated_mul``, ``mul_uniform``, ``rms_norm``,
``layer_norm``, ``linear``, ``conv2d``) at each rule site.

Presets mirror ``lxt_tpu``: :data:`attnlrp`, :data:`cp_lrp` and
:data:`vanilla_gradient`. The explicit rules of linear and conv layers
(gamma, alpha-beta / z+, flat, w-square, z-box; ``ops/rules.py``) are set
layer-wide (:meth:`Composite.with_gamma`, :meth:`Composite.with_rules`),
per site (:meth:`Composite.override_sites`) or per layer depth
(:meth:`Composite.override_layers`, resolved by :meth:`Composite.for_layer`
at each depth of the model's layer loop). Quantized weights
(:class:`~lxt_tpu_torch.ops.quant.QuantizedTensor`) go through
:func:`~lxt_tpu_torch.ops.quant.quant_matmul`, or are dequantized first
under a rule.
"""

import dataclasses
from typing import Optional

import torch

from lxt_tpu_torch.ops import tensor_parallel
from lxt_tpu_torch.ops.quant import QuantizedTensor, dequantize, quant_matmul
from lxt_tpu_torch.ops.rules import (
    _conv2d,
    alphabeta_conv2d,
    alphabeta_linear,
    divide_gradient,
    gamma_conv2d,
    gamma_linear,
    identity_rule,
    modz_conv2d,
    modz_linear,
    stop_gradient,
)


def _norm_rule_spec(rule):
    """Canonicalize a linear/conv rule spec: None, ("gamma", g),
    ("alphabeta", a, b) with a - b = 1, ("zplus",) -> ("alphabeta", 1, 0),
    ("flat",), ("wsquare",), ("zbox", low, high) (scalar input bounds),
    ("epsilon",)/("pass",) -> None (epsilon is the implicit G*I behavior;
    pass keeps the plain gradient)."""
    if rule is None:
        return None
    if isinstance(rule, str):
        rule = (rule,)
    kind = rule[0]
    if kind in ("epsilon", "pass"):
        return None
    if kind == "gamma":
        return ("gamma", float(rule[1]))
    if kind == "zplus":
        return ("alphabeta", 1.0, 0.0)
    if kind == "alphabeta":
        a, b = float(rule[1]), float(rule[2])
        if abs(a - b - 1.0) > 1e-6:
            raise ValueError(
                f"alphabeta needs alpha - beta = 1 (conservation), got "
                f"alpha={a}, beta={b}")
        return ("alphabeta", a, b)
    if kind in ("flat", "wsquare"):
        return (kind,)
    if kind == "zbox":
        low, high = float(rule[1]), float(rule[2])
        if not low < high:
            raise ValueError(f"zbox needs low < high, got {low}, {high}")
        return ("zbox", low, high)
    raise ValueError(
        f"unknown rule spec {rule!r}; use None, 'epsilon', 'pass', "
        f"('gamma', g), ('alphabeta', a, b), 'zplus', 'flat', 'wsquare' "
        f"or ('zbox', low, high)")


def _rule_text(rule):
    if rule is None:
        return "epsilon rule (implicit via G*I)"
    if rule[0] == "gamma":
        return f"gamma rule (gamma={rule[1]})"
    if rule[0] == "flat":
        return "flat rule (uniform over fan-in)"
    if rule[0] == "wsquare":
        return "w^2 rule (weight-magnitude redistribution)"
    if rule[0] == "zbox":
        return f"z-box rule (input bounds [{rule[1]}, {rule[2]}])"
    if rule[1:] == (1.0, 0.0):
        return "z+ rule (alphabeta 1,0)"
    return f"alpha-beta rule (alpha={rule[1]}, beta={rule[2]})"


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
    #: gamma-rule strength for conv layers, None = plain autodiff.
    conv_gamma: Optional[float] = None
    #: gamma-rule strength for linear layers, None = plain autodiff.
    linear_gamma: Optional[float] = None
    #: explicit rule for linear layers, superseding ``linear_gamma``: a
    #: :func:`_norm_rule_spec` spec (None = epsilon, implicit via G*I).
    linear_rule: Optional[tuple] = None
    #: explicit rule for conv layers (the same forms as ``linear_rule``).
    conv_rule: Optional[tuple] = None
    #: per-site overrides: sorted ``(site_name, rule_spec)`` pairs, sites
    #: being the models' parameter leaf names (:meth:`override_sites`).
    site_rules: tuple = ()
    #: per-depth overrides: ``(selector, changes)`` pairs, ``selector`` a
    #: half-open ``(start, stop)`` range, ``changes`` ``(field, value)``
    #: pairs; later entries win (:meth:`override_layers`).
    layer_overrides: tuple = ()

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

    def _linear_rule(self):
        if self.linear_rule is not None:
            return _norm_rule_spec(self.linear_rule)
        if self.linear_gamma is not None:
            return ("gamma", self.linear_gamma)
        return None

    def _conv_rule(self):
        if self.conv_rule is not None:
            return _norm_rule_spec(self.conv_rule)
        if self.conv_gamma is not None:
            return ("gamma", self.conv_gamma)
        return None

    def _site_rule(self, site, default):
        """An :meth:`override_sites` entry for ``site`` wins over the
        layer-wide default; a site set to None pins epsilon."""
        if site is not None:
            for s, spec in self.site_rules:
                if s == site:
                    return spec
        return default

    def linear(self, x, w, b=None, site=None, row_parallel=False):
        """Dense layer, ``w: [in, out]``. Under Gradient*Input a plain linear
        already implements the epsilon rule; a gamma / alpha-beta /
        modified-z rule (``linear_rule``, or ``site``'s entry in
        :attr:`site_rules`, ``site`` being the parameter leaf name)
        redistributes explicitly. int8/int4/nf4
        :class:`~lxt_tpu_torch.ops.quant.QuantizedTensor` weights go through
        :func:`~lxt_tpu_torch.ops.quant.quant_matmul` (weights carry no
        relevance), or under a rule are dequantized to ``x``'s dtype first.

        ``row_parallel``: under tensor parallelism
        (:mod:`~lxt_tpu_torch.ops.tensor_parallel`) ``x`` and ``w`` hold
        one shard of the input features; the partial products are summed
        over the group, the bias is added once after the sum, and a rule's
        denominators are the summed ones. Without a group it changes
        nothing."""
        rule = self._site_rule(site, self._linear_rule())
        group = tensor_parallel.group() if row_parallel else None
        if isinstance(w, QuantizedTensor):
            if rule is None:
                if group is None:
                    return quant_matmul(x, w, b)
                y = tensor_parallel.reduce(quant_matmul(x, w))
                return y if b is None else y + b
            w = dequantize(w, x.dtype)
        if not isinstance(w, torch.Tensor):
            raise NotImplementedError(
                f"weights of type {type(w).__name__} are not supported "
                f"(a torch.Tensor or a QuantizedTensor)")
        if rule is None:
            y = torch.matmul(x, w)
            if group is not None:
                y = tensor_parallel.reduce(y)
            return y if b is None else y + b
        if rule[0] == "gamma":
            return gamma_linear(x, w, b, rule[1], group=group)
        if rule[0] in ("flat", "wsquare", "zbox"):
            return modz_linear(x, w, b, rule, group=group)
        return alphabeta_linear(x, w, b, rule[1], rule[2], group=group)

    def conv2d(self, x, w, b=None, strides=(1, 1), padding="VALID",
               site=None):
        """NHWC conv, ``w: [kh, kw, cin, cout]``; the ``conv_rule`` (or
        ``site``'s) if one is set (the vision towers' patch embedding)."""
        rule = self._site_rule(site, self._conv_rule())
        if rule is None:
            return _conv2d(x, w, b, strides, padding)
        if rule[0] == "gamma":
            return gamma_conv2d(x, w, b, strides, padding, rule[1])
        if rule[0] in ("flat", "wsquare", "zbox"):
            return modz_conv2d(x, w, b, strides, padding, rule)
        return alphabeta_conv2d(x, w, b, strides, padding, rule[1], rule[2])

    def with_gamma(self, conv_gamma=None, linear_gamma=None):
        """A gamma-rule variant (ViT denoising); an omitted (None) argument
        keeps the current value."""
        return dataclasses.replace(
            self,
            conv_gamma=self.conv_gamma if conv_gamma is None else conv_gamma,
            linear_gamma=(self.linear_gamma if linear_gamma is None
                          else linear_gamma),
            name=self.name if self.name.endswith("+gamma")
            else f"{self.name}+gamma")

    def with_rules(self, linear="keep", conv="keep"):
        """A variant with explicit linear / conv rules. Specs: None /
        'epsilon' / 'pass', ('gamma', g), ('alphabeta', a, b), 'zplus',
        'flat', 'wsquare', ('zbox', low, high); 'keep' leaves the current
        value."""
        lr = self.linear_rule if linear == "keep" else _norm_rule_spec(linear)
        cr = self.conv_rule if conv == "keep" else _norm_rule_spec(conv)
        return dataclasses.replace(
            self, linear_rule=lr, conv_rule=cr,
            name=f"{self.name}+rules" if not self.name.endswith("+rules")
            else self.name)

    def override_sites(self, **site_specs):
        """A variant with per-site rules: keys are the models' parameter
        leaf names (ViT: ``conv_w``, ``w_qkv``, ``w_proj``, ``w_fc``,
        ``w_out``, ``head_w``; llama: ``wq wk wv wo wg wu wd``), values any
        :meth:`with_rules` spec (None pins epsilon at that site even under a
        layer-wide rule). Later calls win per site; a site entry also wins
        over a depth override of ``linear_rule``."""
        merged = dict(self.site_rules)
        for k, v in site_specs.items():
            merged[k] = _norm_rule_spec(v)
        return dataclasses.replace(
            self, site_rules=tuple(sorted(merged.items())),
            name=self.name if self.name.endswith("+sites")
            else f"{self.name}+sites")

    def override_layers(self, layers, **changes):
        """A variant whose fields change on the selected layer depths:
        ``layers`` is an int depth or a half-open ``(start, stop)`` range
        (``stop=None`` through the last layer; negative indices count from
        the end). Later overrides win. The models resolve
        :meth:`for_layer` at each depth of their layer loop."""
        valid = {f.name for f in dataclasses.fields(self)} - {
            "name", "layer_overrides"}
        for k in changes:
            if k not in valid:
                raise ValueError(f"unknown Composite field {k!r}; "
                                 f"overridable: {sorted(valid)}")
        if isinstance(layers, int):
            i = int(layers)
            # int -1 is the last layer: (-1, 0) would match nothing
            sel = (i, None) if i == -1 else (i, i + 1)
        else:
            sel = (int(layers[0]),
                   None if layers[1] is None else int(layers[1]))
        norm = {}
        for k, v in changes.items():
            if k in ("linear_rule", "conv_rule"):
                v = _norm_rule_spec(v)
            norm[k] = v
        entry = (sel, tuple(sorted(norm.items())))
        return dataclasses.replace(
            self, layer_overrides=self.layer_overrides + (entry,),
            name=f"{self.name}+L{sel[0]}:{sel[1]}")

    def for_layer(self, i: int, num_layers: Optional[int] = None):
        """The composite governing layer depth ``i`` (0-based), carrying no
        further overrides; ``self`` when there are none."""
        if not self.layer_overrides:
            return self
        fields = {}
        for (start, stop), changes in self.layer_overrides:
            lo = start if start >= 0 else (
                None if num_layers is None else start + num_layers)
            hi = (num_layers if stop is None else
                  (stop if stop >= 0 else
                   (None if num_layers is None else stop + num_layers)))
            if lo is None or (hi is None and stop is not None and stop < 0):
                raise ValueError(
                    "negative layer_overrides indices need num_layers")
            if lo <= i and (hi is None or i < hi):
                fields.update(dict(changes))
        return dataclasses.replace(self, layer_overrides=(), **fields)

    def summary(self, verbose: bool = True) -> str:
        """The rule at every site as a table (the text of
        ``lxt_tpu.Composite.summary``); printed when ``verbose``."""
        rows = [
            ("elementwise nonlinearities", {
                "identity": "identity rule (Eq. 9)",
                "vanilla": "plain autodiff"}[self.activation]),
            ("gated-MLP product", {
                "uniform": "uniform rule, /2 (Eq. 7)",
                "cp": "stop-gradient through gate branch (CP-LRP)",
                "vanilla": "plain autodiff"}[self.gate]),
            ("attention q/k/v", {
                "attnlrp": "uniform rule: q,k /4 and v /2 (AttnLRP)",
                "cp": "stop-gradient on q,k (CP-LRP)",
                "vanilla": "plain autodiff"}[self.attention]),
            ("softmax", "Deep-Taylor Prop 3.1 (implicit via G*I)"
             if self.attention == "attnlrp" else
             ("relevance blocked (CP)" if self.attention == "cp"
              else "plain autodiff")),
            ("norm denominators", {
                "identity": "identity rule via stop-grad std (Prop 3.4)",
                "vanilla": "plain autodiff"}[self.norm]),
            ("linear layers", _rule_text(self._linear_rule())),
            ("conv layers", _rule_text(self._conv_rule())),
            ("biases", "relevance sink (absorbed, as in the reference)"),
        ]
        for site, spec in self.site_rules:
            rows.append((f"site '{site}'", _rule_text(spec)))
        for (start, stop), changes in self.layer_overrides:
            span = f"layers [{start}, {'end' if stop is None else stop})"
            rows.append((span, ", ".join(f"{k}={v!r}" for k, v in changes)))
        width = max(len(site) for site, _ in rows)
        lines = [f"Composite '{self.name}'"]
        lines += [f"  {site.ljust(width)}  ->  {rule}" for site, rule in rows]
        text = "\n".join(lines)
        if verbose:
            print(text)
        return text


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
