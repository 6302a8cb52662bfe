"""Rule audit: which LRP rule governs every op that carries relevance
(counterpart of ``lxt_tpu/rule_audit.py``).

``lxt_tpu`` traces the function and walks its jaxpr. The counterpart here
runs the function once on the example arguments (as leaves that require a
gradient) and walks the autograd graph back from its output's ``grad_fn``:
exactly the graph the backward will run.

- A rule Function appears as its ``<Name>Backward`` node, whose
  ``_forward_cls`` is the Function. Each rule Function of the port names
  its rule in a class attribute, ``lrp_rule = (kind, rule)``: kind "rule"
  for the LRP rules, "attention" for the flash attention Function (the
  AttnLRP corrections wrap around the kernels), "linear" for the
  quantized matmuls (the implicit epsilon rule).
- An operand whose subgraph reaches no example argument is a weight (a
  tensor that needs no gradient is no edge of the graph at all), so a
  product (``mm``, ``bmm``, ``addmm``, a convolution, a quantized matmul)
  with one activation operand is the implicit epsilon rule ("linear").
- A product with two activation operands (``mul``, ``div``, ``bmm``...)
  is governed when every activation operand has passed through a rule on
  every path (the attention products under AttnLRP's q/k/v rules), or when
  the product feeds a rule through shape and dtype ops only (the gated
  MLP's ``divide_gradient(g * up, 2)``); otherwise it is UNRULED and
  flagged (``on_unruled='warn'``) or raised (``'raise'``).
- Values that are dead to relevance (a detached norm statistic, a CP-LRP
  q/k branch) never appear in the graph, so there is no "blocked" entry.
- Non-reentrant checkpointing (``remat=True``) records each layer's nodes
  as a plain forward does, so the audit sees the same graph with remat on.

PyTorch has no named regions, so a hand-written activation appears as its
primitives, and ``lxt_tpu``'s content rule (a single-input region of
elementwise primitives is a pointwise nonlinearity) has nothing to apply
to. The decision here: a product is judged as a product wherever it
stands, so a hand-written activation with a product of two
activation-derived factors (``x * tanh(softplus(x))``, ``x * x``) is an
UNRULED bilinear unless a rule governs it, where ``lxt_tpu`` passes it
when it sits in a jitted function of its own. Wrap such an activation in
``identity_rule`` (the attnlrp composite's ``act`` does), or use a
one-node op (``F.silu``, ``F.gelu``), which gets a "nonlinearity" entry.
A softmax written out as ``exp(x) / exp(x).sum()`` is recognized.

Each entry's ``site`` is the line of the forward that created the node
(the innermost frame outside PyTorch and the port's rule plumbing), read
from the traceback that anomaly mode records on the node.

Usage::

    entries = lxt_tpu_torch.audit(
        lambda e: forward(params, cfg, e, comp).logits, embeds)

Pass the activations as arguments and close parameters over.
"""

import dataclasses
import os
import re
import warnings
from typing import Callable, List

import torch

__all__ = ["audit", "AuditEntry", "UnruledOpError"]


class UnruledOpError(ValueError):
    """A bilinear op with activation-derived operands carries no LRP rule."""


@dataclasses.dataclass(frozen=True)
class AuditEntry:
    """One audited op site."""

    site: str        #: the forward's line, e.g. "llama.py:263 layer"
    op: str          #: the op, e.g. "mm", "mul", "silu"
    shape: str       #: the output, e.g. "float32[2, 8, 16]"
    kind: str        #: rule | linear | bilinear | nonlinearity | attention
    rule: str        #: human-readable rule (or "UNRULED bilinear op")
    ok: bool         #: False = unruled (the reference's red cross)

    def row(self):
        mark = "ok " if self.ok else "!! "
        return f"  {mark}{self.site:<28} {self.op:<22} {self.shape:<18} {self.rule}"


_RULE_KINDS = {"gamma": "gamma", "alphabeta": "alpha-beta",
               "modz": "flat/w^2/z-box"}

#: products: op -> the positions of its two factors among its inputs
_PRODUCTS = {"mm": (0, 1), "bmm": (0, 1), "mv": (0, 1), "dot": (0, 1),
             "addmm": (1, 2), "baddbmm": (1, 2),
             "addbmm": (1, 2), "addmv": (1, 2), "convolution": (0, 1),
             "mul": (0, 1), "div": (0, 1)}
_ELEMENTWISE_PRODUCTS = ("mul", "div")
#: one-node elementwise nonlinearities, entered as such
_NONLIN_NODES = {"silu", "gelu", "tanh", "sigmoid", "relu", "threshold",
                 "softplus", "elu", "leakyrelu", "hardtanh", "hardswish",
                 "mish", "softmax", "logsoftmax"}
#: shape and dtype plumbing a "corrected downstream" verdict may cross
_PASS = {"view", "reshape", "unsafeview", "transpose", "permute", "expand",
         "unsqueeze", "squeeze", "tocopy", "clone", "slice", "select",
         "alias", "t", "split", "splitwithsizes", "unbind"}
_TORCH_DIR = os.path.dirname(torch.__file__)
_PLUMBING = tuple(os.path.join(os.path.dirname(os.path.abspath(__file__)), p)
                  for p in ("ops", "composites.py", "explicit.py",
                            os.path.join("models", "common.py")))
_FRAME = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')


def _lrp_rule(node):
    """The ``(kind, rule)`` that ``node``'s Function declares, or None."""
    return getattr(getattr(node, "_forward_cls", None), "lrp_rule", None)


def _ruled(node):
    """A rule Function or the flash attention Function: the relevance
    leaving it is rule-corrected."""
    rule = _lrp_rule(node)
    return rule is not None and rule[0] in ("rule", "attention")


def _op(node):
    """``MulBackward0`` -> ``mul``; a Function keeps its class name."""
    cls = getattr(node, "_forward_cls", None)
    if cls is not None:
        return cls.__name__.strip("_")
    return re.sub(r"Backward\d*$", "", node.name().split("::")[-1]).lower()


def _site(node):
    """The forward line that created ``node``: the innermost recorded frame
    outside PyTorch and the port's rule plumbing."""
    frames = [m.groups() for m in map(_FRAME.search,
                                      node.metadata.get("traceback_", []))
              if m]
    for path, line, fn in reversed(frames):
        if not path.startswith(_TORCH_DIR) and not path.startswith(_PLUMBING):
            return f"{os.path.basename(path)}:{line} {fn}"
    return "?"


def _shape(node):
    meta = getattr(node, "_input_metadata", None)
    if not meta:
        return "?"
    m = meta[0]
    return f"{str(m.dtype).replace('torch.', '')}{list(m.shape)}"


def _graph(roots):
    """Every node reachable from ``roots``: (children-first order, each
    node's input edges (a node or None, per input), each node's
    consumers)."""
    edges, parents, order, seen = {}, {}, [], set()
    stack = [(r, False) for r in roots]
    while stack:
        node, expanded = stack.pop()
        if expanded:
            order.append(node)
            continue
        if node in seen:
            continue
        seen.add(node)
        edges[node] = [c for c, _ in node.next_functions]
        stack.append((node, True))
        for c in edges[node]:
            if c is not None:
                parents.setdefault(c, []).append(node)
                if c not in seen:
                    stack.append((c, False))
    return order, edges, parents


class _Auditor:
    def __init__(self, roots, args):
        self.roots = set(roots)
        arg_ids = {id(a) for a in args}
        self.order, self.edges, self.parents = _graph(roots)
        # act: the node's value derives from an example argument (carries
        # relevance); touched: every path down to an argument passes
        # through a rule
        self.act, self.touched = {}, {}
        for node in self.order:
            kids = [c for c in self.edges[node] if c is not None and self.act[c]]
            if node.name().endswith("AccumulateGrad"):
                self.act[node] = id(node.variable) in arg_ids
                self.touched[node] = False
            else:
                self.act[node] = bool(kids)
                self.touched[node] = bool(kids) and (
                    _ruled(node) or all(self.touched[c] for c in kids))

    def entries(self):
        out = []
        nodes = sorted((n for n in self.order if self.act[n]
                        and not n.name().endswith("AccumulateGrad")),
                       key=lambda n: n._sequence_nr())
        for node in nodes:
            entry = self._entry(node)
            if entry is not None:
                out.append(entry)
        return out

    def _entry(self, node):
        op, declared = _op(node), _lrp_rule(node)
        kids = [c for c in self.edges[node] if c is not None and self.act[c]]
        all_touch = all(self.touched[c] for c in kids)

        def add(kind, rule, ok):
            return AuditEntry(_site(node), op, _shape(node), kind, rule, ok)

        if declared is not None:
            kind, rule = declared
            return add(kind, rule.format(_RULE_KINDS.get(getattr(node, "kind", ""), "")),
                       True)
        if op in _NONLIN_NODES:
            if op in ("softmax", "logsoftmax"):
                rule = f"{op} Deep-Taylor (Prop 3.1, implicit via G*I)"
            elif all_touch:
                rule = f"governed upstream (G*I through {op})"
            else:
                rule = f"plain autodiff through {op} (no identity rule)"
            return add("nonlinearity", rule, True)
        if op not in _PRODUCTS:
            return None
        edges = self.edges[node]
        factors = [edges[i] for i in _PRODUCTS[op] if i < len(edges)]
        factors = [c for c in factors if c is not None and self.act[c]]
        if len(factors) == 1 and op not in _ELEMENTWISE_PRODUCTS:
            return add("linear", "epsilon rule (implicit via G*I)", True)
        if len(factors) < 2:
            return None
        if op == "div" and self._softmax_div(factors):
            return add("nonlinearity", "softmax Deep-Taylor (Prop 3.1, "
                       "implicit via G*I)", True)
        if all(self.touched[c] for c in factors):
            return add("bilinear", "operands rule-corrected upstream (uniform/CP)",
                       True)
        if self._downstream(node) == "corrected":
            return add("bilinear", "uniform/CP rule applied to the product "
                       "downstream", True)
        return add("bilinear", "UNRULED bilinear op", False)

    def _softmax_div(self, factors):
        """``exp(x) / sum(exp(x))``: the numerator an ``exp`` node, the
        denominator a (broadcast, reshaped, cast) sum of that same node."""
        num, den = factors
        if _op(num) != "exp":
            return False
        for _ in range(6):
            op = _op(den)
            if op == "sum":
                return num in self.edges[den]
            if op not in _PASS or not self.edges[den] or self.edges[den][0] is None:
                return False
            den = self.edges[den][0]
        return False

    def _downstream(self, node, pure=True, depth=0):
        """'corrected' when every consumer path of ``node``'s output reaches
        a rule through shape and dtype ops only, else 'live'."""
        if node in self.roots or depth >= 12:
            return "live"
        states = []
        for p in self.parents.get(node, []):
            if _ruled(p):
                states.append("corrected" if pure else "live")
            else:
                states.append(self._downstream(p, pure and _op(p) in _PASS,
                                               depth + 1))
        return "corrected" if states and all(s == "corrected" for s in states) \
            else "live"


def audit(fn: Callable, *example_args, on_unruled: str = "warn",
          verbose: bool = True) -> List[AuditEntry]:
    """Run ``fn`` on ``example_args`` and report the LRP rule governing
    every relevance-carrying op of the autograd graph of its output.

    ``fn``'s tensor ARGUMENTS are the relevance-carrying activations
    (copies that require a gradient are passed); close parameters over. A
    product with one activation operand is the implicit epsilon rule; with
    two it must be governed by a rule.

    ``on_unruled``: 'warn' (default) emits a ``UserWarning`` naming the
    unruled products, 'raise' raises :class:`UnruledOpError`, 'ignore'
    returns the entries alone. With ``verbose`` the table is printed.
    Returns the entries in forward order."""
    if on_unruled not in ("warn", "raise", "ignore"):
        raise ValueError("on_unruled must be 'warn', 'raise' or 'ignore'")
    args = [a.detach().requires_grad_(True)
            if isinstance(a, torch.Tensor) and a.is_floating_point() else a
            for a in example_args]
    with torch.enable_grad(), warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # anomaly mode's notice
        with torch.autograd.detect_anomaly(check_nan=False):
            out = fn(*args)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    roots = [o.grad_fn for o in outs
             if isinstance(o, torch.Tensor) and o.grad_fn is not None]
    entries = _Auditor(roots, [a for a in args if isinstance(a, torch.Tensor)]
                       ).entries()
    bad = [e for e in entries if not e.ok]
    if verbose:
        print(f"rule audit: {len(entries)} sites, {len(bad)} unruled")
        for e in entries:
            print(e.row())
    if bad:
        msg = (f"{len(bad)} bilinear op(s) with activation-derived operands "
               f"carry no LRP rule: "
               + "; ".join(f"{e.op} at {e.site} {e.shape}" for e in bad[:8]))
        if on_unruled == "raise":
            raise UnruledOpError(msg)
        if on_unruled == "warn":
            warnings.warn(msg)
    return entries
