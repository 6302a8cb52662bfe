"""Faithfulness evaluation: input-perturbation curves and AOPC
(counterpart of ``lxt_tpu/utils/faithfulness.py``).

The AttnLRP paper validates attributions by perturbation analysis: ablate
the most relevant tokens first and watch the explained logit collapse;
ablating the least relevant first should barely move it.

- MoRF ("most relevant first"): ablate tokens in DESCENDING relevance
  order. A faithful explanation makes the target drop fast: larger AOPC.
- LeRF ("least relevant first"): ablate ASCENDING; faithful => flat curve.
- AOPC = mean over steps of (f(x) - f(x_perturbed)).

Each curve runs ``steps + 1`` forwards without a graph, one per ablated
fraction (``lxt_tpu`` vmaps them; the values are the same). Usage::

    def logit_fn(e):   # [B, T, D] -> [B] explained logit values
        out = llama.forward(params, cfg, e, lxt_tpu_torch.attnlrp, logits_at=-1)
        return out.logits[:, -1, :].max(-1).values

    curve = perturbation_curve(logit_fn, embeds, relevance, order="morf")
    curve.aopc, curve.fractions, curve.values  # [B], [S+1], [S+1, B]
"""

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class PerturbationCurve:
    fractions: torch.Tensor   # [S+1] fraction of tokens ablated per step
    values: torch.Tensor      # [S+1, B] explained logit after ablation
    aopc: torch.Tensor        # [B] area over the perturbation curve


def _rank_order(relevance, descending):
    """rank[i] = position of token i in the ablation order (0 = first out);
    equal relevances keep their token order (stable sorts, as ``jnp.argsort``)."""
    r = relevance if descending else -relevance
    order = torch.argsort(-r, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _fractions(steps):
    """The ablated fractions ``[steps + 1]`` in float32, bit-equal to
    ``jnp.linspace(0, 1, steps + 1)`` as XLA computes it: ``i * (1 / steps)``
    (the division by a constant becomes a product by its reciprocal), then
    exactly 1. One ulp moves k = round(frac * n_valid) wherever the product
    lands on a half."""
    step = torch.ones((), dtype=torch.float32) / steps
    return torch.cat([torch.arange(steps, dtype=torch.float32) * step,
                      torch.ones(1)])


def perturbation_curve(
    logit_fn: Callable,
    inputs_embeds,
    relevance,
    *,
    steps: int = 10,
    order: str = "morf",
    baseline=None,
    valid_mask=None,
    generator=None,
):
    """A perturbation curve, one forward per ablated fraction.

    ``logit_fn(embeds [B,T,D]) -> [B]`` explained logits; ``relevance``:
    [B, T] token scores; ``baseline``: replacement embedding (scalar/[D]/
    [B,T,D], or ``'mean'`` for the per-example mean embedding over valid
    positions; default 0, embedding-space token deletion); ``valid_mask``:
    optional [B, T] bool marking real (non-padding) tokens, which are the
    only ones counted and ablated. ``generator``: the ``torch.Generator``
    for ``order='random'`` (default: a fixed seed on the embeds' device,
    which keeps the control reproducible)."""
    if order not in ("morf", "lerf", "random"):
        raise ValueError(order)
    x = inputs_embeds.detach()
    B, T, D = x.shape
    device = x.device
    if valid_mask is None:
        valid_mask = torch.ones((B, T), dtype=torch.bool, device=device)
    valid_mask = torch.as_tensor(valid_mask, device=device).bool()
    n_valid = valid_mask.sum(-1)
    if baseline is None or (isinstance(baseline, str) and baseline == "zero"):
        baseline = torch.zeros((), dtype=x.dtype, device=device)
    elif isinstance(baseline, str):
        if baseline != "mean":
            raise ValueError(f"baseline must be 'zero', 'mean' or an "
                             f"array, got {baseline!r}")
        # mean over VALID positions only: padding must not drag the
        # replacement embedding
        m = valid_mask[..., None]
        baseline = ((x * m).sum(-2, keepdim=True)
                    / n_valid.clamp(min=1)[:, None, None]).to(x.dtype)
    baseline = torch.as_tensor(baseline, dtype=x.dtype,
                               device=device).expand(B, T, D)

    rel = torch.as_tensor(relevance, device=device).float()
    if order == "random":
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        rel = torch.rand(rel.shape, generator=generator, device=device)
    # padded tokens sort to the very end in every order
    pad = float("inf") if order == "lerf" else float("-inf")
    rel = torch.where(valid_mask, rel, pad)
    ranks = _rank_order(rel, descending=order != "lerf")

    fracs = _fractions(steps).to(device)
    values = []
    with torch.no_grad():
        for frac in fracs:
            # round, not ceil: float32 frac*n lands epsilon above integers
            k = torch.round(frac * n_valid).to(torch.int32)
            ablate = ranks < k[:, None]                       # [B, T]
            values.append(logit_fn(torch.where(ablate[..., None], baseline, x)))
    values = torch.stack(values)                              # [S+1, B]
    aopc = (values[0][None] - values[1:]).mean(0)
    return PerturbationCurve(fractions=fracs, values=values, aopc=aopc)


def aopc_scores(logit_fn, inputs_embeds, relevance, *, steps: int = 10,
                baseline=None, valid_mask=None):
    """(aopc_morf, aopc_lerf, aopc_random) per example; faithful relevance
    satisfies morf > random > lerf."""
    return tuple(perturbation_curve(
        logit_fn, inputs_embeds, relevance, steps=steps, order=order,
        baseline=baseline, valid_mask=valid_mask).aopc
        for order in ("morf", "lerf", "random"))


def auc(values):
    """Trapezoidal area under a ``[S+1, B]`` (or ``[S+1]``) curve over the
    ablated fraction in [0, 1]. Lower is better for MoRF, higher for LeRF."""
    values = torch.as_tensor(values).float()
    steps = values.shape[0] - 1
    return (0.5 * (values[0] + values[-1]) + values[1:-1].sum(0)) / steps


def faithfulness_report(logit_fn, inputs_embeds, relevance, *,
                        steps: int = 10, baseline=None, valid_mask=None,
                        generator=None) -> dict:
    """MoRF + LeRF + random curves and the summary scores, one dict.

    Keys: ``morf``/``lerf``/``random`` (:class:`PerturbationCurve`),
    ``auc_morf``/``auc_lerf``/``auc_random`` and ``aopc_*`` (``[B]``), and
    ``abpc [B]``: the area between the LeRF and MoRF curves, the single
    faithfulness score of the AttnLRP paper's evaluation (higher = the
    attribution separates important from unimportant tokens better; 0 = no
    better than its own reverse ordering). ``generator`` draws the random
    order (see :func:`perturbation_curve`)."""
    out = {}
    for order in ("morf", "lerf", "random"):
        curve = perturbation_curve(logit_fn, inputs_embeds, relevance,
                                   steps=steps, order=order, baseline=baseline,
                                   valid_mask=valid_mask, generator=generator)
        out[order] = curve
        out[f"auc_{order}"] = auc(curve.values)
        out[f"aopc_{order}"] = curve.aopc
    out["abpc"] = out["auc_lerf"] - out["auc_morf"]
    return out
