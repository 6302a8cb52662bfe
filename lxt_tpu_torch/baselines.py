"""Gradient-method baselines: Gradient*Input, Integrated Gradients and
SmoothGrad (counterpart of ``lxt_tpu/baselines.py``).

The AttnLRP paper's claim is that LRP beats gradient-based attribution on
faithfulness while costing one backward pass instead of dozens; with these
the claim is runnable:

    rep_lrp = faithfulness_report(logit_fn, e, lrp_relevance)
    rep_ig  = faithfulness_report(logit_fn, e, integrated_gradients(...))

Each method loops over its interpolation points or noise samples, one
batched forward and backward each, and accumulates the gradients in
float32. ``target_fn(embeds [B, T, D]) -> [B]`` per-example explained
logits, the contract of :mod:`lxt_tpu_torch.utils.faithfulness` (use the
plain forward, e.g. under ``vanilla_gradient``: these methods define their
own relevance).
"""

from typing import Callable

import torch


def _grad(target_fn, x):
    """The gradient of the summed per-example target at ``x`` (per-example
    targets have disjoint gradients, so the sum seeds every row with 1)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        (grad,) = torch.autograd.grad(target_fn(x).sum(), x)
    return grad


def _reduce(rel, sum_features):
    return rel.sum(-1) if sum_features else rel


def gradient_x_input(target_fn: Callable, inputs_embeds, *,
                     sum_features: bool = True):
    """Plain Gradient*Input (what the ``vanilla_gradient`` composite gives
    through the attribution API)."""
    grad = _grad(target_fn, inputs_embeds)
    return _reduce(inputs_embeds.float() * grad.float(), sum_features)


def integrated_gradients(target_fn: Callable, inputs_embeds, *,
                         steps: int = 32, baseline="zero",
                         sum_features: bool = True):
    """Integrated Gradients (Sundararajan et al. 2017) over the embedding
    path ``x0 + a*(x - x0)``, midpoint rule: ``a = (i + 1/2) / steps``.

    ``baseline``: 'zero', 'mean' (the per-example mean embedding) or a
    tensor or array broadcastable to ``[B, T, D]``. Returns ``[B, T]``
    relevance (or ``[B, T, D]``). Complete up to quadrature error:
    ``rel.sum(1) ~= target(x) - target(x0)``, exact for a linear target."""
    x = inputs_embeds.detach()
    if isinstance(baseline, str):
        if baseline == "zero":
            x0 = torch.zeros_like(x)
        elif baseline == "mean":
            x0 = x.mean(-2, keepdim=True).to(x.dtype).expand_as(x)
        else:
            raise ValueError(f"baseline must be 'zero', 'mean' or an "
                             f"array, got {baseline!r}")
    else:
        x0 = torch.as_tensor(baseline, dtype=x.dtype,
                             device=x.device).expand_as(x)
    delta = x - x0
    alphas = (torch.arange(steps, dtype=torch.float32) + 0.5) / steps
    total = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for a in alphas:
        total += _grad(target_fn, x0 + a.to(x.device, x.dtype) * delta).float()
    return _reduce(delta.float() * (total / steps), sum_features)


def smoothgrad(target_fn: Callable, inputs_embeds, generator, *,
               samples: int = 16, sigma: float = 0.1,
               sum_features: bool = True, times_input: bool = True):
    """SmoothGrad (Smilkov et al. 2017): gradients averaged over Gaussian
    input noise, of scale ``sigma`` times the per-example embedding std.

    ``generator``: the ``torch.Generator`` (on the embeds' device) the noise
    is drawn from; the same seed gives the same result. ``times_input=True``
    returns the Gradient*Input form (comparable to the LRP relevances);
    ``False`` the smoothed gradient."""
    x = inputs_embeds.detach()
    noise_scale = sigma * x.float().std(dim=(-1, -2), keepdim=True,
                                        correction=0)
    total = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for _ in range(samples):
        noise = torch.randn(x.shape, generator=generator, device=x.device)
        total += _grad(target_fn, x + (noise * noise_scale).to(x.dtype)).float()
    avg = total / samples
    return _reduce(x.float() * avg if times_input else avg, sum_features)
