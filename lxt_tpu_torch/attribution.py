"""Attribution API: one backward pass = one heatmap (counterpart of
``lxt_tpu/attribution.py``).

    logits = forward(inputs_embeds).logits
    relevance = (x * d select_logit(logits) / dx).float().sum(-1)
"""

from typing import Callable

import torch


def select_logit(logits, position=-1, token=None):
    """Scalar explanation target from ``[B, T, V]`` logits.

    ``token=None`` explains the argmax logit at ``position``; an int array
    ``[B]`` explains those token ids. Summing over the batch is safe because
    per-example targets have disjoint gradients."""
    row = logits[:, position, :]
    if token is None:
        return row.max(dim=-1).values.sum()
    token = torch.as_tensor(token, device=row.device).reshape(-1, 1)
    return torch.gather(row, -1, token.long()).sum()


def input_relevance(target_fn: Callable, inputs_embeds, *,
                    sum_features: bool = True):
    """Per-token input relevance via Gradient*Input.

    ``target_fn(embeds) -> scalar``. The gradient is taken with respect to
    ``inputs_embeds`` only (parameters need no ``requires_grad``). Returns
    ``(target_value, relevance)`` with relevance ``[B, T]`` (float32) or
    ``[B, T, D]`` if ``sum_features=False``."""
    x = inputs_embeds.detach().requires_grad_(True)
    with torch.enable_grad():
        value = target_fn(x)
        (grad,) = torch.autograd.grad(value, x)
    rel = x.detach().float() * grad.float()
    if sum_features:
        rel = rel.sum(-1)
    return value.detach(), rel
