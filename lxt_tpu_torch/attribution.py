"""Attribution API: one backward pass = one heatmap (counterpart of
``lxt_tpu/attribution.py``).

    logits = forward(inputs_embeds).logits
    relevance = (x * d select_logit(logits) / dx).float().sum(-1)

The multi-target functions run the forward once and pull K cotangents back
through its graph (``torch.autograd.grad(..., retain_graph=True)``, the
graph freed after the last pull): ``lxt_tpu``'s one ``jax.vjp`` and K
pullbacks of its residuals. ``via`` takes ``lxt_tpu``'s two values, but
both run that loop of pulls and give the same values: a batched pull
(``is_grads_batched``) would need a vmap rule on every autograd Function of
the model (the rules, the flash attention, the quantized matmuls).
"""

from typing import Callable

import torch
import torch.nn.functional as F


def select_logit(logits, position=-1, token=None):
    """Scalar explanation target from ``[B, T, V]`` logits.

    ``token=None`` explains the argmax logit at ``position``; an int array
    ``[B]`` explains those token ids. Summing over the batch is safe because
    per-example targets have disjoint gradients."""
    row = logits[:, position, :]
    if token is None:
        return row.max(dim=-1).values.sum()
    return _pick(row, token).sum()


def _pick(row, token):
    """The entries of ``row [B, V]`` at ``token`` (``[B]`` ids, or one id
    for every row) -> ``[B]``."""
    token = torch.as_tensor(token, device=row.device).long().reshape(-1, 1)
    return torch.gather(row, -1, token.expand(row.shape[0], 1))[:, 0]


def _leaf(t):
    """A detached copy of ``t`` that requires grad: the input a pull
    differentiates against."""
    return t.detach().requires_grad_(True)


def _gxi(x, grad, sum_features=True):
    """Gradient*Input in float32, the feature axis summed or kept."""
    rel = x.detach().float() * grad.float()
    return rel.sum(-1) if sum_features else rel


def input_relevance(target_fn: Callable, inputs_embeds, *,
                    sum_features: bool = True):
    """Per-token input relevance via Gradient*Input.

    ``target_fn(embeds) -> scalar``. The gradient is taken with respect to
    ``inputs_embeds`` only (parameters need no ``requires_grad``). Returns
    ``(target_value, relevance)`` with relevance ``[B, T]`` (float32) or
    ``[B, T, D]`` if ``sum_features=False``."""
    x = _leaf(inputs_embeds)
    with torch.enable_grad():
        value = target_fn(x)
        (grad,) = torch.autograd.grad(value, x)
    return value.detach(), _gxi(x, grad, sum_features)


def latent_relevance(forward_fn: Callable, inputs_embeds, probe_shape, *,
                     sum_features: bool = False):
    """Per-neuron relevance at every layer plus input relevance, one backward.

    ``forward_fn(embeds, probes) -> (scalar_target, hidden_states)`` where
    ``probes`` (zeros of ``probe_shape = [L, B, T, D]`` in the embeds' dtype)
    are added to each layer's output inside the model and ``hidden_states``
    is ``[L+1, B, T, D]``. The gradient with respect to the probes is the
    gradient at each layer output, so ``hidden * grad`` is the latent
    relevance (the reference's ``register_hook`` recipe,
    docs/source/latent-feature-attribution-efficient.rst).

    Returns ``(value, input_rel [B, T], latent_rel [L, B, T(, D)])``, the
    relevances float32."""
    x = _leaf(inputs_embeds)
    probes = torch.zeros(probe_shape, dtype=x.dtype, device=x.device,
                         requires_grad=True)
    with torch.enable_grad():
        value, hiddens = forward_fn(x, probes)
        g_embeds, g_probes = torch.autograd.grad(value, (x, probes))
    latent = hiddens[1:].detach().float() * g_probes.float()
    if sum_features:
        latent = latent.sum(-1)
    return value.detach(), _gxi(x, g_embeds), latent


def _check_via(via):
    if via not in ("scan", "vmap"):
        raise ValueError(f"via must be 'scan' or 'vmap', got {via!r}")


def _row_fn(logits_fn, position):
    """Wrap ``logits_fn`` to return the ``[B, V]`` row at ``position``
    (passthrough when the model already returns 2-D logits)."""
    def row(inputs_embeds):
        logits = logits_fn(inputs_embeds)
        return logits if logits.dim() == 2 else logits[:, position, :]
    return row


def _token_rows(tokens, batch, device):
    """``tokens`` ``[K]`` (the same candidates for every row) or ``[K, B]``
    -> int64 ``[K, B]``."""
    tokens = torch.as_tensor(tokens, device=device).long()
    if tokens.dim() == 1:
        tokens = tokens[:, None].expand(tokens.shape[0], batch)
    return tokens


def _token_pulls(row, x, tokens, sum_features):
    """One ``(value, relevance)`` per ``[B]`` token row of ``tokens [K, B]``,
    each a pull of a one-hot cotangent of ``row [B, V]`` back to ``x``
    through the one forward's graph, which the last pull frees. Returns
    ``(values [K, B], relevance [K, B, T(, D)])``."""
    values, rels = [], []
    for i, tok in enumerate(tokens):
        ct = F.one_hot(tok, row.shape[-1]).to(row.dtype)
        (grad,) = torch.autograd.grad(row, x, grad_outputs=ct,
                                      retain_graph=i < len(tokens) - 1)
        rels.append(_gxi(x, grad, sum_features))
        values.append(_pick(row.detach(), tok))
    return torch.stack(values), torch.stack(rels)


def multi_token_relevance(logits_fn, inputs_embeds, tokens, *, position=-1,
                          sum_features: bool = True, via: str = "scan"):
    """K relevance maps sharing ONE forward pass.

    ``logits_fn(embeds) -> [B, T, V]`` (or ``[B, V]``); ``tokens`` is
    ``[K]`` (the same candidates for every batch row) or ``[K, B]`` int
    ids. Returns ``(values [K, B], relevance [K, B, T])``: one forward and
    K pulls through its graph instead of K forwards and backwards. ``via``:
    'scan' or 'vmap', the same loop (see the module docstring)."""
    _check_via(via)
    x = _leaf(inputs_embeds)
    with torch.enable_grad():
        row = _row_fn(logits_fn, position)(x)
        tokens = _token_rows(tokens, row.shape[0], row.device)
        return _token_pulls(row, x, tokens, sum_features)


def topk_relevance(logits_fn, inputs_embeds, k: int = 5, *, position=-1,
                   sum_features: bool = True, via: str = "scan"):
    """Explain the model's top-k candidates at ``position`` in one pass.

    Returns ``(tokens [K, B], values [K, B], relevance [K, B, T])`` with
    ``tokens[0]`` the argmax. Equal logits are ordered by token id, lower
    first, as ``jax.lax.top_k`` orders them (a stable descending sort)."""
    _check_via(via)
    x = _leaf(inputs_embeds)
    with torch.enable_grad():
        row = _row_fn(logits_fn, position)(x)
        toks = torch.sort(row.detach(), dim=-1, descending=True,
                          stable=True).indices[:, :k].T        # [K, B]
        values, rel = _token_pulls(row, x, toks, sum_features)
    return toks, values, rel


def _site_pulls(logits, inputs, positions, tokens, grads_of, contrastive):
    """The pull loop of the multi-site functions: site k seeds a one-hot
    of ``tokens[k]`` (minus one of its rival under ``contrastive``) at
    ``positions[k]`` in one ``[B, T, V]`` cotangent, reused for every site
    (its row set, pulled, cleared). ``grads_of(grads)`` maps the pull's
    gradients for ``inputs`` to the site's results. Returns the tuple of
    stacked ``(values [K, B], *results)``."""
    V = logits.shape[-1]
    ct = torch.zeros_like(logits)
    detached = logits.detach()
    out = []
    for i, (pos, tok) in enumerate(zip(positions, tokens)):
        row = detached[:, pos, :]
        seed = F.one_hot(tok, V).to(logits.dtype)
        value = _pick(row, tok)
        if contrastive:
            # the rival: the strongest token at the site other than the target
            masked = torch.where(seed > 0, float("-inf"), row.float())
            rival = masked.argmax(-1)
            seed = seed - F.one_hot(rival, V).to(logits.dtype)
            value = value - _pick(row, rival)
        ct[:, pos, :] = seed
        grads = torch.autograd.grad(logits, inputs, grad_outputs=ct,
                                    retain_graph=i < len(tokens) - 1)
        out.append((value, *grads_of(grads)))
        ct[:, pos, :] = 0
    return tuple(torch.stack(parts) for parts in zip(*out))


def multi_site_relevance(logits_fn, inputs_embeds, positions, tokens, *,
                         aux_input=None, sum_features: bool = True,
                         contrastive: bool = False, via: str = "scan"):
    """K relevance maps for K (position, token) sites, ONE forward pass.

    ``logits_fn(embeds) -> [B, T, V]``; ``positions [K]`` int positions,
    ``tokens`` ``[K]`` or ``[K, B]`` int ids. Site k's target is the logit
    of ``tokens[k]`` at ``positions[k]``. Returns ``(values [K, B],
    relevance [K, B, T])``.

    ``aux_input``: a second differentiable input; then
    ``logits_fn(embeds, aux)`` and the return gains a third element, the
    per-site aux relevance (Gradient*Input over ``aux``, last axis summed
    under ``sum_features``).

    ``contrastive``: each site's target becomes ``logit(token) -
    logit(rival)``, the rival being the strongest other token at that
    position; ``values`` are then the logit margins. ``via`` as in
    :func:`multi_token_relevance`."""
    _check_via(via)
    x = _leaf(inputs_embeds)
    inputs = (x,) if aux_input is None else (x, _leaf(aux_input))
    with torch.enable_grad():
        logits = logits_fn(*inputs)
        if logits.dim() != 3:
            raise ValueError(
                f"multi_site_relevance needs [B, T, V] logits, got "
                f"{tuple(logits.shape)} — for one fixed position use "
                f"multi_token_relevance")
        tokens = _token_rows(tokens, logits.shape[0], logits.device)
        positions = torch.as_tensor(positions).reshape(-1).tolist()
        return _site_pulls(
            logits, inputs, positions, tokens,
            lambda grads: [_gxi(t, g, sum_features)
                           for t, g in zip(inputs, grads)], contrastive)


def multi_site_latent_relevance(forward_fn, inputs_embeds, positions,
                                tokens, probe_shape, *, via: str = "scan"):
    """Input AND per-layer relevance for K (position, token) sites, one
    forward.

    ``forward_fn(embeds, probes) -> (logits [B, T, V], hidden_states
    [L+1, B, T, D])`` with ``probes`` zeros of ``probe_shape = [L, B, T, D]``
    added to each layer output (the contract of :func:`latent_relevance`).
    Site k targets the logit of ``tokens[k]`` at ``positions[k]``. Returns
    ``(values [K, B], input_rel [K, B, T], latent_rel [K, L, B, T])``."""
    _check_via(via)
    x = _leaf(inputs_embeds)
    probes = torch.zeros(probe_shape, dtype=x.dtype, device=x.device,
                         requires_grad=True)
    with torch.enable_grad():
        logits, hiddens = forward_fn(x, probes)
        h32 = hiddens[1:].detach().float()
        tokens = _token_rows(tokens, logits.shape[0], logits.device)
        positions = torch.as_tensor(positions).reshape(-1).tolist()
        return _site_pulls(
            logits, (x, probes), positions, tokens,
            lambda grads: (_gxi(x, grads[0]),
                           (h32 * grads[1].float()).sum(-1)), False)


def contrastive_target(logits, token_a, token_b, position=-1):
    """Contrastive explanation target: logit(a) - logit(b) at ``position``
    (reference docs/source/quickstart.rst GPT-2 contrastive example)."""
    row = logits[:, position, :]
    return (_pick(row, token_a) - _pick(row, token_b)).sum()


def normalize_relevance(rel, axis=None):
    """Scale relevance to [-1, 1] by the max |R| (the reference normalizes
    before pdf_heatmap, examples/quantized_llama.py:50)."""
    rel = torch.as_tensor(rel)
    denom = (rel.abs().max() if axis is None
             else rel.abs().amax(dim=axis, keepdim=True))
    return rel / (denom + 1e-12)
