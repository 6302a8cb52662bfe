"""Ring (sequence-parallel) flash attention with a relevance-correct
backward (counterpart of ``lxt_tpu/parallel/ring.py``).

For contexts longer than one device holds, the sequence is split over the
processes of a ``torch.distributed`` group: each holds one shard of q/k/v.
At ring step s, every process computes flash attention between its local
queries and the kv shard that started on process ``(idx − s) mod n``, then
passes its current kv shard to the next process. Partial results merge by
logsumexp reweighting; the merge, the shift and each step's kernels are
differentiable, so one backward pass over the whole ring yields exactly the
relevance of one attention, including the paths through the merge weights,
because :func:`flash_attention_lse`'s backward folds the lse cotangent into
its Δ. The masks run in global positions (``q_start``/``k_start``); a step
whose kv shard the mask hides wholly from the local queries (in their
future under the causal mask, or behind the window) launches no kernel
and merges nothing, since it would add lse −1e30: zero merge weight.

The shift is an autograd Function: forward, send to rank + 1 and receive
from rank − 1; backward, the same shift in reverse, so the backward's
point-to-point calls pair up on every process. NCCL moves CUDA tensors
directly; gloo has no point-to-point for CUDA tensors, so a gloo group
stages them through host copies (communication only: the attention and
matmul work stays on the card).
"""

import contextlib

import torch
import torch.distributed as dist

from lxt_tpu_torch.attribution import select_logit
from lxt_tpu_torch.ops import check, tensor_parallel
from lxt_tpu_torch.ops.flash_attention import NEG_INF, flash_attention_lse

#: the group ``attention(impl="ring")`` runs over; None: the default group.
#: Module-level rather than a context variable: a checkpointed layer's
#: recompute runs on autograd's device thread, which must see it too.
_active = [None]


def active_group():
    """The process group of the ring that ``attribute_sequence_parallel``
    is running (None: the default group)."""
    return _active[0]


@contextlib.contextmanager
def _using(group):
    prev, _active[0] = _active[0], group
    try:
        yield
    finally:
        _active[0] = prev


def _size_rank(group):
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def ring_length(T):
    """The global sequence length of the running ring, whose shards hold
    ``T`` tokens (the models pass it to longrope's schedule choice)."""
    return T * _size_rank(active_group())[0]


def _global(group, r):
    return r if group is None else dist.get_global_rank(group, r)


def _shift(group, tensors, step):
    """Send each tensor to group rank + ``step`` and return the ones
    received from group rank − ``step``, in one batch."""
    n, r = _size_rank(group)
    dst, src = _global(group, (r + step) % n), _global(group, (r - step) % n)
    # gloo has no point-to-point for CUDA tensors: a host copy
    stage = tensor_parallel.staged(group, tensors[0])
    send = [(t.cpu() if stage else t).contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = []
    for tag, (s, rv) in enumerate(zip(send, recv)):
        ops.append(dist.P2POp(dist.isend, s, dst, group, tag))
        ops.append(dist.P2POp(dist.irecv, rv, src, group, tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [rv.to(t.device) if stage else rv for rv, t in zip(recv, tensors)]


def _hidden(idx, src, Tl, causal, window):
    """Whether the mask hides the kv shard of process ``src`` wholly from
    the queries of process ``idx`` (shards of ``Tl`` positions): in their
    future under the causal mask, or its newest key behind the window of
    the oldest query."""
    if causal and src > idx:
        return True
    return window is not None and (src + 1) * Tl - 1 <= idx * Tl - max(int(window), 1)


class _RingShift(torch.autograd.Function):
    """k and v moved one rank to the right together (one batch), so the
    backward's shift of dk and dv to the left pairs up identically on every
    process (``lax.ppermute`` and its transpose)."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group = group
        return tuple(_shift(group, (k, v), 1))

    @staticmethod
    def backward(ctx, dk, dv):
        return (None, *_shift(ctx.group, (dk, dv), -1))


class _Join(torch.autograd.Function):
    """``out`` unchanged, with ``k`` and ``v`` in its graph at a zero
    gradient. The shifts communicate, so every process runs the backward of
    each one; where the mask hid the last step, the k/v the shifts brought
    reach the result through this alone."""

    @staticmethod
    def forward(ctx, out, k, v):
        ctx.kv = [(t.shape, t.dtype, t.device) for t in (k, v)]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *[torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.kv])


def _merge(out_a, lse_a, out_b, lse_b):
    """Combine two normalized partial attentions via logsumexp weights."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)
    wb = torch.exp(lse_b - m)
    denom = wa + wb
    out = out_a * (wa / denom)[..., None] + out_b * (wb / denom)[..., None]
    return out, m + torch.log(denom)


def ring_flash_attention(q, k, v, group=None, *, scale=None, causal=True,
                         window=None):
    """Sequence-parallel attention over the processes of ``group`` (None:
    the default group; an uninitialized ``torch.distributed`` is a ring of
    one).

    q: local ``[B, H, T_local, D]``; k, v: local ``[B, Hkv, T_local, D]``,
    this process's shard of the global sequence (shard i holds positions
    ``[i·T_local, (i + 1)·T_local)``). Returns the local shard of
    softmax(q kᵀ·scale + mask) v as if computed over the whole sequence,
    in q's dtype. ``window`` None is unbounded in global positions."""
    n, idx = _size_rank(group)
    B, H, Tl, D = q.shape
    out = torch.zeros((B, H, Tl, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, Tl), NEG_INF, dtype=torch.float32, device=q.device)
    for s in range(n):
        src = (idx - s) % n  # the process the current kv shard came from
        hidden = _hidden(idx, src, Tl, causal, window)
        if not hidden:
            out_s, lse_s = flash_attention_lse(q, k, v, window, q_start=idx * Tl,
                                               k_start=src * Tl, scale=scale,
                                               causal=causal)
            out, lse = _merge(out, lse, out_s.float(), lse_s)
        if s < n - 1:  # the last shift would only bring back the own shard
            k, v = _RingShift.apply(group, k, v)
    if n > 1 and hidden:
        out = _Join.apply(out, k, v)
    return out.to(q.dtype)


def attribute_sequence_parallel(forward_fn, params, cfg, inputs_embeds,
                                composite, *, group=None, position=-1,
                                token=None, param_shardings=None):
    """Long-context attribution with the sequence split over the processes
    of ``group``; every process calls it with the same arguments.

    Each process takes its shard of the global ``inputs_embeds`` [B, T, D]
    and runs ``forward_fn(params, cfg, shard, composite, positions=...,
    attn_impl="ring")`` with its global positions: every positionwise op
    runs on the shard and attention runs as a ring. The explained target is
    the argmax logit at ``position`` of the last shard (-1: the last global
    position), or the logit of ``token`` there (as :func:`select_logit`;
    near-tied bf16 logits can make the argmax differ between runs that
    sum in other orders). One backward pass on every process (the shifts communicate)
    gives the relevance: the last process seeds it with its target, the
    others with zero times theirs, which keeps their graphs connected and
    adds nothing. Returns ``(value, relevance [B, T] float32)``, both on
    every process.

    ``param_shardings`` (sequence × tensor parallelism): a
    :class:`~lxt_tpu_torch.parallel.mesh.NamedSharding` tree over the
    ``model`` dimension of a mesh whose other dimension is the ring's
    ``group`` (e.g. ``family_param_shardings(family, params, mesh)`` on a
    ``("sp", "model")`` mesh, ``group=mesh.get_group("sp")``): each process
    keeps its slices of ``params`` (the whole model's) and the ring's
    layers run tensor-parallel over ``model``, each ring step on the local
    heads. The conservation and NaN checks are refused (they run on one
    process)."""
    check.refuse_parallel("sequence parallelism")
    tp_group = None
    if param_shardings is not None:
        from lxt_tpu_torch.parallel.mesh import model_group, shard_params
        params, param_shardings = shard_params(params, param_shardings)
        tp_group = model_group(param_shardings)
    n, idx = _size_rank(group)
    B, T, _ = inputs_embeds.shape
    if T % n:
        raise ValueError(f"sequence {T} must divide over {n} processes")
    Tl = T // n
    x = inputs_embeds[:, idx * Tl:(idx + 1) * Tl].detach().requires_grad_(True)
    positions = idx * Tl + torch.arange(Tl, dtype=torch.int32, device=x.device)
    with _using(group), tensor_parallel.using(tp_group), torch.enable_grad():
        logits = forward_fn(params, cfg, x, composite, positions=positions,
                            attn_impl="ring").logits
        local = select_logit(logits, position=position, token=token)
        (grad,) = torch.autograd.grad(local if idx == n - 1 else local * 0.0, x)
    rel = (x.detach().float() * grad.float()).sum(-1)
    if n == 1:
        return local.detach(), rel
    g = dist.group.WORLD if group is None else group
    return (tensor_parallel.broadcast(local, n - 1, g),
            tensor_parallel.all_gather(rel, g, dim=1))
