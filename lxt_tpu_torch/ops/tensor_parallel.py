"""Tensor-parallel primitives over the ``model`` process group (Megatron's
two autograd Functions, and the vocabulary-split embedding and head).

GSPMD writes these collectives for ``lxt_tpu``; here every process of the
group runs the same model code on its own weight shards, and the model
calls these at the block boundaries:

- :func:`copy` (identity forward, all-reduce backward) sits before a
  block's column-parallel products: the relevance reaching a replicated
  input is the sum of what each shard's products send back to it;
- :func:`reduce` (all-reduce forward, identity backward) sits after a
  row-parallel product, whose shards each hold a partial sum (the bias is
  added once, after it: ``Composite.linear(..., row_parallel=True)``);
- :func:`embedding` looks tokens up in a vocabulary-split table (a masked
  local lookup, then an all-reduce) and :func:`gather_last` gathers
  vocabulary-split logits (backward: each process keeps its own columns of
  the gradient, which every process computes alike from the gathered
  logits).

The active group is module state, as the ring's is
(``parallel/ring.py``): a checkpointed layer's recompute runs on
autograd's device thread and must see it too, and under remat every
process replays the same collectives in the same order. With no group
active (the single-process paths) every function here returns its input
unchanged and adds nothing to the graph. A gloo group has no CUDA
collectives, so it stages CUDA tensors through host copies
(communication only).
"""

import contextlib

import torch
import torch.distributed as dist

#: the ``model`` group of the running tensor-parallel call, or None
_active = [None]
#: whether the forward is between a :func:`copy` and the :func:`reduce`
#: (or gather) that ends its block: there the activations are shards
_sharded = [False]


def group():
    """The active tensor-parallel group (None: no tensor parallelism)."""
    return _active[0]


def size(g=None):
    g = _active[0] if g is None else g
    return 1 if g is None else dist.get_world_size(g)


def rank(g=None):
    g = _active[0] if g is None else g
    return 0 if g is None else dist.get_rank(g)


def sharded():
    """Whether the forward runs between a :func:`copy` and the reduce that
    ends its block, where each process holds a shard of the activations
    (the check mode keeps it for each rule site: ``ops/check.py``)."""
    return _sharded[0]


def end_shards():
    """Mark the activations replicated again: a row-parallel product that
    sums its partial outputs itself (``ops/rules._LinearRule``) ends the
    block as :func:`reduce` does."""
    _sharded[0] = False


@contextlib.contextmanager
def using(g):
    """Run the block with ``g`` as the tensor-parallel group; a group of
    one process is no tensor parallelism."""
    if g is not None and dist.get_world_size(g) == 1:
        g = None
    prev, _active[0] = (_active[0], _sharded[0]), g
    _sharded[0] = False
    try:
        yield
    finally:
        _active[0], _sharded[0] = prev


def staged(g, t):
    """Whether ``t`` travels through a host copy: a gloo group has no CUDA
    collectives or point-to-point."""
    return t.is_cuda and dist.get_backend(g) == dist.Backend.GLOO


def all_reduce(t, g, op=dist.ReduceOp.SUM):
    """The sum (or ``op``) of ``t`` over ``g``, as a new tensor (``t`` is
    untouched)."""
    stage = staged(g, t)
    buf = t.detach().cpu() if stage else t.detach().clone()
    dist.all_reduce(buf, op=op, group=g)
    return buf.to(t.device) if stage else buf


def all_gather(t, g, dim):
    """The tensors of every process of ``g`` concatenated on ``dim``."""
    stage = staged(g, t)
    src = (t.detach().cpu() if stage else t.detach()).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, src, group=g)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if stage else out


def broadcast(t, src, g):
    """``t`` of group rank ``src`` on every process of ``g`` (a new tensor
    on ``t``'s device; ``t`` gives the shape and dtype elsewhere)."""
    stage = staged(g, t)
    buf = t.detach().cpu().clone() if stage else t.detach().clone()
    dist.broadcast(buf, dist.get_global_rank(g, src), group=g)
    return buf.to(t.device) if stage else buf


def send(t, dst, g):
    """Send ``t`` to group rank ``dst`` (blocking)."""
    buf = t.detach().cpu() if staged(g, t) else t.detach()
    dist.send(buf.contiguous(), dist.get_global_rank(g, dst), group=g)


def recv(like, src, g):
    """Receive a tensor shaped and typed as ``like`` from group rank
    ``src`` (blocking), on ``like``'s device."""
    stage = staged(g, like)
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if stage else like.device)
    dist.recv(buf, dist.get_global_rank(g, src), group=g)
    return buf.to(like.device) if stage else buf


def local_heads(n):
    """This process's share of ``n`` attention heads (a head is never
    split: each process runs whole heads, and a GQA group stays whole when
    the kv heads divide too)."""
    tp = size()
    if n % tp:
        raise ValueError(f"{n} heads do not divide over {tp} tensor-parallel "
                         f"processes")
    return n // tp


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return None, all_reduce(grad, ctx.g)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x):
        return all_reduce(x, g)

    @staticmethod
    def backward(ctx, grad):
        return None, grad


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x):
        ctx.n, ctx.r = x.shape[-1], dist.get_rank(g)
        return all_gather(x, g, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return None, grad.narrow(-1, ctx.r * ctx.n, ctx.n)


def copy(x):
    """Identity forward; the backward sums the gradient over the group."""
    g = _active[0]
    if g is None:
        return x
    _sharded[0] = True
    return _Copy.apply(g, x)


def reduce(x):
    """The forward sums ``x`` over the group; identity backward."""
    g = _active[0]
    if g is None:
        return x
    _sharded[0] = False
    return _Reduce.apply(g, x)


def gather_last(x):
    """Vocabulary-split logits ``[..., V/tp]`` -> ``[..., V]`` on every
    process."""
    g = _active[0]
    if g is None:
        return x
    _sharded[0] = False
    return _GatherLast.apply(g, x)


def embedding(table, ids):
    """``table[ids]``; under tensor parallelism ``table`` holds this
    process's contiguous rows of the vocabulary (``Shard(0)``)."""
    g = _active[0]
    if g is None:
        return table[ids]
    n = table.shape[0]
    local = ids - rank(g) * n
    inside = (local >= 0) & (local < n)
    rows = table[torch.where(inside, local, torch.zeros_like(local))]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    _sharded[0] = False
    return _Reduce.apply(g, rows)
