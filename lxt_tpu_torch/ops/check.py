"""Conservation and NaN checks for the LRP rules (counterpart of
``lxt_tpu/ops/check.py``).

Under :func:`conservation_check` every rule backward discards the relevance
it computed and spreads the *incoming* relevance uniformly over its input
elements. If every op of a model conserves, the total relevance arriving at
the input equals the seeded output relevance; a leak (an op without a rule,
a bias sink, a NaN) shows up in :func:`conservation_error`. Under
:func:`nan_check` (or ``conservation_check(raise_on_nan=True)``) every rule
backward records whether the relevance it returns is finite.

The mode lives in module-level state, as ``lxt_tpu``'s flags do. Each rule
reads it in its ``forward`` (:func:`mode`) and keeps it on its ``ctx``, so
the backward uses the mode that was in force when the forward ran: JAX
reads its flags while tracing, and on CUDA the autograd engine runs the
backward on a thread of its own, where a thread-local flag would read its
default. A layer that ``torch.utils.checkpoint`` recomputes runs its
forward again inside the backward, on that thread, and reads the mode
again: hold the context around the backward too, as the
``AttributionModel`` methods do (``check=``).

The NaN check makes no host sync inside the backward. Each rule site
appends one device scalar, the float32 sum of the relevance it returns (a
NaN or an Inf anywhere makes it non-finite; one reduction a site), to the
record of the outermost open NaN context; :func:`checked` (or the
context's exit) stacks them, tests them for finiteness and copies the
flags to the host in one read, raising ``RuntimeError("NaN/Inf relevance
at rule backward: <site>")`` naming the first non-finite site in backward
order. A site whose finite relevances overflow float32 when summed reads
as non-finite too. ``counters["host_reads"]`` counts those reads. With no check on, a
rule's backward adds no device work.

Under data and tensor parallelism (``parallel/mesh.attribute_sharded``,
a forward under ``mesh.model_parallel``) both checks give what one process
running the whole batch gives, which is also what ``lxt_tpu``'s GSPMD
program computes: each rule site sums its incoming relevance and counts
its input elements over the whole world (over ``data``, and over ``model``
for a shard; a tensor replicated over ``model`` counts once), and the NaN
check reduces its flags over the world before its one host read, so that
every process raises the same site. The ring and the pipeline driver
refuse both checks (:func:`refuse_parallel`): their sums would be per ring
step or per microbatch.

Scope: the redistribution assumes that the cotangent IS relevance, i.e. the
explicit path (:mod:`lxt_tpu_torch.ops.functional`,
:mod:`lxt_tpu_torch.explicit`). Under the Gradient*Input rules
(``ops/rules.py``, the composites) the cotangent is a gradient and
relevance is ``x * grad``, so :func:`conservation_error` is not meaningful
there.
"""

import contextlib
import dataclasses
import functools
from typing import Any, Optional

import torch
import torch.distributed as dist

from lxt_tpu_torch.ops import tensor_parallel

CONSERVATION_CHECK_FLAG = [False]
NAN_CHECK_FLAG = [False]
#: the NaN check's record: (site, device float32 sum) pairs, owned by the
#: outermost NaN context that is open (None when none is)
_RECORD = [None]
#: the ``data`` group of the running ``attribute_sharded`` call, or None
_DATA = [None]
#: device-to-host reads made to discharge the NaN check
counters = {"host_reads": 0}
_NOW = object()  # maybe_redistribute's default: the mode in force now


@dataclasses.dataclass(frozen=True)
class Mode:
    """The check mode a rule's forward keeps for its backward."""

    conservation: bool
    #: the NaN check's record to append to, or None (no NaN check)
    record: Optional[list]
    #: the tensor-parallel and the data-parallel group in force (None: the
    #: work is not split that way)
    model: Any = None
    data: Any = None
    #: the forward ran between a tensor-parallel copy and its reduce, where
    #: each process holds a shard of the activations
    sharded: bool = False


class _Record(list):
    """The NaN check's record; ``groups``: the (model, data) groups its
    sites ran under, over which the flags are reduced (None: one process)."""

    groups = None


@contextlib.contextmanager
def data_parallel(g):
    """Run the block with ``g`` as the data-parallel group of the checks
    (``mesh.attribute_sharded`` enters it; a group of one is none)."""
    if g is not None and dist.get_world_size(g) == 1:
        g = None
    prev, _DATA[0] = _DATA[0], g
    try:
        yield
    finally:
        _DATA[0] = prev


def mode() -> Optional[Mode]:
    """The check mode in force, or None when no check is on (then a rule's
    backward does nothing more than its own arithmetic)."""
    if not (CONSERVATION_CHECK_FLAG[0] or NAN_CHECK_FLAG[0]):
        return None
    return Mode(CONSERVATION_CHECK_FLAG[0],
                _RECORD[0] if NAN_CHECK_FLAG[0] else None,
                tensor_parallel.group(), _DATA[0], tensor_parallel.sharded())


def refuse_parallel(what):
    """Raise ``ValueError`` when a check mode is on (the ring and the
    pipeline driver): there a rule site's sums would be those of one ring
    step or one microbatch, which one process never forms. Every process
    refuses alike, before any collective."""
    if CONSERVATION_CHECK_FLAG[0] or NAN_CHECK_FLAG[0]:
        raise ValueError(f"the conservation and NaN checks do not run under "
                         f"{what}: its rule sites see one step's or one "
                         f"microbatch's relevance (run the check without it, "
                         f"or under attribute_sharded)")


def _discharge():
    """Read the current record to the host in one copy, clear it, and raise
    on its first non-finite site. Under the mesh the index of each
    process's first non-finite site is reduced (a min) over the world
    first, so every process raises the same site."""
    record = _RECORD[0]
    if not record:
        return
    names = [where for where, _ in record]
    sums = torch.stack([total.to(record[0][1].device) for _, total in record])
    groups, record.groups = record.groups, None
    record.clear()
    flags = torch.isfinite(sums)
    n = len(names)
    first = torch.where(flags, n, torch.arange(n, device=flags.device)).min()
    for g in groups or ():
        if g is not None:
            first = tensor_parallel.all_reduce(first, g, op=dist.ReduceOp.MIN)
    i = int(first)
    counters["host_reads"] += 1
    if i < n:
        raise RuntimeError(f"NaN/Inf relevance at rule backward: {names[i]} "
                           f"(site {i + 1} of {n} in backward order)")


@contextlib.contextmanager
def nan_check():
    """Record, at every rule backward, whether its outgoing relevance is
    finite. The record is read (one host copy) by :func:`checked`, or when
    the outermost NaN context exits without an exception; a non-finite
    site raises ``RuntimeError``."""
    prev = NAN_CHECK_FLAG[0], _RECORD[0]
    NAN_CHECK_FLAG[0] = True
    if _RECORD[0] is None:
        _RECORD[0] = _Record()
    try:
        yield
        if prev[1] is None:
            _discharge()
    finally:
        NAN_CHECK_FLAG[0], _RECORD[0] = prev


@contextlib.contextmanager
def conservation_check(raise_on_nan: bool = False):
    """Uniform-redistribution mode for every rule (the reference's
    ``lxt.explicit.check.conservation_check``). ``raise_on_nan=True`` adds
    the NaN check of :func:`nan_check`."""
    prev = CONSERVATION_CHECK_FLAG[0]
    CONSERVATION_CHECK_FLAG[0] = True
    try:
        with nan_check() if raise_on_nan else contextlib.nullcontext():
            yield
    finally:
        CONSERVATION_CHECK_FLAG[0] = prev


def checked(fn):
    """Wrap ``fn`` so that, after it returns, the NaN check's record is read
    to the host once and a non-finite site raises ``RuntimeError`` (the
    counterpart of ``lxt_tpu``'s checkify discharge). Without a NaN check
    on, the wrapper reads nothing."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        _discharge()
        return out

    return wrapped


def _total(r):
    """The sum of a relevance, in float32 (float64 for a float64 one: a
    reference run)."""
    return r.to(torch.promote_types(r.dtype, torch.float32)).sum()


def _world_fill(in_relevances, out_relevances, check, layout):
    """The conservation fill of one site under the mesh: the incoming sum
    and the input count over the world, as one process running the whole
    batch forms them. Per tensor, over ``model``: a shard ("S") adds each
    process's part; a replicated tensor ("R") counts once (tensor-parallel
    rank 0's); the input of a column-parallel product ("P", after a copy,
    whose backward sums each process's relevance) counts once and each
    process fills its 1/tp share."""
    tp = tensor_parallel.size(check.model)
    first = check.model is None or dist.get_rank(check.model) == 0
    kind_in, kind_out = {"row": ("S", "R"), "column": ("P", "S")}.get(
        layout, ("S", "S") if check.sharded else ("R", "R"))
    dev = next(r.device for r in (*in_relevances, *out_relevances)
               if isinstance(r, torch.Tensor))
    tot = torch.zeros(2, dtype=torch.float64, device=dev)
    if kind_out == "S" or first:
        for r in out_relevances:
            if r is not None:
                tot[0] += _total(r)
    if kind_in == "S" or first:
        tot[1] = sum(r.numel() for r in in_relevances if r is not None)
    for g in (check.model, check.data):
        if g is not None:
            tot = tensor_parallel.all_reduce(tot, g)
    mean = tot[0] / tot[1]
    return mean / tp if kind_in == "P" else mean


def maybe_redistribute(in_relevances, out_relevances, where="rule",
                       check=_NOW, layout=None):
    """The check hook of a rule backward.

    ``in_relevances``: one entry per input: the relevance (a tensor), None
    (the input takes no share), or a ``torch.Size``: an input that takes
    its share of the uniform mean but carries no relevance (a constant,
    such as a mask; it comes back as None). ``out_relevances``: the
    incoming relevances (tensors or None). ``check``: the :class:`Mode` the
    rule's forward kept (default: the mode in force now). ``layout``: the
    site's tensor-parallel split, "row" (a row-parallel product: the input
    a shard, the output replicated), "column" (a column-parallel one: the
    whole input, a shard of the output) or None (every entry a shard
    between a copy and its reduce, replicated elsewhere).

    Under the NaN check each tensor entry records its float32 sum;
    under the conservation check each tensor entry becomes the uniform mean
    of the total outgoing relevance over all counted elements, a fill from
    a device scalar; under the mesh both sums run over the world. Returns a
    tuple matching ``in_relevances``."""
    if check is _NOW:
        check = mode()
    parallel = check is not None and (check.model is not None
                                      or check.data is not None)
    if check is not None and check.record is not None:
        check.record.extend((where, r.sum(dtype=torch.float32))
                            for r in in_relevances
                            if isinstance(r, torch.Tensor))
        if parallel:
            check.record.groups = (check.model, check.data)
    if check is None or not check.conservation:
        return tuple(None if isinstance(r, torch.Size) else r
                     for r in in_relevances)
    if parallel:
        mean = _world_fill(in_relevances, out_relevances, check, layout)
    else:
        out_sum = sum(_total(r) for r in out_relevances if r is not None)
        mean = out_sum / sum(r.numel() for r in in_relevances if r is not None)
    return tuple(torch.empty_like(r).copy_(mean)
                 if isinstance(r, torch.Tensor) else None
                 for r in in_relevances)


def assert_finite_relevance(relevance, where="relevance"):
    """Host-side NaN/Inf check of a relevance map (one host read)."""
    rel = torch.as_tensor(relevance)
    bad = int((~torch.isfinite(rel)).sum())
    if bad:
        raise ValueError(f"NaN/Inf in {where}: {bad}/{rel.numel()} elements")
    return relevance


def conservation_error(input_relevance, seeded_value):
    """Relative conservation error ``|sum(R_in) - seed| / (|seed| + 1e-9)``
    in float32, as a 0-d tensor.

    Run an attribution of the explicit path under :func:`conservation_check`
    and pass its input relevance and the seeded output relevance (the
    explained logit's value); near 0 means every op conserved."""
    total = torch.as_tensor(input_relevance).float().sum()
    seed = torch.as_tensor(seeded_value).float().sum()
    return (total - seed).abs() / (seed.abs() + 1e-9)
