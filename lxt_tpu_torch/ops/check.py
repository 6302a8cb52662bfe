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

Multi-process attribution (``parallel/``) refuses both checks
(:func:`refuse_parallel`): run them on one process.

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
from typing import Optional

import torch

from lxt_tpu_torch.ops import tensor_parallel

CONSERVATION_CHECK_FLAG = [False]
NAN_CHECK_FLAG = [False]
#: the NaN check's record: (site, device float32 sum) pairs, owned by the
#: outermost NaN context that is open (None when none is)
_RECORD = [None]
#: device-to-host reads made to discharge the NaN check
counters = {"host_reads": 0}
_NOW = object()  # maybe_redistribute's default: the mode in force now


@dataclasses.dataclass(frozen=True)
class Mode:
    """The check mode a rule's forward keeps for its backward."""

    conservation: bool
    #: the NaN check's record to append to, or None (no NaN check)
    record: Optional[list]


def mode() -> Optional[Mode]:
    """The check mode in force, or None when no check is on (then a rule's
    backward does nothing more than its own arithmetic). Raises
    ``ValueError`` under tensor parallelism (see :func:`refuse_parallel`)."""
    if not (CONSERVATION_CHECK_FLAG[0] or NAN_CHECK_FLAG[0]):
        return None
    if tensor_parallel.group() is not None:
        refuse_parallel("tensor parallelism")
    return Mode(CONSERVATION_CHECK_FLAG[0],
                _RECORD[0] if NAN_CHECK_FLAG[0] else None)


def refuse_parallel(what):
    """Raise ``ValueError`` when a check mode is on: the checks run on one
    process. Split over processes (``what``), a rule site would spread its
    uniform fill over its own shard of the input only (a row-parallel
    product's shards would pass on the group's size times the relevance
    they received), and each process would test its own shard for NaNs, so
    some would raise and the others run on out of step. Every process
    refuses alike, before any collective."""
    if CONSERVATION_CHECK_FLAG[0] or NAN_CHECK_FLAG[0]:
        raise ValueError(f"the conservation and NaN checks run on one "
                         f"process; {what} splits the relevance over "
                         f"processes (run the check without the mesh)")


def _discharge():
    """Read the current record to the host in one copy, clear it, and raise
    on its first non-finite site."""
    record = _RECORD[0]
    if not record:
        return
    names = [where for where, _ in record]
    sums = torch.stack([total.to(record[0][1].device) for _, total in record])
    record.clear()
    flags = torch.isfinite(sums).cpu()
    counters["host_reads"] += 1
    if not bool(flags.all()):
        i = int((~flags).nonzero()[0, 0])
        raise RuntimeError(f"NaN/Inf relevance at rule backward: {names[i]} "
                           f"(site {i + 1} of {len(names)} in backward order)")


@contextlib.contextmanager
def nan_check():
    """Record, at every rule backward, whether its outgoing relevance is
    finite. The record is read (one host copy) by :func:`checked`, or when
    the outermost NaN context exits without an exception; a non-finite
    site raises ``RuntimeError``."""
    prev = NAN_CHECK_FLAG[0], _RECORD[0]
    NAN_CHECK_FLAG[0] = True
    if _RECORD[0] is None:
        _RECORD[0] = []
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


def maybe_redistribute(in_relevances, out_relevances, where="rule",
                       check=_NOW):
    """The check hook of a rule backward.

    ``in_relevances``: one entry per input: the relevance (a tensor), None
    (the input takes no share), or a ``torch.Size``: an input that takes
    its share of the uniform mean but carries no relevance (a constant,
    such as a mask; it comes back as None). ``out_relevances``: the
    incoming relevances (tensors or None). ``check``: the :class:`Mode` the
    rule's forward kept (default: the mode in force now).

    Under the NaN check each tensor entry records its float32 sum;
    under the conservation check each tensor entry becomes the uniform mean
    of the total outgoing relevance over all counted elements, a fill from
    a device scalar. Returns a tuple matching ``in_relevances``."""
    if check is _NOW:
        check = mode()
    if check is not None and check.record is not None:
        check.record.extend((where, r.sum(dtype=torch.float32))
                            for r in in_relevances
                            if isinstance(r, torch.Tensor))
    if check is None or not check.conservation:
        return tuple(None if isinstance(r, torch.Size) else r
                     for r in in_relevances)
    out_sum = sum(r.float().sum() for r in out_relevances if r is not None)
    n = sum(r.numel() for r in in_relevances if r is not None)
    mean = out_sum / n
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
