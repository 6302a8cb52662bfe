"""Spans: where the port's host time goes, as totals that are always on and
as events on ``torch.profiler``'s timeline while a profiler records.

``with span(name):`` bounds one region of the program. Its totals in
``spans`` (``<name>.n`` spans opened, ``<name>.ns`` their nanoseconds and
``<name>.self_ns`` those nanoseconds less their child spans') are kept on
every call, at the cost of a few clock reads. While a ``torch.profiler``
records, the span also opens ``record_function(name)`` with the number of
the pipeline call as its argument, so the profiler's trace shows it on the
device operations' clock. Spans nest per thread: remat's recompute runs on
autograd's device thread, and its spans are children of nothing there.

``NAMES`` is closed; another name raises. Every key of ``spans`` exists,
at zero, from import, so a before/after difference never meets a new key.
The totals are plain adds, like the port's counters: one call runs at a
time (the server's one worker; the caller waits while autograd's thread
recomputes), and calls made at once from two threads may lose an add.
"""

import threading
import time

import torch
from torch.autograd import profiler as _profiler

#: the spans of the program: what each bounds is written at its site
NAMES = (
    "lxt.pipeline.encode",      # tokenising, padding, ids / kv_begin (pipeline)
    "lxt.pipeline.finish",      # token strings, normalisation, Heatmaps (pipeline)
    "lxt.layer",                # one layer's forward (models/common.run_layers)
    "lxt.layer.recompute",      # one layer's recompute in the backward (remat)
    "lxt.moe",                  # the mixture block (models/mixtral.moe_block)
    "lxt.moe.read",             # its one synchronising read of the group sizes
    "lxt.mla",                  # latent attention, projections to output (models/deepseek_v3)
)
#: per name: spans opened, their nanoseconds, and those less their child
#: spans'; :func:`reset` zeroes them
spans = {f"{name}.{k}": 0 for name in NAMES for k in ("n", "ns", "self_ns")}
_CALL = "lxt.pipeline.encode.n"
_clock = time.perf_counter_ns


class _Frames(threading.local):
    def __init__(self):
        self.stack = []     # [profiler event or None, children's ns, start]


_frames = _Frames()


def reset():
    for key in spans:
        spans[key] = 0


class _Span:
    __slots__ = ("name", "n", "ns", "self_ns")

    def __init__(self, name):
        self.name = name
        self.n, self.ns, self.self_ns = (f"{name}.{k}" for k in ("n", "ns", "self_ns"))

    def __enter__(self):
        spans[self.n] += 1
        event = None
        if _profiler._is_profiler_enabled:
            event = torch.profiler.record_function(self.name, str(spans[_CALL]))
            event.__enter__()
        _frames.stack.append([event, 0, _clock()])

    def __exit__(self, *exc):
        end = _clock()
        stack = _frames.stack
        event, children, start = stack.pop()
        if event is not None:
            event.__exit__(*exc)
        ns = end - start
        spans[self.ns] += ns
        spans[self.self_ns] += ns - children
        if stack:
            stack[-1][1] += ns
        return False


_SPANS = {name: _Span(name) for name in NAMES}


def span(name):
    """The context manager of span ``name`` (one of ``NAMES``)."""
    try:
        return _SPANS[name]
    except KeyError:
        raise KeyError(f"no span {name!r}; the spans are {NAMES}") from None
