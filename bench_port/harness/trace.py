"""Reading ``torch.profiler``'s trace of the profiled calls.

The kernel classes and :func:`busy_us` are frozen copies of
``scripts/profile_torch_paths.py``'s, and :meth:`Trace.expert_gemms` of
its arithmetic over the operators' recorded shapes, so that the
yardstick stays what it is when the program changes. :class:`Trace` holds
what the metric readers need as plain data: every device operation, the
benchmark's span of each profiled call, the host operators that a gap may
fall in, and the matrix products with the kernels they launched.
"""

import re

GEMM = r"gemm|xmma|nvjet|cutlass|cublas"
CLASSES = (  # first match wins
    ("K1 flash_fwd", r"flash_fwd"),
    ("K2 flash_bwd_dkv", r"flash_bwd_dkv"),
    ("K2 flash_bwd_dq", r"flash_bwd_dq"),
    ("rotation pass", r"rope_rotate"),
    ("K3 nf4_dequant", r"nf4_dequant"),
    ("cuBLAS GEMMs", GEMM),
    ("gathers, scatters and sorts", r"[Ii]ndex|[Gg]ather|[Ss]catter|[Ss]ort|[Hh]istogram"),
    ("copies and casts", r"[Cc]opy|cast"),
    ("reductions", r"[Rr]educe"),
    ("softmax", r"[Ss]oftmax"),
    ("other elementwise", r"."),
)
#: the classes of elementwise work (the rules' float32 round trips among them)
ELEMENTWISE = ("copies and casts", "reductions", "softmax", "other elementwise")
#: the benchmark's span around each profiled call
CALL_SPAN = "bench_port.call"
_PRODUCTS = ("aten::mm", "aten::addmm", "aten::bmm")


def classify(name):
    for cls, pat in CLASSES:
        if re.search(pat, name):
            return cls
    return CLASSES[-1][0]


def busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, -1e300
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def device_ops(prof):
    """The device operations ``(name, start, end)`` of a profile, in order
    of start; the benchmark's span leaves a mark on the device's timeline
    that is no operation."""
    from torch.autograd import DeviceType
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name != CALL_SPAN
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda o: o[1])


class Trace:
    """The profiled calls as plain data (times in microseconds), from two
    passes over the same calls.

    The device pass traces the device alone, one profile a call, so that
    the host runs as in the window: ``call_ops[i]`` holds call i's device
    operations ``(name, start, end)``, and the window is the sum of each
    call's span from its first operation's start to its last one's end.
    The host pass traces host operators too, with their shapes, inside the
    benchmark's span around each call (tracing every host operator slows
    the host several times over where the path launches many small
    kernels, so no idle time is read from it): ``calls`` holds each span
    ``(start, end)`` and ``traced_ops`` the device operations it saw,
    ``host`` the host operators ``(name, start, end)``, ``products`` the
    matrix products ``(input shapes, [(kernel name, us)])``.
    ``call_lengths``: the prompt lengths of each call."""

    def __init__(self, call_ops, prof, call_lengths):
        from torch.autograd import DeviceType
        self.call_ops = call_ops
        self.ops = [o for ops in call_ops for o in ops]
        self.calls, self.host, self.products = [], [], []
        for e in prof.events():
            if e.device_type != DeviceType.CPU:
                continue
            start, end = e.time_range.start, e.time_range.end
            if e.name == CALL_SPAN:
                self.calls.append((start, end))
            else:
                self.host.append((e.name, start, end))
            if e.name in _PRODUCTS:
                self.products.append((
                    [tuple(s) for s in (e.input_shapes or []) if s],
                    [(k.name, k.duration) for k in e.kernels]))
        self.traced_ops = device_ops(prof)
        self.calls.sort()
        self.call_lengths = call_lengths
        self.heatmaps = sum(len(c) for c in call_lengths)

    def window(self):
        """Microseconds of the calls' device windows, summed."""
        return sum(max(o[2] for o in ops) - ops[0][1] for ops in self.call_ops if ops)

    def busy(self):
        return sum(busy_us([(s, e) for _, s, e in ops]) for ops in self.call_ops)

    def in_call(self, i):
        """The device operations of call ``i`` (the device pass)."""
        return self.call_ops[i]

    def host_ms(self, i):
        """Host time of call ``i`` outside its device work, in the host
        pass: its span minus its first-to-last device interval."""
        a, b = self.calls[i]
        ops = [o for o in self.traced_ops if o[1] >= a and o[2] <= b]
        if not ops:
            return None
        return ((b - a) - (max(o[2] for o in ops) - ops[0][1])) / 1e3

    def by_class(self):
        """``{class: (us, launches)}`` over every device operation."""
        out = {}
        for name, s, e in self.ops:
            cls = classify(name)
            us, n = out.get(cls, (0.0, 0))
            out[cls] = (us + e - s, n + 1)
        return out

    def expert_gemms(self, width):
        """(us, launches) of the GEMM kernels launched by matrix products
        with an operand dimension ``width``."""
        us, n = 0.0, 0
        for shapes, kernels in self.products:
            if any(width in s for s in shapes):
                for name, dur in kernels:
                    if re.search(GEMM, name):
                        us += dur
                        n += 1
        return us, n

    def idle_gaps(self, top=10):
        """The ``top`` longest device idle gaps inside the host pass's
        calls, ``[(label, us)]``, each labelled with the innermost host
        operator (or the benchmark's span) running when the gap began."""
        gaps, end = [], None
        for _, s, e in self.traced_ops:
            if end is not None and s > end:
                gaps.append((end, s - end))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: -g[1])
        spans = self.host + [(CALL_SPAN, a, b) for a, b in self.calls]
        out = []
        for t, dur in gaps[:top]:
            inside = [h for h in spans if h[1] <= t < h[2]]
            label = (min(inside, key=lambda h: h[2] - h[1])[0] if inside
                     else "between calls")
            out.append((label, dur))
        return out
