"""The mixture's share of the device's idle time, in percent, in the host
pass of the profiled calls (host spans and device operations from one
profile, on one clock): each idle gap between two device operations of one
call (inside the benchmark's span ``bench_port.call``) is put down to the
innermost of the program's ``lxt.*`` spans open on the host when the gap
began (none: the rest); the share is that of the gaps under ``lxt.moe`` or
``lxt.moe.read``. Gaps between calls are not counted."""

LAYER = "MoE"
SOURCE = "program_span"
MOE = ("lxt.moe", "lxt.moe.read")


def idle_by_span(trace):
    """``{innermost lxt.* span or None: idle us}`` over the host pass's
    calls."""
    spans = [h for h in trace.host if h[0].startswith("lxt.")]
    idle = {}
    for a, b in trace.calls:
        end = None
        for _, s, e in trace.traced_ops:
            if not a <= s < b:
                continue
            if end is not None and s > end:
                inside = [h for h in spans if h[1] <= end < h[2]]
                label = (min(inside, key=lambda h: h[2] - h[1])[0] if inside
                         else None)
                idle[label] = idle.get(label, 0.0) + s - end
            end = e if end is None else max(end, e)
    return idle


def read(run):
    tr = run.trace
    if tr is None or not any(h[0].startswith("lxt.") for h in tr.host):
        return None
    idle = idle_by_span(tr)
    total = sum(idle.values())
    return 100.0 * sum(idle.get(m, 0.0) for m in MOE) / total if total else None
