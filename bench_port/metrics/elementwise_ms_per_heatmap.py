"""Device ms of copies and casts, reductions, softmax and other elementwise
kernels (the frozen classifier's classes) in the profiled calls, per
heatmap: where the rules' float32 round trips go."""

from bench_port.harness.trace import ELEMENTWISE

LAYER = "model step"
SOURCE = "device_trace"


def read(run):
    tr = run.trace
    if tr is None or not tr.heatmaps:
        return None
    by = tr.by_class()
    us = sum(by[c][0] for c in ELEMENTWISE if c in by)
    return us / 1e3 / tr.heatmaps if us else None
