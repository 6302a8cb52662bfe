#!/usr/bin/env python3
"""What one span of ``lxt_tpu_torch.tracing`` costs on this host, and where
its events land in a ``torch.profiler`` trace.

    python3 scripts/tracing_cost.py [--n 200000]

Prints the nanoseconds of one empty span's enter and exit with no profiler
and while a profiler records (the CPU, and the device where there is one),
beside a bare ``record_function``'s. Then, for one profile of the host and
the device and one of the device alone, the events named ``lxt.*`` around a
small matrix product: their count, device type, and whether torch marks
them as user annotations (which readers of device operations leave out).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def per_span_ns(n, make):
    t = time.perf_counter_ns()
    for _ in range(n):
        with make():
            pass
    return (time.perf_counter_ns() - t) / n


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--n", type=int, default=200000)
    args = parser.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from lxt_tpu_torch import tracing

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    span = lambda: tracing.span("lxt.layer")  # noqa: E731
    bare = lambda: record_function("lxt.layer")  # noqa: E731
    per_span_ns(args.n // 10, span)                    # warm-up
    print(f"span, no profiler: {per_span_ns(args.n, span):.0f} ns "
          f"(median of 5: {sorted(per_span_ns(args.n, span) for _ in range(5))[2]:.0f} ns)")
    print(f"record_function, no profiler: {per_span_ns(args.n // 10, bare):.0f} ns")
    with profile(activities=acts):
        print(f"span, profiler recording {[a.name for a in acts]}: "
              f"{per_span_ns(args.n // 10, span):.0f} ns")
    if not cuda:
        return
    x = torch.randn(256, 256, device="cuda")
    for label, activities in (("CPU and CUDA", acts), ("CUDA alone", [ProfilerActivity.CUDA])):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            with tracing.span("lxt.moe"):
                with tracing.span("lxt.moe.read"):
                    (x @ x).sum().item()
            torch.cuda.synchronize()
        found = [(e.name, str(e.device_type).split(".")[-1],
                  getattr(e, "is_user_annotation", None))
                 for e in prof.events() if e.name.startswith("lxt.")]
        kernels = sum(1 for e in prof.events()
                      if str(e.device_type).endswith("CUDA")
                      and not getattr(e, "is_user_annotation", False))
        print(f"profile of {label}: lxt events {found}; device operations {kernels}")


if __name__ == "__main__":
    main()
