"""The flash kernels' share of their roofline, in percent: over every K1
``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` launch of the profiled
calls, the sum of each launch's bound time (the larger of its FLOPs over the
bf16 peak and its bytes over HBM's, by the frozen ``work`` summed over the
call's prompts at their own lengths: what these inputs need) over the sum
of the launches' measured times. Against the published peaks at 700 W."""

import re

from bench_port.harness import flash_work, peaks

LAYER = "kernels"
SOURCE = "device_trace"
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    H, Hkv, D = run.family.attention_shape(run.config)
    window = run.config["config"].get("sliding_window")
    bound, spent = 0.0, 0.0
    for i, lengths in enumerate(tr.call_lengths):
        ops = tr.in_call(i)
        for name in KERNELS:
            launches = [o for o in ops if re.search(name, o[0])]
            if not launches:
                continue
            per = 0.0
            for n in lengths:
                flops, moved = flash_work.work(name, 1, H, Hkv, n, D, window=window)
                per += max(flops / peaks.BF16_FLOPS, moved / peaks.HBM_BYTES_PER_S)
            bound += per * len(launches)
            spent += sum(e - s for _, s, e in launches) / 1e6
    return 100.0 * bound / spent if spent else None
