"""Latent attention's K1/K2 launches' share of their roofline, in percent:
over every K1 ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` launch
of the profiled calls, the sum of each launch's bound time over the sum of
their measured times. The bound is what MLA needs (``harness/mla_work.py``:
H heads, q/k head dim Dqk, v head dim Dv, MHA, causal, each prompt at its
own length, each launch priced at its own call's prompts): the larger of
its FLOPs over the bf16 peak and its bytes over HBM's. The kernels run
both widths padded to a native one, so the padding reads as lost share.
Against the published peaks at 700 W."""

import re

from bench_port.harness import mla_work, peaks

LAYER = "kernels"
SOURCE = "device_trace"
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or not hasattr(run.family, "mla_shape"):
        return None
    H, Dqk, Dv = run.family.mla_shape(run.config["config"])
    bound, spent = 0.0, 0.0
    for i, lengths in enumerate(tr.call_lengths):
        ops = tr.in_call(i)
        for name in KERNELS:
            launches = [o for o in ops if re.search(name, o[0])]
            if not launches:
                continue
            per = 0.0
            for n in lengths:
                flops, moved = mla_work.work(name, H, n, Dqk, Dv)
                per += max(flops / peaks.BF16_FLOPS, moved / peaks.HBM_BYTES_PER_S)
            bound += per * len(launches)
            spent += sum(e - s for _, s, e in launches) / 1e6
    return 100.0 * bound / spent if spent else None
