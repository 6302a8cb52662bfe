#!/usr/bin/env python3
"""Where the device time of one attribution goes, on one NVIDIA GPU, for the
three paths chip_smoke.py drives: the main path (bf16 Llama at TinyLlama-1.1B
widths, 22 layers, batch 8 x 1024, remat off), the NF4 path (Llama-3-8B
widths and depth, batch 1 x 4096, remat) and Gemma-3-4B's text model (bf16,
full width and depth, batch 1 x 4096, remat off). Random weights from a seed.

    python3 scripts/profile_torch_paths.py [--paths main,nf4_8b,gemma]

For each path: the wall time of three unprofiled attributions after a
warm-up, then one attribution under torch.profiler: the device kernel time
by class (each flash kernel and the rotation pass by name, K3, cuBLAS GEMMs,
copies and casts, reductions, softmax, other elementwise) with launch
counts, and the device's idle share over the profiled window (1 − the union
of kernel intervals over the span from the first kernel's start to the last
one's end). Needs a CUDA device; prints the card's nvidia-smi name and
power limit first.
"""

import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CLASSES = (  # first match wins
    ("K1 flash_fwd", r"flash_fwd"),
    ("K2 flash_bwd_dkv", r"flash_bwd_dkv"),
    ("K2 flash_bwd_dq", r"flash_bwd_dq"),
    ("rotation pass", r"rope_rotate"),
    ("K3 nf4_dequant", r"nf4_dequant"),
    ("cuBLAS GEMMs", r"gemm|xmma|nvjet|cutlass|cublas"),
    ("copies and casts", r"[Cc]opy|cast"),
    ("reductions", r"[Rr]educe"),
    ("softmax", r"[Ss]oftmax"),
    ("other elementwise", r"."),
)


def busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, -1e300
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile(run, label, card):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3 * 1e3
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    if not spans:
        raise SystemExit(f"{label}: the profiler saw no device kernels")
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = busy_us(spans)
    by = {name: [0.0, 0] for name, _ in CLASSES}
    for e in kernels:
        for name, pat in CLASSES:
            if re.search(pat, e.name):
                by[name][0] += (e.time_range.end - e.time_range.start) / 1e3
                by[name][1] += 1
                break
    print(f"{label}: wall {wall:.1f} ms per attribution unprofiled; profiled "
          f"window {window / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, idle "
          f"{1 - busy / window:.1%} [{card}]", flush=True)
    for name, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0]):
        if n:
            print(f"  {name:20s} {ms:9.2f} ms  {n:5d} launches", flush=True)


def main():
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("profile_torch_paths: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    paths = "main,nf4_8b,gemma"
    if "--paths" in sys.argv:
        paths = sys.argv[sys.argv.index("--paths") + 1]
    card = cs.card_line()
    print(card, flush=True)
    from lxt_tpu_torch.models import gemma3, llama
    from lxt_tpu_torch.ops import _build
    _build.library()
    if "main" in paths:
        cfg = llama.LlamaConfig(**cs.MODEL, dtype="bfloat16")
        gen = torch.Generator("cuda").manual_seed(0)
        params = llama.init_params(cfg, gen)
        ids = torch.randint(0, cfg.vocab_size, (cs.SERVE_BATCH, cs.SEQ),
                            generator=gen, device="cuda")
        profile(lambda: cs.attribute(params, cfg, ids, "auto", False),
                f"main path bf16 L{cfg.num_layers} B{cs.SERVE_BATCH}x{cs.SEQ} "
                f"remat off", card)
        del params
        torch.cuda.empty_cache()
    if "nf4_8b" in paths:
        cfg = llama.LlamaConfig(**cs.LLAMA3_8B, dtype="bfloat16")
        params = llama.init_params(cfg, torch.Generator("cuda").manual_seed(8),
                                   quantize_bits="nf4")
        ids = torch.randint(0, cfg.vocab_size, (1, cs.SEQ_8B),
                            generator=torch.Generator("cuda").manual_seed(9),
                            device="cuda")
        profile(lambda: cs.attribute(params, cfg, ids, "auto", True),
                f"NF4 Llama-3-8B width L{cfg.num_layers} B1x{cs.SEQ_8B} remat",
                card)
        del params
        torch.cuda.empty_cache()
    if "gemma" in paths:
        cfg = gemma3.Gemma3Config(**cs.GEMMA3_4B)
        gen = torch.Generator("cuda").manual_seed(12)
        params = gemma3.init_params(cfg, gen, dtype=torch.bfloat16)
        ids = torch.randint(0, cfg.vocab_size, (1, cs.SEQ_GEMMA), generator=gen,
                            device="cuda")
        profile(lambda: cs.attribute(params, cfg, ids, "auto", False, "gemma3_text"),
                f"Gemma-3-4B L{cfg.num_layers} B1x{cs.SEQ_GEMMA} bf16 remat off",
                card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
