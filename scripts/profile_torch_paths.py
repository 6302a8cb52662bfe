#!/usr/bin/env python3
"""Where the device time of one attribution goes, on one NVIDIA GPU, for
paths chip_smoke.py drives: the main path (bf16 Llama at TinyLlama-1.1B
widths, 22 layers, batch 8 x 1024, remat off), the NF4 path (Llama-3-8B
widths and depth, batch 1 x 4096, remat), Gemma-3-4B's text model (bf16,
full width and depth, batch 1 x 4096, remat off), NF4 Mixtral-8x7B
(full width and depth, bf16 activations, batch 1 x 4096, remat) and GPT-2
XL (bf16, full depth, batch 8 x 1024, remat off, CP-LRP). Random weights
from a seed.

    python3 scripts/profile_torch_paths.py [--paths main,nf4_8b,gemma,mixtral,gpt2]

The default is the first three. For each path: the wall time of three
unprofiled attributions after a warm-up, then one attribution under
torch.profiler: the device kernel time by class (each flash kernel and the
rotation pass by name, K3, cuBLAS GEMMs, gathers, scatters and sorts,
copies and casts, reductions, softmax, other elementwise) with launch
counts, and the device's idle share over the profiled window (1 − the union
of kernel intervals over the span from the first kernel's start to the last
one's end), and the operators whose kernels take the most device time.
For Mixtral also the GEMMs of the expert products apart (the
cuBLAS kernels of matrix products with an operand of the intermediate
width), the host reads of the router's group sizes (device-to-host copies)
and the device idle that follows them. Needs a CUDA device; prints the
card's nvidia-smi name and power limit first.
"""

import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GEMM = r"gemm|xmma|nvjet|cutlass|cublas"
TOP_OPS = 12
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


def busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, -1e300
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def expert_gemms(prof, width):
    """(ms, launches) of the cuBLAS kernels launched by matrix products
    with an operand dimension ``width`` (Mixtral's expert products, the
    only products of the intermediate width)."""
    from torch.autograd import DeviceType
    ms, n = 0.0, 0
    for e in prof.events():
        if (e.device_type == DeviceType.CPU and e.name in ("aten::mm", "aten::addmm")
                and any(width in shape for shape in e.input_shapes if shape)):
            for k in e.kernels:
                if re.search(GEMM, k.name):
                    ms += k.duration / 1e3
                    n += 1
    return ms, n


def host_read_idle(kernels):
    """(count, idle ms) of the device-to-host copies and of the device
    idle from each one's end to the next device activity's start."""
    events = sorted(kernels, key=lambda e: e.time_range.start)
    n, idle = 0, 0.0
    for e, nxt in zip(events, events[1:]):
        if "DtoH" in e.name or "Device -> Pageable" in e.name:
            n += 1
            idle += max(0.0, nxt.time_range.start - e.time_range.end) / 1e3
    return n, idle


def profile(run, label, card, expert_width=None):
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
                                            ProfilerActivity.CUDA],
                                record_shapes=expert_width is not None) as prof:
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
            print(f"  {name:27s} {ms:9.2f} ms  {n:5d} launches", flush=True)
    ops = sorted((a for a in prof.key_averages() if a.device_type == DeviceType.CPU),
                 key=lambda a: -a.self_device_time_total)
    print("  ops by the device time of the kernels they launch: " + ", ".join(
        f"{a.key} {a.self_device_time_total / 1e3:.2f} ms ({a.count})"
        for a in ops[:TOP_OPS] if a.self_device_time_total > 0), flush=True)
    if expert_width is not None:
        ms, n = expert_gemms(prof, expert_width)
        print(f"  of the cuBLAS GEMMs, the expert products: {ms:.2f} ms, {n} "
              f"launches", flush=True)
        n, idle = host_read_idle(kernels)
        print(f"  device-to-host copies {n}, device idle after them {idle:.2f} ms",
              flush=True)


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
    from lxt_tpu_torch.models import gemma3, gpt2, llama, mixtral
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
        del params
        torch.cuda.empty_cache()
    if "mixtral" in paths:
        cfg = mixtral.MixtralConfig(**cs.MIXTRAL_8X7B)
        params = mixtral.init_params(cfg, torch.Generator("cuda").manual_seed(14),
                                     dtype=torch.bfloat16, quantize_bits="nf4")
        ids = torch.randint(0, cfg.vocab_size, (1, cs.SEQ_MIXTRAL),
                            generator=torch.Generator("cuda").manual_seed(15),
                            device="cuda")

        def run():
            mixtral.reset_routing()
            return cs.attribute(params, cfg, ids, "auto", True, "mixtral")

        profile(run, f"NF4 Mixtral-8x7B L{cfg.num_layers} B1x{cs.SEQ_MIXTRAL} "
                f"bf16 remat", card, expert_width=cfg.intermediate_size)
        print(f"  router group sizes read to the host per attribution: "
              f"{mixtral.routing['host_reads']} ({mixtral.routing['nonempty_groups']} "
              f"non-empty expert groups)", flush=True)
        del params
        torch.cuda.empty_cache()
    if "gpt2" in paths:
        import lxt_tpu_torch
        cfg = gpt2.GPT2Config(**cs.GPT2_XL)
        gen = torch.Generator("cuda").manual_seed(16)
        params = gpt2.init_params(cfg, gen, dtype=torch.bfloat16)
        ids = torch.randint(0, cfg.vocab_size, (cs.SERVE_BATCH, cs.SEQ),
                            generator=gen, device="cuda")
        profile(lambda: cs.attribute(params, cfg, ids, "auto", False, "gpt2",
                                     composite=lxt_tpu_torch.cp_lrp),
                f"GPT-2 XL L{cfg.num_layers} B{cs.SERVE_BATCH}x{cs.SEQ} bf16 "
                f"remat off CP-LRP", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
