#!/usr/bin/env python3
"""Smoke run of lxt_tpu_torch on one NVIDIA GPU: builds the flash-attention
kernels, holds each against its plain PyTorch version, and drives the AttnLRP
main path (input relevance of a Llama-family LM with TinyLlama-1.1B widths,
random weights from a seed) through the kernels.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
  2. the kernel build (nvcc, into lxt_tpu_torch/_build/);
  3. K1 flash_fwd and K2 flash_bwd_dq / flash_bwd_dkv against their plain
     versions, bf16 and float32, over the mask regimes; times at the main
     path's shapes;
  4. the main path in float32, 22 layers, batch 1 x 1024: the kernel path
     against the einsum path (normalized L2 of logits and relevance <= 1e-4)
     and the kernel launches per attribution;
  5. the main path served: bf16, batch 8 x 1024, three attributions through
     the kernels (launch counts, finite relevance, heatmaps/s), the einsum
     path's heatmaps/s, the bf16-vs-float32 relevance divergence at batch 1,
     and the peak device memory.
The line before the last is a JSON object with each kernel's launches, error
and times; the last line is {"ok": true, "device": {...}}.
"""

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEQ, SERVE_BATCH, REQUESTS = 1024, 8, 3
PARITY_BAR, DIVERGENCE_BAR = 1e-4, 0.1
# TinyLlama-1.1B geometry, full depth
MODEL = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
             num_layers=22, num_heads=32, num_kv_heads=4, rms_eps=1e-5)
# kernel cases: name -> (B, H, Hkv, T, D, options)
CASES = {
    "causal_hd64": (2, 4, 4, 512, 64, {}),
    "causal_hd128": (2, 4, 4, 512, 128, {}),
    "causal_hd256": (2, 4, 4, 512, 256, {}),
    "gqa_32_4": (1, 32, 4, 512, 64, {}),
    "window": (2, 4, 4, 512, 64, {"window": 100}),
    "window_gqa": (1, 8, 2, 512, 64, {"window": 200}),
    "kv_begin": (2, 4, 4, 512, 64, {"kv_begin": [0, 137]}),
    "kv_end_bidirectional": (2, 4, 4, 512, 64, {"kv_end": [512, 300],
                                                "causal": False}),
    "bidirectional": (2, 4, 4, 512, 64, {"causal": False}),
    "multi_tile_T2048": (1, 4, 4, 2048, 64, {}),
    "rope": (2, 4, 2, 512, 64, {"rope": True}),
}
# the main path's attention call: B 8, H 32 / Hkv 4, T 1024, D 64, rope
MAIN_CASE = (SERVE_BATCH, 32, 4, SEQ, 64, {"rope": True})
KERNELS = {
    "flash_fwd": ("lxt_tpu_torch/csrc/flash_fwd.cu",
                  "lxt_tpu/ops/flash_attention.py:184"),
    "flash_bwd_dq": ("lxt_tpu_torch/csrc/flash_bwd.cu",
                     "lxt_tpu/ops/flash_attention.py:759"),
    "flash_bwd_dkv": ("lxt_tpu_torch/csrc/flash_bwd.cu",
                      "lxt_tpu/ops/flash_attention.py:837"),
}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters`` runs."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nl2(got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def kernel_inputs(case, dtype, seed):
    """Seeded q, k, v, do and the kernels' canonical extra arguments."""
    import torch
    from lxt_tpu_torch.models import common
    B, H, Hkv, T, D, opt = case
    gen = torch.Generator("cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = r(B, H, T, D), r(B, Hkv, T, D), r(B, Hkv, T, D), r(B, H, T, D)
    cos = sin = None
    if opt.get("rope"):
        cos, sin = (t.to("cuda", dtype).contiguous()
                    for t in common.rope_tables(torch.arange(T), D))

    def span(key):
        return (None if key not in opt else
                torch.tensor(opt[key], dtype=torch.int32, device="cuda"))

    window = opt.get("window", T + 2**20)
    extra = (cos, sin, span("kv_begin"), span("kv_end"), window, D ** -0.5,
             opt.get("causal", True))
    return (q, k, v, do), extra


def compare_kernels(case, dtype, seed):
    """Each kernel and its plain version on the same inputs: returns
    {output: (max_abs_err, bound)}; the backward kernels get the plain
    forward's lse and delta, so each is held alone."""
    import torch
    from lxt_tpu_torch.ops import flash_attention as fa
    a, r = (0.01, 0.01171875) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    (q, k, v, do), extra = kernel_inputs(case, dtype, seed)
    out, lse = fa.flash_fwd(q, k, v, *extra)
    ref_out, ref_lse = fa.flash_fwd_ref(q, k, v, *extra)
    delta = (ref_out.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, ref_lse, delta, *extra)
    seen = ref_lse > -1e29
    got = {"out": out, "lse": torch.where(seen, lse, 0.0),
           "dq": fa.flash_bwd_dq(*bwd)}
    got["dk"], got["dv"] = fa.flash_bwd_dkv(*bwd)
    want = {"out": ref_out, "lse": torch.where(seen, ref_lse, 0.0),
            "dq": fa.flash_bwd_dq_ref(*bwd)}
    want["dk"], want["dv"] = fa.flash_bwd_dkv_ref(*bwd)
    torch.cuda.synchronize()
    if not torch.equal(lse <= -1e29, ~seen):
        raise AssertionError("flash_fwd: empty rows differ from the plain version")
    res = {}
    for name in got:
        w = want[name].float()
        err = (got[name].float() - w).abs().max().item()
        res[name] = (err, a + r * w.abs().max().item())
    return res


def phase_kernels(card):
    import torch
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, case) in enumerate(CASES.items()):
            res = compare_kernels(case, dtype, seed=i)
            ok = all(err <= bound for err, bound in res.values())
            if not ok:
                failures.append(f"kernel case {name} {dtype}")
            print(f"kernel case {str(dtype)[6:]:8s} {name:22s} " + " ".join(
                f"{k} {e:.3g}/{b:.3g}" for k, (e, b) in res.items())
                + (" PASS" if ok else " FAIL"), flush=True)
    # the main path's shapes: error and times, kernel vs plain
    res = compare_kernels(MAIN_CASE, torch.bfloat16, seed=99)
    ok = all(err <= bound for err, bound in res.values())
    if not ok:
        failures.append("kernel case main_shape")
    print("kernel case bfloat16 main_shape_B8_H32/4_T1024_D64_rope " + " ".join(
        f"{k} {e:.3g}/{b:.3g}" for k, (e, b) in res.items())
        + (" PASS" if ok else " FAIL"), flush=True)
    from lxt_tpu_torch.ops import flash_attention as fa
    (q, k, v, do), extra = kernel_inputs(MAIN_CASE, torch.bfloat16, seed=99)
    _, lse = fa.flash_fwd_ref(q, k, v, *extra)
    out = fa.flash_fwd(q, k, v, *extra)[0]
    delta = (out.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, *extra)
    errs = {"flash_fwd": max(res["out"][0], res["lse"][0]),
            "flash_bwd_dq": res["dq"][0],
            "flash_bwd_dkv": max(res["dk"][0], res["dv"][0])}
    timed = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, *extra),
                      lambda: fa.flash_fwd_ref(q, k, v, *extra)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*bwd),
                         lambda: fa.flash_bwd_dq_ref(*bwd)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*bwd),
                          lambda: fa.flash_bwd_dkv_ref(*bwd)),
    }
    times = {}
    for name, (kern, plain) in timed.items():
        # plain, kernel, kernel, plain: the mean of each pair
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"kernel time {name} at B8 H32/4 T1024 D64 bf16 causal rope: "
              f"kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms "
              f"[{card}]", flush=True)
    return failures, errs, times


def attribute(params, cfg, ids, impl, remat):
    """One heatmap per example: (logits at the last position, relevance)."""
    import lxt_tpu_torch
    from lxt_tpu_torch.models import llama
    held = {}

    def target(x):
        logits = llama.forward(params, cfg, x, lxt_tpu_torch.attnlrp,
                               remat=remat, logits_at=-1,
                               attn_impl=impl).logits
        held["logits"] = logits.detach()
        return lxt_tpu_torch.select_logit(logits)

    _, rel = lxt_tpu_torch.input_relevance(target, llama.embed(params, ids))
    return held["logits"], rel


def phase_parity(card):
    """float32 main path: kernels against the einsum path."""
    import torch
    from lxt_tpu_torch.models import llama
    from lxt_tpu_torch.ops import flash_attention as fa
    failures = []
    cfg = llama.LlamaConfig(**MODEL, dtype="float32")
    gen = torch.Generator("cuda").manual_seed(0)
    params = llama.init_params(cfg, gen)
    ids = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=gen, device="cuda")
    before = dict(fa.launches)
    t0 = time.perf_counter()
    logits_k, rel_k = attribute(params, cfg, ids, "auto", remat=False)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    rose = {n: fa.launches[n] - before[n] for n in fa.launches}
    logits_e, rel_e = attribute(params, cfg, ids, "einsum", remat=False)
    d_logits, d_rel = nl2(logits_k, logits_e), nl2(rel_k, rel_e)
    finite = bool(torch.isfinite(rel_k).all() and torch.isfinite(logits_k).all())
    print(f"main path float32 L22 B1x{SEQ}: kernels vs einsum normalized L2 "
          f"logits {d_logits:.3g}, relevance {d_rel:.3g} (bar {PARITY_BAR}); "
          f"launches per attribution {rose}; one attribution {t_k:.3f} s "
          f"[{card}]", flush=True)
    if not (finite and d_logits <= PARITY_BAR and d_rel <= PARITY_BAR):
        failures.append("main path float32 parity")
    if any(n != cfg.num_layers for n in rose.values()):
        failures.append(f"launches per attribution {rose}")
    return failures, params, ids, rel_k


def phase_served(card, params32, ids1, rel32):
    """bf16 main path at batch 8 x 1024: three attributions through the
    kernels, then the einsum path, then the bf16-vs-f32 divergence."""
    import torch
    from lxt_tpu_torch.models import llama
    from lxt_tpu_torch.ops import flash_attention as fa
    failures = []
    cfg = llama.LlamaConfig(**MODEL, dtype="bfloat16")
    params = {k: ({n: t.to(torch.bfloat16) for n, t in v.items()}
                  if isinstance(v, dict) else v.to(torch.bfloat16))
              for k, v in params32.items()}
    gen = torch.Generator("cuda").manual_seed(1)

    def request():
        return torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SEQ),
                             generator=gen, device="cuda")

    def serve(impl, remat):
        rels = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            rels.append(attribute(params, cfg, request(), impl, remat)[1])
        torch.cuda.synchronize()
        return SERVE_BATCH * REQUESTS / (time.perf_counter() - t0), rels

    attribute(params, cfg, request(), "auto", False)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    rate, rels = serve("auto", remat=False)
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ok = all(r.shape == (SERVE_BATCH, SEQ) and bool(torch.isfinite(r).all())
             for r in rels)
    print(f"main path served bf16 L22 B{SERVE_BATCH}x{SEQ} remat off, kernels: "
          f"{REQUESTS} attributions, {rate:.3f} heatmaps/s, launches {launches}, "
          f"relevance finite and [{SERVE_BATCH}, {SEQ}]: {ok}, peak device "
          f"memory {peak:.2f} GiB [{card}]", flush=True)
    if not ok:
        failures.append("served relevance not finite or misshapen")
    if any(n != REQUESTS * cfg.num_layers for n in launches.values()):
        failures.append(f"served launches {launches}")

    attribute(params, cfg, request(), "einsum", False)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    rate_e, _ = serve("einsum", remat=False)
    peak_e = torch.cuda.max_memory_allocated() / 2**30
    print(f"main path served bf16 L22 B{SERVE_BATCH}x{SEQ} remat off, plain "
          f"einsum path: {rate_e:.3f} heatmaps/s, peak device memory "
          f"{peak_e:.2f} GiB [{card}]", flush=True)

    _, rel16 = attribute(params, cfg, ids1, "auto", False)
    div = nl2(rel16.float(), rel32)
    print(f"main path bf16 vs float32 relevance at B1x{SEQ}, kernels: "
          f"normalized L2 {div:.4g} (bar {DIVERGENCE_BAR})", flush=True)
    if not (math.isfinite(div) and div <= DIVERGENCE_BAR):
        failures.append("bf16 divergence")
    return failures, launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "lxt_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(lxt_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from lxt_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.build_seconds:.1f} s) [{card}]", flush=True)

    failures, errs, times = phase_kernels(card)
    f, params32, ids1, rel32 = phase_parity(card)
    failures += f
    f, launches = phase_served(card, params32, ids1, rel32)
    failures += f
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, tpu) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
