#!/usr/bin/env python3
"""Where the device time of one attribution goes, on one NVIDIA GPU, for
paths chip_smoke.py drives: the main path (bf16 Llama at TinyLlama-1.1B
widths, 22 layers, batch 8 x 1024, remat off), the NF4 path (Llama-3-8B
widths and depth, batch 1 x 4096, remat), Gemma-3-4B's text model (bf16,
full width and depth, batch 1 x 4096, remat off), NF4 Mixtral-8x7B
(full width and depth, bf16 activations, batch 1 x 4096, remat), GPT-2
XL (bf16, full depth, batch 8 x 1024, remat off, CP-LRP), BERT-base (bf16,
batch 32 x 512, 8 rows right-padded to 300, remat off) and decoding at
TinyLlama-1.1B widths (bf16, batch 8 x 896: one prefill, generate's
prefill and 128 steps, one attribute_response over the 1024 tokens, K 128),
serving (one coalesced batch of 8 prompts of 640-1024 words through
AttributionServer at TinyLlama-1.1B widths, bf16, remat off), the vision
towers (ViT-B/16 bf16 batch 64 under cp_lrp with gamma, conv 0.25 and
linear 0.05, remat; OpenCLIP ViT-L/14 bf16 batch 32 towards a direction)
and Gemma-3-4B image + text (bf16, one 896 x 896 image in a prompt of
512, 27 vision and 34 text layers, text remat off). Random weights from a
seed.

    python3 scripts/profile_torch_paths.py \
        [--paths main,nf4_8b,gemma,mixtral,gpt2,bert,decode,serve,vision,multimodal,
                 explicit,check]
        [--repo DIR]

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
width); for Mixtral and decoding the host reads (device-to-host copies:
the router's group sizes, generate's done flags) and the device idle that
follows them. For serving also the host's own time in tokenization (the
server's submit), in normalising the maps (the pipeline's) and in JSON
(the HTTP frontend's), each timed apart on the batch's prompts and maps.
For the vision towers and Gemma-3 image + text also the GEMM kernels by
name (the explicit rules' backwards run float32 GEMMs beside the bf16
ones). ``explicit``: the explicit Llama, GPT-2 XL and BERT of chip_smoke's
phase 18 (a). ``check`` is no profile but a census: the name and launches of
every device kernel of one ``AttributionModel.attribute`` with no
``check=`` at the main path (remat off and on), and a digest of the list;
``--repo DIR`` imports ``lxt_tpu_torch`` from another checkout, so that two
commits' censuses can be compared in one call. Needs a CUDA device; prints
the card's nvidia-smi name and power limit first.
"""

import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  this checkout's, before --repo goes first on the path
if "--repo" in sys.argv:   # the package of another checkout
    sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--repo") + 1]))

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


def profile(run, label, card, expert_width=None, host_reads=False, reps=3,
            unit="attribution", gemm_names=False):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA],
                                record_shapes=expert_width is not None) as prof:
        run()
        torch.cuda.synchronize()
    # the program's spans (``lxt_tpu_torch.tracing``) are device-side
    # annotations too, spanning whole layers: no operations
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
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
    print(f"{label}: wall {wall:.1f} ms per {unit} unprofiled; profiled "
          f"window {window / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, idle "
          f"{1 - busy / window:.1%} [{card}]", flush=True)
    for name, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0]):
        if n:
            print(f"  {name:27s} {ms:9.2f} ms  {n:5d} launches", flush=True)
    ops = sorted((a for a in prof.key_averages() if a.device_type == DeviceType.CPU),
                 key=lambda a: -a.self_device_time_total)
    print("  ops by the device time of the kernels they launch: " + (", ".join(
        f"{a.key} {a.self_device_time_total / 1e3:.2f} ms ({a.count})"
        for a in ops[:TOP_OPS] if a.self_device_time_total > 0)
        or "none attributed (launched from another thread)"), flush=True)
    if gemm_names:
        gemms = {}
        for e in kernels:
            if re.search(GEMM, e.name):
                t = gemms.setdefault(e.name, [0.0, 0])
                t[0] += (e.time_range.end - e.time_range.start) / 1e3
                t[1] += 1
        print("  GEMM kernels by name: " + "; ".join(
            f"{name} {ms:.2f} ms ({n})" for name, (ms, n) in
            sorted(gemms.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]), flush=True)
    if expert_width is not None:
        ms, n = expert_gemms(prof, expert_width)
        print(f"  of the cuBLAS GEMMs, the expert products: {ms:.2f} ms, {n} "
              f"launches", flush=True)
    if expert_width is not None or host_reads:
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
    from lxt_tpu_torch.models.registry import AttributionModel
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
        del params
        torch.cuda.empty_cache()
    if "bert" in paths:
        import lxt_tpu_torch
        from lxt_tpu_torch.models import bert
        cfg = bert.BertConfig(**cs.BERT_BASE)
        gen = torch.Generator("cuda").manual_seed(17)
        model = AttributionModel("bert", cfg, bert.init_params(cfg, gen, dtype=torch.bfloat16),
                                 lxt_tpu_torch.attnlrp, remat=False)
        ids = torch.randint(0, cfg.vocab_size, (cs.BERT_BATCH, cs.SEQ_BERT),
                            generator=gen, device="cuda")
        ends = torch.full((cs.BERT_BATCH,), cs.SEQ_BERT, dtype=torch.int32,
                          device="cuda")
        ends[:cs.BERT_BATCH // 4] = cs.BERT_REAL
        profile(lambda: model.attribute(ids, kv_end=ends),
                f"BERT-base L{cfg.num_layers} B{cs.BERT_BATCH}x{cs.SEQ_BERT} bf16 "
                f"remat off ({cs.BERT_BATCH // 4} rows kv_end {cs.BERT_REAL})", card)
        del model
        torch.cuda.empty_cache()
    if "decode" in paths:
        import lxt_tpu_torch
        from lxt_tpu_torch.models import decode
        cfg = llama.LlamaConfig(**cs.MODEL, dtype="bfloat16")
        gen = torch.Generator("cuda").manual_seed(0)
        model = AttributionModel("llama", cfg, llama.init_params(cfg, gen),
                                 lxt_tpu_torch.attnlrp, remat=False)
        B, T0, N = cs.DECODE_BF16
        ids = torch.randint(0, cfg.vocab_size, (B, T0), generator=gen, device="cuda")
        label = f"TinyLlama width bf16 L{cfg.num_layers} B{B}x{T0}"
        profile(lambda: decode.prefill(model.params, cfg, model.embed(ids), T0 + N),
                f"prefill {label}", card, unit="prefill")
        profile(lambda: model.generate(ids, N + 1, eos_token_id=0),
                f"generate {label}, {N + 1} new tokens (the prefill and {N} steps)",
                card, host_reads=True, reps=1, unit="generate")
        out = model.generate(ids, N)
        profile(lambda: model.attribute_response(out, T0),
                f"attribute_response {label} + {N}, K {N}", card, reps=1,
                unit="call")
    if "serve" in paths:
        profile_serve(card)
    if "vision" in paths:
        profile_vision(card)
    if "multimodal" in paths:
        profile_multimodal(card)
    if "explicit" in paths:
        profile_explicit(card)
    if "check" in paths:
        census_check(card)
    return 0


def profile_explicit(card):
    """The explicit TinyLlama-1.1B and GPT-2 XL (bf16, 8 x 1024) and BERT-base
    (bf16, 32 x 512, a quarter masked to 300) of chip_smoke's phase 18 (a),
    remat on."""
    import torch
    import chip_smoke as cs
    for family in ("llama", "gpt2", "bert"):
        cfg, params, _, comp, _, ex, embed = cs.explicit_setup(family)
        params = cs.cast(params, torch.bfloat16)
        B, T = (cs.BERT_BATCH, cs.SEQ_BERT) if family == "bert" else (cs.SERVE_BATCH, cs.SEQ)
        ids = torch.randint(0, cfg.vocab_size, (B, T), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(181))
        kw = {}
        if family == "bert":
            kw["attention_mask"] = torch.ones(B, T, dtype=torch.int32, device="cuda")
            kw["attention_mask"][:B // 4, cs.BERT_REAL:] = 0
        profile(lambda: cs.explicit_map(family, cfg, params, comp, ex, embed, ids, **kw),
                f"explicit {family} bf16 L{cfg.num_layers} B{B}x{T} remat on {comp.name}",
                card)
        del params
        torch.cuda.empty_cache()


def census_check(card):
    """The device kernels of one attribution at the main path, with no
    check=: the census two commits are compared by (chip_smoke's
    kernel_census, device-to-host copies included)."""
    import hashlib
    import torch
    import lxt_tpu_torch
    import chip_smoke as cs
    from lxt_tpu_torch.models import llama
    from lxt_tpu_torch.models.registry import AttributionModel
    print(f"lxt_tpu_torch from {os.path.dirname(lxt_tpu_torch.__file__)}", flush=True)
    cfg = llama.LlamaConfig(**cs.MODEL, dtype="bfloat16")
    params = llama.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    ids = torch.randint(0, cfg.vocab_size, (cs.SERVE_BATCH, cs.SEQ), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))
    for remat in (False, True):
        model = AttributionModel("llama", cfg, params, lxt_tpu_torch.attnlrp, remat=remat)
        model.attribute(ids)  # warm-up
        census, _ = cs.kernel_census(lambda: model.attribute(ids))
        digest = hashlib.sha1(repr(sorted(census.items())).encode()).hexdigest()[:16]
        print(f"census check=None bf16 L{cfg.num_layers} B{cs.SERVE_BATCH}x{cs.SEQ} "
              f"remat {remat}: {sum(census.values())} device kernel launches of "
              f"{len(census)} kernels, digest {digest} [{card}]", flush=True)
        for name, n in sorted(census.items(), key=lambda kv: (-kv[1], kv[0])):
            print(f"  {n:5d} {name[:150]}", flush=True)


def profile_vision(card):
    """ViT-B/16 under chip_smoke's gamma composite, and OpenCLIP ViT-L/14."""
    import torch
    import lxt_tpu_torch
    import chip_smoke as cs
    from lxt_tpu_torch.models import vit
    from lxt_tpu_torch.models.registry import VisionAttributionModel
    gen = torch.Generator("cuda").manual_seed(30)
    cfg = vit.ViTConfig(**cs.VIT_B16)
    gamma = lxt_tpu_torch.cp_lrp.with_gamma(conv_gamma=0.25, linear_gamma=0.05)
    model = VisionAttributionModel("vit", cfg, vit.init_params(cfg, gen, dtype=torch.bfloat16),
                                   gamma)
    images = cs.vision_images(gen, cs.VIT_BATCH, 224, torch.bfloat16)
    profile(lambda: model.attribute_image(images),
            f"ViT-B/16 L{cfg.num_layers} B{cs.VIT_BATCH} bf16 {gamma.name} (conv 0.25, "
            f"linear 0.05) remat", card, unit="batch", gemm_names=True)
    del model
    cfg = vit.ViTConfig(**cs.OPENCLIP_L14)
    model = VisionAttributionModel("openclip", cfg,
                                   vit.init_params(cfg, gen, dtype=torch.bfloat16),
                                   lxt_tpu_torch.cp_lrp)
    images = cs.vision_images(gen, cs.CLIP_BATCH, 224, torch.bfloat16)
    direction = torch.randn(cfg.proj_dim, generator=gen, device="cuda").to(torch.bfloat16)
    profile(lambda: model.attribute_image(images, target=direction),
            f"OpenCLIP ViT-L/14 L{cfg.num_layers} B{cs.CLIP_BATCH} bf16 cp_lrp remat",
            card, unit="batch", gemm_names=True)
    del model
    torch.cuda.empty_cache()


def profile_multimodal(card):
    """One joint token + pixel map of Gemma-3-4B image + text."""
    import torch
    import lxt_tpu_torch
    import chip_smoke as cs
    from lxt_tpu_torch.models.registry import MultimodalAttributionModel
    gen = torch.Generator("cuda").manual_seed(50)
    mmcfg = cs.mm_config()
    model = MultimodalAttributionModel(mmcfg, cs.mm_weights(mmcfg, gen, torch.bfloat16),
                                       lxt_tpu_torch.attnlrp, remat=False)
    ids, pix = cs.mm_prompt(gen, torch.bfloat16)
    profile(lambda: model.attribute(ids, pix),
            f"Gemma-3-4B image + text L{mmcfg.vision.num_layers}+{mmcfg.text.num_layers} "
            f"B1x{cs.SEQ_MM} one 896x896 image, bf16, text remat off", card,
            unit="joint map", gemm_names=True)
    del model
    torch.cuda.empty_cache()


def profile_serve(card):
    """One coalesced batch of 8 through AttributionServer (submit, the
    worker's pipeline call, the futures), and the host's parts of a served
    request timed apart."""
    import json

    import lxt_tpu_torch
    import numpy as np
    import torch
    import chip_smoke as cs
    from lxt_tpu_torch import pipeline as pl
    from lxt_tpu_torch.models import llama
    from lxt_tpu_torch.models.registry import AttributionModel
    from lxt_tpu_torch.serve import AttributionServer, _result_json
    cfg = llama.LlamaConfig(**cs.MODEL, dtype="bfloat16")
    model = AttributionModel("llama", cfg, llama.init_params(
        cfg, torch.Generator("cuda").manual_seed(20)), lxt_tpu_torch.attnlrp,
        remat=False)
    tok = cs.WordTokenizer(cfg.vocab_size)
    pipe = pl.AttributionPipeline(model, tok)
    prompts = cs.words(np.random.default_rng(21), cs.SERVE_WORDS, cs.SERVE_MAX_BATCH)
    server = AttributionServer(pipe, max_batch=cs.SERVE_MAX_BATCH,
                               max_wait_ms=cs.SERVE_WAIT_MS)
    maps = {}

    def run():
        first = len(server.batch_sizes)
        maps["out"] = [f.result() for f in [server.submit(p) for p in prompts]]
        maps["batches"] = list(server.batch_sizes)[first:]

    try:
        profile(run, f"serve TinyLlama width bf16 L{cfg.num_layers}, "
                f"{cs.SERVE_MAX_BATCH} prompts of {cs.SERVE_WORDS[0]}-"
                f"{cs.SERVE_WORDS[1]} words", card, unit="coalesced batch")
    finally:
        server.close()
    out = maps["out"]

    def host_ms(fn, reps=20):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    t_tok = host_ms(lambda: [tok(p) for p in prompts])
    t_norm = host_ms(lambda: [pl._normalized(h.raw_relevance) for h in out])
    t_json = host_ms(lambda: [json.dumps({"heatmaps": [_result_json(h)]})
                              for h in out])
    print(f"  host: tokenization {t_tok:.3f} ms, normalisation {t_norm:.3f} ms, "
          f"JSON {t_json:.3f} ms for the batch's {len(out)} requests "
          f"(T {max(len(h.tokens) for h in out)}); coalesced batches of the "
          f"profiled run {maps['batches']}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
