#!/usr/bin/env python3
"""Smoke run of lxt_tpu_torch on one NVIDIA GPU: builds the kernels, holds
each against its plain PyTorch version, and drives the AttnLRP main path
(input relevance of a Llama-family LM with TinyLlama-1.1B widths, random
weights from a seed), the quantized path (NF4 weights at Llama-3-8B width
and depth, and a bitsandbytes-NF4 checkpoint through from_pretrained),
Gemma-3-4B's text model at full width and depth through the kernels, the
sequence-parallel ring (flash_attention_lse's calls) over four processes on
the one card, the rest of the attribution API (multi-target and latent
relevance, faithfulness, Integrated Gradients) at the main path's width,
Mixtral-8x7B at full width and depth in NF4 (the routed expert products)
and GPT-2 XL at full depth (no rotary embedding).

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --kernels   # phases 1-3 only, no result line

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
  2. the kernel build (nvcc, into lxt_tpu_torch/_build/), and the registers
     and spills ptxas reported for every flash body;
  3. K1 flash_fwd, K2 flash_bwd_dq (dq and the delta it computes inside) /
     flash_bwd_dkv and the RoPE rotation pass against their plain versions
     (the pass bit-exact on contiguous tensors and head-split views, delta
     within 1e-5 normalized L2), bf16, float16 and float32, over the mask
     regimes,
     T 320 (a part-full last q tile) at head dim 64, 128 and 256, GQA 16/2
     with a window of 40 at head dim 256, Gemma-3-4B's local and global
     calls (head dim 256, T 4096, window 1024 or none) and both paths' calls;
     the ring steps (offsets and an lse cotangent) at every (q_start,
     k_start) pair of a 4-way split and one pair off the tile grid, bf16,
     float16 and float32, head dim 64, 128 (window 300) and 256 (window
     1024), on both bodies; then at the main path's call (B8 H32/4 T1024 D64), the
     NF4 8B path's (B1 H32/8 T4096 D128; Mixtral-8x7B's too), Gemma-3-4B's
     two (B1 H8/4 T4096 D256) and GPT-2 XL's (B8 H25/25 T1024 D64, no
     rope), bf16, causal: each kernel's device time (CUDA-graph replays) and
     body (Hopper or mma.sync) beside its plain version's time, its
     roofline bound (fa.work: FLOPs over 989 TFLOP/s or bytes over 3.35
     TB/s, the larger) and the library's time for the same attention
     (scaled_dot_product_attention under its flash and cuDNN backends, and
     the memory-efficient one where a window needs a mask, the fastest
     kept, by graph replays with the eager times beside; its backward
     against dq (delta inside) + dkv); as controls, the mma.sync body of
     each kernel that runs its Hopper body at the call and the separate
     delta pass that the backward no longer runs; and a
     ring step at Llama-3-8B widths (B1 H32/8 T_local 2048 D128, keys
     wholly in the past: the full square, dlse) beside the library's
     non-causal attention;
  4. K3 nf4_dequant against its plain version, bit-exact, bf16, float16
     and float32,
     over the Llama-3-8B projection shapes, ragged ones and Mixtral's
     router [4096, 8] (the unaligned path); times at the wg [4096, 14336]
     and wd [14336, 4096] shapes;
  5. the main path in float32, 22 layers, batch 1 x 1024: the kernel path
     against the einsum path (normalized L2 of logits and relevance <= 1e-4)
     and the kernel launches per attribution;
  6. the main path served: bf16, batch 8 x 1024, three attributions through
     the kernels (launch counts, finite relevance, heatmaps/s), the einsum
     path's heatmaps/s, the bf16-vs-float32 relevance divergence at batch 1,
     the peak device memory, and float16 at batch 1 through the kernels'
     float16 bodies (launches, divergence from float32);
  7. the NF4 path at Llama-3-8B width and depth (32 layers, bf16, batch
     1 x 4096, remat): three attributions (heatmaps/s, launches per
     attribution of K1, K2, the rotation pass and K3 against 64 / 32 / 128 /
     640, finite relevance, peak memory), then the
     dense control with every projection plainly dequantized to bf16
     (heatmaps/s, normalized L2 of its relevance against the NF4 run <= 1e-3);
  8. from_pretrained on the card: a tiny bitsandbytes-NF4-serialized Llama
     checkpoint written here, loaded with device="cuda" and attributed
     (QuantizedTensor leaves, weights exact against the checkpoint's values,
     finite relevance within 1e-4 of the CPU load, K3 launched);
  9. Gemma-3-4B's text model (google/gemma-3-4b-it text_config widths):
     float32 at 6 layers (one global), batch 1 x 2048, the kernel path
     against the einsum path (normalized L2 <= 1e-4) and bf16 against it
     (relevance <= 0.1); then bf16 at full width and depth (34 layers),
     batch 1 x 4096, remat off: three attributions (heatmaps/s, launches
     per attribution against 34 of each flash kernel and 102 of the
     rotation pass, finite relevance, peak memory), and attribute_latent of
     the first request (latent [34, 1, 4096, 2560] finite, its input
     relevance within 0.02 normalized L2 of the attribution's, the same
     launches, peak memory);
 10. the ring: four processes on the one card over a gloo group (its
     host-staged point-to-point; the card count is 1), Llama-3-8B widths,
     random weights from one seed on every process, each comparison
     explaining the reference's argmax token at the last position: at 2
     layers and 1 x 4096 the float32 ring against the single-process
     float32 kernel path (normalized L2 <= 1e-4) and the bf16 ring against
     the float32 ring (<= 0.1); then bf16 at 4 layers and 1 x 8192 (2048 a
     process, remat off), three attributions: finite relevance, its
     divergence from the single-process bf16 kernel path (<= 0.02), the
     peak memory, the wall time and the launches per process of K1,
     flash_bwd_dq and flash_bwd_dkv against the steps whose kv shard the
     causal mask leaves visible (process r: r + 1 of 4) x 4 layers. A
     process that fails or hangs fails it;
 11. the attribution API at TinyLlama-1.1B width and depth on phases 5-6's
     weights through the kernels, remat off (AttributionModel(...,
     remat=False)): attribute_topk (k 5), attribute_multi (three tokens)
     and multi_site_relevance (three (position, token) sites, plain and
     contrastive), each through one forward and K pulls of its graph, in
     bf16 at batch 8 x 1024 and float32 at 1 x 1024: launches exactly L of
     K1 and K x L of each K2 half (and the rotation pass before each
     Hopper launch), each map within 1e-3 (bf16) / 1e-5 (float32)
     normalized L2 of its separate attribution (token= or an explicit
     target=), maps/s beside the separate calls'; attribute_latent in bf16
     at 8 x 1024 (latent [22, 8, 1024, 2048] finite, input relevance within
     0.02 of attribute's, one attribution's launches, peak memory); CP-LRP
     latent relevance in float32 at 1 x 1024 (every layer's total within
     1e-3 relative of the target); faithfulness(steps=10) in bf16 at
     8 x 1024 (finite curves, ABPC, seconds per report, K1 launched once a
     layer for each of its 1 + 3 x 11 forwards); integrated_gradients
     (steps 32, vanilla_gradient) in bf16 at 8 x 1024 (32 forwards and
     pulls of launches, finite relevance, the completeness gap printed);
 12. Mixtral-8x7B (Mixtral-8x7B-v0.1 config.json widths, random weights):
     float32 at 2 layers, batch 1 x 1024: the kernel path against the
     einsum path and the ragged mixture against the dense one (normalized
     L2 <= 1e-4), bf16 against float32 (<= 0.1) with the share of
     (layer, token) rows whose top-2 expert set differs between the two
     printed; then NF4 on every quantizable leaf at full depth (32
     layers), bf16, batch 1 x 4096, remat: init and quantize seconds, GiB
     of codes and scales, three attributions (heatmaps/s, peak memory,
     finite relevance, launches against K1 2L, each K2 half L, 4L
     rotation passes and K3's count derived from the expert groups the
     run saw); a dense bf16 control at 4 layers (each (layer, expert)
     slice plainly dequantized) against the NF4 run at 4 layers (<= 1e-3);
 13. GPT-2 XL (gpt2-xl widths, random weights, CP-LRP): float32 at 6
     layers, batch 1 x 1024, kernels against einsum (<= 1e-4) and bf16
     against float32 (<= 0.1); bf16 at full depth (48 layers), batch
     8 x 1024, remat off: three attributions (heatmaps/s, peak memory,
     launches of K1 and each K2 half L each with no rotation pass); one
     left-padded batch (row 0 kv_begin 128: finite, 0 on the padding,
     within 0.02 of its tokens unpadded).
The line before the last is a JSON object with each kernel's launches, error,
times, bound and library time at the main path's call (K3: at wg), under
"at_8b" at the NF4 8B path's (K3: at wd), and, for the flash kernels, under
"at_gemma_local" / "at_gemma_global" at Gemma-3-4B's calls and "at_ring"
at the ring step and "at_gpt2" at GPT-2 XL's call (where the call runs
no rotation pass, the pass has no entry); a flash kernel's entry names its
"body" and, where a control ran, its mma.sync body's time "mma_ms".
"launches", "launches_8b", "launches_gemma", "launches_mixtral" and
"launches_gpt2" are each the count over its path's three timed
attributions ("launches" of K3: the NF4 8B path's), "launches_ring" over
the ring's three driven attributions, all four processes together, and
"launches_api" over phase 11's calls of the API (not the separate
attributions they are held against); the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import itertools
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEQ, SERVE_BATCH, REQUESTS = 1024, 8, 3
PARITY_BAR, DIVERGENCE_BAR = 1e-4, 0.1
# (a, r) of each dtype's max|diff| bar a + r * absmax for K1/K2 against their
# plain versions: lxt_tpu's TPU-kernel criterion for bf16, an eighth of it
# for float16 (three more mantissa bits), 1e-4 for float32
KERNEL_BARS = {"bfloat16": (0.01, 0.01171875), "float16": (0.00125, 0.00146484375),
               "float32": (1e-4, 1e-4)}
# flash_bwd_dq's delta against the plain version's, normalized L2: the same
# float32 products summed in another order
DELTA_BAR = 1e-5
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
    # a half-full last 128-row q tile of K1's Hopper body
    "odd_tiles_T320_hd64": (2, 4, 2, 320, 64, {"rope": True}),
    "odd_tiles_T320_hd128": (2, 4, 2, 320, 128, {"rope": True, "kv_begin": [0, 37]}),
    "gqa_32_8_hd128_window": (1, 32, 8, 512, 128, {"window": 200, "rope": True}),
    # head dim 256: a half-full last 128-row q tile of K1's Hopper body, and
    # GQA 16/2 with a window narrower than a tile
    "odd_tiles_T320_hd256": (2, 8, 4, 320, 256, {"rope": True}),
    "gqa_16_2_hd256_window40": (1, 16, 2, 512, 256, {"window": 40, "rope": True,
                                                     "kv_begin": [37]}),
    # Gemma-3-4B's calls (head dim 256: the Hopper bodies of K1,
    # flash_bwd_dq and flash_bwd_dkv in bf16): local layers with the 1024
    # window, global layers without one
    "gemma_local": (1, 8, 4, 4096, 256, {"window": 1024, "rope": True}),
    "gemma_global": (1, 8, 4, 4096, 256, {"rope": True}),
}
# ring steps (flash_attention_lse's calls): every (q_start, k_start) pair of
# a 4-way split of 4 x T (keys in the past, on the diagonal and wholly in the
# future) and one pair off the tile grid, each with a nonzero lse cotangent:
# the Hopper bodies in bf16 at D 64, 128 and 256 (with Gemma-3's window);
# the mma.sync bodies in float32 and float16
RING_CASES = {
    "ring_hd64": (2, 4, 2, 256, 64, {}),
    "ring_hd128_window300": (1, 8, 2, 256, 128, {"window": 300}),
    "ring_hd256_window1024": (1, 8, 4, 1024, 256, {"window": 1024}),
}


def ring_pairs(T):
    return [(i * T, j * T) for i in range(4) for j in range(4)] + [(100, 37)]


# the paths' attention calls, bf16, causal, rope: the main path's
# (TinyLlama-1.1B widths, B 8 x 1024), the NF4 8B path's (Llama-3-8B
# widths, B 1 x 4096; Mixtral-8x7B's attention is the same call) and
# Gemma-3-4B's local and global layers' (B 1 x 4096); a ring step of phase
# 10 at Llama-3-8B widths (T_local 2048, rope applied outside, keys wholly
# in the past: the full square, with an lse cotangent); and GPT-2 XL's
# (B 8 x 1024, H 25/25, no rope: no rotation pass)
MAIN_CASE = (SERVE_BATCH, 32, 4, SEQ, 64, {"rope": True})
CALLS = {"main": MAIN_CASE, "8b": (1, 32, 8, 4096, 128, {"rope": True}),
         "gemma_local": CASES["gemma_local"], "gemma_global": CASES["gemma_global"],
         "ring": (1, 32, 8, 2048, 128, {"q_start": 2048, "dlse": True}),
         "gpt2": (SERVE_BATCH, 25, 25, SEQ, 64, {})}
CALL_NAMES = {"main": "B8 H32/4 T1024 D64 causal rope",
              "8b": "B1 H32/8 T4096 D128 causal rope",
              "gemma_local": "B1 H8/4 T4096 D256 window 1024 causal rope",
              "gemma_global": "B1 H8/4 T4096 D256 causal rope",
              "ring": "B1 H32/8 T_local 2048 D128 ring step q_start 2048 k_start 0 "
                      "(full square) dlse",
              "gpt2": "B8 H25/25 T1024 D64 causal, no rope"}
# peak rates of an H100 SXM (data sheet): bf16 tensor cores, float32 outside
# them (the rotation pass's elementwise work), device memory
PEAK_BF16, PEAK_F32, HBM_BYTES_PER_S = 989e12, 67e12, 3.35e12
KERNELS = {
    "flash_fwd": ("lxt_tpu_torch/csrc/flash_fwd.cu",
                  "lxt_tpu/ops/flash_attention.py:184"),
    "flash_bwd_dq": ("lxt_tpu_torch/csrc/flash_bwd.cu",
                     "lxt_tpu/ops/flash_attention.py:759"),
    "flash_bwd_dkv": ("lxt_tpu_torch/csrc/flash_bwd.cu",
                      "lxt_tpu/ops/flash_attention.py:837"),
    "nf4_dequant": ("lxt_tpu_torch/csrc/nf4_dequant.cu",
                    "lxt_tpu/ops/quant.py:206"),
    "rope_rotate": ("lxt_tpu_torch/csrc/rope.cu",
                    "lxt_tpu/ops/flash_attention.py:129"),
}
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rope_rotate")
# Meta-Llama-3-8B's config.json widths (bench.py llama3_8b_config), full
# depth, random weights; bench_8b's setup: bf16, batch 1 x 4096, remat
LLAMA3_8B = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                 num_layers=32, num_heads=32, num_kv_heads=8, rms_eps=1e-5,
                 rope_theta=500000.0)
SEQ_8B, DENSE_BAR = 4096, 1e-3
PROJECTIONS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
# K3 cases: name -> (weight shape [..., K, N], nf4 block); the 8B projection
# shapes, the whole 8B wk stack, and ragged shapes (K 64 with block 64 is
# one lxt_tpu's Pallas kernel refuses: K/2 % block != 0)
K3_CASES = {
    "wq_wo_4096x4096": ((4096, 4096), 64),
    "wk_wv_4096x1024": ((4096, 1024), 64),
    "wg_wu_4096x14336": ((4096, 14336), 64),
    "wd_14336x4096": ((14336, 4096), 64),
    "wk_stack_32x4096x1024": ((32, 4096, 1024), 64),
    "ragged_128x48": ((128, 48), 64),
    "ragged_64x40": ((64, 40), 64),
    # Mixtral-8x7B's router [4096, 8]: N < 16 takes the unaligned path
    "router_4096x8": ((4096, 8), 64),
}
K3_TIMED = ("wg_wu_4096x14336", "wd_14336x4096")
# the tiny bitsandbytes-NF4 checkpoint of phase 8
TINY = dict(model_type="llama", vocab_size=512, hidden_size=256,
            intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, rms_norm_eps=1e-5, tie_word_embeddings=False)
# Gemma-3-4B's text model: google/gemma-3-4b-it config.json text_config,
# the rest from transformers' Gemma3TextConfig defaults (every 6th layer
# global); full depth, random weights; bf16, batch 1 x 4096, remat off. The
# float32 gates run 6 layers (layer 6 global) at 1 x 2048.
GEMMA3_4B = dict(vocab_size=262208, hidden_size=2560, intermediate_size=10240,
                 num_layers=34, num_heads=8, num_kv_heads=4, head_dim=256,
                 rope_theta=1e6, rope_local_theta=1e4, rope_global_scaling=8.0,
                 rms_eps=1e-6, query_pre_attn_scalar=256.0, sliding_window=1024)
SEQ_GEMMA, GEMMA_PARITY_LAYERS, SEQ_GEMMA_PARITY = 4096, 6, 2048
# phase 10, the ring: four processes on the one card over a gloo group,
# Llama-3-8B widths, random weights from one seed on every process; gates
# at 2 layers and 1 x 4096, the driven run bf16 at 4 layers and 1 x 8192.
# The driven run's bar against the single-process bf16 kernel path: both
# bf16, explaining one token, apart only in sum order (read 0.004164 on the
# H100 before the ring skipped hidden steps)
RING_WORLD, RING_SEED, RING_TIMEOUT = 4, 21, 600
RING_GATE = (2, 4096)
RING_DRIVEN = (4, 8192)
RING_BF16_BAR = 0.02
# phase 11, the attribution API on phases 5-6's weights, remat off: top-k
# (k 5), three fixed tokens and three (position, token) sites, each map
# against its separate attribution (bf16 at B 8 x 1024, float32 at B 1);
# attribute_latent's input relevance against attribute's; CP-LRP's
# per-layer totals against the target (tests/test_registry.py's bar); a
# faithfulness report and Integrated Gradients (printed and gated on launches)
API_K, API_TOKENS = 5, (17, 4242, 31999)
API_SITES = ((100, 17), (511, 4242), (SEQ - 1, 31999))
API_BF16_BAR, API_F32_BAR, LATENT_BAR, CONSERVATION_RTOL = 1e-3, 1e-5, 0.02, 1e-3
FAITH_STEPS, IG_STEPS = 10, 32
# phase 12, Mixtral: Mixtral-8x7B-v0.1's config.json widths (transformers'
# MixtralConfig defaults), random weights from a seed. The float32 gates at
# 2 layers and 1 x 1024; the headline NF4 run at full depth, bf16, 1 x 4096,
# remat; the dense control at 4 layers against the NF4 run at 4 layers
MIXTRAL_8X7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                    num_layers=32, num_heads=32, num_kv_heads=8, num_experts=8,
                    experts_per_token=2, rope_theta=1e6, rms_eps=1e-5)
MIXTRAL_GATE, SEQ_MIXTRAL, MIXTRAL_CONTROL_LAYERS = (2, 1024), 4096, 4
# phase 13, GPT-2 XL (openai-community/gpt2-xl config.json widths): bf16,
# batch 8 x 1024, remat off, CP-LRP; the float32 gates at 6 layers and
# 1 x 1024. One left-padded batch: row 0 padded by 128, its relevance held
# against the same tokens unpadded (bf16 through other GEMM shapes)
GPT2_XL = dict(vocab_size=50257, hidden_size=1600, num_layers=48, num_heads=25,
               max_positions=1024, ln_eps=1e-5)
GPT2_GATE_LAYERS, GPT2_PAD, PADDED_BAR = 6, 128, 0.02


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


def graph_ms(fn, iters=10, stream=None):
    """Mean device time of ``fn`` in ms with the host out of the way:
    ``iters`` calls captured in one CUDA graph, replayed twice between
    CUDA events. A wrapper's Python checks and launches cost tens of
    microseconds a call, which back-to-back eager calls (cuda_ms) would
    count wherever they exceed the kernel's own time. ``stream``: the
    capture stream (a backward's ops run on its forward's stream)."""
    import torch
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (2 * iters)


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


def ring_args(case, seed):
    """A call's global offsets ({"q_start", "k_start"}) and, where the
    case asks for one, a seeded lse cotangent [B, H, T] (None otherwise)."""
    import torch
    B, H, _, T, _, opt = case
    off = {"q_start": opt.get("q_start", 0), "k_start": opt.get("k_start", 0)}
    gen = torch.Generator("cuda").manual_seed(seed + 1)
    dlse = (torch.randn((B, H, T), generator=gen, device="cuda")
            if opt.get("dlse") else None)
    return off, dlse


def compare_kernels(case, dtype, seed):
    """Each kernel and its plain version on the same inputs (at the case's
    global offsets, flash_bwd_dq with its lse cotangent): returns {output:
    (error, bound, max_abs_err)}, the error being the max abs error except
    for delta (normalized L2); the backward kernels get the plain forward's
    out and lse and flash_bwd_dkv the plain delta, so each is held alone."""
    import torch
    from lxt_tpu_torch.ops import flash_attention as fa
    a, r = KERNEL_BARS[str(dtype)[6:]]
    (q, k, v, do), extra = kernel_inputs(case, dtype, seed)
    off, dlse = ring_args(case, seed)
    out, lse = fa.flash_fwd(q, k, v, *extra, **off)
    ref_out, ref_lse = fa.flash_fwd_ref(q, k, v, *extra, **off)
    dq_args = (q, k, v, do, ref_out, ref_lse, *extra)
    want_dq, want_delta = fa.flash_bwd_dq_ref(*dq_args, dlse=dlse, **off)
    bwd = (q, k, v, do, ref_lse, want_delta, *extra)
    seen = ref_lse > -1e29
    got = {"out": out, "lse": torch.where(seen, lse, 0.0)}
    got["dq"], got["delta"] = fa.flash_bwd_dq(*dq_args, dlse=dlse, **off)
    got["dk"], got["dv"] = fa.flash_bwd_dkv(*bwd, **off)
    want = {"out": ref_out, "lse": torch.where(seen, ref_lse, 0.0),
            "dq": want_dq, "delta": want_delta}
    want["dk"], want["dv"] = fa.flash_bwd_dkv_ref(*bwd, **off)
    cos, sin = extra[:2]
    if cos is not None:  # the rotation pass, bit-exact: bound 0
        got["rope"] = fa.rope_rotate(q, cos, sin)
        want["rope"] = fa.rope_rotate_ref(q, cos, sin)
        # a head-split view, as the model hands q and k over
        view = q.transpose(1, 2).contiguous().transpose(1, 2)
        got["rope_view"] = fa.rope_rotate(view, cos, sin)
        want["rope_view"] = fa.rope_rotate_ref(view, cos, sin)
    torch.cuda.synchronize()
    if not torch.equal(lse <= -1e29, ~seen):
        raise AssertionError("flash_fwd: empty rows differ from the plain version")
    res = {}
    for name in got:
        w = want[name].float()
        err = (got[name].float() - w).abs().max().item()
        if name == "delta":
            res[name] = (nl2(got[name], w), DELTA_BAR, err)
        else:
            res[name] = (err, 0.0 if name.startswith("rope")
                         else a + r * w.abs().max().item(), err)
    return res


def bound(name, case):
    """(bound_ms, bound_by) of one call: the larger of its FLOPs over the
    peak rate of their type and its bytes over the memory rate."""
    from lxt_tpu_torch.ops import flash_attention as fa
    B, H, Hkv, T, D, opt = case
    flops, moved = fa.work(name, B, H, Hkv, T, D, 2, window=opt.get("window"),
                           causal=opt.get("causal", True),
                           rope=bool(opt.get("rope")),
                           q_start=opt.get("q_start", 0),
                           k_start=opt.get("k_start", 0),
                           dlse=bool(opt.get("dlse")))
    t_ops = flops / (PEAK_F32 if name == "rope_rotate" else PEAK_BF16) * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


_CAPTURE = {"refused": False}


def sdpa_yardstick(q, k, v, do, cos, sin, scale, window=None, causal=True):
    """The library's time for the same attention: one
    scaled_dot_product_attention call (causal or, for a ring step whose keys
    lie wholly in the past, non-causal; GQA) under its flash and its
    cuDNN backend, forward and backward (torch.autograd.grad with
    retain_graph) timed apart, each by CUDA-graph replays and eagerly; with
    a window, whose mask only a boolean attn_mask can give, under the
    memory-efficient backend too. q and k are rotated (where the call has
    tables), and k/v repeated where a backend refuses GQA, outside the timed
    windows. Returns the fastest {"fwd": (ms, backend, eager ms), "bwd":
    (...)} by replay time (by the eager time, and the backend's name says
    so, where it refuses capture) and a line per backend."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from lxt_tpu_torch.models import common
    from lxt_tpu_torch.ops.attention import repeat_kv
    qr, kr = (q, k) if cos is None else common.apply_rope(q, k, cos, sin)
    n_rep = q.shape[1] // k.shape[1]
    best, lines = {}, []
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION]
    mask = {"is_causal": causal}
    if window is not None:
        i = torch.arange(q.shape[2], device=q.device)
        mask = {"attn_mask": (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)}
        backends.append(SDPBackend.EFFICIENT_ATTENTION)
    for backend in backends:
        for gqa in (True, False):
            kk, vv = (kr, v) if gqa else (repeat_kv(kr, n_rep), repeat_kv(v, n_rep))

            def fresh():
                return [t.detach().clone().requires_grad_(True) for t in (qr, kk, vv)]

            def attend(ls):
                return F.scaled_dot_product_attention(
                    *ls, scale=scale, enable_gqa=gqa, **mask)

            leaves = fresh()

            def fwd():
                return attend(leaves)

            def fwd_no_grad():
                with torch.no_grad():
                    return fwd()

            name = backend.name.lower() + ("" if gqa else " (k/v repeated)")
            try:
                with sdpa_kernel([backend]):
                    eager = {"fwd": cuda_ms(fwd_no_grad)}
                    out = fwd()
                    eager["bwd"] = cuda_ms(lambda: torch.autograd.grad(
                        out, leaves, do, retain_graph=True))
                    torch.cuda.synchronize()
            except RuntimeError as e:
                lines.append(f"{name}: refused ({str(e).splitlines()[0][:80]})")
                continue
            replay = {}
            for key in ("fwd", "bwd"):
                if _CAPTURE["refused"]:
                    replay[key] = "not captured: an earlier capture failed"
                    continue
                try:
                    with sdpa_kernel([backend]):
                        if key == "fwd":
                            replay[key] = graph_ms(fwd_no_grad)
                        else:
                            # fresh leaves and the forward on the capture
                            # stream: the backward's ops, and its leaves'
                            # gradient nodes, then run on that stream, not
                            # the default one, which a capture may not touch
                            side = torch.cuda.Stream()
                            side.wait_stream(torch.cuda.current_stream())
                            with torch.cuda.stream(side):
                                ls = fresh()
                                out = attend(ls)
                            replay[key] = graph_ms(lambda: torch.autograd.grad(
                                out, ls, do, retain_graph=True), stream=side)
                except RuntimeError as e:
                    # a failed capture can leave the caching allocator
                    # unable to free memory: no further captures
                    _CAPTURE["refused"] = True
                    torch.cuda.synchronize()
                    replay[key] = f"refused capture ({str(e).splitlines()[0][:60]})"
            lines.append(f"{name}: " + ", ".join(
                f"{label} {eager[key]:.4f} ms eager, "
                + (f"{replay[key]:.4f} ms graph replay" if isinstance(replay[key], float)
                   else replay[key])
                for key, label in (("fwd", "forward"), ("bwd", "backward"))))
            for key in ("fwd", "bwd"):
                ms, label = ((replay[key], name) if isinstance(replay[key], float)
                             else (eager[key], name + ", eager: capture refused"))
                if key not in best or ms < best[key][0]:
                    best[key] = (ms, label, eager[key])
            del out, leaves
            break
    return best, lines


def time_call(call, card):
    """Each flash kernel at one of the paths' calls, and the rotation pass
    where a kernel of the call runs its Hopper body (bf16: that body reads
    an operand rotated by the pass): kernel and plain times (plain, kernel,
    kernel, plain), bound and the library's time (graph replays); and, as
    controls, the mma.sync body of each kernel that runs its Hopper body
    here (q and k rotated in the kernel) and, beside flash_bwd_dq's Hopper
    body, the separate delta pass, which the backward no longer runs."""
    import torch
    from lxt_tpu_torch.ops import flash_attention as fa
    case = CALLS[call]
    (q, k, v, do), extra = kernel_inputs(case, torch.bfloat16, seed=99)
    off, dlse = ring_args(case, seed=99)
    cos, sin, scale = extra[0], extra[1], extra[5]
    B, H, Hkv, T, D, opt = case
    window = opt.get("window")
    full = fa.visible_pairs(T, window, opt.get("causal", True), **off) == T * T
    out, lse = fa.flash_fwd(q, k, v, *extra, **off)
    dq_args = (q, k, v, do, out, lse, *extra)
    _, delta = fa.flash_bwd_dq(*dq_args, dlse=dlse, **off)
    bwd = (q, k, v, do, lse, delta, *extra)
    timed = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, *extra, **off),
                      lambda: fa.flash_fwd_ref(q, k, v, *extra, **off)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*dq_args, dlse=dlse, **off),
                         lambda: fa.flash_bwd_dq_ref(*dq_args, dlse=dlse, **off)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*bwd, **off),
                          lambda: fa.flash_bwd_dkv_ref(*bwd, **off)),
        "rope_rotate": (lambda: fa.rope_rotate(q, cos, sin),
                        lambda: fa.rope_rotate_ref(q, cos, sin)),
    }
    lib, lib_lines = sdpa_yardstick(q, k, v, do, cos, sin, scale, window,
                                    causal=not full)
    library = {"flash_fwd": lib.get("fwd"), "flash_bwd_dq": lib.get("bwd"),
               "flash_bwd_dkv": lib.get("bwd"), "rope_rotate": None}
    plain_iters = 10 if call == "main" else 3
    # each kernel's body at this call; the mma.sync bodies rotate inside
    bodies = {n: fa._hopper(n, q) for n in FLASH[:3]}
    if not any(bodies.values()) or cos is None:
        del timed["rope_rotate"]
    res = {}
    for name, (kern, plain) in timed.items():
        # plain, kernel, kernel, plain; the kernel's device time from graph
        # replays, and its eager back-to-back time beside it
        p1, k1, k2 = cuda_ms(plain, plain_iters, 1), graph_ms(kern), graph_ms(kern)
        p2 = cuda_ms(plain, plain_iters, 1)
        eager = cuda_ms(kern)
        b_ms, b_by = bound(name, case)
        lib_ms, lib_name, lib_eager = library[name] or (None, None, None)
        res[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     "library": lib_name, "library_eager_ms": lib_eager,
                     "eager_ms": eager}
        r = res[name]
        body = ""
        if name in bodies:
            r["body"] = "Hopper" if bodies[name] else "mma.sync"
            body = f" ({r['body']} body)"
        print(f"kernel time {name} at {CALL_NAMES[call]} bf16{body}: "
              f"kernel {r['ms']:.4f} ms (eager calls {eager:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
              f"{b_ms / r['ms']:.1%} of it), library "
              + (f"{lib_ms:.4f} ms ({lib_name}; eager {lib_eager:.4f} ms)"
                 if lib_ms else "none")
              + f" [{card}]", flush=True)
    if not any(off.values()):
        mma = {"flash_fwd": lambda: fa.flash_fwd_mma(q, k, v, *extra),
               "flash_bwd_dq": lambda: fa.flash_bwd_dq_mma(*dq_args),
               "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_mma(*bwd)}
        parts = []
        for name, fn in mma.items():
            # bf16 builds K1's and flash_bwd_dkv's mma.sync bodies at head
            # dim 256 only, where their Hopper bodies replaced them
            if bodies[name] and (name == "flash_bwd_dq" or D == 256):
                ms = res[name]["mma_ms"] = graph_ms(fn)
                parts.append(f"{name} {ms:.4f} ms against its Hopper body "
                             f"{res[name]['ms']:.4f} ms ({ms / res[name]['ms']:.2f}x)")
        if bodies["flash_bwd_dq"]:
            delta_ms = graph_ms(lambda: (out.float() * do.float()).sum(-1))
            parts.append(f"the separate delta pass the backward no longer runs "
                         f"{delta_ms:.4f} ms")
        if parts:
            print(f"controls at {CALL_NAMES[call]}: the mma.sync bodies (q and k "
                  f"rotated in the kernel) " + "; ".join(parts) + f" [{card}]",
                  flush=True)
    dq_ms = res["flash_bwd_dq"]["ms"]
    pair = dq_ms + res["flash_bwd_dkv"]["ms"]
    print(f"library at {CALL_NAMES[call]}: " + "; ".join(lib_lines), flush=True)
    if "bwd" in lib and "fwd" in lib:
        print(f"against the library at {CALL_NAMES[call]} (its graph-replay times): "
              f"K1 {res['flash_fwd']['ms'] / lib['fwd'][0]:.2f}x its forward; the K2 "
              f"pair (delta inside flash_bwd_dq) {pair:.4f} ms, "
              f"{pair / lib['bwd'][0]:.2f}x its backward [{card}]", flush=True)
    return res


def ptxas_report():
    """The registers and spills that ptxas reported (-Xptxas=-v) for each
    flash body of the library in use, one line a kernel, demangled where
    c++filt is found."""
    import re
    import shutil
    from lxt_tpu_torch.ops import _build
    found, name = {}, None
    for line in _build.log_path().read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None or "flash" not in name:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            found.setdefault(name, {})["spills"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.setdefault(name, {})["registers"] = int(m.group(1))
    names = list(found)
    if shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(out) == len(names):
            names = [n.split("(")[0] for n in out]
    return [f"ptxas {shown}: {info.get('registers')} registers, "
            f"{info.get('spills', ('?', '?'))[0]} bytes spill stores, "
            f"{info.get('spills', ('?', '?'))[1]} bytes spill loads"
            for shown, info in zip(names, found.values())]


def phase_kernels(card):
    import torch
    failures = []
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for i, (name, case) in enumerate(CASES.items()):
            res = compare_kernels(case, dtype, seed=i)
            ok = all(err <= bound for err, bound, _ in res.values())
            if not ok:
                failures.append(f"kernel case {name} {dtype}")
            print(f"kernel case {str(dtype)[6:]:8s} {name:22s} " + " ".join(
                f"{k} {e:.3g}/{b:.3g}" for k, (e, b, _) in res.items())
                + (" PASS" if ok else " FAIL"), flush=True)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for i, (name, (B, H, Hkv, T, D, opt)) in enumerate(RING_CASES.items()):
            worst, ok = {}, True
            for q_start, k_start in ring_pairs(T):
                step = dict(opt, q_start=q_start, k_start=k_start, dlse=True)
                res = compare_kernels((B, H, Hkv, T, D, step), dtype, seed=100 + i)
                for key, (err, bnd, _) in res.items():
                    ok = ok and err <= bnd
                    worst[key] = max(worst.get(key, (0.0, 1.0)), (err, bnd),
                                     key=lambda eb: eb[0] / eb[1])
            if not ok:
                failures.append(f"kernel case {name} {dtype}")
            print(f"kernel case {str(dtype)[6:]:8s} {name:22s} over "
                  f"{len(ring_pairs(T))} ring-step offsets with dlse, worst: "
                  + " ".join(f"{k} {e:.3g}/{b:.3g}" for k, (e, b) in worst.items())
                  + (" PASS" if ok else " FAIL"), flush=True)
    errs = {}
    for call, case in CALLS.items():
        res = compare_kernels(case, torch.bfloat16, seed=99)
        ok = all(err <= bound for err, bound, _ in res.values())
        if not ok:
            failures.append(f"kernel case {call} call")
        print(f"kernel case bfloat16 {call} call {CALL_NAMES[call]}: " + " ".join(
            f"{k} {e:.3g}/{b:.3g}" for k, (e, b, _) in res.items())
            + (" PASS" if ok else " FAIL"), flush=True)
        if call == "main":
            abs_err = {k: m for k, (_, _, m) in res.items()}
            errs = {"flash_fwd": max(abs_err["out"], abs_err["lse"]),
                    "flash_bwd_dq": max(abs_err["dq"], abs_err["delta"]),
                    "flash_bwd_dkv": max(abs_err["dk"], abs_err["dv"]),
                    "rope_rotate": max(abs_err["rope"], abs_err["rope_view"])}
    timing = {call: time_call(call, card) for call in CALLS}
    return failures, errs, timing


def attribute(params, cfg, ids, impl, remat, family="llama", token=None,
              composite=None):
    """One heatmap per example: (logits at the last position, relevance),
    through the family's embedding and forward under ``composite``
    (default AttnLRP); the target is the argmax logit at the last
    position, or ``token``'s."""
    import lxt_tpu_torch
    from lxt_tpu_torch.models.registry import FAMILIES
    fns = FAMILIES[family]
    held = {}

    def target(x):
        logits = fns["forward"](params, cfg, x, composite or lxt_tpu_torch.attnlrp,
                                remat=remat, logits_at=-1,
                                attn_impl=impl).logits
        held["logits"] = logits.detach()
        return lxt_tpu_torch.select_logit(logits, token=token)

    _, rel = lxt_tpu_torch.input_relevance(target, fns["embed"](params, ids, cfg))
    return held["logits"], rel


# the kernels that run their Hopper bodies (and read an operand rotated by
# the rotation pass) in bf16 at each head dim; none in float32 and float16
HOPPER_BODIES = {D: ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                 for D in (64, 128, 256)}


def expected_launches(L, remat, hopper=(), forwards=1, pulls=1):
    """Flash launches of ``forwards`` forwards and ``pulls`` backward pulls
    (one attribution: one of each): K1 once a layer a forward (and a pull,
    with remat, whose recompute runs the forward again) and each K2 half
    once a layer a pull; the rotation pass once before each launch of a
    kernel in ``hopper`` (those running their Hopper bodies): k before K1
    and flash_bwd_dq, q before flash_bwd_dkv."""
    counts = {"flash_fwd": (forwards + (pulls if remat else 0)) * L,
              "flash_bwd_dq": pulls * L, "flash_bwd_dkv": pulls * L}
    return {**counts, "rope_rotate": sum(counts[n] for n in hopper)}


def main_weights():
    """The main path's float32 model (TinyLlama-1.1B widths, full depth),
    random weights from seed 0, and a batch 1 x SEQ request from the same
    generator: phases 5-6's, and phase 11's again."""
    import torch
    from lxt_tpu_torch.models import llama
    cfg = llama.LlamaConfig(**MODEL, dtype="float32")
    gen = torch.Generator("cuda").manual_seed(0)
    params = llama.init_params(cfg, gen)
    ids = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=gen, device="cuda")
    return cfg, params, ids


def phase_parity(card):
    """float32 main path: kernels against the einsum path."""
    import torch
    from lxt_tpu_torch.ops import flash_attention as fa
    failures = []
    cfg, params, ids = main_weights()
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
    if rose != expected_launches(cfg.num_layers, remat=False):
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
    want = expected_launches(cfg.num_layers, remat=False, hopper=HOPPER_BODIES[64])
    if launches != {n: REQUESTS * c for n, c in want.items()}:
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
    # control: the same bf16 model through the einsum attention path
    _, rel16_e = attribute(params, cfg, ids1, "einsum", False)
    div_e = nl2(rel16_e.float(), rel32)
    print(f"main path bf16 vs float32 relevance at B1x{SEQ}, kernels: "
          f"normalized L2 {div:.4g} (bar {DIVERGENCE_BAR}; the bf16 einsum "
          f"path: {div_e:.4g})", flush=True)
    if not (math.isfinite(div) and div <= DIVERGENCE_BAR):
        failures.append("bf16 divergence")

    # float16 through the kernels' float16 bodies (mma.sync: the rotation
    # runs inside them)
    cfg_h = llama.LlamaConfig(**MODEL, dtype="float16")
    params_h = cast(params32, torch.float16)
    fa.reset_launches()
    _, rel_h = attribute(params_h, cfg_h, ids1, "auto", False)
    torch.cuda.synchronize()
    launches_h = dict(fa.launches)
    div_h = nl2(rel_h.float(), rel32)
    want_h = expected_launches(cfg_h.num_layers, remat=False)
    print(f"main path float16 vs float32 relevance at B1x{SEQ}, kernels: "
          f"normalized L2 {div_h:.4g} (bar {DIVERGENCE_BAR}); launches "
          f"{launches_h} (expected {want_h}) [{card}]", flush=True)
    if not (math.isfinite(div_h) and div_h <= DIVERGENCE_BAR):
        failures.append("float16 divergence")
    if launches_h != want_h:
        failures.append(f"float16 launches {launches_h}")
    return failures, launches


def phase_k3(card):
    """K3 against its plain version: bit-exact on every case, all three
    dtypes; then times at the wg and wd shapes (bf16, the main path's
    dtype)."""
    import torch
    from lxt_tpu_torch.ops import quant
    failures, err_max = [], 0.0
    gen = torch.Generator("cuda").manual_seed(7)

    def weight(shape):
        return 0.02 * torch.randn(shape, generator=gen, device="cuda")

    for name, (shape, block) in K3_CASES.items():
        qt = quant.quantize(weight(shape), "nf4", block=block)
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            got = quant.nf4_dequant(qt.q, qt.scale, qt.block, dtype)
            want = quant.nf4_dequant_ref(qt.q, qt.scale, qt.block, dtype)
            torch.cuda.synchronize()
            ok = got.dtype == want.dtype and got.shape == want.shape
            err = (got.float() - want.float()).abs().max().item() if ok else math.inf
            ok = ok and torch.equal(got, want)
            err_max = max(err_max, err)
            if not ok:
                failures.append(f"K3 case {name} {dtype}")
            print(f"K3 case {str(dtype)[6:]:8s} {name:22s} block {qt.block}: "
                  f"max abs err {err:.3g}, bit-exact {ok}"
                  + (" PASS" if ok else " FAIL"), flush=True)
            del got, want
    times = {}
    for name in K3_TIMED:
        shape, block = K3_CASES[name]
        # four weights in turn: their 4 x 33 MB of codes and scales overflow
        # the 50 MB L2, so each launch reads its inputs cold, as a layer does
        qts = [quant.quantize(weight(shape), "nf4", block=block) for _ in range(4)]
        turn = itertools.cycle(qts)

        def kern():
            qt = next(turn)
            quant.nf4_dequant(qt.q, qt.scale, qt.block, torch.bfloat16)

        def plain():
            qt = next(turn)
            quant.nf4_dequant_ref(qt.q, qt.scale, qt.block, torch.bfloat16)

        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
        K, N = shape
        moved = K * N // 2 + K // block * N * 4 + K * N * 2
        times[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                       "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                       "bound_by": "bytes", "library_ms": None, "library": None}
        t = times[name]
        rate = moved / (t["ms"] * 1e-3)
        print(f"K3 time {name} bf16: kernel {t['ms']:.4f} ms "
              f"({rate / 1e9:.0f} GB/s, {rate / HBM_BYTES_PER_S:.0%} of "
              f"3.35 TB/s; bound {t['bound_ms']:.4f} ms, bytes), plain "
              f"{t['plain_ms']:.4f} ms; no PyTorch call computes it [{card}]",
              flush=True)
        del qts
    return failures, err_max, times


def serve_rate(fn, requests):
    """Heatmaps/s of ``fn`` (one batch-1 request -> relevance) over
    ``requests``, host clock around synchronised work; and the relevances."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rels = [fn(ids) for ids in requests]
    torch.cuda.synchronize()
    return len(requests) / (time.perf_counter() - t0), rels


def phase_nf4_8b(card):
    """The NF4 path at Llama-3-8B width and depth, then the dense control."""
    import torch
    from lxt_tpu_torch.models import llama
    from lxt_tpu_torch.ops import flash_attention as fa
    from lxt_tpu_torch.ops import quant
    failures = []
    cfg = llama.LlamaConfig(**LLAMA3_8B, dtype="bfloat16")
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator("cuda").manual_seed(8),
                               quantize_bits="nf4")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    qbytes = sum(t.numel() * t.element_size() for n in PROJECTIONS
                 for t in (params["layers"][n].q, params["layers"][n].scale))
    gen = torch.Generator("cuda").manual_seed(9)
    requests = [torch.randint(0, cfg.vocab_size, (1, SEQ_8B), generator=gen,
                              device="cuda") for _ in range(REQUESTS)]

    def run(p):
        return lambda ids: attribute(p, cfg, ids, "auto", remat=True)[1]

    run(params)(requests[0])  # warm-up
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    quant.reset_launches()
    rate, rels = serve_rate(run(params), requests)
    launches = {**fa.launches, **quant.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    per = {n: c / REQUESTS for n, c in launches.items()}
    # per layer: K1 in the forward and the recompute; K3 for the 7
    # projections in the forward and the backward, and for 6 in the
    # recompute, which stops before wd (its backward needs only codes)
    want = dict(expected_launches(L, remat=True, hopper=HOPPER_BODIES[128]),
                nf4_dequant=20 * L)
    ok = all(r.shape == (1, SEQ_8B) and bool(torch.isfinite(r).all())
             for r in rels)
    print(f"NF4 Llama-3-8B width L{L} B1x{SEQ_8B} bf16 remat: init and "
          f"quantize {t_init:.1f} s, nf4 codes and scales "
          f"{qbytes / 2**30:.2f} GiB; {REQUESTS} attributions, {rate:.4f} "
          f"heatmaps/s ({1 / rate:.3f} s each), launches per attribution "
          f"{per} (expected {want}), relevance finite and [1, {SEQ_8B}]: {ok}, "
          f"peak device memory {peak:.2f} GiB [{card}]", flush=True)
    if not ok:
        failures.append("NF4 8B relevance not finite or misshapen")
    if per != want:
        failures.append(f"NF4 8B launches per attribution {per}")

    # dense control: every projection plainly dequantized to bf16, one
    # layer at a time (the plain version's int64 indices for a whole
    # stacked wg would take ~15 GB)
    dense = dict(params, layers=dict(params["layers"]))
    for name in PROJECTIONS:
        qt = params["layers"][name]
        w = torch.empty(qt.shape, dtype=torch.bfloat16, device="cuda")
        for i in range(L):
            w[i] = quant.nf4_dequant_ref(qt.q[i], qt.scale[i], qt.block,
                                         torch.bfloat16)
        dense["layers"][name] = w
    run(dense)(requests[0])  # warm-up
    torch.cuda.reset_peak_memory_stats()
    rate_d, rels_d = serve_rate(run(dense), requests)
    peak_d = torch.cuda.max_memory_allocated() / 2**30
    d = max(nl2(a, b) for a, b in zip(rels_d, rels))
    print(f"NF4 Llama-3-8B dense control (bf16 weights, plainly dequantized): "
          f"{rate_d:.4f} heatmaps/s, peak device memory {peak_d:.2f} GiB "
          f"(NF4 weights still resident); relevance against the NF4 run: "
          f"normalized L2 {d:.3g} (bar {DENSE_BAR}) [{card}]", flush=True)
    if not (math.isfinite(d) and d <= DENSE_BAR):
        failures.append("NF4 8B dense control")
    return failures, launches


def phase_gemma(card):
    """Gemma-3-4B's text model: the float32 gates at reduced depth, then
    bf16 at full width and depth."""
    import torch
    import lxt_tpu_torch
    from lxt_tpu_torch.models import gemma3
    from lxt_tpu_torch.models.registry import AttributionModel
    from lxt_tpu_torch.ops import flash_attention as fa
    failures = []
    fam = "gemma3_text"
    cfg = gemma3.Gemma3Config(**dict(GEMMA3_4B, num_layers=GEMMA_PARITY_LAYERS))
    gen = torch.Generator("cuda").manual_seed(12)
    params = gemma3.init_params(cfg, gen)
    ids = torch.randint(0, cfg.vocab_size, (1, SEQ_GEMMA_PARITY), generator=gen,
                        device="cuda")
    fa.reset_launches()
    logits_k, rel_k = attribute(params, cfg, ids, "auto", False, fam)
    torch.cuda.synchronize()
    rose = dict(fa.launches)
    logits_e, rel_e = attribute(params, cfg, ids, "einsum", False, fam)
    d_logits, d_rel = nl2(logits_k, logits_e), nl2(rel_k, rel_e)
    finite = bool(torch.isfinite(rel_k).all() and torch.isfinite(logits_k).all())
    want = expected_launches(cfg.num_layers, remat=False)
    print(f"Gemma-3-4B width float32 L{cfg.num_layers} (layer types "
          f"{''.join('L' if s else 'G' for s in gemma3.layer_sliding_flags(cfg))}) "
          f"B1x{SEQ_GEMMA_PARITY}: kernels vs einsum normalized L2 logits "
          f"{d_logits:.3g}, relevance {d_rel:.3g} (bar {PARITY_BAR}); launches "
          f"per attribution {rose} (expected {want}) [{card}]", flush=True)
    if not (finite and d_logits <= PARITY_BAR and d_rel <= PARITY_BAR):
        failures.append("Gemma float32 parity")
    if rose != want:
        failures.append(f"Gemma float32 launches {rose}")
    del logits_e, rel_e
    params16 = {k: ({n: t.to(torch.bfloat16) for n, t in v.items()}
                    if isinstance(v, dict) else v.to(torch.bfloat16))
                for k, v in params.items()}
    del params
    _, rel16 = attribute(params16, cfg, ids, "auto", False, fam)
    div = nl2(rel16.float(), rel_k)
    print(f"Gemma-3-4B width bf16 vs float32 relevance L{cfg.num_layers} "
          f"B1x{SEQ_GEMMA_PARITY}, kernels: normalized L2 {div:.4g} (bar "
          f"{DIVERGENCE_BAR}) [{card}]", flush=True)
    if not (math.isfinite(div) and div <= DIVERGENCE_BAR):
        failures.append("Gemma bf16 divergence")
    del params16
    torch.cuda.empty_cache()

    cfg = gemma3.Gemma3Config(**GEMMA3_4B)
    t0 = time.perf_counter()
    params = gemma3.init_params(cfg, gen, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params["layers"].values()) + params["embed"].numel()
    requests = [torch.randint(0, cfg.vocab_size, (1, SEQ_GEMMA), generator=gen,
                              device="cuda") for _ in range(REQUESTS)]

    def run(ids):
        return attribute(params, cfg, ids, "auto", False, fam)[1]

    run(requests[0])  # warm-up
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    rate, rels = serve_rate(run, requests)
    launches = dict(fa.launches)
    per = {n: c / REQUESTS for n, c in launches.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = expected_launches(cfg.num_layers, remat=False, hopper=HOPPER_BODIES[256])
    ok = all(r.shape == (1, SEQ_GEMMA) and bool(torch.isfinite(r).all()) for r in rels)
    print(f"Gemma-3-4B L{cfg.num_layers} B1x{SEQ_GEMMA} bf16 remat off: "
          f"{n_params / 1e9:.3f} B parameters, init {t_init:.1f} s; {REQUESTS} "
          f"attributions, {rate:.4f} heatmaps/s ({1 / rate:.4f} s each), "
          f"launches per attribution {per} (expected {want}), relevance "
          f"finite and [1, {SEQ_GEMMA}]: {ok}, peak device memory {peak:.2f} "
          f"GiB [{card}]", flush=True)
    if not ok:
        failures.append("Gemma relevance not finite or misshapen")
    if per != want:
        failures.append(f"Gemma launches per attribution {per}")

    # latent relevance at full width and depth: one backward on the same
    # weights and the first request, against its attribution
    model = AttributionModel(fam, cfg, params, lxt_tpu_torch.attnlrp, remat=False)
    model.attribute_latent(requests[0])  # warm-up
    torch.cuda.reset_peak_memory_stats()
    (_, in_rel, latent), latent_launches, secs = counted(
        lambda: model.attribute_latent(requests[0]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    d = nl2(in_rel, rels[0])
    shape = (cfg.num_layers, 1, SEQ_GEMMA, cfg.hidden_size)
    finite = bool(torch.isfinite(latent).all())
    ok = (tuple(latent.shape) == shape and finite and d <= LATENT_BAR
          and latent_launches == want)
    print(f"Gemma-3-4B attribute_latent L{cfg.num_layers} B1x{SEQ_GEMMA} bf16: latent "
          f"{list(latent.shape)} finite {finite}, {secs:.4f} s, input relevance "
          f"against the attribution's normalized L2 {d:.3g} (bar {LATENT_BAR}), "
          f"launches {latent_launches} (expected {want}), peak device memory "
          f"{peak:.2f} GiB" + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    if not ok:
        failures.append("Gemma attribute_latent")
    return failures, launches


def ring_weights(layers, dtype):
    """Phase 10's model: Llama-3-8B widths at ``layers``, random weights
    from RING_SEED drawn on the card (the same on every process)."""
    import torch
    from lxt_tpu_torch.models import llama
    cfg = llama.LlamaConfig(**dict(LLAMA3_8B, num_layers=layers), dtype=dtype)
    return cfg, llama.init_params(cfg, torch.Generator("cuda").manual_seed(RING_SEED))


def ring_ids(T, vocab):
    import torch
    gen = torch.Generator("cuda").manual_seed(RING_SEED + T)
    return torch.randint(0, vocab, (1, T), generator=gen, device="cuda")


def cast(params, dtype):
    return {k: ({n: t.to(dtype) for n, t in v.items()} if isinstance(v, dict)
                else v.to(dtype)) for k, v in params.items()}


def ring_rank(rank, store, out_dir, tokens):
    """One process of phase 10: the gate runs (float32, then the same
    weights in bf16) and the driven bf16 run through
    attribute_sequence_parallel over a gloo group, each explaining the
    logit of its ``tokens`` entry at the last position; writes its results
    to ``out_dir``/rank<r>.pt."""
    import functools
    import torch
    import torch.distributed as dist
    import lxt_tpu_torch
    from lxt_tpu_torch.models import llama
    from lxt_tpu_torch.ops import flash_attention as fa
    from lxt_tpu_torch.ops import quant
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    # the host's cores shared out: more threads a process oversubscribe them
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (RING_WORLD + 1)))
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=RING_WORLD)
    try:
        forward = functools.partial(llama.forward, remat=False)

        def run(cfg, params, ids, token):
            return lxt_tpu_torch.attribute_sequence_parallel(
                forward, params, cfg, llama.embed(params, ids), lxt_tpu_torch.attnlrp,
                token=token)

        res = {}
        layers, T = RING_GATE
        cfg, params = ring_weights(layers, "float32")
        ids = ring_ids(T, cfg.vocab_size)
        res["value32"], res["rel32"] = run(cfg, params, ids, tokens["rel32"])
        params = cast(params, torch.bfloat16)
        cfg = llama.LlamaConfig(**dict(LLAMA3_8B, num_layers=layers), dtype="bfloat16")
        res["value16"], res["rel16"] = run(cfg, params, ids, tokens["rel32"])
        del params
        torch.cuda.empty_cache()

        layers, T = RING_DRIVEN
        cfg, params = ring_weights(layers, "bfloat16")
        ids = ring_ids(T, cfg.vocab_size)
        run(cfg, params, ids, tokens["rel"])  # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        quant.reset_launches()
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            res["value"], res["rel"] = run(cfg, params, ids, tokens["rel"])
        torch.cuda.synchronize()
        res["seconds"] = (time.perf_counter() - t0) / REQUESTS
        res["launches"] = {**fa.launches, **quant.launches}
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        dist.barrier()
        torch.save({k: v.cpu() if torch.is_tensor(v) else v for k, v in res.items()},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_ring(card):
    """Phase 10: the ring on the card. The single-process kernel-path
    references (float32 at the gate's size, bf16 at the driven size) in
    this process, then RING_WORLD processes over gloo on the one card. Each
    comparison explains one token, the reference's argmax at the last
    position: in bf16 the two largest logits can tie, and the argmax then
    depends on the sum order."""
    import multiprocessing
    import torch
    from lxt_tpu_torch.ops import flash_attention as fa
    failures = []
    refs, tokens = {}, {}
    for key, (layers, T), dtype in (("rel32", RING_GATE, "float32"),
                                    ("rel", RING_DRIVEN, "bfloat16")):
        cfg, params = ring_weights(layers, dtype)
        ids = ring_ids(T, cfg.vocab_size)
        logits, _ = attribute(params, cfg, ids, "auto", remat=False)
        tokens[key] = int(logits[0, -1].float().argmax())
        refs[key] = attribute(params, cfg, ids, "auto", remat=False,
                              token=tokens[key])[1].float().cpu()
        del params, logits
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=ring_rank,
                             args=(r, os.path.join(tmp, "store"), tmp, tokens))
                 for r in range(RING_WORLD)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(0.0, RING_TIMEOUT - (time.perf_counter() - t0)))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if hung or codes != [0] * RING_WORLD:
            return [f"ring processes: hung {hung}, exit codes {codes}"], {}
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(RING_WORLD)]
    r0 = ranks[0]
    same = all(torch.equal(r["rel"], r0["rel"]) and torch.equal(r["rel32"], r0["rel32"])
               for r in ranks)
    d32 = nl2(r0["rel32"], refs["rel32"])
    d16 = nl2(r0["rel16"].float(), r0["rel32"])
    layers, T = RING_GATE
    print(f"ring Llama-3-8B width L{layers} B1x{T} over {RING_WORLD} processes "
          f"(gloo, one card), explaining token {tokens['rel32']} at the last "
          f"position: float32 ring vs the single-process float32 kernel "
          f"path relevance normalized L2 {d32:.3g} (bar {PARITY_BAR}); bf16 ring vs "
          f"float32 ring {d16:.4g} (bar {DIVERGENCE_BAR}); every process holds the "
          f"same gathered relevance: {same} [{card}]", flush=True)
    if not (same and d32 <= PARITY_BAR and d16 <= DIVERGENCE_BAR):
        failures.append("ring gates")
    layers, T = RING_DRIVEN
    Tl = T // RING_WORLD
    # the ring steps whose kv shard the causal mask leaves some visible
    # pair of, per process (a brute-force count of the mask)
    steps = [sum(fa.visible_pairs(Tl, None, True, q_start=r * Tl,
                                  k_start=((r - s) % RING_WORLD) * Tl) > 0
                 for s in range(RING_WORLD)) for r in range(RING_WORLD)]
    want = [{"flash_fwd": REQUESTS * n * layers, "flash_bwd_dq": REQUESTS * n * layers,
             "flash_bwd_dkv": REQUESTS * n * layers, "rope_rotate": 0, "nf4_dequant": 0}
            for n in steps]
    finite = all(r["rel"].shape == (1, T) and bool(torch.isfinite(r["rel"]).all())
                 for r in ranks)
    d = nl2(r0["rel"], refs["rel"])
    print(f"ring driven run: Llama-3-8B width L{layers} bf16 B1x{T} ({Tl} per "
          f"process, remat off), {REQUESTS} attributions explaining token "
          f"{tokens['rel']}: relevance finite and [1, {T}]: {finite}, against the "
          f"single-process bf16 kernel path normalized L2 {d:.4g} (bar "
          f"{RING_BF16_BAR}); launches per process {[r['launches'] for r in ranks]} "
          f"(expected {want}: {steps} visible steps of {RING_WORLD} x {layers} "
          f"layers x {REQUESTS}); peak device memory per process "
          f"{[round(r['peak_gib'], 2) for r in ranks]} GiB; wall time per "
          f"attribution through gloo's host staging "
          f"{[round(r['seconds'], 3) for r in ranks]} s (printed, not claimed) "
          f"[{card}]", flush=True)
    if not (finite and same and d <= RING_BF16_BAR):
        failures.append("ring driven relevance")
    if [r["launches"] for r in ranks] != want:
        failures.append("ring launches")
    return failures, {n: sum(r["launches"][n] for r in ranks) for n in r0["launches"]}


def counted(fn):
    """``fn()``'s result, its flash launches (the counts set to 0 just
    before it and read just after) and its seconds on the host's clock
    around synchronised work."""
    import torch
    from lxt_tpu_torch.ops import flash_attention as fa
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(fa.launches), time.perf_counter() - t0


def api_maps(card, label, shared, separate, bar, want):
    """One multi-target call against separate attributions: ``shared()``
    (values, relevance [K, B, T]) through one forward and K pulls, gated
    on its launches (``want``); ``separate(k)`` the k-th map's own
    attribution, each within ``bar`` normalized L2. Returns (failures,
    launches)."""
    import torch
    (values, rel), launches, secs = counted(shared)
    maps = []
    t0 = time.perf_counter()
    for k in range(rel.shape[0]):
        maps.append(separate(k)[1])
    torch.cuda.synchronize()
    t_sep = time.perf_counter() - t0
    errs = [nl2(rel[k], m) for k, m in enumerate(maps)]
    n = rel.shape[0] * rel.shape[1]
    ok = (all(math.isfinite(e) and e <= bar for e in errs)
          and bool(torch.isfinite(rel).all()))
    print(f"api {label}: {rel.shape[0]} maps of [{rel.shape[1]}, {rel.shape[2]}] "
          f"through one forward: {n / secs:.3f} maps/s ({secs:.4f} s) against "
          f"{rel.shape[0]} separate attributions {n / t_sep:.3f} maps/s "
          f"({t_sep:.4f} s); normalized L2 of each map against its separate "
          f"attribution {[f'{e:.3g}' for e in errs]} (bar {bar}); launches "
          f"{launches} (expected {want})" + (" PASS" if ok and launches == want
                                              else " FAIL") + f" [{card}]",
          flush=True)
    failures = [] if ok else [f"api {label} maps"]
    if launches != want:
        failures.append(f"api {label} launches {launches}")
    return failures, launches


def site_target(pos, tok, contrastive):
    """The explicit target of one (position, token) site, as
    multi_site_relevance seeds it: the logit, or its margin over the
    strongest other token at the position."""
    import torch

    def target(logits):
        row = logits[:, pos, :]
        value = row[:, tok]
        if contrastive:
            masked = row.detach().float().clone()
            masked[:, tok] = -math.inf
            value = value - row.gather(-1, masked.argmax(-1, keepdim=True))[:, 0]
        return value.sum()

    return target


def phase_api(card):
    """Phase 11: the attribution API at TinyLlama-1.1B width and depth
    through the kernels, remat off, on phases 5-6's weights (float32, and
    cast to bf16): top-k, multi-token and multi-site maps through one
    forward and K pulls against separate attributions, latent relevance,
    CP-LRP conservation per layer, a faithfulness report and Integrated
    Gradients. Returns (failures, the launches of its driven calls)."""
    import torch
    import lxt_tpu_torch
    from lxt_tpu_torch.models import llama
    from lxt_tpu_torch.models.registry import AttributionModel
    failures, total = [], {}

    def add(launches):
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c

    cfg32, params32, ids1 = main_weights()
    L = cfg32.num_layers
    cfg16 = llama.LlamaConfig(**MODEL, dtype="bfloat16")
    models = {"bf16": AttributionModel("llama", cfg16, cast(params32, torch.bfloat16),
                                       lxt_tpu_torch.attnlrp, remat=False),
              "f32": AttributionModel("llama", cfg32, params32,
                                      lxt_tpu_torch.attnlrp, remat=False)}
    gen = torch.Generator("cuda").manual_seed(11)
    batch = {"bf16": torch.randint(0, cfg16.vocab_size, (SERVE_BATCH, SEQ),
                                   generator=gen, device="cuda"), "f32": ids1}
    hopper = {"bf16": HOPPER_BODIES[64], "f32": ()}
    bars = {"bf16": API_BF16_BAR, "f32": API_F32_BAR}
    positions, tokens = (list(x) for x in zip(*API_SITES))
    for key, model in models.items():
        ids, B = batch[key], batch[key].shape[0]
        label = f"{key} B{B}x{SEQ}"
        model.attribute_topk(ids, API_K)  # warm-up
        held = {}

        def topk():
            held["toks"], values, rel = model.attribute_topk(ids, API_K)
            return values, rel

        want = expected_launches(L, False, hopper[key], pulls=API_K)
        f, launches = api_maps(
            card, f"attribute_topk k={API_K} {label}", topk,
            lambda k: model.attribute(ids, token=held["toks"][k]), bars[key], want)
        failures += f
        add(launches)
        want = expected_launches(L, False, hopper[key], pulls=len(API_TOKENS))
        f, launches = api_maps(
            card, f"attribute_multi tokens {list(API_TOKENS)} {label}",
            lambda: model.attribute_multi(ids, list(API_TOKENS)),
            lambda k: model.attribute(ids, token=[API_TOKENS[k]] * B), bars[key], want)
        failures += f
        add(launches)
        for contrastive in (False, True):
            want = expected_launches(L, False, hopper[key], pulls=len(API_SITES))
            f, launches = api_maps(
                card, f"multi_site_relevance sites {list(zip(positions, tokens))}"
                f"{' contrastive' if contrastive else ''} {label}",
                lambda: lxt_tpu_torch.multi_site_relevance(
                    lambda e: llama.forward(model.params, model.cfg, e,
                                            lxt_tpu_torch.attnlrp,
                                            remat=False).logits,
                    model.embed(ids), positions, tokens, contrastive=contrastive),
                lambda k: model.attribute(ids, target=site_target(
                    positions[k], tokens[k], contrastive)), bars[key], want)
            failures += f
            add(launches)
        torch.cuda.empty_cache()

    # CP-LRP conservation, f32 B1 x 1024 through the kernels: each layer's
    # total relevance is the target's value
    (value, _, latent), launches, _ = counted(lambda: models["f32"].attribute_latent(
        ids1, composite=lxt_tpu_torch.cp_lrp))
    add(launches)
    sums = latent.double().sum(dim=(1, 2, 3))
    dev = ((sums - float(value)).abs() / abs(float(value))).max().item()
    ok = (math.isfinite(dev) and dev <= CONSERVATION_RTOL
          and launches == expected_launches(L, False))
    print(f"api CP-LRP conservation f32 B1x{SEQ} through the kernels: target "
          f"{float(value):.6g}, per-layer totals {float(sums.min()):.6g} .. "
          f"{float(sums.max()):.6g}, max relative deviation {dev:.3g} (bar "
          f"{CONSERVATION_RTOL}); launches {launches}"
          + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    if not ok:
        failures.append("api CP-LRP conservation")
    del latent
    torch.cuda.empty_cache()

    # latent relevance, bf16 B8 x 1024: one backward
    model, ids = models["bf16"], batch["bf16"]
    del models, params32
    torch.cuda.empty_cache()
    model.attribute_latent(ids)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    (value, in_rel, latent), launches, secs = counted(lambda: model.attribute_latent(ids))
    peak = torch.cuda.max_memory_allocated() / 2**30
    add(launches)
    want = expected_launches(L, False, HOPPER_BODIES[64])
    _, rel = model.attribute(ids)
    d = nl2(in_rel, rel)
    shape = (L, SERVE_BATCH, SEQ, MODEL["hidden_size"])
    ok = (tuple(latent.shape) == shape and bool(torch.isfinite(latent).all())
          and d <= LATENT_BAR and launches == want)
    print(f"api attribute_latent bf16 B{SERVE_BATCH}x{SEQ}: latent {list(latent.shape)} "
          f"finite {bool(torch.isfinite(latent).all())}, {secs:.4f} s, input relevance "
          f"against attribute's normalized L2 {d:.3g} (bar {LATENT_BAR}), launches "
          f"{launches} (expected {want}), peak device memory {peak:.2f} GiB"
          + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    if not ok:
        failures.append("api attribute_latent bf16")
    del latent, in_rel, rel
    torch.cuda.empty_cache()

    # the faithfulness report, bf16 B8 x 1024: one attribution, then
    # 3 x (steps + 1) forwards without a graph
    report, launches, secs = counted(lambda: model.faithfulness(ids, steps=FAITH_STEPS))
    add(launches)
    want = expected_launches(L, False, HOPPER_BODIES[64],
                             forwards=1 + 3 * (FAITH_STEPS + 1))
    finite = all(bool(torch.isfinite(report[o].values).all())
                 for o in ("morf", "lerf", "random"))
    abpc = report["abpc"].float()
    print(f"api faithfulness steps={FAITH_STEPS} bf16 B{SERVE_BATCH}x{SEQ}: "
          f"{secs:.4f} s per report, curves finite {finite}, ABPC mean "
          f"{float(abpc.mean()):.4g} (per example {[round(float(a), 4) for a in abpc]}), "
          f"AOPC MoRF / LeRF / random {float(report['aopc_morf'].float().mean()):.4g} / "
          f"{float(report['aopc_lerf'].float().mean()):.4g} / "
          f"{float(report['aopc_random'].float().mean()):.4g}; launches {launches} "
          f"(expected {want})" + (" PASS" if finite and launches == want else " FAIL")
          + f" [{card}]", flush=True)
    if not finite:
        failures.append("api faithfulness curves not finite")
    if launches != want:
        failures.append(f"api faithfulness launches {launches}")

    # Integrated Gradients under vanilla_gradient, bf16 B8 x 1024, of the
    # argmax logit at the last position
    embeds = model.embed(ids)

    def row(e, composite):
        return llama.forward(model.params, model.cfg, e, composite, remat=False,
                             logits_at=-1).logits[:, -1]

    with torch.no_grad():
        tk = row(embeds, lxt_tpu_torch.attnlrp).argmax(-1, keepdim=True)

    def target(e):
        return row(e, lxt_tpu_torch.vanilla_gradient).gather(-1, tk)[:, 0]

    rel, launches, secs = counted(lambda: lxt_tpu_torch.integrated_gradients(
        target, embeds, steps=IG_STEPS))
    add(launches)
    want = expected_launches(L, False, HOPPER_BODIES[64], forwards=IG_STEPS,
                             pulls=IG_STEPS)
    with torch.no_grad():
        gain = (target(embeds) - target(torch.zeros_like(embeds))).double()
    gap = ((rel.double().sum(-1) - gain).abs() / gain.abs()).cpu()
    finite = bool(torch.isfinite(rel).all())
    print(f"api integrated_gradients steps={IG_STEPS} vanilla_gradient bf16 "
          f"B{SERVE_BATCH}x{SEQ}: {secs:.4f} s ({SERVE_BATCH / secs:.4f} maps/s), "
          f"relevance finite {finite}, completeness gap |sum rel - (f(x) - f(0))| / "
          f"|f(x) - f(0)| mean {float(gap.mean()):.4g}, max {float(gap.max()):.4g} "
          f"(printed, not gated); launches {launches} (expected {want})"
          + (" PASS" if finite and launches == want else " FAIL") + f" [{card}]",
          flush=True)
    if not finite:
        failures.append("api integrated_gradients not finite")
    if launches != want:
        failures.append(f"api integrated_gradients launches {launches}")
    return failures, total


def write_safetensors(path, tensors):
    """A minimal safetensors writer (the card's machine has no safetensors
    package): 8-byte header length, JSON header, raw little-endian data."""
    kinds = {np.dtype(np.float32): "F32", np.dtype(np.uint8): "U8"}
    header, blobs, offset = {}, [], 0
    for name, arr in tensors.items():
        raw = np.ascontiguousarray(arr).tobytes()
        header[name] = {"dtype": kinds[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        f.writelines(blobs)


def bnb_nf4(w):
    """bitsandbytes' 4-bit serialization of one [out, in] weight (flat
    blocks of 64, nearest NF4 code, first element in the high nibble) and
    the values it stands for."""
    from lxt_tpu_torch.ops.quant import NF4_CODE
    blocks = w.reshape(-1, 64)
    absmax = np.abs(blocks).max(axis=1).astype(np.float32)
    idx = np.argmin(np.abs((blocks / absmax[:, None])[..., None] - NF4_CODE),
                    axis=-1).astype(np.uint8)
    values = (NF4_CODE[idx] * absmax[:, None]).reshape(w.shape)
    flat = idx.reshape(-1)
    meta = {"blocksize": 64, "quant_type": "nf4", "dtype": "float32",
            "shape": list(w.shape)}
    entries = {"": ((flat[0::2] << 4) | flat[1::2]).reshape(-1, 1),
               ".absmax": absmax, ".quant_map": NF4_CODE.copy(),
               ".quant_state.bitsandbytes__nf4": np.frombuffer(
                   json.dumps(meta).encode(), np.uint8).copy()}
    return entries, values


def phase_from_pretrained(card):
    """A tiny bitsandbytes-NF4 Llama checkpoint, loaded on the card."""
    import torch
    import lxt_tpu_torch
    from lxt_tpu_torch.ops import quant
    failures = []
    rng = np.random.default_rng(10)
    D, I, V = TINY["hidden_size"], TINY["intermediate_size"], TINY["vocab_size"]
    kv = TINY["num_key_value_heads"] * D // TINY["num_attention_heads"]

    def w(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    state = {"model.embed_tokens.weight": w(V, D), "lm_head.weight": w(V, D),
             "model.norm.weight": 1 + w(D)}
    values = {}
    for i in range(TINY["num_hidden_layers"]):
        p = f"model.layers.{i}."
        state[p + "input_layernorm.weight"] = 1 + w(D)
        state[p + "post_attention_layernorm.weight"] = 1 + w(D)
        for name, shape in (("self_attn.q_proj", (D, D)), ("self_attn.k_proj", (kv, D)),
                            ("self_attn.v_proj", (kv, D)), ("self_attn.o_proj", (D, D)),
                            ("mlp.gate_proj", (I, D)), ("mlp.up_proj", (I, D)),
                            ("mlp.down_proj", (D, I))):
            entries, values[p + name] = bnb_nf4(w(*shape))
            state.update({p + name + ".weight" + k: v for k, v in entries.items()})
    ids = rng.integers(0, V, (1, 256))
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(TINY, f)
        write_safetensors(os.path.join(tmp, "model.safetensors"), state)
        model = lxt_tpu_torch.from_pretrained(tmp, device="cuda")
        cpu_model = lxt_tpu_torch.from_pretrained(tmp, device="cpu")
    wq = model.params["layers"]["wq"]
    leaves_ok = all(isinstance(model.params["layers"][n], quant.QuantizedTensor)
                    and model.params["layers"][n].bits == "nf4"
                    and model.params["layers"][n].q.is_cuda for n in PROJECTIONS)
    got_wq = quant.nf4_dequant(wq.q[0], wq.scale[0], wq.block, torch.float32)
    exact = torch.equal(got_wq.cpu(), torch.from_numpy(
        values["model.layers.0.self_attn.q_proj"].T.copy()))
    quant.reset_launches()
    _, rel = model.attribute(ids)
    torch.cuda.synchronize()
    k3 = quant.launches["nf4_dequant"]
    _, rel_cpu = cpu_model.attribute(ids)
    d = nl2(rel.cpu(), rel_cpu)
    ok = (leaves_ok and exact and k3 > 0 and rel.shape == (1, 256)
          and bool(torch.isfinite(rel).all()) and d <= PARITY_BAR)
    print(f"from_pretrained bnb-NF4 Llama checkpoint (L{TINY['num_hidden_layers']} "
          f"D{D}, float32) on the card: QuantizedTensor nf4 leaves {leaves_ok}, "
          f"wq exact against the checkpoint's values {exact}, K3 launches per "
          f"attribution {k3}, relevance finite [1, 256] against the CPU load: "
          f"normalized L2 {d:.3g} (bar {PARITY_BAR})"
          + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    if not ok:
        failures.append("from_pretrained on the card")
    return failures


@contextlib.contextmanager
def recorded_routes():
    """Records the sorted top-K expert ids [N, K] of every router call of
    the Mixtral model while the context is open (one per layer per forward
    with remat off)."""
    from lxt_tpu_torch.models import mixtral
    seen, route = [], mixtral._route

    def recording(*args):
        top_w, top_idx = route(*args)
        seen.append(top_idx.detach().reshape(-1, top_idx.shape[-1]).sort(-1).values)
        return top_w, top_idx

    mixtral._route = recording
    try:
        yield seen
    finally:
        mixtral._route = route


def route_flips(a, b):
    """The share of (layer, token) rows whose top-K expert sets differ."""
    rows = sum(x.shape[0] for x in a)
    return sum(int((x != y).any(-1).sum()) for x, y in zip(a, b)) / rows


def nf4_leaf_bytes(qt):
    return qt.q.numel() * qt.q.element_size() + qt.scale.numel() * 4


def phase_mixtral(card):
    """Phase 12: Mixtral-8x7B's widths. The float32 gates at 2 layers; the
    NF4 run at full depth (three attributions); the dense control at 4
    layers. Returns (failures, the launches of the NF4 run's three
    attributions)."""
    import torch
    from lxt_tpu_torch.models import mixtral
    from lxt_tpu_torch.ops import flash_attention as fa
    from lxt_tpu_torch.ops import quant
    failures, fam = [], "mixtral"
    layers, T = MIXTRAL_GATE
    cfg = mixtral.MixtralConfig(**dict(MIXTRAL_8X7B, num_layers=layers))
    gen = torch.Generator("cuda").manual_seed(13)
    params = mixtral.init_params(cfg, gen)
    ids = torch.randint(0, cfg.vocab_size, (1, T), generator=gen, device="cuda")

    def run(p, impl, c=cfg):
        with recorded_routes() as routes:
            logits, rel = attribute(p, c, ids, impl, False, fam)
        return logits, rel, routes

    fa.reset_launches()
    logits_k, rel_k, routes_k = run(params, "auto")
    torch.cuda.synchronize()
    rose = dict(fa.launches)
    logits_e, rel_e, routes_e = run(params, "einsum")
    d_logits, d_rel = nl2(logits_k, logits_e), nl2(rel_k, rel_e)
    finite = bool(torch.isfinite(rel_k).all() and torch.isfinite(logits_k).all())
    want = expected_launches(layers, remat=False)
    print(f"Mixtral-8x7B width float32 L{layers} B1x{T} ragged: kernels vs einsum "
          f"normalized L2 logits {d_logits:.3g}, relevance {d_rel:.3g} (bar "
          f"{PARITY_BAR}), top-2 sets differing {route_flips(routes_k, routes_e):.3%} "
          f"of (layer, token); launches per attribution {rose} (expected {want}) "
          f"[{card}]", flush=True)
    if not (finite and d_logits <= PARITY_BAR and d_rel <= PARITY_BAR):
        failures.append("Mixtral float32 parity")
    if rose != want:
        failures.append(f"Mixtral float32 launches {rose}")
    del logits_e, rel_e
    logits_d, rel_d, routes_d = run(params, "auto", dataclasses.replace(cfg, moe_impl="dense"))
    d_logits, d_rel = nl2(logits_k, logits_d), nl2(rel_k, rel_d)
    print(f"Mixtral-8x7B width float32 L{layers} B1x{T}, kernels: ragged vs dense "
          f"normalized L2 logits {d_logits:.3g}, relevance {d_rel:.3g} (bar "
          f"{PARITY_BAR}), top-2 sets differing {route_flips(routes_k, routes_d):.3%} "
          f"[{card}]", flush=True)
    if not (d_logits <= PARITY_BAR and d_rel <= PARITY_BAR):
        failures.append("Mixtral ragged vs dense")
    del logits_d, rel_d
    params16 = cast(params, torch.bfloat16)
    del params
    _, rel16, routes16 = run(params16, "auto")
    div = nl2(rel16.float(), rel_k)
    print(f"Mixtral-8x7B width bf16 vs float32 relevance L{layers} B1x{T}, kernels: "
          f"normalized L2 {div:.4g} (bar {DIVERGENCE_BAR}); top-2 expert sets "
          f"differing between the bf16 and float32 runs: "
          f"{route_flips(routes16, routes_k):.3%} of (layer, token) [{card}]",
          flush=True)
    if not (math.isfinite(div) and div <= DIVERGENCE_BAR):
        failures.append("Mixtral bf16 divergence")
    del params16
    torch.cuda.empty_cache()

    # the headline: NF4 on every quantizable leaf at full depth
    cfg = mixtral.MixtralConfig(**MIXTRAL_8X7B)
    L = cfg.num_layers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = mixtral.init_params(cfg, torch.Generator("cuda").manual_seed(14),
                                 dtype=torch.bfloat16, quantize_bits="nf4")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    names = quant.FAMILY_QUANTIZABLE[fam]
    qbytes = sum(nf4_leaf_bytes(params["layers"][n]) for n in names)
    ebytes = sum(nf4_leaf_bytes(params["layers"][n]) for n in mixtral.EXPERT_LEAVES)
    gen = torch.Generator("cuda").manual_seed(15)
    requests = [torch.randint(0, cfg.vocab_size, (1, SEQ_MIXTRAL), generator=gen,
                              device="cuda") for _ in range(REQUESTS)]

    def runner(p, c):
        return lambda ids: attribute(p, c, ids, "auto", True, fam)[1]

    runner(params, cfg)(requests[0])  # warm-up
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    quant.reset_launches()
    mixtral.reset_routing()
    rate, rels = serve_rate(runner(params, cfg), requests)
    launches = {**fa.launches, **quant.launches}
    routing = dict(mixtral.routing)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # K3 per block run (forward and recompute): the four attention
    # projections, the router and three products per non-empty expert
    # group; the backward dequantizes once more for each of the forward's
    reads, groups = routing["host_reads"], routing["nonempty_groups"]
    want = {n: REQUESTS * c for n, c in
            expected_launches(L, remat=True, hopper=HOPPER_BODIES[128]).items()}
    want["nf4_dequant"] = 3 * (5 * reads + 3 * groups) // 2
    ok = all(r.shape == (1, SEQ_MIXTRAL) and bool(torch.isfinite(r).all())
             for r in rels)
    print(f"NF4 Mixtral-8x7B L{L} B1x{SEQ_MIXTRAL} bf16 remat: init and quantize "
          f"{t_init:.1f} s, nf4 codes and scales {qbytes / 2**30:.2f} GiB "
          f"({qbytes / 1e9:.2f} GB; experts {ebytes / 1e9:.2f} GB); {REQUESTS} "
          f"attributions, {rate:.4f} heatmaps/s ({1 / rate:.3f} s each), launches "
          f"over them {launches} (expected {want}; group sizes read {reads} "
          f"times, {groups / reads:.3f} non-empty experts a block), relevance "
          f"finite and [1, {SEQ_MIXTRAL}]: {ok}, peak device memory {peak:.2f} GiB "
          f"[{card}]", flush=True)
    if not ok:
        failures.append("NF4 Mixtral relevance not finite or misshapen")
    if launches != want or reads != 2 * L * REQUESTS:
        failures.append(f"NF4 Mixtral launches {launches}")

    # dense control at MIXTRAL_CONTROL_LAYERS layers: the same NF4 leaves
    # plainly dequantized to bf16, one (layer, expert) slice at a time,
    # against the NF4 run of those layers
    Lc = MIXTRAL_CONTROL_LAYERS
    cfg_c = dataclasses.replace(cfg, num_layers=Lc)
    nf4_c = dict(params, layers={n: t[:Lc] for n, t in params["layers"].items()})
    dense = dict(nf4_c, layers=dict(nf4_c["layers"]))
    for name in names:
        qt = nf4_c["layers"][name]
        w = torch.empty(qt.shape, dtype=torch.bfloat16, device="cuda")
        for idx in itertools.product(*(range(n) for n in qt.q.shape[:-2])):
            w[idx] = quant.nf4_dequant_ref(qt.q[idx], qt.scale[idx], qt.block,
                                           torch.bfloat16)
        dense["layers"][name] = w
    rate_n, rels_n = serve_rate(runner(nf4_c, cfg_c), requests)
    runner(dense, cfg_c)(requests[0])  # warm-up
    rate_d, rels_d = serve_rate(runner(dense, cfg_c), requests)
    d = max(nl2(a, b) for a, b in zip(rels_d, rels_n))
    print(f"NF4 Mixtral-8x7B dense control L{Lc} (bf16 weights, plainly "
          f"dequantized): {rate_d:.4f} heatmaps/s against the NF4 run's "
          f"{rate_n:.4f} at L{Lc}; relevance against it: normalized L2 {d:.3g} "
          f"(bar {DENSE_BAR}) [{card}]", flush=True)
    if not (math.isfinite(d) and d <= DENSE_BAR):
        failures.append("NF4 Mixtral dense control")
    return failures, launches


def phase_gpt2(card):
    """Phase 13: GPT-2 XL under CP-LRP. The float32 gates at 6 layers;
    three bf16 attributions at full depth, batch 8 x 1024, remat off; one
    left-padded batch. Returns (failures, the launches of the three
    attributions)."""
    import torch
    import lxt_tpu_torch
    from lxt_tpu_torch.models import gpt2
    from lxt_tpu_torch.models.registry import AttributionModel
    from lxt_tpu_torch.ops import flash_attention as fa
    failures, fam, comp = [], "gpt2", lxt_tpu_torch.cp_lrp
    cfg = gpt2.GPT2Config(**dict(GPT2_XL, num_layers=GPT2_GATE_LAYERS))
    gen = torch.Generator("cuda").manual_seed(16)
    params = gpt2.init_params(cfg, gen)
    ids = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=gen, device="cuda")
    fa.reset_launches()
    logits_k, rel_k = attribute(params, cfg, ids, "auto", False, fam, composite=comp)
    torch.cuda.synchronize()
    rose = dict(fa.launches)
    logits_e, rel_e = attribute(params, cfg, ids, "einsum", False, fam, composite=comp)
    d_logits, d_rel = nl2(logits_k, logits_e), nl2(rel_k, rel_e)
    finite = bool(torch.isfinite(rel_k).all() and torch.isfinite(logits_k).all())
    want = expected_launches(cfg.num_layers, remat=False)
    print(f"GPT-2 XL width float32 L{cfg.num_layers} B1x{SEQ} CP-LRP: kernels vs "
          f"einsum normalized L2 logits {d_logits:.3g}, relevance {d_rel:.3g} (bar "
          f"{PARITY_BAR}); launches per attribution {rose} (expected {want}) "
          f"[{card}]", flush=True)
    if not (finite and d_logits <= PARITY_BAR and d_rel <= PARITY_BAR):
        failures.append("GPT-2 float32 parity")
    if rose != want:
        failures.append(f"GPT-2 float32 launches {rose}")
    _, rel16 = attribute(cast(params, torch.bfloat16), cfg, ids, "auto", False, fam,
                         composite=comp)
    div = nl2(rel16.float(), rel_k)
    print(f"GPT-2 XL width bf16 vs float32 relevance L{cfg.num_layers} B1x{SEQ}, "
          f"kernels: normalized L2 {div:.4g} (bar {DIVERGENCE_BAR}) [{card}]",
          flush=True)
    if not (math.isfinite(div) and div <= DIVERGENCE_BAR):
        failures.append("GPT-2 bf16 divergence")
    del params, logits_e, rel_e
    torch.cuda.empty_cache()

    cfg = gpt2.GPT2Config(**GPT2_XL)
    L = cfg.num_layers
    params = gpt2.init_params(cfg, gen, dtype=torch.bfloat16)
    requests = [torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SEQ), generator=gen,
                              device="cuda") for _ in range(REQUESTS)]

    def run(ids):
        return attribute(params, cfg, ids, "auto", False, fam, composite=comp)[1]

    run(requests[0])  # warm-up
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rels = [run(ids) for ids in requests]
    torch.cuda.synchronize()
    rate = SERVE_BATCH * REQUESTS / (time.perf_counter() - t0)
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {n: REQUESTS * c for n, c in expected_launches(L, remat=False).items()}
    ok = all(r.shape == (SERVE_BATCH, SEQ) and bool(torch.isfinite(r).all())
             for r in rels)
    print(f"GPT-2 XL L{L} B{SERVE_BATCH}x{SEQ} bf16 remat off CP-LRP, kernels: "
          f"{REQUESTS} attributions, {rate:.3f} heatmaps/s, launches {launches} "
          f"(expected {want}: no rotation pass), relevance finite and "
          f"[{SERVE_BATCH}, {SEQ}]: {ok}, peak device memory {peak:.2f} GiB "
          f"[{card}]", flush=True)
    if not ok:
        failures.append("GPT-2 relevance not finite or misshapen")
    if launches != want:
        failures.append(f"GPT-2 launches {launches}")

    # left padding: row 0 padded by GPT2_PAD, against its tokens unpadded
    model = AttributionModel(fam, cfg, params, comp, remat=False)
    kv_begin = torch.zeros(SERVE_BATCH, dtype=torch.int32, device="cuda")
    kv_begin[0] = GPT2_PAD
    (_, rel_p), rose, _ = counted(lambda: model.attribute(requests[0], kv_begin=kv_begin))
    _, rel_u = model.attribute(requests[0][:1, GPT2_PAD:])
    d = nl2(rel_p[0, GPT2_PAD:].float(), rel_u[0].float())
    pad_zero = bool((rel_p[0, :GPT2_PAD] == 0).all())
    ok = (bool(torch.isfinite(rel_p).all()) and pad_zero and d <= PADDED_BAR
          and rose == expected_launches(L, remat=False))
    print(f"GPT-2 XL left-padded batch B{SERVE_BATCH}x{SEQ} (row 0 kv_begin "
          f"{GPT2_PAD}): relevance finite, 0 on the padding {pad_zero}, row 0 "
          f"against its {SEQ - GPT2_PAD} tokens unpadded: normalized L2 {d:.3g} "
          f"(bar {PADDED_BAR}), launches {rose}" + (" PASS" if ok else " FAIL")
          + f" [{card}]", flush=True)
    if not ok:
        failures.append("GPT-2 left padding")
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
    for line in ptxas_report():
        print(line, flush=True)

    t_start = time.perf_counter()
    failures, errs, timing = phase_kernels(card)
    if "--kernels" in sys.argv[1:]:
        print(f"phase 3 took {time.perf_counter() - t_start:.1f} s; "
              f"failures: {failures}", flush=True)
        return 1 if failures else 0
    f, errs["nf4_dequant"], k3_times = phase_k3(card)
    failures += f
    f, params32, ids1, rel32 = phase_parity(card)
    failures += f
    f, launches = phase_served(card, params32, ids1, rel32)
    failures += f
    del params32, ids1, rel32
    torch.cuda.empty_cache()
    f, nf4_launches = phase_nf4_8b(card)
    failures += f
    launches["nf4_dequant"] = nf4_launches["nf4_dequant"]
    torch.cuda.empty_cache()
    failures += phase_from_pretrained(card)
    torch.cuda.empty_cache()
    f, gemma_launches = phase_gemma(card)
    failures += f
    torch.cuda.empty_cache()
    f, ring_launches = phase_ring(card)
    failures += f
    torch.cuda.empty_cache()
    t_api = time.perf_counter()
    f, api_launches = phase_api(card)
    failures += f
    print(f"phase 11 took {time.perf_counter() - t_api:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    f, mixtral_launches = phase_mixtral(card)
    failures += f
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    f, gpt2_launches = phase_gpt2(card)
    failures += f
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s; phases 3-13 "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1

    # each kernel's numbers at the main path's call (K3: at wg), at the NF4
    # 8B path's call (K3: at wd) and at Gemma-3-4B's two (not K3)
    at = {name: {call: timing[call][name] for call in CALLS if name in timing[call]}
          for name in FLASH}
    at["nf4_dequant"] = {"main": k3_times[K3_TIMED[0]], "8b": k3_times[K3_TIMED[1]]}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library")
    more = ("body", "mma_ms", "library_eager_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errs[name],
         **{key: at[name]["main"][key] for key in keys + more
            if key in at[name]["main"]},
         **{f"at_{call}": {key: at[name][call][key] for key in keys + more
                           if key in at[name][call]}
            for call in CALLS if call != "main" and call in at[name]},
         "launches_8b": nf4_launches[name],
         "launches_gemma": gemma_launches.get(name, 0),
         "launches_ring": ring_launches.get(name, 0),
         "launches_api": api_launches.get(name, 0),
         "launches_mixtral": mixtral_launches.get(name, 0),
         "launches_gpt2": gpt2_launches.get(name, 0)}
        for name, (src, tpu) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
