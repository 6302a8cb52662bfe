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
Mixtral-8x7B at full width and depth in NF4 (the routed expert products),
GPT-2 XL at full depth (no rotary embedding), BERT-base (bidirectional,
right-padded by kv_end), KV-cached decoding (generate, then
attribute_response over the response), the HTTP server
(AttributionServer over AttributionPipeline, a checkpoint loaded with
from_pretrained), and vision: the explicit rules, ViT-B/16, OpenCLIP
ViT-L/14 and Gemma-3-4B with one 896 x 896 image at full width and depth,
and the explicit path (the explicit Llama, GPT-2 and BERT at full width),
check= and the rule audit, multi-device attribution (data, tensor,
expert, pipeline and sequence x tensor parallelism, the checks under
dp x tp, and the data-parallel server) over four processes on the one
card, and loading at scale (checkpoints of Llama-3-8B and Mixtral-8x7B
widths written here and read by the native loader, layer by layer, NF4
while converting).

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --kernels   # phases 1-3 only, no result line
    python3 chip_smoke.py --serve     # phases 1-2 and 16 only, no result line
    python3 chip_smoke.py --vision    # phases 1-2 and 17 only, no result line
    python3 chip_smoke.py --explicit  # phases 1-2 and 18 only, no result line
    python3 chip_smoke.py --parallel  # phases 1-2 and 19 only, no result line
    python3 chip_smoke.py --load      # phases 1-2 and 20 only, no result line

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
     1024), on both bodies; BERT-base's call (B32 H12/12 T512 D64,
     bidirectional, 8 rows with kv_end 300); a query length other than the
     key length (Tq != Tk: a chunk against a longer cache, keys that start
     after the first queries, a non-causal call with more queries than
     keys) at head dim 64, 128 and 256 in bf16, float16 and float32, the
     body each kernel ran printed; then at the main path's call
     (B8 H32/4 T1024 D64), the
     NF4 8B path's (B1 H32/8 T4096 D128; Mixtral-8x7B's too), Gemma-3-4B's
     two (B1 H8/4 T4096 D256), GPT-2 XL's (B8 H25/25 T1024 D64, no
     rope), BERT-base's (bidirectional: non-causal SDPA) and a chunk of
     queries against its cache (B1 H32/8 Tq1024 Tk4096 D128, q_start 3072:
     SDPA with an explicit boolean mask), bf16: each
     kernel's device time (CUDA-graph replays) and body (Hopper or
     mma.sync) beside its plain version's time, its
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
     within 0.02 of its tokens unpadded);
 14. BERT-base (bert-base-uncased widths, 12 layers, 2 labels, random
     weights): float32 at 2 x 512 with row 1 right-padded to 300, the kernel
     path with kv_end against the einsum path with kv_end and with the
     attention_mask (normalized L2 <= 1e-4), row 1 against its 300 tokens
     unpadded (<= 1e-4, relevance exactly 0 on the padding), launches 12 of
     each flash kernel and no rotation pass; bf16 against float32 (<= 0.1);
     bf16 at 32 x 512, remat off, 8 rows right-padded: three attributions
     (heatmaps/s, peak memory, finite relevance, 0 on the padding, launches
     exact);
 15. decoding on phases 5-6's TinyLlama weights: float32 batch 2 x 256
     (row 0 left-padded by 64), 32 new tokens, cached greedy tokens equal
     to use_cache=False and each step's frontier logits within 1e-4 of the
     full forward's; bf16 batch 8 x 896, 128 new tokens (eos id 0): the
     prefill's ms and launches (22 of K1, nothing else), generate's tokens/s,
     host reads of done, device kernels a step (torch.profiler), the steps'
     logits against the float32 full forward's (max abs error at most 0.05
     above the bf16 full forward's own); attribute_response over the
     1024 tokens (K 128: maps/s, peak memory, launches 22 of K1 and 128 x 22
     of each K2 half plus the rotation passes, maps 0, 63 and 127 within
     1e-3 of separate attributions); attribute_response_latent at batch 1
     (finite, input relevance within 0.02 of attribute_response's); cached
     against uncached in float32 for Gemma-3-4B widths at 6 layers, GPT-2
     XL widths at 6 layers and Mixtral-8x7B widths at 2 layers (batch
     2 x 256, row 0 left-padded by 32, 16 tokens); the NF4 8B model of
     phase 7 generating 16 tokens from 1 x 4096 (tokens/s, K3 7 x 32 a step);
 16. serving: a checkpoint of TinyLlama-1.1B widths and depth (HF Llama
     names, random bf16 weights) written here and loaded with
     from_pretrained(dtype=bfloat16) (seconds, GB/s, weights bit-equal),
     remat off, behind AttributionServer(max_batch=8, max_wait_ms=10) and
     http_server on 127.0.0.1 (a crc32 whitespace tokenizer): 32 POST
     /v1/attribute from 16 client threads, prompts of 640-1024 words
     (heatmaps/s, p50/p99 latency, coalesced batch sizes; the launches of
     K1 and each K2 half exactly batches x one attribution's, and no
     rotation pass: a left-padded batch's per-example rope positions are
     applied before the kernels), each served map within 0.02 (bf16) of its prompt
     attributed alone, and within 1e-4 in float32 at 2 layers; a top-3
     request (map 0 within 1e-3 of the topk=1 map); 4 concurrent greedy
     POST /v1/respond of 32 tokens coalesced into one respond (tokens equal
     to generate on the same left-padded batch, launches exact, maps 0 and
     31 of row 0 within 1e-3 of separate attributions) and a sampled
     request sent twice (identical tokens); then --bits 8 and --bits 4 at
     Llama-3-8B widths and depth (remat, one prompt of 4096 tokens through
     the pipeline: heatmaps/s, GiB of codes and scales, peak) against a
     dense bf16 control of the same weights (int8 <= 1e-3; int4 <= 0.02,
     and at 4 layers within 0.1 of a float32 run of its weights, the
     control's own distance from it printed);
 17. vision: (a) each explicit rule (gamma 0.25, alpha-beta (2, 1), z+,
     flat, w-square, z-box (-3, 3)) at ViT-B/16's patch embedding (conv)
     and w_fc (linear), batch 8, float32 on the card against float64 on
     the CPU (<= 1e-5; gamma, whose denominators cross 0, within twice
     the CPU float32's own distance); (b) ViT-B/16 (torchvision vit_b_16
     geometry, random weights) bf16 batch 64 under cp_lrp with gamma
     (conv 0.25, linear 0.05): logits bit-equal across attnlrp, cp_lrp
     and the gamma composite, three batches (heatmaps/s, peak memory,
     finite maps, no flash launch: the towers attend on einsum), bf16
     against float32 on the same bf16 weights, pixels and labels (<= 0.1
     under cp_lrp and under cp_lrp with the conv gamma; the whole gamma
     composite's printed: gamma on the linears is ill-conditioned),
     attribute_topk k 5 against five
     attribute_image(label=) calls (<= 1e-3); (c) OpenCLIP ViT-L/14 bf16
     batch 32 towards a random unit direction (maps/s, peak memory);
     (d) Gemma-3-4B image + text (gemma-3-4b-it's SigLIP at 896 and text
     model, 256 image tokens in a prompt of 512, random weights): at 2
     vision and 6 text layers in float32 the text side on the kernels
     against einsum (<= 1e-4, launches exact), bf16 against float32
     (<= 0.1), cached greedy tokens equal to uncached; at full depth
     (27 + 34 layers) bf16, text remat off, three joint maps (heatmaps/s,
     peak memory, launches per map 34 / 34 / 34 / 102, finite token and
     pixel relevance), generate 32 tokens (K1 34, nothing else), and
     attribute_response over the 544 tokens padded to 640 (K 32: launches
     exact, map 0 within 1e-3 of a separate attribute);
 18. the explicit path and the checks: (a) the explicit Llama (TinyLlama-
     1.1B widths, attnlrp, 8 x 1024), GPT-2 XL (cp_lrp, 8 x 1024) and
     BERT-base (32 x 512, a quarter of the rows masked to 300 by
     attention_mask) at full width and depth, bf16, remat on: heatmaps/s,
     peak memory, finite maps, no flash launch, the bf16-vs-float32
     distance of one row's map (printed); (b) float32 at full width and 2
     layers, one row: explicit vs efficient input relevance through K1/K2
     (cosine > 0.999), Llama's latent relevance likewise, the card
     against the host CPU rule by rule (each rule backward run on the card
     from the CPU's saved tensors, <= 1e-4), the card's map against the
     float64 map (a bar per family); (c) check= on the main
     path (TinyLlama-1.1B, bf16, 8 x 1024, remat off and on): 'nan' bit-
     equal to None, exact flash launches, one host read, a NaN in one wq
     raising "NaN/Inf relevance", 'conservation' finite, the 'nan' overhead
     in ms, check=None's device kernels (torch.profiler) equal to the
     direct attribution's; (d) audit of the main-path forward through K1:
     0 unruled sites under attnlrp and cp_lrp at 22 layers, 12 under
     vanilla_gradient at 2 (tests/test_torch_rule_audit.py's count);
 19. multi-device, four processes on the one card over gloo (its
     collectives and point-to-point staged through host copies: the wall
     times are not scaling numbers): the single-process references first,
     then (a) Llama-3-8B dp 2 x tp 2 (local heads 16/4): float32 at 4
     layers, batch 2 x 4096, against the single-process kernel path
     (<= 1e-4), the same shards in bf16 against it (<= 0.1), bf16 at full
     depth; (b) NF4 tp 2 x dp 2 at Llama-3-8B width, 4 layers, float32
     (<= 1e-4 against the single-process NF4 run, K3 launches equal to its);
     (c) NF4 Mixtral-8x7B width ep 2 x dp 2, 4 layers, float32, 2 x 1024
     (<= 1e-4; K3 from each process's own routing counters); (d) pp 4,
     n_micro 4: float32 at 4 layers, 4 x 2048 (<= 1e-4), bf16 at full depth,
     4 x 4096; (e) sp 2 x tp 2, float32, 4 layers, 1 x 8192, remat off
     (<= 1e-4); each with the launches of K1, K2, the rotation pass and K3
     per process gated exactly, each process's wall time and peak memory;
     (f) build_server --data-parallel 2 on a TinyLlama-width checkpoint
     (this process rank 0, one rank spawned): 16 requests, each map within
     0.02 of its prompt alone through a single-process pipeline, both
     ranks' launches exactly batches x one attribution's; (g) the checks at
     dp 2 x tp 2, Llama-3-8B width, 2 layers, float32, 2 x 1024, gamma on
     every linear: under conservation_check the map and conservation_error
     against the single process's (<= 1e-4), and under nan_check a NaN in
     one process's head shard raising the same site on all four;
 20. loading at scale (the native loader, g++ into lxt_tpu_torch/_build/):
     (a) a Llama-3-8B-width bf16 checkpoint cut to 8 layers, written here
     from a seed and loaded with from_pretrained(dtype=bfloat16): seconds,
     GB/s, the load's peak host RSS (sampled) and peak device memory,
     weights bit-equal to the written ones; (b) a Mixtral-8x7B-width bf16
     checkpoint cut to 2 layers, loaded with quantize_bits="nf4": peak
     device memory during the load minus the resident size after it at
     most 1.25 x one layer's bf16 bytes, and the projection to 32 layers;
     (c) one bf16 attribution (1 x 4096, remat) on each loaded model
     through K1/K2 (and K3 for NF4), its relevance bit-equal to that of a
     model loaded by the plain numpy reader and converted, then quantized,
     whole; the written files deleted at the end, also on failure.
The line before the last is a JSON object with each kernel's launches, error,
times, bound and library time at the main path's call (K3: at wg), under
"at_8b" at the NF4 8B path's (K3: at wd), and, for the flash kernels, under
"at_gemma_local" / "at_gemma_global" at Gemma-3-4B's calls and "at_ring"
at the ring step, "at_gpt2" at GPT-2 XL's call and "at_bert" at BERT-base's
(where the call runs no rotation pass, the pass has no entry); a flash
kernel's entry names its
"body" and, where a control ran, its mma.sync body's time "mma_ms".
"launches", "launches_8b", "launches_gemma", "launches_mixtral" and
"launches_gpt2" are each the count over its path's three timed
attributions ("launches" of K3: the NF4 8B path's), "launches_ring" over
the ring's three driven attributions, all four processes together, and
"launches_api" over phase 11's calls of the API (not the separate
attributions they are held against), "launches_bert" over phase 14's three
bf16 attributions and "launches_decode" over phase 15's driven calls (the
bf16 generate, attribute_response, attribute_response_latent and the NF4
generate), "launches_serve" over phase 16's 32 served attribute requests,
"launches_vision" over phase 17's ViT and OpenCLIP calls and
"launches_multimodal" over its full-depth Gemma-3 calls (three attribute,
generate, attribute_response), "launches_parallel" over phase 19's runs
(every process's, the references excepted, and both serving ranks'),
"launches_load" over phase 20's two attributions of the loaded models; the
at_chunk entry is the Tq != Tk call; the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import gc
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
    # BERT-base's call: bidirectional, MHA 12/12, head dim 64, no rope, a
    # quarter of the rows right-padded to 300 (T 512 is off K1's 192-row q
    # tile grid at D 64)
    "bert_base": (32, 12, 12, 512, 64, {"causal": False,
                                        "kv_end": [300] * 8 + [512] * 24}),
    # a query length other than the key length (opt "Tk"): a chunk of
    # queries against a longer cache (causal, q_start = Tk - Tq; Tk 704 runs
    # K1's 128-row Hopper kv tiles past Tk at head dim 64), with a window
    # across tiles at 128 and an odd last q tile, keys that start after the
    # first queries (empty rows) at 256, and a non-causal call with more
    # queries than keys cut by kv_end at 256; lse cotangents on two
    "tk_chunk_hd64": (2, 4, 2, 256, 64, {"Tk": 704, "q_start": 448, "dlse": True}),
    "tk_chunk_hd128_window300": (1, 8, 2, 320, 128, {"Tk": 1024, "q_start": 704,
                                                     "window": 300}),
    "tk_keys_later_hd256": (1, 8, 2, 256, 256, {"Tk": 512, "q_start": 256,
                                                "k_start": 320, "dlse": True}),
    "tk_bidirectional_hd256_kv_end": (2, 8, 4, 512, 256, {"Tk": 192, "causal": False,
                                                          "kv_end": [192, 100]}),
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
         "gpt2": (SERVE_BATCH, 25, 25, SEQ, 64, {}), "bert": CASES["bert_base"],
         "chunk": (1, 32, 8, 1024, 128, {"Tk": 4096, "q_start": 3072})}
CALL_NAMES = {"main": "B8 H32/4 T1024 D64 causal rope",
              "8b": "B1 H32/8 T4096 D128 causal rope",
              "gemma_local": "B1 H8/4 T4096 D256 window 1024 causal rope",
              "gemma_global": "B1 H8/4 T4096 D256 causal rope",
              "ring": "B1 H32/8 T_local 2048 D128 ring step q_start 2048 k_start 0 "
                      "(full square) dlse",
              "gpt2": "B8 H25/25 T1024 D64 causal, no rope",
              "bert": "B32 H12/12 T512 D64 bidirectional, kv_end 300 on 8 of 32 rows, "
                      "no rope",
              "chunk": "B1 H32/8 Tq1024 Tk4096 D128 causal q_start 3072 (a chunk "
                       "against its cache), no rope"}
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
# phase 14, BERT (bert-base-uncased config.json widths, 2 labels, random
# weights, full depth): the float32 gates at 2 x 512 with row 1 right-padded
# to 300; bf16 at 32 x 512, remat off, 8 of the 32 rows right-padded to 300
BERT_BASE = dict(vocab_size=30522, hidden_size=768, intermediate_size=3072,
                 num_layers=12, num_heads=12, max_positions=512,
                 type_vocab_size=2, num_labels=2)
SEQ_BERT, BERT_BATCH, BERT_REAL = 512, 32, 300
# phase 15, decoding: on phases 5-6's TinyLlama weights, float32 batch 2 x
# 256 (row 0 left-padded by 64), 32 new tokens, cached against uncached
# and each step's logits against the full forward's (<= 1e-4); bf16 batch
# 8 x 896, 128 new tokens (eos id 0), its steps' logits against the full
# forward's (tests/test_decode.py's bar of 0.05, see below); attribute_response over the
# 1024 tokens (K 128), maps 0, 63 and 127 against separate attributions
# (<= 1e-3); attribute_response_latent at batch 1 (<= 0.02). At this width
# bf16 rounding alone moves logits (up to ~5, a bf16 ulp 0.031) by more than
# 0.05: the bf16 full forward through the kernels and through the einsum
# path differ by up to 0.1543 (H100, 700 W). So the steps' logits are held
# to the float32 full forward's: their max abs error may exceed the bf16 full
# forward's own by at most 0.05; the direct difference is printed. The other
# families in float32 at reduced depth, batch 2 x 256, 16 new tokens; the
# NF4 8B model of phase 7 generating 16 tokens from 1 x 4096
DECODE_F32 = (2, 256, 32, 64)            # batch, prompt, new tokens, row 0 pad
DECODE_BF16 = (SERVE_BATCH, 896, 128)    # batch, prompt, new tokens
DECODE_BF16_BAR, RESPONSE_CHECKED = 0.05, (0, 63, 127)
DECODE_OTHERS = (2, 256, 16, 32)         # batch, prompt, new tokens, row 0 pad
DECODE_NF4 = (SEQ_8B, 16)                # prompt, new tokens
# phase 16, serving: a checkpoint of TinyLlama-1.1B widths and depth
# (TinyLlama's config.json values, HF Llama names, random bf16 weights from
# a seed) written here and loaded with from_pretrained(dtype=bfloat16),
# remat off, behind AttributionServer(max_batch=8, max_wait_ms=10) and
# http_server on 127.0.0.1 with a whitespace tokenizer (ids by crc32).
# Attribute traffic: 32 single-prompt requests from 16 client threads,
# prompts of 640-1024 words (each batch pads to a multiple of 128); each
# served map against the prompt attributed alone (bf16: the padded-rows
# bar; float32 at 2 layers, 8 requests from 8 threads: the parity bar);
# one top-3 request. Respond traffic: 4 concurrent greedy requests of 32
# new tokens (prompts of 256-512 words) coalesced into one respond, and one
# sampled request sent twice. Then the server's --bits 8 / --bits 4 paths
# at Llama-3-8B widths and depth (remat on, one prompt of 4096 tokens)
# against dense controls of the same weights
TINYLLAMA_CONFIG = dict(
    model_type="llama", vocab_size=32000, hidden_size=2048, intermediate_size=5632,
    num_hidden_layers=22, num_attention_heads=32, num_key_value_heads=4,
    rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=2048,
    tie_word_embeddings=False, hidden_act="silu", torch_dtype="bfloat16")
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_WORDS = 32, 16, (640, 1024)
SERVE_MAX_BATCH, SERVE_WAIT_MS = 8, 10.0
SERVE_F32 = (2, 8)                       # layers, requests
SERVE_TOPK, TOPK_BAR = 3, 1e-3
RESPOND_REQUESTS, RESPOND_TOKENS, RESPOND_WORDS = 4, 32, (256, 512)
RESPOND_CHECKED, SAMPLED = (0, RESPOND_TOKENS - 1), dict(temperature=0.8, top_k=40,
                                                         seed=7)
# int4 against its dense control: int4 multiplies the exact integer planes
# in bf16 (two half products and their sum, each rounded; the backward
# rounds g * scale first) where the control multiplies q * scale rounded to
# bf16, so the two are one function in different bf16 roundings. The
# control's own rounding already exceeds DENSE_BAR: at 4 layers it reads
# 0.006596 against a float32 run of the same weights, and int4 against the
# control 0.01643 there, 0.01207 at 32 layers (H100, 700 W). So int4 is
# held to the bar of two bf16 computations apart in rounding (the padded
# rows' and the ring's, 0.02), and to DIVERGENCE_BAR against float32 at 4
# layers; int8 dequantizes to bf16 before its product, as the control does
BITS_CONTROL_LAYERS, INT4_BAR = 4, 0.02
# phase 17, vision. (a) the explicit rules at ViT-B/16's patch embedding
# (conv 16 x 16, stride 16, 3 -> 768 over 224 x 224 normalized pixels) and
# its w_fc (768 -> 3072 over 197 LayerNorm-like rows), batch 8, float32 on
# the card against the same call in float64 on the CPU. The gamma rule's
# denominators z = x (w + g w+) + b cross 0 on such inputs, so float32
# itself lands far from float64 there; gamma is held to twice the CPU's own
# float32
# distance (printed), the other specs to RULE_BAR.
RULE_BATCH, RULE_BAR, RULE_GAMMA_FACTOR = 8, 1e-5, 2.0
RULE_SPECS = {"gamma 0.25": ("gamma", 0.25), "alphabeta (2, 1)": ("alphabeta", 2.0, 1.0),
              "zplus": "zplus", "flat": "flat", "wsquare": "wsquare",
              "zbox (-3, 3)": ("zbox", -3.0, 3.0)}
# (b) ViT-B/16, torchvision vit_b_16's geometry: bf16, batch 64, the gamma
# composite of examples/vision_one_call.py; (c) OpenCLIP ViT-L/14
# (open_clip's ViT-L-14.json): bf16, batch 32, one random unit direction
VIT_B16 = dict(image_size=224, patch_size=16, hidden_size=768, intermediate_size=3072,
               num_layers=12, num_heads=12, num_classes=1000, ln_eps=1e-6,
               act="gelu_exact")
OPENCLIP_L14 = dict(image_size=224, patch_size=14, hidden_size=1024,
                    intermediate_size=4096, num_layers=24, num_heads=16, ln_eps=1e-5,
                    act="quick_gelu", openclip=True, proj_dim=768)
VIT_BATCH, CLIP_BATCH, TOPK_VIT = 64, 32, 5
# (d) Gemma-3-4B image + text: google/gemma-3-4b-it's vision_config (SigLIP
# so400m at 896: 27 layers, D 1152, 16 heads of 72), mm_tokens_per_image
# 256 (a 4 x 4 pool of the 64 x 64 patch grid) and the text model of phase
# 9, all 34 layers; bf16, attnlrp, text remat off, one image's 256 tokens
# between boi and eoi in a prompt of 512. The gates at 2 vision and 6 text
# layers; then generate 32 tokens and attribute_response over prompt +
# response right-padded to 640
SIGLIP_896 = dict(image_size=896, patch_size=14, hidden_size=1152,
                  intermediate_size=4304, num_layers=27, num_heads=16, ln_eps=1e-6)
MM_TOKENS, IMAGE_TOKEN, BOI, EOI = 256, 262144, 255999, 256000
SEQ_MM, MM_IMAGE_AT, MM_NEW = 512, 128, 32
MM_GATE = (2, 6)                          # vision layers, text layers
# phase 18, the explicit path and the checks. (a) the explicit Llama
# (TinyLlama-1.1B widths, MODEL), GPT-2 XL and BERT-base at full width and
# depth, bf16, remat on: Llama 8 x SEQ under attnlrp, GPT-2 XL 8 x SEQ under
# cp_lrp, BERT 32 x 512 with a quarter of the rows masked to 300 by
# attention_mask; heatmaps/s, peak memory, no flash launch (the explicit
# attention is einsum), and the bf16-vs-float32 distance of one row's map
# (printed, not gated: the epsilon rules' denominators cross 0). (b) float32
# at full width cut to EXPLICIT_GATE_LAYERS, one row: the explicit input
# relevance against the efficient path's through K1/K2 (cosine >
# EXPLICIT_COS, tests/test_explicit_model.py's bar) and Llama's explicit
# latent relevance against latent_relevance's; the card against the host
# CPU rule by rule: the CPU's call keeps its graph, and every custom
# Function's backward is run again on the card from the node's saved
# tensors and incoming relevance, normalized L2 <= EXPLICIT_SITE_BAR
# against what it returned on the CPU; and the card's map against the
# float64 map, within EXPLICIT_F64_BAR. The maps' distances from float64
# are set by the epsilon rules' denominators (output + epsilon, a plain +
# as in lxt_tpu): where one unit's denominator is near 0, the float32
# rounding of that one unit moves the map (scripts/explicit_float32_sites.py
# finds the unit and sets it to its float64 value). Each family's bar lies
# between the largest float32 reading, card or CPU, and the distance of
# its bf16 map in (a). (c) check= on the
# main path (TinyLlama-1.1B, bf16, 8 x SEQ, remat on and off): 'nan' bit-
# equal to None with exact flash launches and one host read, a NaN in one
# wq raising, 'conservation' finite, the 'nan' overhead, and check=None's
# device kernels (torch.profiler: names and counts) equal to the direct
# attribution's, which no check code reaches. (d) audit of the main-path
# forward through K1 at that width: no unruled site under attnlrp and
# cp_lrp at full depth; vanilla_gradient at 2 layers flags AUDIT_VANILLA
# products, tests/test_torch_rule_audit.py's count at its tiny config
EXPLICIT_GATE_LAYERS, EXPLICIT_COS, EXPLICIT_REQUESTS, CHECK_REPS = 2, 0.999, 2, 5
EXPLICIT_SITE_BAR = 1e-4
EXPLICIT_F64_BAR = {"llama": 1e-3, "gpt2": 3e-2, "bert": 1e-3}
AUDIT_VANILLA = 12          # 5 a layer (the norms' 4, the gate's) + the final norm's 2
# phase 19, multi-device: PAR_WORLD processes on the one card over gloo
# (NCCL refuses two ranks on one device; gloo stages CUDA tensors through
# host copies), random weights from seeds drawn on the card, the same on
# every process and in the single-process references; each comparison
# explains the reference's float32 argmax tokens at the last position.
# (a) Llama-3-8B dp 2 x tp 2: the float32 gate at PAR_GATE_LAYERS, the same
# shards in bf16 against it, then bf16 at full depth, batch PAR_DPTP, remat;
# (b) NF4 tp 2 (x dp 2) and (c) NF4 Mixtral-8x7B ep 2 (x dp 2), float32 at
# PAR_GATE_LAYERS; (d) pp PAR_WORLD, n_micro PAR_PP_MICRO: the float32 gate
# at PAR_GATE_LAYERS (one layer a stage), then bf16 at full depth; (e) sp 2
# x tp 2 float32 at PAR_GATE_LAYERS and 1 x PAR_SP_T, remat off (as phase
# 10); (f) serve --data-parallel 2 on phase 16's TinyLlama-width checkpoint
PAR_WORLD, PAR_SEED, PAR_TIMEOUT = 4, 31, 480
PAR_GATE_LAYERS, PAR_DPTP, PAR_MIXTRAL_T = 4, (2, 4096), 1024
PAR_PP_GATE, PAR_PP, PAR_PP_MICRO = (4, 2048), (4, 4096), 4
PAR_SP_T = 8192
PAR_SERVE_REQUESTS, PAR_SERVE_WORDS = 16, (256, 512)
# (g) the checks: depth, batch and length, and the explicit-rule composite
PAR_CHECK_LAYERS, PAR_CHECK = 2, (2, 1024)
# phase 19 (g)'s bar on the conservation map (normalized L2) and on
# conservation_error (absolute; near 1 here), each against the single process
CHECK_BAR = 1e-6
# phase 20, loading at scale: Llama-3-8B widths cut to 8 layers and
# Mixtral-8x7B's cut to 2, bf16 checkpoints written from a seed (HF names);
# the NF4 load's transient device bytes at most LOAD_TRANSIENT_BAR x one
# layer's bf16 bytes
LOAD_8B_LAYERS, LOAD_MIXTRAL_LAYERS, LOAD_TRANSIENT_BAR = 8, 2, 1.25
LLAMA3_8B_CONFIG = dict(
    model_type="llama", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=LOAD_8B_LAYERS, num_attention_heads=32, num_key_value_heads=8,
    rms_norm_eps=1e-5, rope_theta=500000.0, max_position_embeddings=8192,
    tie_word_embeddings=False, hidden_act="silu", torch_dtype="bfloat16")
MIXTRAL_8X7B_CONFIG = dict(
    model_type="mixtral", vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=LOAD_MIXTRAL_LAYERS, num_attention_heads=32,
    num_key_value_heads=8, num_local_experts=8, num_experts_per_tok=2,
    rms_norm_eps=1e-5, rope_theta=1e6, max_position_embeddings=32768,
    sliding_window=None, tie_word_embeddings=False, hidden_act="silu",
    torch_dtype="bfloat16")


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
    Tk = opt.get("Tk", T)
    gen = torch.Generator("cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = r(B, H, T, D), r(B, Hkv, Tk, D), r(B, Hkv, Tk, D), r(B, H, T, D)
    cos = sin = None
    if opt.get("rope"):
        cos, sin = (t.to("cuda", dtype).contiguous()
                    for t in common.rope_tables(torch.arange(T), D))

    def span(key):
        return (None if key not in opt else
                torch.tensor(opt[key], dtype=torch.int32, device="cuda"))

    window = opt.get("window", max(T, Tk) + 2**20)
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
                           kv_begin=opt.get("kv_begin"), kv_end=opt.get("kv_end"),
                           rope=bool(opt.get("rope")),
                           q_start=opt.get("q_start", 0),
                           k_start=opt.get("k_start", 0),
                           dlse=bool(opt.get("dlse")), Tk=opt.get("Tk"))
    t_ops = flops / (PEAK_F32 if name == "rope_rotate" else PEAK_BF16) * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


_CAPTURE = {"refused": False}


def sdpa_yardstick(q, k, v, do, cos, sin, scale, window=None, causal=True,
                   attn_mask=None):
    """The library's time for the same attention: one
    scaled_dot_product_attention call (causal or, for a ring step whose keys
    lie wholly in the past, non-causal; GQA) under its flash and its
    cuDNN backend, forward and backward (torch.autograd.grad with
    retain_graph) timed apart, each by CUDA-graph replays and eagerly; with
    a window, whose mask only a boolean attn_mask can give, or an explicit
    boolean ``attn_mask`` (a chunk of queries against a longer cache),
    under the memory-efficient backend too. q and k are rotated (where the call has
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
    if attn_mask is not None:
        mask = {"attn_mask": attn_mask}
        backends.append(SDPBackend.EFFICIENT_ATTENTION)
    elif window is not None:
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
    Tk = opt.get("Tk", T)
    window = opt.get("window")
    full = fa.visible_pairs(T, window, opt.get("causal", True), **off, Tk=Tk) == T * Tk
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
    # Tq != Tk: the mask in global positions, as an explicit boolean mask
    chunk_mask = (None if Tk == T else
                  fa._allowed(q, k, None, None, extra[4], opt.get("causal", True),
                              **off)[0, 0])
    lib, lib_lines = sdpa_yardstick(q, k, v, do, cos, sin, scale, window,
                                    causal=not full, attn_mask=chunk_mask)
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
    from lxt_tpu_torch.ops import flash_attention as fa
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for i, (name, case) in enumerate(CASES.items()):
            res = compare_kernels(case, dtype, seed=i)
            ok = all(err <= bound for err, bound, _ in res.values())
            if not ok:
                failures.append(f"kernel case {name} {dtype}")
            # the body each kernel ran (Tq != Tk takes the same routing)
            probe = torch.empty(1, 1, 1, case[4], dtype=dtype)
            bodies = ", ".join(f"{n} {'Hopper' if fa._hopper(n, probe) else 'mma.sync'}"
                               for n in FLASH[:3])
            print(f"kernel case {str(dtype)[6:]:8s} {name:22s} " + " ".join(
                f"{k} {e:.3g}/{b:.3g}" for k, (e, b, _) in res.items())
                + (f" (Tq {case[3]}, Tk {case[5]['Tk']}; {bodies})"
                   if "Tk" in case[5] else "")
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
    """A copy of the parameter tree ``params`` in ``dtype``."""
    if isinstance(params, dict):
        return {k: cast(v, dtype) for k, v in params.items()}
    return params.to(dtype)


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
    package): 8-byte header length, JSON header, raw little-endian data.
    Tensors are numpy float32 / uint8 arrays or torch bf16 tensors."""
    kinds = {np.dtype(np.float32): "F32", np.dtype(np.uint8): "U8"}
    header, blobs, offset = {}, [], 0
    for name, arr in tensors.items():
        if isinstance(arr, np.ndarray):
            kind, raw = kinds[arr.dtype], np.ascontiguousarray(arr).tobytes()
        else:   # a torch bf16 tensor: its bits
            import torch
            if arr.dtype != torch.bfloat16:
                raise ValueError(f"{name}: {arr.dtype} is not written")
            kind = "BF16"
            raw = arr.detach().contiguous().cpu().view(torch.int16).numpy().tobytes()
        header[name] = {"dtype": kind, "shape": list(arr.shape),
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


def bert_attribute(params, cfg, ids, impl, **kw):
    """BERT's classification attribution (the argmax label's logit summed
    over the batch) through its forward with ``attn_impl=impl``: (logits,
    relevance)."""
    import lxt_tpu_torch
    from lxt_tpu_torch.models import bert
    held = {}

    def target(x):
        logits = bert.forward(params, cfg, x, lxt_tpu_torch.attnlrp, remat=False,
                              attn_impl=impl, **kw).logits
        held["logits"] = logits.detach()
        return logits.max(dim=-1).values.sum()

    _, rel = lxt_tpu_torch.input_relevance(target, bert.embed(params, ids))
    return held["logits"], rel


def phase_bert(card):
    """Phase 14: BERT-base through the kernels (bidirectional, right-padded
    by kv_end): the float32 gates against the einsum path (kv_end and
    attention_mask) and the padded row against its tokens unpadded, bf16
    against float32, then three bf16 attributions at 32 x 512. Returns
    (failures, the launches of the three attributions)."""
    import torch
    import lxt_tpu_torch
    from lxt_tpu_torch.models import bert
    from lxt_tpu_torch.models.registry import AttributionModel
    failures = []
    cfg = bert.BertConfig(**BERT_BASE)
    L = cfg.num_layers
    gen = torch.Generator("cuda").manual_seed(17)
    params = bert.init_params(cfg, gen)
    ids = torch.randint(0, cfg.vocab_size, (2, SEQ_BERT), generator=gen, device="cuda")
    kv_end = torch.tensor([SEQ_BERT, BERT_REAL], dtype=torch.int32, device="cuda")
    mask = (torch.arange(SEQ_BERT, device="cuda")[None] < kv_end[:, None]).int()
    (logits_k, rel_k), rose, _ = counted(
        lambda: bert_attribute(params, cfg, ids, "auto", kv_end=kv_end))
    want = expected_launches(L, remat=False)
    logits_e, rel_e = bert_attribute(params, cfg, ids, "einsum", kv_end=kv_end)
    logits_m, rel_m = bert_attribute(params, cfg, ids, "einsum", attention_mask=mask)
    logits_u, rel_u = bert_attribute(params, cfg, ids[1:, :BERT_REAL], "auto")
    d = {"einsum kv_end": (nl2(logits_k, logits_e), nl2(rel_k, rel_e)),
         "einsum attention_mask": (nl2(logits_k, logits_m), nl2(rel_k, rel_m)),
         f"row 1 against its {BERT_REAL} tokens unpadded": (
             nl2(logits_k[1:], logits_u), nl2(rel_k[1, :BERT_REAL], rel_u[0]))}
    pad_zero = bool((rel_k[1, BERT_REAL:] == 0).all())
    finite = bool(torch.isfinite(rel_k).all() and torch.isfinite(logits_k).all())
    ok = (finite and pad_zero and rose == want
          and all(a <= PARITY_BAR and b <= PARITY_BAR for a, b in d.values()))
    print(f"BERT-base float32 L{L} B2x{SEQ_BERT} (row 1 kv_end {BERT_REAL}), kernels "
          f"against: " + "; ".join(f"{k} logits {a:.3g}, relevance {b:.3g}"
                                   for k, (a, b) in d.items())
          + f" (bar {PARITY_BAR}); relevance 0 on the padding {pad_zero}; launches "
          f"{rose} (expected {want})" + (" PASS" if ok else " FAIL") + f" [{card}]",
          flush=True)
    if not ok:
        failures.append("BERT float32 gates")
    _, rel16 = bert_attribute(cast(params, torch.bfloat16), cfg, ids, "auto",
                              kv_end=kv_end)
    div = nl2(rel16.float(), rel_k)
    print(f"BERT-base bf16 vs float32 relevance B2x{SEQ_BERT}, kernels: normalized "
          f"L2 {div:.4g} (bar {DIVERGENCE_BAR}) [{card}]", flush=True)
    if not (math.isfinite(div) and div <= DIVERGENCE_BAR):
        failures.append("BERT bf16 divergence")
    del params, logits_e, rel_e, logits_m, rel_m
    torch.cuda.empty_cache()

    model = AttributionModel("bert", cfg, bert.init_params(cfg, gen, dtype=torch.bfloat16),
                             lxt_tpu_torch.attnlrp, remat=False)
    ends = torch.full((BERT_BATCH,), SEQ_BERT, dtype=torch.int32, device="cuda")
    ends[:BERT_BATCH // 4] = BERT_REAL
    requests = [torch.randint(0, cfg.vocab_size, (BERT_BATCH, SEQ_BERT), generator=gen,
                              device="cuda") for _ in range(REQUESTS)]
    model.attribute(requests[0], kv_end=ends)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    rels, launches, secs = counted(
        lambda: [model.attribute(ids, kv_end=ends)[1] for ids in requests])
    rate = BERT_BATCH * REQUESTS / secs
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {n: REQUESTS * c for n, c in expected_launches(L, remat=False).items()}
    ok = all(r.shape == (BERT_BATCH, SEQ_BERT) and bool(torch.isfinite(r).all())
             and bool((r[:BERT_BATCH // 4, BERT_REAL:] == 0).all()) for r in rels)
    print(f"BERT-base L{L} B{BERT_BATCH}x{SEQ_BERT} bf16 remat off ({BERT_BATCH // 4} "
          f"rows kv_end {BERT_REAL}), kernels: {REQUESTS} attributions, {rate:.3f} "
          f"heatmaps/s, launches {launches} (expected {want}: no rotation pass), "
          f"relevance finite, [{BERT_BATCH}, {SEQ_BERT}] and 0 on the padding: {ok}, "
          f"peak device memory {peak:.2f} GiB [{card}]", flush=True)
    if not ok:
        failures.append("BERT relevance not finite, misshapen or nonzero on padding")
    if launches != want:
        failures.append(f"BERT launches {launches}")
    return failures, launches


def kernels_per_step(step, steps=4):
    """Device kernels a decode step launches, counted by torch.profiler over
    ``steps`` calls of ``step()`` (None where it sees no device kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return n / steps if n else None


def step_logits(model, ids, out, kv_begin=None):
    """The cached path's frontier logits at every new position of ``out``
    (``ids`` the prompt): the prefill's, then each decode step's; [N, B, V]."""
    import torch
    from lxt_tpu_torch.models.registry import FAMILIES
    fns = FAMILIES[model.family]
    T0, N = ids.shape[1], out.shape[1] - ids.shape[1]
    with torch.no_grad():
        logits, caches = fns["prefill"](model.params, model.cfg, model.embed(ids),
                                        T0 + N, kv_begin=kv_begin,
                                        composite=model.composite)
        rows = [logits[:, 0]]
        for k in range(1, N):
            logits, caches = fns["decode_step"](
                model.params, model.cfg, model.embed(out[:, T0 + k - 1:T0 + k]),
                caches, T0 + k - 1, kv_begin=kv_begin, composite=model.composite)
            rows.append(logits[:, 0])
    return torch.stack(rows)


def full_logits(model, out, kv_begin=None):
    """The full forward's logits over ``out`` (no graph): [B, T, V]."""
    import torch
    from lxt_tpu_torch.models.registry import FAMILIES
    with torch.no_grad():
        return FAMILIES[model.family]["forward"](
            model.params, model.cfg, model.embed(out), model.composite,
            kv_begin=kv_begin, remat=False).logits


def cached_equals_uncached(card, label, model, ids, n, kv_begin):
    """Greedy tokens of the cached path against use_cache=False; returns
    (ok, the cached tokens)."""
    import torch
    out = model.generate(ids, n, kv_begin=kv_begin)
    ref = model.generate(ids, n, kv_begin=kv_begin, use_cache=False)
    same = bool(torch.equal(out, ref))
    print(f"decode {label}: {n} greedy tokens, cached equal to uncached "
          f"(use_cache=False): {same}" + (" PASS" if same else " FAIL") + f" [{card}]",
          flush=True)
    return same, out


def phase_decode(card):
    """Phase 15: generate and attribute_response. Returns (failures, the
    launches of the driven calls: the bf16 prefill and generate,
    attribute_response, attribute_response_latent and the NF4 generate)."""
    import torch
    import lxt_tpu_torch
    from lxt_tpu_torch.models import decode, gemma3, gpt2, llama, mixtral
    from lxt_tpu_torch.models.registry import AttributionModel
    from lxt_tpu_torch.ops import quant
    failures, total = [], {}

    def add(launches):
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c

    # float32: cached against uncached, each step's logits against the full
    # forward's, one left-padded row
    cfg32, params32, _ = main_weights()
    L = cfg32.num_layers
    model = AttributionModel("llama", cfg32, params32, lxt_tpu_torch.attnlrp, remat=False)
    B, T0, N, pad = DECODE_F32
    gen = torch.Generator("cuda").manual_seed(18)
    ids = torch.randint(0, cfg32.vocab_size, (B, T0), generator=gen, device="cuda")
    kv_begin = torch.tensor([pad] + [0] * (B - 1), dtype=torch.int32, device="cuda")
    same, out = cached_equals_uncached(
        card, f"TinyLlama width float32 L{L} B{B}x{T0} (row 0 kv_begin {pad})",
        model, ids, N, kv_begin)
    steps = step_logits(model, ids, out, kv_begin)
    full = full_logits(model, out, kv_begin)[:, T0 - 1:-1].transpose(0, 1)
    errs = [nl2(a, b) for a, b in zip(steps, full)]
    ok = same and max(errs) <= PARITY_BAR
    print(f"decode TinyLlama width float32: frontier logits of the prefill and "
          f"{N - 1} steps against the full forward's, normalized L2 max "
          f"{max(errs):.3g} (bar {PARITY_BAR})" + (" PASS" if ok else " FAIL")
          + f" [{card}]", flush=True)
    if not ok:
        failures.append("decode float32 cached against uncached")
    model32 = model
    del steps, full
    torch.cuda.empty_cache()

    # bf16 serving: prefill, then decode steps, through generate
    cfg = llama.LlamaConfig(**MODEL, dtype="bfloat16")
    model = AttributionModel("llama", cfg, cast(params32, torch.bfloat16),
                             lxt_tpu_torch.attnlrp, remat=False)
    B, T0, N = DECODE_BF16
    ids = torch.randint(0, cfg.vocab_size, (B, T0), generator=gen, device="cuda")
    model.generate(ids, 2)  # warm-up
    (_, caches), rose, t_pre = counted(lambda: decode.prefill(
        model.params, cfg, model.embed(ids), T0 + N))
    want = {"flash_fwd": L, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "rope_rotate": 0}
    t_pre = min(t_pre, counted(lambda: decode.prefill(
        model.params, cfg, model.embed(ids), T0 + N))[2])
    decode.reset_counters()
    out, launches, t_gen = counted(lambda: model.generate(ids, N, eos_token_id=0))
    add(launches)
    reads, nsteps = decode.counters["done_reads"], decode.counters["steps"]
    t_steps = t_gen - t_pre
    per_step = kernels_per_step(lambda: decode.decode_step(
        model.params, cfg, model.embed(out[:, T0:T0 + 1]), caches, T0))
    ok = rose == want and launches == want and out.shape == (B, T0 + N)
    print(f"decode TinyLlama width bf16 L{L} B{B}x{T0}, {N} new tokens (eos id 0): "
          f"prefill {t_pre * 1e3:.2f} ms (launches {rose}, expected {want}); generate "
          f"{t_gen:.3f} s, {nsteps} steps, {B * N / t_gen:.1f} tokens/s end to end, "
          f"{B * nsteps / t_steps:.1f} tokens/s over the steps ({t_steps / nsteps * 1e3:.3f}"
          f" ms a step); host reads of done {reads}; device kernels a step "
          + (f"{per_step:.1f}" if per_step else "not measured (the profiler saw none)")
          + f"; generate's launches {launches}" + (" PASS" if ok else " FAIL")
          + f" [{card}]", flush=True)
    if not ok:
        failures.append(f"decode bf16 launches {rose} / {launches}")
    del caches
    steps = step_logits(model, ids, out).float()
    full = full_logits(model, out)[:, T0 - 1:-1].transpose(0, 1).float()
    truth = full_logits(model32, out)[:, T0 - 1:-1].transpose(0, 1)
    err, own = ((steps - truth).abs().max().item(), (full - truth).abs().max().item())
    direct = (steps - full).abs().max().item()
    ok = math.isfinite(err) and err <= own + DECODE_BF16_BAR
    print(f"decode TinyLlama width bf16: frontier logits of the prefill and {N - 1} "
          f"steps against the float32 full forward's max abs {err:.4g}, the bf16 full "
          f"forward's own {own:.4g} (bar: that + {DECODE_BF16_BAR}); normalized L2 "
          f"{nl2(steps, truth):.4g} against the bf16 full forward's {nl2(full, truth):.4g};"
          f" against the bf16 full forward (kernels) max abs {direct:.4g}"
          + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    if not ok:
        failures.append("decode bf16 logits")
    del steps, full, truth, model32, params32
    torch.cuda.empty_cache()

    # attribute_response: K maps through one forward and K pulls
    K = N
    torch.cuda.reset_peak_memory_stats()
    (values, rel), launches, secs = counted(lambda: model.attribute_response(out, T0))
    add(launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = expected_launches(L, False, HOPPER_BODIES[64], pulls=K)
    errs = []
    for k in RESPONSE_CHECKED:
        _, sep = model.attribute(out, position=T0 + k - 1, token=out[:, T0 + k])
        errs.append(nl2(rel[k], sep))
    ok = (rel.shape == (K, B, T0 + N) and bool(torch.isfinite(rel).all())
          and max(errs) <= API_BF16_BAR and launches == want)
    print(f"attribute_response TinyLlama width bf16 B{B}x{T0 + N}, K {K}: "
          f"{K * B / secs:.3f} maps/s ({secs:.3f} s), peak device memory {peak:.2f} "
          f"GiB, maps {list(RESPONSE_CHECKED)} against separate attributions "
          f"{[f'{e:.3g}' for e in errs]} (bar {API_BF16_BAR}), launches {launches} "
          f"(expected {want})" + (" PASS" if ok else " FAIL") + f" [{card}]",
          flush=True)
    if not ok:
        failures.append("attribute_response")
    del values, rel
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (values, rel_in, latent), launches, secs = counted(
        lambda: model.attribute_response_latent(out[:1], T0))
    add(launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, rel1 = model.attribute_response(out[:1], T0)
    d = nl2(rel_in, rel1)
    ok = (latent.shape == (K, L, 1, T0 + N) and bool(torch.isfinite(latent).all())
          and d <= LATENT_BAR and launches == expected_launches(
              L, False, HOPPER_BODIES[64], pulls=K))
    print(f"attribute_response_latent TinyLlama width bf16 B1x{T0 + N}, K {K}: latent "
          f"{list(latent.shape)} finite, {secs:.3f} s, peak {peak:.2f} GiB, input "
          f"relevance against attribute_response's {d:.3g} (bar {LATENT_BAR}), "
          f"launches {launches}" + (" PASS" if ok else " FAIL") + f" [{card}]",
          flush=True)
    if not ok:
        failures.append("attribute_response_latent")
    del model, values, rel_in, latent
    torch.cuda.empty_cache()

    # the other families, float32 at reduced depth
    B, T0, N, pad = DECODE_OTHERS
    kv_begin = torch.tensor([pad] + [0] * (B - 1), dtype=torch.int32, device="cuda")
    others = {
        "gemma3_text": (gemma3.Gemma3Config(**dict(GEMMA3_4B,
                                                   num_layers=GEMMA_PARITY_LAYERS)),
                        gemma3.init_params, "Gemma-3-4B width L6 (one global)"),
        "gpt2": (gpt2.GPT2Config(**dict(GPT2_XL, num_layers=GPT2_GATE_LAYERS)),
                 gpt2.init_params, "GPT-2 XL width L6"),
        "mixtral": (mixtral.MixtralConfig(**dict(MIXTRAL_8X7B,
                                                 num_layers=MIXTRAL_GATE[0])),
                    mixtral.init_params, "Mixtral-8x7B width L2 ragged")}
    for family, (cfg_o, init, label) in others.items():
        params = init(cfg_o, torch.Generator("cuda").manual_seed(19))
        model = AttributionModel(family, cfg_o, params,
                                 lxt_tpu_torch.cp_lrp if family == "gpt2"
                                 else lxt_tpu_torch.attnlrp)
        ids = torch.randint(0, cfg_o.vocab_size, (B, T0), generator=gen, device="cuda")
        same, _ = cached_equals_uncached(
            card, f"{label} float32 B{B}x{T0} (row 0 kv_begin {pad})", model, ids, N,
            kv_begin)
        if not same:
            failures.append(f"decode {family} cached against uncached")
        del model, params
        torch.cuda.empty_cache()

    # NF4 Llama-3-8B at full width and depth (phase 7's weights)
    cfg = llama.LlamaConfig(**LLAMA3_8B, dtype="bfloat16")
    model = AttributionModel("llama", cfg, llama.init_params(
        cfg, torch.Generator("cuda").manual_seed(8), quantize_bits="nf4"), lxt_tpu_torch.attnlrp)
    T0, N = DECODE_NF4
    ids = torch.randint(0, cfg.vocab_size, (1, T0), generator=gen, device="cuda")
    model.generate(ids, 2)  # warm-up
    quant.reset_launches()
    _, rose, t_pre = counted(lambda: decode.prefill(model.params, cfg, model.embed(ids),
                                                    T0 + N))
    k3_prefill = quant.launches["nf4_dequant"]
    quant.reset_launches()
    decode.reset_counters()
    out, launches, t_gen = counted(lambda: model.generate(ids, N))
    launches["nf4_dequant"] = quant.launches["nf4_dequant"]
    add(launches)
    nsteps = decode.counters["steps"]
    per_step = (launches["nf4_dequant"] - k3_prefill) / nsteps
    want_step = len(PROJECTIONS) * cfg.num_layers
    ok = (k3_prefill == want_step and per_step == want_step
          and launches["flash_fwd"] == cfg.num_layers and out.shape == (1, T0 + N))
    print(f"decode NF4 Llama-3-8B width L{cfg.num_layers} B1x{T0}, {N} new tokens: "
          f"prefill {t_pre * 1e3:.1f} ms, generate {t_gen:.3f} s, "
          f"{N / t_gen:.2f} tokens/s end to end, {nsteps / (t_gen - t_pre):.2f} tokens/s "
          f"over the steps; K3 launches {k3_prefill} in the prefill and {per_step:g} a "
          f"step (expected {want_step}); flash launches {rose}"
          + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    if not ok:
        failures.append(f"decode NF4 8B launches {launches}")
    return failures, total


class WordTokenizer:
    """Whitespace words -> ids by crc32 (Python's ``hash`` is salted per
    process); 0 pads, 1 ends a sequence. What a served checkpoint's
    AutoTokenizer provides to the pipeline, built without transformers."""

    pad_token_id, eos_token_id = 0, 1

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size

    def __call__(self, text):
        import zlib
        return {"input_ids": [2 + zlib.crc32(w.encode()) % (self.vocab_size - 2)
                              for w in text.split()]}

    def convert_ids_to_tokens(self, ids):
        return [f"t{int(i)}" for i in ids]

    def decode(self, ids):
        return " ".join(self.convert_ids_to_tokens(ids))


def words(rng, bounds, n):
    """``n`` prompts of a length drawn in ``bounds`` (inclusive)."""
    return [" ".join(f"w{int(i)}" for i in rng.integers(0, 10**6, int(k)))
            for k in rng.integers(bounds[0], bounds[1] + 1, n)]


def post(port, path, body):
    """(status, JSON reply, seconds) of one POST to the local server."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            code, out = resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        code, out = e.code, json.loads(e.read())
    return code, out, time.perf_counter() - t0


@contextlib.contextmanager
def served(pipeline):
    """An AttributionServer over ``pipeline`` (max_batch 8, max_wait 10 ms)
    behind http_server on 127.0.0.1, a free port; yields (server, port) and
    stops both."""
    import threading
    from lxt_tpu_torch.serve import AttributionServer, http_server
    server = AttributionServer(pipeline, max_batch=SERVE_MAX_BATCH,
                               max_wait_ms=SERVE_WAIT_MS)
    httpd = http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield server, httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(timeout=60)


def concurrent_posts(port, path, bodies, clients):
    """``bodies`` POSTed from ``clients`` threads released together:
    [(status, reply, seconds)] in order, and the host clock (perf_counter,
    one clock for every process of the machine) before the first request
    and after the last reply."""
    import concurrent.futures
    import threading
    start = threading.Barrier(min(clients, len(bodies)))

    def one(body):
        if len(bodies) <= clients:
            start.wait(timeout=60)
        return post(port, path, body)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(clients) as ex:
        out = list(ex.map(one, bodies))
    return out, t0, time.perf_counter()


def client_process(port, path, bodies, clients, out):
    """A process of its own for the traffic's clients (a server's clients
    do not share its interpreter lock): one GET /healthz first (the
    process's first request imports and builds urllib's machinery), then
    puts concurrent_posts' result on ``out``."""
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
        r.read()
    out.put(concurrent_posts(port, path, bodies, clients))


def remote_posts(port, path, bodies, clients):
    """concurrent_posts from a spawned client process."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=client_process, args=(port, path, bodies, clients, out))
    proc.start()
    try:
        return out.get(timeout=600)
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
            proc.join()


def hf_llama_state(params, cfg):
    """The port's stacked Llama parameters -> an HF Llama state dict
    ([out, in] weights), bf16 tensors on the host."""
    state = {"model.embed_tokens.weight": params["embed"],
             "model.norm.weight": params["final_norm"],
             "lm_head.weight": params["lm_head"].T}
    names = {"ln1": "input_layernorm", "ln2": "post_attention_layernorm",
             "wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "wg": "mlp.gate_proj", "wu": "mlp.up_proj", "wd": "mlp.down_proj"}
    for ours, hf in names.items():
        for i in range(cfg.num_layers):
            w = params["layers"][ours][i]
            state[f"model.layers.{i}.{hf}.weight"] = w if w.dim() == 1 else w.T
    return {k: v.contiguous().cpu() for k, v in state.items()}


def served_maps_gate(card, label, results, prompts, pipe, bar):
    """Each served map (the JSON of /v1/attribute) against
    ``pipe([prompt])`` of its prompt alone: tokens equal, value and
    relevance finite, normalized L2 of the relevance <= ``bar``. Returns
    (ok, the direct maps)."""
    errs, dvals, ok = [], [], True
    direct = []
    for (code, reply, _), prompt in zip(results, prompts):
        want = pipe([prompt])[0]
        direct.append(want)
        if code != 200:
            ok = False
            continue
        (got,) = reply["heatmaps"]
        rel = np.asarray(got["relevance"], np.float64)
        ok = ok and got["tokens"] == want.tokens and bool(np.isfinite(rel).all())
        ok = ok and math.isfinite(got["value"])
        errs.append(float(np.linalg.norm(rel - want.relevance)
                          / np.linalg.norm(want.relevance)))
        dvals.append(abs(got["value"] - want.value))
    ok = ok and len(errs) == len(prompts) and max(errs) <= bar
    print(f"serve {label}: {len(prompts)} served maps against each prompt "
          f"alone, normalized L2 max {max(errs, default=math.inf):.4g} (bar {bar}), "
          f"value max abs diff {max(dvals, default=math.inf):.4g}, tokens equal, "
          f"finite" + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    return ok, direct


def phase_serve(card):
    """Phase 16: a TinyLlama-width checkpoint loaded with from_pretrained
    and served over HTTP. Returns (failures, the flash launches of the 32
    attribute requests)."""
    import torch
    import lxt_tpu_torch
    from lxt_tpu_torch.models import llama
    from lxt_tpu_torch.models.registry import AttributionModel
    from lxt_tpu_torch.ops import flash_attention as fa
    from lxt_tpu_torch.pipeline import AttributionPipeline
    failures = []
    gc.collect()    # earlier phases' cycles: no collector pause mid-traffic
    cfg = llama.LlamaConfig(**MODEL, dtype="bfloat16")
    L = cfg.num_layers
    params = llama.init_params(cfg, torch.Generator("cuda").manual_seed(20))
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(TINYLLAMA_CONFIG, f)
        path = os.path.join(tmp, "model.safetensors")
        t0 = time.perf_counter()
        write_safetensors(path, hf_llama_state(params, cfg))
        t_write, size = time.perf_counter() - t0, os.path.getsize(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = lxt_tpu_torch.from_pretrained(tmp, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    loaded = model.params
    exact = (model.cfg.num_layers == L and all(
        torch.equal(loaded["layers"][n], params["layers"][n]) for n in params["layers"])
        and all(torch.equal(loaded[n], params[n])
                for n in ("embed", "final_norm", "lm_head")))
    print(f"serve load: TinyLlama-1.1B width L{L} bf16 checkpoint "
          f"{size / 1e9:.3f} GB written in {t_write:.2f} s; from_pretrained "
          f"(dtype=bfloat16, device {model.device}) {t_load:.2f} s, "
          f"{size / 1e9 / t_load:.3f} GB/s; "
          f"weights bit-equal to the written ones: {exact}"
          + (" PASS" if exact else " FAIL") + f" [{card}]", flush=True)
    if not exact:
        failures.append("serve checkpoint load")
    del params, loaded
    model = dataclasses.replace(model, remat=False)
    tok = WordTokenizer(cfg.vocab_size)
    calls = []

    class TimedPipeline(AttributionPipeline):
        """Records each call's (start, end) on the host's clock: the
        worker's busy spans (a call ends with its results on the host)."""

        def __call__(self, *args, **kw):
            t0 = time.perf_counter()
            out = super().__call__(*args, **kw)
            calls.append((t0, time.perf_counter()))
            return out

    pipe = TimedPipeline(model, tok)
    if pipe.pad_multiple != 128:
        failures.append(f"serve pad_multiple {pipe.pad_multiple}")
    rng = np.random.default_rng(21)
    prompts = words(rng, SERVE_WORDS, SERVE_REQUESTS)
    # a left-padded batch takes per-example rope positions (kv_begin, the
    # HF convention), so RoPE is applied before the kernels (3-D tables)
    # and no rotation pass runs
    want = expected_launches(L, remat=False)
    with served(pipe) as (server, port):
        # warm-up: one batch of the traffic's shape
        concurrent_posts(port, "/v1/attribute",
                         [{"prompt": p} for p in prompts[:SERVE_MAX_BATCH]],
                         SERVE_MAX_BATCH)
        torch.cuda.synchronize()
        first = len(server.batch_sizes)
        fa.reset_launches()
        calls.clear()
        results, t_first, t_last = remote_posts(
            port, "/v1/attribute", [{"prompt": p} for p in prompts], SERVE_CLIENTS)
        wall = t_last - t_first
        launches = dict(fa.launches)
        batches = list(server.batch_sizes)[first:]
        spans = [round((e - s_) * 1e3, 1) for s_, e in calls]
        gaps = [round((b - a) * 1e3, 1) for (_, a), (b, _) in zip(calls, calls[1:])]
        lat = np.asarray([sec for _, _, sec in results])
        codes_ok = all(code == 200 for code, _, _ in results)
        expect = {n: len(batches) * c for n, c in want.items()}
        ok = codes_ok and launches == expect and sum(batches) == SERVE_REQUESTS
        print(f"serve attribute: {SERVE_REQUESTS} POST /v1/attribute from "
              f"{SERVE_CLIENTS} clients, prompts {SERVE_WORDS[0]}-{SERVE_WORDS[1]} "
              f"words, bf16 L{L} remat off: {SERVE_REQUESTS / wall:.3f} heatmaps/s "
              f"({wall:.3f} s), latency p50 {np.percentile(lat, 50):.3f} s, p99 "
              f"{np.percentile(lat, 99):.3f} s, coalesced batches {batches}, the "
              f"worker's pipeline calls {spans} ms with {gaps} ms between them, the "
              f"first begun {(calls[0][0] - t_first) * 1e3:.1f} ms after the first "
              f"request left, the last reply in {(t_last - calls[-1][1]) * 1e3:.1f} "
              f"ms after the last call's end; launches "
              f"{launches} (expected {len(batches)} batches x {want})"
              + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
        if not ok:
            failures.append(f"serve attribute launches {launches} / batches {batches}")
        ok, direct = served_maps_gate(card, f"bf16 L{L}", results, prompts, pipe,
                                      PADDED_BAR)
        if not ok:
            failures.append("serve bf16 maps")

        post(port, "/v1/attribute", {"prompt": prompts[1], "topk": SERVE_TOPK})
        code, reply, sec = post(port, "/v1/attribute",
                                {"prompt": prompts[0], "topk": SERVE_TOPK})
        cands = reply.get("heatmaps", [[]])[0] if code == 200 else []
        err = (nl2(torch.tensor(cands[0]["relevance"]),
                   torch.from_numpy(direct[0].relevance)) if cands else math.inf)
        ok = (len(cands) == SERVE_TOPK and err <= TOPK_BAR
              and cands[0]["target_token_id"] is not None
              and [c["value"] for c in cands] == sorted(
                  (c["value"] for c in cands), reverse=True))
        print(f"serve topk: one POST /v1/attribute with topk {SERVE_TOPK}: "
              f"{len(cands)} maps in {sec:.3f} s, map 0 against the topk=1 map "
              f"{err:.3g} (bar {TOPK_BAR})" + (" PASS" if ok else " FAIL")
              + f" [{card}]", flush=True)
        if not ok:
            failures.append("serve topk")

        # respond: 4 concurrent greedy requests, coalesced into one respond
        rprompts = words(rng, RESPOND_WORDS, RESPOND_REQUESTS)
        post(port, "/v1/respond", {"prompt": rprompts[0], "max_new_tokens": 2})
        torch.cuda.synchronize()
        first = len(server.batch_sizes)
        fa.reset_launches()
        rres, t_first, t_last = remote_posts(
            port, "/v1/respond",
            [{"prompt": p, "max_new_tokens": RESPOND_TOKENS} for p in rprompts],
            RESPOND_REQUESTS)
        rlaunches = dict(fa.launches)
        rwall = t_last - t_first
        rbatches = list(server.batch_sizes)[first:]
        sampled = [post(port, "/v1/respond", {"prompt": rprompts[0],
                                              "max_new_tokens": RESPOND_TOKENS,
                                              **SAMPLED}) for _ in range(2)]

    ids, kv_begin, seqs = pipe._encode(rprompts)
    T0 = ids.shape[1]
    out = model.generate(ids, RESPOND_TOKENS, eos_token_id=tok.eos_token_id,
                         kv_begin=kv_begin)
    same = all(code == 200 for code, _, _ in rres)
    for i, (code, reply, _) in enumerate(rres):
        gen = out[i, T0:].tolist()
        if tok.eos_token_id in gen:
            gen = gen[:gen.index(tok.eos_token_id) + 1]
        got = ([h["target_token_id"] for h in reply["responses"][0]["heatmaps"]]
               if code == 200 else None)
        same = same and got == gen
    # the prefill launches K1 once a layer; the maps, over prompt +
    # response right-padded to the grid, one forward and one pull per
    # token through the kernels; rope applied outside them throughout
    rwant = expected_launches(L, False, pulls=RESPOND_TOKENS)
    rwant["flash_fwd"] += L
    ok = same and rbatches == [RESPOND_REQUESTS] and rlaunches == rwant
    print(f"serve respond: {RESPOND_REQUESTS} concurrent POST /v1/respond, "
          f"{RESPOND_TOKENS} new tokens greedy, prompts {RESPOND_WORDS[0]}-"
          f"{RESPOND_WORDS[1]} words (T0 {T0}): coalesced batches {rbatches}, "
          f"{rwall:.3f} s, latency {[round(sec, 3) for _, _, sec in rres]} s; tokens "
          f"equal to generate on the same left-padded batch: {same}; launches "
          f"{rlaunches} (expected {rwant})"
          + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    if not ok:
        failures.append("serve respond tokens / coalescing")
    if same:
        # maps 0 and 31 of row 0 against separate attributions at those
        # sites, on the ids right-padded as the pipeline pads them
        T = out.shape[1]
        Tp = -(-T // pipe.pad_multiple) * pipe.pad_multiple
        padded = torch.cat([out, out.new_full((out.shape[0], Tp - T), tok.pad_token_id)], 1)
        maps = rres[0][1]["responses"][0]["heatmaps"]
        lo, keep, errs = T0 - len(seqs[0]), len(maps), []
        for k in RESPOND_CHECKED:
            k = min(k, keep - 1)
            _, sep = model.attribute(padded, position=T0 + k - 1,
                                     token=padded[:, T0 + k], kv_begin=kv_begin)
            r = sep[0, lo:T0 + keep].float().cpu()
            errs.append(nl2(torch.tensor(maps[k]["relevance"]),
                            r / (r.abs().max() + 1e-12)))
        ok = max(errs) <= API_BF16_BAR
        print(f"serve respond maps {list(RESPOND_CHECKED)} of row 0 against separate "
              f"attributions: normalized L2 {[f'{e:.3g}' for e in errs]} (bar "
              f"{API_BF16_BAR})" + (" PASS" if ok else " FAIL") + f" [{card}]",
              flush=True)
        if not ok:
            failures.append("serve respond maps")
    toks = [[h["target_token_id"] for h in reply["responses"][0]["heatmaps"]]
            if code == 200 else None for code, reply, _ in sampled]
    ok = toks[0] is not None and toks[0] == toks[1]
    print(f"serve respond sampled ({SAMPLED}), sent twice: {len(toks[0] or [])} "
          f"tokens, identical: {ok}, latency {[round(sec, 3) for _, _, sec in sampled]} "
          f"s" + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    if not ok:
        failures.append("serve sampled respond")

    # float32 at 2 layers: the served maps within the parity bar
    n_layers, n_req = SERVE_F32
    p32 = cast(model.params, torch.float32)
    p32["layers"] = {n: t[:n_layers] for n, t in p32["layers"].items()}
    del model, pipe
    torch.cuda.empty_cache()
    m32 = AttributionModel("llama", llama.LlamaConfig(**dict(MODEL, num_layers=n_layers)),
                           p32, lxt_tpu_torch.attnlrp, remat=False)
    pipe32 = AttributionPipeline(m32, tok)
    with served(pipe32) as (server, port):
        results, _, _ = concurrent_posts(port, "/v1/attribute",
                                      [{"prompt": p} for p in prompts[:n_req]], n_req)
        batches = list(server.batch_sizes)
    ok, _ = served_maps_gate(card, f"float32 L{n_layers} (coalesced batches "
                             f"{batches})", results, prompts[:n_req], pipe32, PARITY_BAR)
    if not ok:
        failures.append("serve float32 maps")
    del m32, pipe32, p32, server
    gc.collect()
    torch.cuda.empty_cache()
    failures += phase_serve_bits(card)
    return failures, launches


def phase_serve_bits(card):
    """The server's --bits 8 / --bits 4 paths: Llama-3-8B widths and depth,
    init_params(quantize_bits=...), remat on, one prompt of 4096 tokens
    through the pipeline, against a dense bf16 control of the same weights
    (each projection plainly dequantized). int8's product dequantizes to
    bf16 first, so its control computes the same; int4's multiplies the
    integer planes and scales the float32 output, while the control rounds
    q * scale to bf16. So int4 is also run at BITS_CONTROL_LAYERS layers
    against a float32 run of the same dequantized weights, beside the
    control's own distance from it."""
    import torch
    from lxt_tpu_torch.models import llama
    from lxt_tpu_torch.models.registry import AttributionModel
    from lxt_tpu_torch.ops import quant
    from lxt_tpu_torch.pipeline import AttributionPipeline
    import lxt_tpu_torch
    failures = []
    cfg = llama.LlamaConfig(**LLAMA3_8B, dtype="bfloat16")
    tok = WordTokenizer(cfg.vocab_size)
    ids = np.random.default_rng(22).integers(2, cfg.vocab_size, SEQ_8B).tolist()

    def heatmap(params, c=cfg):
        pipe = AttributionPipeline(AttributionModel("llama", c, params,
                                                    lxt_tpu_torch.attnlrp), tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hm = pipe([ids])[0]
        return hm.raw_relevance, time.perf_counter() - t0

    def dense(params, dtype, layers=None):
        out = dict(params, layers=dict(params["layers"]))
        for name in PROJECTIONS:
            qt = params["layers"][name]
            n = layers or qt.q.shape[0]
            out["layers"][name] = torch.stack([quant.dequantize(qt[i], dtype)
                                               for i in range(n)])
        if layers:
            out["layers"] = {n: t[:layers] for n, t in out["layers"].items()}
        return cast(out, dtype) if dtype != torch.bfloat16 else out

    for bits in (8, 4):
        t0 = time.perf_counter()
        params = llama.init_params(cfg, torch.Generator("cuda").manual_seed(23),
                                   quantize_bits=bits)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        qbytes = sum(t.numel() * t.element_size() for n in PROJECTIONS
                     for t in (params["layers"][n].q, params["layers"][n].scale))
        resident = torch.cuda.memory_allocated() / 2**30
        heatmap(params)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        rel, secs = heatmap(params)
        peak = torch.cuda.max_memory_allocated() / 2**30
        finite = bool(np.isfinite(rel).all()) and rel.shape == (SEQ_8B,)
        ctrl = dense(params, torch.bfloat16)
        heatmap(ctrl)  # warm-up
        rel_c, secs_c = heatmap(ctrl)
        d = float(np.linalg.norm(rel - rel_c) / np.linalg.norm(rel_c))
        del ctrl
        torch.cuda.empty_cache()
        line = (f"serve --bits {bits}: Llama-3-8B width L{cfg.num_layers} B1x{SEQ_8B} "
                f"bf16 remat, init and quantize {t_init:.1f} s, int{bits} codes and "
                f"scales {qbytes / 2**30:.2f} GiB; {1 / secs:.4f} heatmaps/s "
                f"({secs:.3f} s), peak device memory {peak:.2f} GiB ({resident:.2f} "
                f"GiB resident before it), relevance "
                f"finite: {finite}; dense bf16 control {1 / secs_c:.4f} heatmaps/s, "
                f"relevance against it: normalized L2 {d:.4g}")
        if bits == 8:
            ok = finite and d <= DENSE_BAR
            line += f" (bar {DENSE_BAR})"
        else:
            # the control's own bf16 rounding, at reduced depth: each of
            # int4 and the bf16 control against float32 on the same weights
            n = BITS_CONTROL_LAYERS
            c_n = llama.LlamaConfig(**dict(LLAMA3_8B, num_layers=n), dtype="bfloat16")
            cut = dict(params, layers={k: (v[:n] if not isinstance(v, quant.QuantizedTensor)
                                          else quant.QuantizedTensor(v.q[:n], v.scale[:n],
                                                                     v.bits, v.block))
                                       for k, v in params["layers"].items()})
            r4, _ = heatmap(cut, c_n)
            rb, _ = heatmap(dense(params, torch.bfloat16, n), c_n)
            r32, _ = heatmap(dense(params, torch.float32, n),
                             llama.LlamaConfig(**dict(LLAMA3_8B, num_layers=n)))

            def dist(a, b):
                return float(np.linalg.norm(a - b) / np.linalg.norm(b))

            d4, db, d4b = dist(r4, r32), dist(rb, r32), dist(r4, rb)
            ok = finite and d <= INT4_BAR and d4 <= DIVERGENCE_BAR
            line += (f" (bar {INT4_BAR}); at L{n}: the bf16 control against float32 "
                     f"{db:.4g}, int4 against float32 {d4:.4g} (bar "
                     f"{DIVERGENCE_BAR}), int4 against the control {d4b:.4g}")
        print(line + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
        if not ok:
            failures.append(f"serve --bits {bits}")
        del params
        torch.cuda.empty_cache()
    return failures


def rule_inputs(kind, device, dtype):
    """Phase 17 (a)'s inputs at ViT-B/16's shapes from a fixed seed, made
    on the CPU: (x, w, b, cotangent)."""
    import torch
    gen = torch.Generator().manual_seed(40)
    if kind == "conv":
        x = (torch.rand(RULE_BATCH, 224, 224, 3, generator=gen, dtype=torch.float64)
             - 0.45) / 0.25
        w = 0.02 * torch.randn(16, 16, 3, 768, generator=gen, dtype=torch.float64)
        out_shape = (RULE_BATCH, 14, 14, 768)
    else:
        x = torch.randn(RULE_BATCH, 197, 768, generator=gen, dtype=torch.float64)
        w = 0.02 * torch.randn(768, 3072, generator=gen, dtype=torch.float64)
        out_shape = (RULE_BATCH, 197, 3072)
    b = 0.02 * torch.randn(w.shape[-1], generator=gen, dtype=torch.float64)
    cot = torch.randn(out_shape, generator=gen, dtype=torch.float64)
    return tuple(t.to(device=device, dtype=dtype) for t in (x, w, b, cot))


def rule_relevance(spec, kind, device, dtype):
    """x * grad of one rule call (the spec on linear and conv alike)."""
    import torch
    import lxt_tpu_torch
    comp = lxt_tpu_torch.cp_lrp.with_rules(linear=spec, conv=spec)
    x, w, b, cot = rule_inputs(kind, device, dtype)
    x.requires_grad_(True)

    def run():
        out = (comp.conv2d(x, w, b, (16, 16)) if kind == "conv"
               else comp.linear(x, w, b))
        return torch.autograd.grad(out, x, cot)[0]

    grad = run()
    ms = cuda_ms(run, iters=5) if device == "cuda" else None
    return (x.detach() * grad).double().cpu(), ms


def phase_rules(card):
    """Phase 17 (a): each rule spec on the card in float32 against float64
    on the CPU."""
    import torch
    failures = []
    for name, spec in RULE_SPECS.items():
        for kind in ("conv", "linear"):
            ref, _ = rule_relevance(spec, kind, "cpu", torch.float64)
            got, ms = rule_relevance(spec, kind, "cuda", torch.float32)
            d = nl2(got, ref)
            bar, note = RULE_BAR, ""
            if spec[0] == "gamma":
                own = nl2(rule_relevance(spec, kind, "cpu", torch.float32)[0], ref)
                bar, note = RULE_GAMMA_FACTOR * own, f" (CPU float32: {own:.4g})"
            ok = math.isfinite(d) and d <= bar
            shape = ("conv 16x16/16 3->768 over 224x224" if kind == "conv"
                     else "linear 768->3072 over 197 rows")
            print(f"rule {name} {shape} B{RULE_BATCH} float32 on the card vs "
                  f"float64 on the CPU: normalized L2 {d:.4g} (bar {bar:.4g}){note}; "
                  f"forward + backward {ms:.3f} ms" + (" PASS" if ok else " FAIL")
                  + f" [{card}]", flush=True)
            if not ok:
                failures.append(f"rule {name} {kind}")
    return failures


def vision_images(gen, batch, size, dtype):
    """Normalized random pixels, NHWC, on the card."""
    import torch
    x = torch.rand(batch, size, size, 3, generator=gen, device="cuda")
    return ((x - 0.45) / 0.25).to(dtype)


def phase_vit(card):
    """Phase 17 (b) and (c): ViT-B/16 and OpenCLIP ViT-L/14. Returns
    (failures, flash launches over the driven calls)."""
    import torch
    import lxt_tpu_torch
    from lxt_tpu_torch.models import vit
    from lxt_tpu_torch.models.registry import VisionAttributionModel
    from lxt_tpu_torch.ops import flash_attention as fa
    failures, launches = [], {n: 0 for n in fa.launches}

    def add(counts):
        for n, c in counts.items():
            launches[n] += c

    cfg = vit.ViTConfig(**VIT_B16)
    gen = torch.Generator("cuda").manual_seed(30)
    params32 = vit.init_params(cfg, gen)
    params16 = cast(params32, torch.bfloat16)
    gamma = lxt_tpu_torch.cp_lrp.with_gamma(conv_gamma=0.25, linear_gamma=0.05)
    model = VisionAttributionModel("vit", cfg, params16, gamma)
    requests = [vision_images(gen, VIT_BATCH, 224, torch.bfloat16)
                for _ in range(REQUESTS)]
    logits = {c.name: model.logits(requests[0], composite=c)
              for c in (lxt_tpu_torch.attnlrp, lxt_tpu_torch.cp_lrp, gamma)}
    same = all(torch.equal(v, logits[gamma.name]) for v in logits.values())
    print(f"ViT-B/16 bf16 B{VIT_BATCH}: logits bit-equal across "
          f"{sorted(logits)}: {same}" + (" PASS" if same else " FAIL") + f" [{card}]",
          flush=True)
    if not same:
        failures.append("ViT-B/16 logits differ across composites")
    model.attribute_image(requests[0])  # warm-up
    torch.cuda.reset_peak_memory_stats()
    outs, counts, secs = counted(lambda: [model.attribute_image(x) for x in requests])
    add(counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rate = VIT_BATCH * REQUESTS / secs
    ok = all(h.shape == (VIT_BATCH, 224, 224) and bool(torch.isfinite(h).all())
             for _, h in outs) and not any(counts.values())
    print(f"ViT-B/16 L{cfg.num_layers} B{VIT_BATCH} bf16 {gamma.name} (conv gamma "
          f"0.25, linear gamma 0.05), remat: {REQUESTS} calls, {rate:.2f} heatmaps/s "
          f"({secs / REQUESTS:.4f} s a batch), peak device memory {peak:.2f} GiB, "
          f"heatmaps finite and [{VIT_BATCH}, 224, 224], flash launches {counts}"
          + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    if not ok:
        failures.append("ViT-B/16 heatmaps or launches")
    # bf16 against float32 on the same (bf16-rounded) weights and pixels,
    # each image explaining the class the bf16 logits pick (random weights
    # leave near-ties among 1000 classes, which the two precisions may break
    # apart), gated under cp_lrp and under cp_lrp with the conv gamma (the
    # conv's inputs are the pixels, the same in both runs); the gamma rule
    # on the linears is ill-conditioned (its denominators z = x (w + g w+)
    # + b cross 0, and bf16 activations move them), so the whole gamma
    # composite's distance is printed, not gated (phase 17 (a) measures
    # the rule's own float32 error)
    del params32
    up = cast(params16, torch.float32)
    conv_gamma = lxt_tpu_torch.cp_lrp.with_gamma(conv_gamma=0.25)
    labels = logits[gamma.name].argmax(-1)
    flips = int((VisionAttributionModel("vit", cfg, up, gamma).logits(
        requests[0].float()).argmax(-1) != labels).sum())

    def div(comp, h16=None):
        if h16 is None:
            h16 = VisionAttributionModel("vit", cfg, params16, comp).attribute_image(
                requests[0], label=labels)[1]
        h32 = VisionAttributionModel("vit", cfg, up, comp).attribute_image(
            requests[0].float(), label=labels)[1]
        return nl2(h16, h32)

    d_cp, d_conv, d_gamma = (div(lxt_tpu_torch.cp_lrp), div(conv_gamma),
                             div(gamma, outs[0][1]))
    ok = all(math.isfinite(d) and d <= DIVERGENCE_BAR for d in (d_cp, d_conv))
    print(f"ViT-B/16 bf16 vs float32 heatmaps B{VIT_BATCH}, the same bf16 weights, "
          f"pixels and labels (the float32 argmax differs on {flips} of "
          f"{VIT_BATCH}): normalized L2 cp_lrp {d_cp:.4g}, cp_lrp with conv gamma "
          f"0.25 {d_conv:.4g} (bar {DIVERGENCE_BAR}); {gamma.name} (conv 0.25, "
          f"linear 0.05) {d_gamma:.4g} (not gated: gamma on the linears)"
          + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    if not ok:
        failures.append("ViT-B/16 bf16 divergence")
    del up
    (labels, values, maps), counts, secs = counted(
        lambda: model.attribute_topk(requests[1], TOPK_VIT))
    add(counts)
    t0 = time.perf_counter()
    sep = [model.attribute_image(requests[1], label=labels[k]) for k in range(TOPK_VIT)]
    torch.cuda.synchronize()
    t_sep = time.perf_counter() - t0
    d = max(nl2(maps[k], h) for k, (_, h) in enumerate(sep))
    ok = d <= API_BF16_BAR and not any(counts.values())
    print(f"ViT-B/16 attribute_topk k {TOPK_VIT} B{VIT_BATCH}: {secs:.4f} s "
          f"({TOPK_VIT * VIT_BATCH / secs:.2f} maps/s) against {TOPK_VIT} "
          f"attribute_image(label=) calls {t_sep:.4f} s; worst map normalized L2 "
          f"{d:.3g} (bar {API_BF16_BAR}), flash launches {counts}"
          + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    if not ok:
        failures.append("ViT-B/16 attribute_topk")
    del model, params16, requests, outs, maps, sep
    torch.cuda.empty_cache()

    cfg = vit.ViTConfig(**OPENCLIP_L14)
    params = vit.init_params(cfg, gen, dtype=torch.bfloat16)
    model = VisionAttributionModel("openclip", cfg, params, lxt_tpu_torch.cp_lrp)
    direction = torch.randn(cfg.proj_dim, generator=gen, device="cuda")
    direction = (direction / direction.norm()).to(torch.bfloat16)
    requests = [vision_images(gen, CLIP_BATCH, 224, torch.bfloat16)
                for _ in range(REQUESTS)]
    model.attribute_image(requests[0], target=direction)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    outs, counts, secs = counted(
        lambda: [model.attribute_image(x, target=direction) for x in requests])
    add(counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ok = all(h.shape == (CLIP_BATCH, 224, 224) and bool(torch.isfinite(h).all())
             for _, h in outs) and not any(counts.values())
    print(f"OpenCLIP ViT-L/14 L{cfg.num_layers} B{CLIP_BATCH} bf16 cp_lrp, remat, "
          f"a unit direction of {cfg.proj_dim}: {REQUESTS} calls, "
          f"{CLIP_BATCH * REQUESTS / secs:.2f} maps/s, peak device memory "
          f"{peak:.2f} GiB, maps finite, flash launches {counts}"
          + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    if not ok:
        failures.append("OpenCLIP ViT-L/14 maps or launches")
    return failures, launches


def mm_config(vision_layers=None, text_layers=None):
    """Gemma-3-4B image + text (phase 17 (d)), cut in depth if asked."""
    from lxt_tpu_torch.models import gemma3, siglip
    vision = siglip.SiglipConfig(**dict(SIGLIP_896, num_layers=vision_layers
                                        or SIGLIP_896["num_layers"]))
    text = gemma3.Gemma3Config(**dict(GEMMA3_4B, num_layers=text_layers
                                      or GEMMA3_4B["num_layers"]))
    return gemma3.Gemma3MultimodalConfig(text=text, vision=vision,
                                         mm_tokens_per_image=MM_TOKENS,
                                         image_token_id=IMAGE_TOKEN)


def mm_weights(mmcfg, gen, dtype):
    """Random image + text weights from ``gen``: SigLIP, the projector and
    the text model (its norms 0, a multiplier of 1)."""
    import torch
    from lxt_tpu_torch.models import common, gemma3, siglip
    Dv, Dt = mmcfg.vision.hidden_size, mmcfg.text.hidden_size
    return {"vision": siglip.init_params(mmcfg.vision, gen, dtype=dtype),
            "mm_proj": common.uniform_init(gen, (Dv, Dt), dtype=dtype, device="cuda"),
            "mm_norm": torch.zeros(Dv, dtype=dtype, device="cuda"),
            "text": gemma3.init_params(mmcfg.text, gen, dtype=dtype)}


def mm_prompt(gen, dtype):
    """One request: ids [1, SEQ_MM], text tokens around boi, the image's
    MM_TOKENS placeholders and eoi; pixels [1, 896, 896, 3] in [-1, 1]."""
    import torch
    ids = torch.randint(0, BOI, (1, SEQ_MM), generator=gen, device="cuda")
    ids[:, MM_IMAGE_AT - 1] = BOI
    ids[:, MM_IMAGE_AT:MM_IMAGE_AT + MM_TOKENS] = IMAGE_TOKEN
    ids[:, MM_IMAGE_AT + MM_TOKENS] = EOI
    pix = torch.rand(1, 896, 896, 3, generator=gen, device="cuda") * 2 - 1
    return ids, pix.to(dtype)


def mm_attribute(params, mmcfg, ids, pix, impl):
    """The joint map of the argmax logit at the last position through
    multimodal_forward with the text attention on ``impl``, remat off:
    (logits [1, 1, V], token relevance [1, T], pixel heatmap [1, H, W])."""
    import torch
    import lxt_tpu_torch
    from lxt_tpu_torch.models import gemma3
    mask = ids == mmcfg.image_token_id
    e = gemma3.embed(params["text"], ids, mmcfg.text).detach().requires_grad_(True)
    p = pix.detach().requires_grad_(True)
    with torch.enable_grad():
        logits = gemma3.multimodal_forward(
            params, mmcfg, e, p, mask, lxt_tpu_torch.attnlrp, remat=False,
            attn_impl=impl, logits_at=-1).logits
        ge, gp = torch.autograd.grad(lxt_tpu_torch.select_logit(logits), (e, p))
    return (logits.detach(), (e.detach().float() * ge.float()).sum(-1),
            (p.detach().float() * gp.float()).sum(-1))


def phase_multimodal(card):
    """Phase 17 (d): the gates at reduced depth, then Gemma-3-4B image +
    text at full width and depth. Returns (failures, flash launches over
    the driven calls)."""
    import torch
    import lxt_tpu_torch
    from lxt_tpu_torch.models.registry import MultimodalAttributionModel
    from lxt_tpu_torch.ops import flash_attention as fa
    failures, launches = [], {n: 0 for n in fa.launches}
    gen = torch.Generator("cuda").manual_seed(50)
    Lv, Lt = MM_GATE
    mmcfg = mm_config(Lv, Lt)
    params = mm_weights(mmcfg, gen, torch.float32)
    ids, pix = mm_prompt(gen, torch.float32)
    label = f"Gemma-3-4B image + text width, {Lv} vision / {Lt} text layers, B1x{SEQ_MM}"
    fa.reset_launches()
    k_out = mm_attribute(params, mmcfg, ids, pix, "auto")
    torch.cuda.synchronize()
    rose = dict(fa.launches)
    e_out = mm_attribute(params, mmcfg, ids, pix, "einsum")
    d = [nl2(a, b) for a, b in zip(k_out, e_out)]
    finite = all(bool(torch.isfinite(t).all()) for t in k_out)
    want = expected_launches(Lt, remat=False)
    ok = finite and max(d) <= PARITY_BAR and rose == want
    print(f"{label} float32: text side on the kernels vs einsum normalized L2 "
          f"logits {d[0]:.3g}, token relevance {d[1]:.3g}, pixel heatmap {d[2]:.3g} "
          f"(bar {PARITY_BAR}); finite {finite}; launches {rose} (expected {want})"
          + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    if not ok:
        failures.append("multimodal float32 parity")
    out16 = mm_attribute(cast(params, torch.bfloat16), mmcfg, ids,
                         pix.to(torch.bfloat16), "auto")
    d16 = [nl2(a, b) for a, b in zip(out16[1:], k_out[1:])]
    finite = all(bool(torch.isfinite(t).all()) for t in out16)
    ok = finite and max(d16) <= DIVERGENCE_BAR
    print(f"{label} bf16 vs float32, kernels: token relevance {d16[0]:.4g}, pixel "
          f"heatmap {d16[1]:.4g} (bar {DIVERGENCE_BAR}); finite {finite}"
          + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    if not ok:
        failures.append("multimodal bf16 divergence")
    model = MultimodalAttributionModel(mmcfg, params, lxt_tpu_torch.attnlrp, remat=False)
    cached = model.generate(ids, pix, MM_NEW)
    same = bool(torch.equal(cached, model.generate(ids, pix, MM_NEW, use_cache=False)))
    print(f"{label} float32 generate {MM_NEW} greedy tokens: cached equal to "
          f"uncached {same}" + (" PASS" if same else " FAIL") + f" [{card}]", flush=True)
    if not same:
        failures.append("multimodal cached tokens differ from uncached")
    del model, params, k_out, e_out, out16
    torch.cuda.empty_cache()

    mmcfg = mm_config()
    t0 = time.perf_counter()
    params = mm_weights(mmcfg, gen, torch.bfloat16)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in iter_leaves(params))
    model = MultimodalAttributionModel(mmcfg, params, lxt_tpu_torch.attnlrp, remat=False)
    requests = [mm_prompt(gen, torch.bfloat16) for _ in range(REQUESTS)]
    Lt = mmcfg.text.num_layers
    label = (f"Gemma-3-4B image + text, {mmcfg.vision.num_layers} vision / {Lt} text "
             f"layers, B1x{SEQ_MM} with one 896x896 image ({MM_TOKENS} tokens), bf16")
    model.attribute(*requests[0])  # warm-up
    torch.cuda.reset_peak_memory_stats()
    outs, counts, secs = counted(lambda: [model.attribute(*r) for r in requests])
    for n, c in counts.items():
        launches[n] += c
    peak = torch.cuda.max_memory_allocated() / 2**30
    per = {n: c / REQUESTS for n, c in counts.items()}
    want = expected_launches(Lt, remat=False, hopper=HOPPER_BODIES[256])
    ok = all(t.shape == (1, SEQ_MM) and p.shape == (1, 896, 896)
             and bool(torch.isfinite(t).all() and torch.isfinite(p).all())
             for _, t, p in outs)
    print(f"{label}, text remat off: {n_params / 1e9:.3f} B parameters, init "
          f"{t_init:.3f} s; {REQUESTS} joint maps, {REQUESTS / secs:.4f} heatmaps/s "
          f"({secs / REQUESTS:.4f} s each), launches per map {per} (expected {want}), "
          f"token relevance [1, {SEQ_MM}] and pixel heatmap [1, 896, 896] finite: "
          f"{ok}, peak device memory {peak:.2f} GiB" + (" PASS" if ok and per == want
                                                        else " FAIL")
          + f" [{card}]", flush=True)
    if not ok:
        failures.append("multimodal relevance not finite or misshapen")
    if per != want:
        failures.append(f"multimodal launches per map {per}")

    ids, pix = requests[0]
    out, counts, secs = counted(lambda: model.generate(ids, pix, MM_NEW))
    for n, c in counts.items():
        launches[n] += c
    want = {n: (Lt if n == "flash_fwd" else 0) for n in counts}
    uncached = model.generate(ids, pix, MM_NEW, use_cache=False)
    agree = int((uncached == out).all(0).sum()) - SEQ_MM
    ok = counts == want
    print(f"{label}: generate {MM_NEW} tokens cached {secs:.3f} s "
          f"({MM_NEW / secs:.2f} tokens/s, the image encoded once), launches "
          f"{counts} (expected {want}); bf16 uncached agrees on {agree} of {MM_NEW} "
          f"tokens (not gated: bf16 ties; the float32 gate above)"
          + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    if not ok:
        failures.append(f"multimodal generate launches {counts}")
    T = out.shape[1]
    padded = -(-T // 128) * 128
    torch.cuda.reset_peak_memory_stats()
    (values, rel_tok, rel_pix), counts, secs = counted(
        lambda: model.attribute_response(out, pix, SEQ_MM))
    for n, c in counts.items():
        launches[n] += c
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = expected_launches(Lt, remat=False, hopper=HOPPER_BODIES[256], pulls=MM_NEW)
    _, tok0, pix0 = model.attribute(out[:, :SEQ_MM], pix, token=out[:, SEQ_MM])
    d = max(nl2(rel_tok[0, :, :SEQ_MM], tok0), nl2(rel_pix[0], pix0))
    ok = (counts == want and d <= API_BF16_BAR and rel_tok.shape == (MM_NEW, 1, T)
          and bool(torch.isfinite(rel_tok).all() and torch.isfinite(rel_pix).all()))
    print(f"{label}: attribute_response over {SEQ_MM} + {MM_NEW} tokens padded to "
          f"{padded}, K {MM_NEW}: {secs:.3f} s ({MM_NEW / secs:.3f} maps/s), peak "
          f"device memory {peak:.2f} GiB, launches {counts} (expected {want}), map 0 "
          f"against a separate attribute normalized L2 {d:.3g} (bar {API_BF16_BAR})"
          + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    if not ok:
        failures.append("multimodal attribute_response")
    return failures, launches


def iter_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from iter_leaves(v)
    else:
        yield tree


def phase_vision(card):
    """Phase 17: the rules, the vision towers, Gemma-3-4B image + text.
    Returns (failures, {"vision": launches, "multimodal": launches})."""
    import torch
    t0 = time.perf_counter()
    failures = phase_rules(card)
    f, vision = phase_vit(card)
    failures += f
    torch.cuda.empty_cache()
    f, multimodal = phase_multimodal(card)
    failures += f
    torch.cuda.empty_cache()
    print(f"phase 17 took {time.perf_counter() - t0:.1f} s", flush=True)
    return failures, {"vision": vision, "multimodal": multimodal}


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def explicit_setup(family, layers=None, seed=18):
    """``(cfg, params, ids, composite, efficient module, explicit module,
    embed)`` of one family at full width (``layers`` cuts the depth),
    float32 random weights from ``seed`` drawn on the card; the ids one row
    of SEQ (SEQ_BERT)."""
    import torch
    import lxt_tpu_torch
    from lxt_tpu_torch.models import (bert, bert_explicit, gpt2, gpt2_explicit, llama,
                                      llama_explicit)
    gen = torch.Generator("cuda").manual_seed(seed)
    if family == "llama":
        cfg = llama.LlamaConfig(**dict(MODEL, num_layers=layers or MODEL["num_layers"]))
        params, comp, mod, ex, T = (llama.init_params(cfg, gen), lxt_tpu_torch.attnlrp,
                                    llama, llama_explicit, SEQ)
    elif family == "gpt2":
        cfg = gpt2.GPT2Config(**dict(GPT2_XL, num_layers=layers or GPT2_XL["num_layers"]))
        params, comp, mod, ex, T = (gpt2.init_params(cfg, gen), lxt_tpu_torch.cp_lrp,
                                    gpt2, gpt2_explicit, SEQ)
    else:
        cfg = bert.BertConfig(**dict(BERT_BASE, num_layers=layers or BERT_BASE["num_layers"]))
        params, comp, mod, ex, T = (bert.init_params(cfg, gen), lxt_tpu_torch.attnlrp,
                                    bert, bert_explicit, SEQ_BERT)
    ids = torch.randint(0, cfg.vocab_size, (1, T), generator=gen, device="cuda")
    embed = {"llama": lambda p, i: llama.embed(p, i), "bert": lambda p, i: bert.embed(p, i),
             "gpt2": lambda p, i: p["wte"][i]}[family]
    return cfg, params, ids, comp, mod, ex, embed


def explicit_target(family, cfg, params, comp, ex, remat=True, **kw):
    """The explained target as a function of the embeddings: the argmax
    logit at the last position (BERT: the argmax label), summed over the
    batch."""
    def target(e):
        if family == "bert":
            return ex.forward(params, cfg, e, remat=remat, **kw).logits.max(-1).values.sum()
        logits = ex.forward(params, cfg, e, comp, remat=remat, **kw).logits
        return logits[:, -1].max(-1).values.sum()

    return target


def explicit_map(family, cfg, params, comp, ex, embed, ids, remat=True, **kw):
    """The explicit input relevance of :func:`explicit_target`."""
    from lxt_tpu_torch.models import llama_explicit
    return llama_explicit.explicit_input_relevance(
        explicit_target(family, cfg, params, comp, ex, remat, **kw), embed(params, ids))[1]


def explicit_sites(family, cfg, params, comp, ex, embed, ids, **kw):
    """:func:`explicit_map` (remat off) with its graph kept. Returns the map;
    for every node of a custom Function in the backward (the rules, RoPE's
    half swap), ``(node, incoming relevance, relevances returned)``; and a
    function that runs the backward over the kept graph again and returns
    its map. The graph, and with it the nodes' saved tensors, lives as long
    as that function."""
    import torch
    x = embed(params, ids).detach().requires_grad_(True)
    with torch.enable_grad():
        value = explicit_target(family, cfg, params, comp, ex, False, **kw)(x)
        nodes, stack, seen = [], [value.grad_fn], set()
        while stack:
            node = stack.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            if hasattr(node, "_forward_cls"):
                nodes.append(node)
            stack.extend(c for c, _ in node.next_functions)
        io = {}
        for node in nodes:
            node.register_hook(lambda gi, go, node=node: io.__setitem__(node, (go, gi)))

    def backward():
        (rel,) = torch.autograd.grad(value, x, value.detach(), retain_graph=True)
        return rel.float().sum(-1)

    rel = backward()
    return rel, [(node, *io[node]) for node in nodes], backward


def replay_sites(sites, device):
    """Run each site's backward again on ``device``, from its node's saved
    tensors and incoming relevance. Returns the worst normalized L2 against
    the relevances the site returned (inf where they disagree in number,
    are not finite, or one of them is 0 where the other is not) and the
    name of its Function."""
    import types
    import torch
    worst, where = 0.0, None
    for node, grads_out, grads_in in sites:
        ctx = types.SimpleNamespace(**vars(node))     # what the forward kept on ctx
        ctx.saved_tensors = tuple(t.to(device) for t in node.saved_tensors)
        ctx.needs_input_grad = node.needs_input_grad
        out = node._forward_cls.backward(
            ctx, *(None if g is None else g.to(device) for g in grads_out))
        got = [t.cpu() for t in (out if isinstance(out, tuple) else (out,))
               if isinstance(t, torch.Tensor)]
        want = [t for t in grads_in if t is not None]
        errs = [nl2(a, b) if b.norm() > 0 else (0.0 if a.norm() == 0 else math.inf)
                for a, b in zip(got, want)]
        err = max((math.inf if math.isnan(e) else e for e in errs), default=0.0)
        if len(got) != len(want):
            err = math.inf
        if err > worst or where is None:
            worst, where = err, node._forward_cls.__name__
    return worst, where


def phase_explicit_models(card):
    """Phase 18 (a): the explicit models at full width and depth, bf16."""
    import torch
    from lxt_tpu_torch.ops import flash_attention as fa
    failures = []
    for family in ("llama", "gpt2", "bert"):
        cfg, params32, ids1, comp, _, ex, embed = explicit_setup(family)
        params = cast(params32, torch.bfloat16)
        B, T = (BERT_BATCH, SEQ_BERT) if family == "bert" else (SERVE_BATCH, SEQ)
        gen = torch.Generator("cuda").manual_seed(181)
        kw = {}
        if family == "bert":
            mask = torch.ones(B, T, dtype=torch.int32, device="cuda")
            mask[:B // 4, BERT_REAL:] = 0
            kw["attention_mask"] = mask
        requests = [torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device="cuda")
                    for _ in range(EXPLICIT_REQUESTS)]
        explicit_map(family, cfg, params, comp, ex, embed, requests[0], **kw)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        rels, launches, secs = counted(lambda: [
            explicit_map(family, cfg, params, comp, ex, embed, r, **kw) for r in requests])
        peak = torch.cuda.max_memory_allocated() / 2**30
        ok = all(r.shape == (B, T) and bool(torch.isfinite(r).all()) for r in rels)
        if family == "bert":
            ok = ok and all(bool((r[:B // 4, BERT_REAL:] == 0).all()) for r in rels)
        one = {k: v[:1] for k, v in kw.items()}
        rel16 = explicit_map(family, cfg, params, comp, ex, embed, ids1, **one)
        rel32 = explicit_map(family, cfg, params32, comp, ex, embed, ids1, **one)
        ok = ok and not any(launches.values())
        print(f"explicit {family} L{cfg.num_layers} B{B}x{T} bf16 remat on {comp.name}"
              + (f" ({B // 4} rows masked to {BERT_REAL})" if family == "bert" else "")
              + f": {EXPLICIT_REQUESTS} attributions, {B * EXPLICIT_REQUESTS / secs:.3f} "
              f"heatmaps/s, peak device memory {peak:.2f} GiB, flash launches {launches}, "
              f"maps finite and [{B}, {T}]" + (" and 0 on the masked keys" if family == "bert"
                                               else "")
              + f": {ok}; bf16 vs float32 map at B1x{T}: normalized L2 "
              f"{nl2(rel16.float(), rel32):.4g} (not gated) [{card}]", flush=True)
        if not ok:
            failures.append(f"explicit {family} bf16 maps or launches")
        del params, params32, rels
        torch.cuda.empty_cache()
    return failures


def phase_explicit_gates(card):
    """Phase 18 (b): float32 at full width, EXPLICIT_GATE_LAYERS layers."""
    import torch
    from lxt_tpu_torch.attribution import input_relevance, latent_relevance
    from lxt_tpu_torch.models import llama_explicit
    failures = []
    for family in ("llama", "gpt2", "bert"):
        cfg, params, ids, comp, mod, ex, embed = explicit_setup(family, EXPLICIT_GATE_LAYERS)
        kw_ex, kw_gi = {}, {}
        if family == "bert":     # the row right-padded to BERT_REAL
            kw_ex = {"attention_mask": (torch.arange(SEQ_BERT, device="cuda")[None]
                                        < BERT_REAL).int()}
            kw_gi = {"kv_end": torch.tensor([BERT_REAL], dtype=torch.int32, device="cuda")}
        rel_ex = explicit_map(family, cfg, params, comp, ex, embed, ids, remat=False, **kw_ex)

        def target(e):
            logits = mod.forward(params, cfg, e, comp, remat=False, **kw_gi).logits
            return (logits if logits.dim() == 2 else logits[:, -1]).max(-1).values.sum()

        (_, rel_gi), launches, _ = counted(lambda: input_relevance(target, embed(params, ids)))
        cos = cosine(rel_ex, rel_gi)
        cpu = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v.cpu())
               for k, v in params.items()}
        rel_cpu, sites, graph = explicit_sites(family, cfg, cpu, comp, ex, embed, ids.cpu(),
                                               **{k: v.cpu() for k, v in kw_ex.items()})
        site_err, site_fn = replay_sites(sites, "cuda")
        n_sites = len(sites)
        del sites, graph
        rel64 = explicit_map(family, cfg, cast(params, torch.float64), comp, ex, embed, ids,
                             remat=False, **kw_ex).cpu()
        e_card, e_cpu = nl2(rel_ex.cpu(), rel64), nl2(rel_cpu, rel64)
        bar64 = EXPLICIT_F64_BAR[family]
        ok = (cos > EXPLICIT_COS and site_err <= EXPLICIT_SITE_BAR and e_card <= bar64
              and launches["flash_fwd"] == launches["flash_bwd_dq"]
              == launches["flash_bwd_dkv"] == cfg.num_layers)
        print(f"explicit {family} float32 L{cfg.num_layers} B1x{ids.shape[1]} {comp.name}: "
              f"explicit vs efficient through K1/K2 cosine {cos:.7f} (bar > {EXPLICIT_COS}, "
              f"efficient launches {launches}); card vs host CPU over {n_sites} rule sites, "
              f"each backward run on the card from the CPU's saved tensors: worst normalized "
              f"L2 {site_err:.3g} at {site_fn} (bar {EXPLICIT_SITE_BAR}); explicit map against "
              f"float64: card {e_card:.3g} (bar {bar64}), host CPU {e_cpu:.3g}, card vs host "
              f"CPU {nl2(rel_ex.cpu(), rel_cpu):.3g}" + (" PASS" if ok else " FAIL")
              + f" [{card}]", flush=True)
        if not ok:
            failures.append(f"explicit {family} float32 gates")
        if family == "llama":
            L, shape = cfg.num_layers, (cfg.num_layers, 1, SEQ, cfg.hidden_size)
            _, in_ex, lat_ex = llama_explicit.explicit_latent_relevance(
                lambda e, p: ex.forward(params, cfg, e, comp, remat=False,
                                        probes=p).logits[:, -1].max(-1).values.sum(),
                embed(params, ids), shape)

            def fwd(e, p):
                out = mod.forward(params, cfg, e, comp, probes=p, remat=False,
                                  output_hidden_states=True, logits_at=-1)
                return out.logits[:, -1].max(-1).values.sum(), out.hidden_states

            _, in_gi, lat_gi = latent_relevance(fwd, embed(params, ids), shape,
                                                sum_features=True)
            c_in, c_lat = cosine(in_ex, in_gi), cosine(lat_ex, lat_gi)
            ok = c_in > EXPLICIT_COS and c_lat > EXPLICIT_COS
            print(f"explicit llama float32 L{L} B1x{SEQ}: explicit_latent_relevance vs "
                  f"latent_relevance through K1/K2 cosine input {c_in:.7f}, latent "
                  f"{c_lat:.7f} (bar > {EXPLICIT_COS})" + (" PASS" if ok else " FAIL")
                  + f" [{card}]", flush=True)
            if not ok:
                failures.append("explicit llama latent relevance")
        del params, cpu
        torch.cuda.empty_cache()
    return failures


def kernel_census(fn):
    """``{kernel name: launches}`` of the device kernels ``fn()`` runs, and
    its device-to-host copies, by torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    census, dtoh = {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        if "DtoH" in e.name or "Device -> Pageable" in e.name:
            dtoh += 1
        census[e.name] = census.get(e.name, 0) + 1
    return census, dtoh


def phase_check(card):
    """Phase 18 (c): check= on the main path."""
    import torch
    import lxt_tpu_torch
    from lxt_tpu_torch.models import llama
    from lxt_tpu_torch.models.registry import AttributionModel
    from lxt_tpu_torch.ops import check as ck
    failures = []
    cfg = llama.LlamaConfig(**MODEL, dtype="bfloat16")
    params = llama.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    ids = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SEQ),
                        generator=torch.Generator("cuda").manual_seed(1), device="cuda")
    L = cfg.num_layers
    for remat in (False, True):
        model = AttributionModel("llama", cfg, params, lxt_tpu_torch.attnlrp, remat=remat)
        model.attribute(ids, check="nan")  # warm-up
        (_, plain), plain_launches, _ = counted(lambda: model.attribute(ids))
        (_, again), _, _ = counted(lambda: model.attribute(ids))
        reads = ck.counters["host_reads"]
        (_, nan), nan_launches, _ = counted(lambda: model.attribute(ids, check="nan"))
        reads = ck.counters["host_reads"] - reads
        want = expected_launches(L, remat, hopper=HOPPER_BODIES[64])
        times = {None: [], "nan": []}
        for _ in range(CHECK_REPS):
            for mode in (None, "nan", "nan", None):
                times[mode].append(counted(lambda: model.attribute(ids, check=mode))[2])
        ms = {m: 1e3 * sorted(t)[len(t) // 2] for m, t in times.items()}
        (_, cons), _, _ = counted(lambda: model.attribute(ids, check="conservation"))
        wq, at = params["layers"]["wq"], (L // 4, 7, 11)
        saved = wq[at].clone()
        wq[at] = float("nan")
        raised = ""
        try:
            model.attribute(ids, check="nan")
        except RuntimeError as e:
            raised = str(e)
        finally:
            wq[at] = saved
        ok = (torch.equal(nan, plain) and nan_launches == want == plain_launches
              and reads == 1 and "NaN/Inf relevance" in raised
              and bool(torch.isfinite(cons).all()))
        print(f"check= main path bf16 L{L} B{SERVE_BATCH}x{SEQ} remat {remat}: 'nan' map "
              f"bit-equal to None's {torch.equal(nan, plain)} (None twice: "
              f"{torch.equal(again, plain)}), launches {nan_launches} (expected {want}), "
              f"host reads {reads}; a NaN in layer {L // 4}'s wq raised: {raised[:90]!r}; "
              f"'conservation' finite {bool(torch.isfinite(cons).all())}; ms per call "
              f"None {ms[None]:.2f}, 'nan' {ms['nan']:.2f} (overhead "
              f"{ms['nan'] - ms[None]:.2f} ms; medians of {2 * CHECK_REPS}, in turns)"
              + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
        if not ok:
            failures.append(f"check= remat {remat}")
        # check=None against the direct attribution, which reaches no check code
        model_census, model_dtoh = kernel_census(lambda: model.attribute(ids))
        direct_census, _ = kernel_census(
            lambda: attribute(params, cfg, ids, "auto", remat))
        nan_census, nan_dtoh = kernel_census(lambda: model.attribute(ids, check="nan"))
        extra = {k: v - model_census.get(k, 0) for k, v in nan_census.items()
                 if v != model_census.get(k, 0)}
        ok = bool(model_census) and model_census == direct_census and model_dtoh == 0
        print(f"check=None device kernels remat {remat}: {sum(model_census.values())} "
              f"launches of {len(model_census)} kernels, equal to the direct "
              f"attribution's ({sum(direct_census.values())}): "
              f"{model_census == direct_census}; device-to-host copies None {model_dtoh}, "
              f"'nan' {nan_dtoh}; 'nan' adds {sum(extra.values())} launches: "
              + ", ".join(f"{k[:60]} x{v}" for k, v in sorted(extra.items(),
                                                                key=lambda kv: -kv[1])[:4])
              + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
        if not ok:
            failures.append(f"check=None kernels remat {remat}")
    del params
    torch.cuda.empty_cache()
    return failures


def phase_audit(card):
    """Phase 18 (d): audit of the main-path forward through K1."""
    import torch
    import lxt_tpu_torch
    from lxt_tpu_torch.models import llama
    failures = []
    for layers, comp, bad_want in ((MODEL["num_layers"], lxt_tpu_torch.attnlrp, 0),
                                   (MODEL["num_layers"], lxt_tpu_torch.cp_lrp, 0),
                                   (2, lxt_tpu_torch.vanilla_gradient, AUDIT_VANILLA)):
        cfg = llama.LlamaConfig(**dict(MODEL, num_layers=layers), dtype="bfloat16")
        params = llama.init_params(cfg, torch.Generator("cuda").manual_seed(0))
        ids = torch.randint(0, cfg.vocab_size, (1, SEQ),
                            generator=torch.Generator("cuda").manual_seed(2), device="cuda")
        entries, launches, secs = counted(lambda: lxt_tpu_torch.audit(
            lambda e: llama.forward(params, cfg, e, comp, remat=False,
                                    logits_at=-1).logits,
            llama.embed(params, ids), on_unruled="ignore", verbose=False))
        bad = [e for e in entries if not e.ok]
        attn = sum(e.kind == "attention" for e in entries)
        ok = (len(bad) == bad_want and attn == layers
              and launches["flash_fwd"] == layers)
        print(f"audit main-path forward bf16 L{layers} B1x{SEQ} {comp.name} through K1: "
              f"{len(entries)} sites, {len(bad)} unruled (expected {bad_want}"
              + (f": {sorted({e.op + ' ' + e.site for e in bad})}" if bad else "")
              + f"), {attn} attention sites, K1 launches {launches['flash_fwd']}, "
              f"{secs:.2f} s" + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
        if not ok:
            failures.append(f"audit {comp.name}")
        del params
        torch.cuda.empty_cache()
    return failures


def phase_explicit(card):
    """Phase 18: the explicit path, check= and the audit."""
    import torch
    t0 = time.perf_counter()
    failures = phase_explicit_models(card)
    failures += phase_explicit_gates(card)
    torch.cuda.empty_cache()
    failures += phase_check(card)
    failures += phase_audit(card)
    print(f"phase 18 took {time.perf_counter() - t0:.1f} s", flush=True)
    return failures


# ---------------------------------------------------------------------------
# phase 19: multi-device attribution over four processes on the one card
# ---------------------------------------------------------------------------

def one_at_a_time(make):
    """``make()`` on each process of the default group in turn (rank order,
    a barrier after each): a whole model lives on one process at a time
    while each keeps only its shards."""
    import torch
    import torch.distributed as dist
    out = None
    for r in range(dist.get_world_size()):
        if dist.get_rank() == r:
            out = make()
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def par_full(family, layers, dtype, seed, bits=None):
    """Phase 19's whole model: Llama-3-8B or Mixtral-8x7B widths at
    ``layers``, random weights from ``seed`` drawn on the card (the same on
    every process and in the references), NF4 with ``bits``."""
    import torch
    from lxt_tpu_torch.models import llama, mixtral
    gen = torch.Generator("cuda").manual_seed(seed)
    if family == "mixtral":
        cfg = mixtral.MixtralConfig(**dict(MIXTRAL_8X7B, num_layers=layers))
        return cfg, mixtral.init_params(cfg, gen, dtype=getattr(torch, dtype),
                                        quantize_bits=bits)
    cfg = llama.LlamaConfig(**dict(LLAMA3_8B, num_layers=layers), dtype=dtype)
    return cfg, llama.init_params(cfg, gen, quantize_bits=bits)


def par_ids(shape, vocab, seed):
    import torch
    gen = torch.Generator("cuda").manual_seed(seed + 1000)
    return torch.randint(0, vocab, shape, generator=gen, device="cuda")


def par_target(family, params, cfg, tokens, remat=True, mesh=None, composite=None,
               **kw):
    """The logit of ``tokens`` (one a row) at the last position, summed over
    the rows; under a mesh, this data rank's rows of ``tokens``; AttnLRP
    unless ``composite``."""
    import lxt_tpu_torch
    from lxt_tpu_torch.models.registry import FAMILIES
    from lxt_tpu_torch.parallel.mesh import data_rows
    forward = FAMILIES[family]["forward"]
    composite = composite or lxt_tpu_torch.attnlrp

    def target(x):
        logits = forward(params, cfg, x, composite, remat=remat,
                         logits_at=-1, **kw).logits
        tok = tokens if mesh is None or tokens is None else data_rows(mesh, tokens)
        return lxt_tpu_torch.select_logit(logits, token=tok)
    return target


def par_counts():
    from lxt_tpu_torch.ops import flash_attention as fa
    from lxt_tpu_torch.ops import quant
    return {**fa.launches, **quant.launches}


def timed_collectives():
    """Wrap the port's collectives (tensor_parallel's all-reduce, gather,
    broadcast, send and receive, and the ring's shift) so that each adds
    its host seconds, after a synchronise (queued kernels are not counted),
    and one call to the returned counter."""
    import torch
    from lxt_tpu_torch.ops import tensor_parallel
    from lxt_tpu_torch.parallel import ring
    spent = {"seconds": 0.0, "calls": 0}

    def wrap(module, name):
        fn = getattr(module, name)

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent["seconds"] += time.perf_counter() - t0
                spent["calls"] += 1
        setattr(module, name, timed)

    for name in ("all_reduce", "all_gather", "broadcast", "send", "recv"):
        wrap(tensor_parallel, name)
    wrap(ring, "_shift")
    return spent


def par_measured(fn, spent=None):
    """``fn()`` with every process lined up before it, the launch counts
    set to 0 just before it and read just after: (result, launches,
    seconds on the host's clock, peak device memory GiB)."""
    import torch
    import torch.distributed as dist
    from lxt_tpu_torch.models import mixtral
    from lxt_tpu_torch.ops import flash_attention as fa
    from lxt_tpu_torch.ops import quant
    torch.cuda.synchronize()
    if dist.is_initialized():
        dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    quant.reset_launches()
    mixtral.reset_routing()
    if spent is not None:
        spent.update(seconds=0.0, calls=0)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {**par_counts(), **{f"routing_{k}": v for k, v in mixtral.routing.items()}}
    if spent is not None:
        counts.update(comm_seconds=spent["seconds"], comm_calls=spent["calls"])
    return out, counts, seconds, torch.cuda.max_memory_allocated() / 2**30


def check_composite():
    """Phase 19 (g)'s explicit-rule composite: gamma 0.25 at every linear."""
    import lxt_tpu_torch
    return lxt_tpu_torch.attnlrp.with_gamma(linear_gamma=0.25)


def par_checks(mesh, cfg, local, ids, tokens):
    """Phase 19 (g) on one process of the mesh: the conservation run
    (value, map, conservation_error), then the NaN check with a NaN written
    into global rank 1's head shard (the message this process raised)."""
    import torch
    import torch.distributed as dist
    from lxt_tpu_torch.models import llama
    from lxt_tpu_torch.ops.check import conservation_check, conservation_error, nan_check
    from lxt_tpu_torch.parallel import attribute_sharded
    from lxt_tpu_torch.parallel.mesh import model_parallel
    with model_parallel(mesh):
        embeds = llama.embed(local, ids)
    step = attribute_sharded(par_target("llama", local, cfg, tokens, True, mesh,
                                        composite=check_composite()), mesh)
    with conservation_check():
        value, rel = step(embeds)
    out = {"value": float(value), "rel": rel.float().cpu(),
           "error": float(conservation_error(rel, value)), "nan": None}
    if dist.get_rank() == 1:
        local["lm_head"][0, 0] = float("nan")
    try:
        with nan_check():
            step(embeds)
    except RuntimeError as e:
        out["nan"] = str(e)
    return out


def parallel_rank(rank, store, out_dir, refs):
    """One process of phase 19: (a) Llama-3-8B dp 2 x tp 2, (b) NF4 tp 2,
    (c) NF4 Mixtral ep 2, (d) pp 4, (e) sp 2 x tp 2, each comparison
    explaining the reference's tokens; writes its results to
    ``out_dir``/rank<r>.pt."""
    import functools
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import lxt_tpu_torch
    from lxt_tpu_torch.models import llama
    from lxt_tpu_torch.models.registry import FAMILIES
    from lxt_tpu_torch.parallel import (attribute_pipeline_parallel,
                                        attribute_sequence_parallel, attribute_sharded,
                                        family_param_shardings, make_mesh,
                                        mixtral_param_shardings,
                                        pipeline_param_shardings, shard_params)
    from lxt_tpu_torch.parallel.mesh import model_parallel
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (PAR_WORLD + 1)))
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=PAR_WORLD)
    res = {}
    measured = functools.partial(par_measured, spent=timed_collectives())

    def keep(key, measured):
        (value, rel), launches, seconds, peak = measured
        res[key] = {"value": float(value), "rel": rel.float().cpu(),
                    "launches": launches, "seconds": seconds, "peak_gib": peak}
        # every process returns its cached blocks before the next model
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            print(f"parallel: {key} run on every process ({seconds:.2f} s on "
                  f"process 0)", flush=True)

    try:
        mesh = make_mesh(data=2, model=2)

        def sharded(family, layers, dtype, seed, bits=None, shardings=None):
            def make():
                cfg, full = par_full(family, layers, dtype, seed, bits)
                spec = (shardings or (lambda p: family_param_shardings(family, p, mesh)))(full)
                return cfg, shard_params(full, spec)[0]
            return one_at_a_time(make)

        def dp_tp(family, cfg, local, ids, tokens, remat=True):
            with model_parallel(mesh):
                embeds = FAMILIES[family]["embed"](local, ids, cfg)
            step = attribute_sharded(par_target(family, local, cfg, tokens, remat, mesh), mesh)
            return lambda: step(embeds)

        # (a) the gate: float32 at PAR_GATE_LAYERS, then its shards in bf16
        layers, (B, T) = PAR_GATE_LAYERS, PAR_DPTP
        cfg, local = sharded("llama", layers, "float32", PAR_SEED)
        ids = par_ids((B, T), cfg.vocab_size, PAR_SEED)
        keep("dptp32", measured(dp_tp("llama", cfg, local, ids, refs["dptp32"]["tokens"])))
        local16 = cast(local, torch.bfloat16)
        del local
        gc.collect()
        torch.cuda.empty_cache()
        cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
        keep("dptp16", measured(dp_tp("llama", cfg16, local16, ids,
                                          refs["dptp32"]["tokens"])))
        del local16
        gc.collect()
        torch.cuda.empty_cache()
        # (a) driven: full depth, bf16
        cfg, local = sharded("llama", LLAMA3_8B["num_layers"], "bfloat16", PAR_SEED + 1)
        ids = par_ids((B, T), cfg.vocab_size, PAR_SEED + 1)
        keep("dptp", measured(dp_tp("llama", cfg, local, ids, None)))
        del local
        gc.collect()
        torch.cuda.empty_cache()
        # (b) NF4 tp 2 (and dp 2) at PAR_GATE_LAYERS, float32
        cfg, local = sharded("llama", layers, "float32", PAR_SEED + 2, bits="nf4")
        ids = par_ids((B, T), cfg.vocab_size, PAR_SEED + 2)
        keep("nf4", measured(dp_tp("llama", cfg, local, ids, refs["nf4"]["tokens"])))
        del local
        gc.collect()
        torch.cuda.empty_cache()
        # (c) NF4 Mixtral ep 2 (and dp 2) at PAR_GATE_LAYERS, float32
        cfg, local = sharded("mixtral", layers, "float32", PAR_SEED + 3, bits="nf4",
                             shardings=lambda p: mixtral_param_shardings(mesh))
        ids = par_ids((B, PAR_MIXTRAL_T), cfg.vocab_size, PAR_SEED + 3)
        keep("ep", measured(dp_tp("mixtral", cfg, local, ids, refs["ep"]["tokens"])))
        del local
        gc.collect()
        torch.cuda.empty_cache()
        # (d) pp 4: the float32 gate (one layer a stage), then full depth bf16
        pp = init_device_mesh("cpu", (PAR_WORLD,), mesh_dim_names=("pp",))

        def pipeline_run(layers, dtype, seed, shape):
            cfg, local = sharded("llama", layers, dtype, seed,
                                 shardings=lambda p: pipeline_param_shardings(p, pp))
            ids = par_ids(shape, cfg.vocab_size, seed)
            # every stage embeds the batch; stage 0's embeddings start the pipeline
            embeds = llama.embed(local, ids)
            forward = functools.partial(llama.forward, logits_at=-1)
            return measured(lambda: attribute_pipeline_parallel(
                forward, local, cfg, embeds, pp, lxt_tpu_torch.attnlrp,
                n_micro=PAR_PP_MICRO, shard=False))

        keep("pp32", pipeline_run(layers, "float32", PAR_SEED + 4, PAR_PP_GATE))
        keep("pp", pipeline_run(LLAMA3_8B["num_layers"], "bfloat16", PAR_SEED + 5,
                                PAR_PP))
        # (e) sp 2 x tp 2, float32, remat off
        spm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("sp", "model"))
        cfg, full = one_at_a_time(lambda: par_full("llama", layers, "float32",
                                                   PAR_SEED + 6))
        ids = par_ids((1, PAR_SP_T), cfg.vocab_size, PAR_SEED + 6)
        embeds = llama.embed(full, ids)
        keep("sptp", measured(lambda: attribute_sequence_parallel(
            functools.partial(llama.forward, remat=False), full, cfg, embeds,
            lxt_tpu_torch.attnlrp, group=spm.get_group("sp"),
            token=refs["sptp"]["tokens"],
            param_shardings=family_param_shardings("llama", full, spm))))
        del full
        gc.collect()
        torch.cuda.empty_cache()
        # (g) the checks at dp 2 x tp 2, float32, gamma at every linear
        cfg, local = sharded("llama", PAR_CHECK_LAYERS, "float32", PAR_SEED + 7)
        ids = par_ids(PAR_CHECK, cfg.vocab_size, PAR_SEED + 7)
        res["checks"] = par_checks(mesh, cfg, local, ids, refs["checks"]["tokens"])
        del local
        gc.collect()
        torch.cuda.empty_cache()
        res["sp_rank"] = dist.get_rank(spm.get_group("sp"))
        dist.barrier()
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def par_reference(*args, **kw):
    """A single-process reference on this process (see par_reference_run),
    its memory returned to the card afterwards."""
    import torch
    out = par_reference_run(*args, **kw)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def par_reference_run(family, layers, dtype, seed, shape, bits=None, remat=True):
    """The whole model, its argmax tokens at the last position (float32),
    and the attribution explaining them through the kernels, its launches
    measured."""
    import torch
    import lxt_tpu_torch
    from lxt_tpu_torch.models.registry import FAMILIES
    cfg, params = par_full(family, layers, dtype, seed, bits)
    ids = par_ids(shape, cfg.vocab_size, seed)
    embeds = FAMILIES[family]["embed"](params, ids, cfg)
    with torch.no_grad():
        logits = FAMILIES[family]["forward"](params, cfg, embeds, lxt_tpu_torch.attnlrp,
                                             remat=False, logits_at=-1).logits
    tokens = logits[:, -1].float().argmax(-1).cpu()
    target = par_target(family, params, cfg, tokens, remat)
    (value, rel), launches, seconds, peak = par_measured(
        lambda: lxt_tpu_torch.input_relevance(target, embeds))
    return {"tokens": tokens, "value": float(value), "rel": rel.float().cpu(),
            "launches": launches, "seconds": seconds, "peak_gib": peak}


def par_check_reference():
    """Phase 19 (g)'s single process: the whole model under
    conservation_check, explaining its argmax tokens."""
    import torch
    import lxt_tpu_torch
    from lxt_tpu_torch.models import llama
    from lxt_tpu_torch.ops.check import conservation_check, conservation_error
    cfg, params = par_full("llama", PAR_CHECK_LAYERS, "float32", PAR_SEED + 7)
    ids = par_ids(PAR_CHECK, cfg.vocab_size, PAR_SEED + 7)
    embeds = llama.embed(params, ids)
    with torch.no_grad():
        logits = llama.forward(params, cfg, embeds, lxt_tpu_torch.attnlrp,
                               remat=False, logits_at=-1).logits
    tokens = logits[:, -1].float().argmax(-1).cpu()
    with conservation_check():
        value, rel = lxt_tpu_torch.input_relevance(
            par_target("llama", params, cfg, tokens, composite=check_composite()),
            embeds)
    out = {"tokens": tokens, "value": float(value), "rel": rel.float().cpu(),
           "error": float(conservation_error(rel, value))}
    del params, embeds, rel
    gc.collect()
    torch.cuda.empty_cache()
    return out


def par_checks_report(card, ranks, ref):
    """Phase 19 (g)'s gates: the conservation map and error of the mesh
    against the single process's, and the NaN raised alike everywhere."""
    got = ranks[0]["checks"]
    d_map = nl2(got["rel"], ref["rel"])
    d_err = abs(got["error"] - ref["error"])
    msgs = [r["checks"]["nan"] for r in ranks]
    same_nan = (all(m is not None and m == msgs[0] for m in msgs)
                and msgs[0].startswith("NaN/Inf relevance at rule backward"))
    ok = d_map <= CHECK_BAR and d_err <= CHECK_BAR and same_nan
    print(f"parallel (g) the checks at dp 2 x tp 2, Llama-3-8B width float32 "
          f"L{PAR_CHECK_LAYERS} B{PAR_CHECK[0]}x{PAR_CHECK[1]} remat, gamma 0.25 at "
          f"every linear: conservation_check map against the single process "
          f"normalized L2 {d_map:.4g}, conservation_error {got['error']:.8g} vs "
          f"{ref['error']:.8g} (difference {d_err:.4g}; bar {CHECK_BAR} for both); "
          f"nan_check with a NaN in process 1's head shard: every process raised "
          f"{msgs[0]!r}: {same_nan}" + (" PASS" if ok else " FAIL") + f" [{card}]",
          flush=True)
    return [] if ok else ["parallel (g) checks"]


def par_spawn(refs):
    """PAR_WORLD processes of parallel_rank over gloo on the one card; their
    results, or the failure (a process that hangs past PAR_TIMEOUT or
    exits non-zero)."""
    import multiprocessing
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=parallel_rank,
                             args=(r, os.path.join(tmp, "store"), tmp, refs))
                 for r in range(PAR_WORLD)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(0.0, PAR_TIMEOUT - (time.perf_counter() - t0)))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if hung or codes != [0] * PAR_WORLD:
            return None, f"parallel processes: hung {hung}, exit codes {codes}"
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(PAR_WORLD)], None


def flash_k3(launches):
    return {n: launches.get(n, 0) for n in KERNELS}


def par_report(card, label, ranks, key, want, ref=None, bar=None, against=None):
    """Print one path's per-process launches (against ``want``, a list of
    per-process counts), wall seconds and peak memory, and its map against
    ``ref`` (or rank 0's ``against`` entry) within ``bar``. Returns the
    failures."""
    import torch
    failures = []
    got = [flash_k3(r[key]["launches"]) for r in ranks]
    rels = [r[key]["rel"] for r in ranks]
    same = all(torch.equal(rel, rels[0]) for rel in rels)
    finite = all(bool(torch.isfinite(rel).all()) for rel in rels)
    line = (f"parallel {label}: relevance {tuple(rels[0].shape)} finite {finite}, "
            f"the same on every process {same}")
    if ref is not None or against is not None:
        want_rel = ref["rel"] if ref is not None else ranks[0][against]["rel"]
        d = nl2(rels[0], want_rel)
        line += (f", against {'the single-process kernel path' if ref is not None else against}"
                 f" normalized L2 {d:.4g} (bar {bar})")
        if ref is not None:
            line += f", value {ranks[0][key]['value']:.6g} vs {ref['value']:.6g}"
        if not d <= bar:
            failures.append(f"parallel {label} relevance {d:.4g}")
    line += (f"; launches per process {got} (expected {want})"
             + (f", the single process's {flash_k3(ref['launches'])}" if ref is not None else "")
             + f"; wall s per process {[round(r[key]['seconds'], 3) for r in ranks]}"
             f", of it in the collectives (host-staged, after a synchronise) "
             f"{[round(r[key]['launches']['comm_seconds'], 3) for r in ranks]} s over "
             f"{[r[key]['launches']['comm_calls'] for r in ranks]} calls"
             f"; peak GiB per process {[round(r[key]['peak_gib'], 2) for r in ranks]}"
             f" [{card}]")
    print(line, flush=True)
    if not (same and finite):
        failures.append(f"parallel {label} relevance not finite or not gathered alike")
    if got != want:
        failures.append(f"parallel {label} launches {got}")
    return failures


def with_k3(counts, k3=0):
    return {**counts, "nf4_dequant": k3}


def phase_parallel_serve(card):
    """Phase 19 (f): a TinyLlama-width checkpoint served by build_server
    with --data-parallel 2 (this process is rank 0; one rank spawned, both
    on the one card over gloo): one warm-up request, then 16 POST
    /v1/attribute from 8 client threads, each map against its prompt alone
    through a single-process pipeline of rank 0's model. Before them, a call
    that raises on every rank (a top_k past the vocabulary) must fail and
    leave the ranks in step. Returns (failures, launches per process)."""
    import functools
    import threading
    import torch
    from lxt_tpu_torch.models import llama
    from lxt_tpu_torch.ops import flash_attention as fa
    from lxt_tpu_torch.ops import quant
    from lxt_tpu_torch.pipeline import AttributionPipeline
    from lxt_tpu_torch.serve import _parse_args, build_server, http_server
    failures = []
    cfg = llama.LlamaConfig(**MODEL, dtype="bfloat16")
    params = llama.init_params(cfg, torch.Generator("cuda").manual_seed(20))
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(TINYLLAMA_CONFIG, f)
        write_safetensors(os.path.join(tmp, "model.safetensors"),
                          hf_llama_state(params, cfg))
        del params
        torch.cuda.empty_cache()
        args = _parse_args(["--model", tmp, "--device", "cuda", "--dtype", "bfloat16",
                            "--data-parallel", "2", "--max-batch", str(SERVE_MAX_BATCH),
                            "--max-wait-ms", str(SERVE_WAIT_MS),
                            "--max-prompt-tokens", "2048"])
        t0 = time.perf_counter()
        server = build_server(args, tokenizer=functools.partial(WordTokenizer,
                                                                cfg.vocab_size))
        t_up = time.perf_counter() - t0
        httpd = http_server(server, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        prompts = words(np.random.default_rng(19), PAR_SERVE_WORDS, PAR_SERVE_REQUESTS)
        try:
            # a call that raises on every rank (a top_k past the vocabulary,
            # sent to the pipeline itself): the ranks agree on its outcome
            # and answer the requests below in step
            try:
                server.pipeline.respond([prompts[0]], 2, temperature=1.0,
                                        top_k=cfg.vocab_size + 1)
                failures.append("parallel serve: a top_k past the vocabulary "
                                "was not refused")
            except ValueError:
                pass
            torch.cuda.synchronize()
            fa.reset_launches()
            quant.reset_launches()
            # one warm-up request (each rank's first call loads its kernels and
            # cuBLAS): counted in the launches, not in the time
            post(httpd.server_address[1], "/v1/attribute", {"prompt": prompts[0]})
            results, t0, t1 = remote_posts(httpd.server_address[1], "/v1/attribute",
                                           [{"prompt": p} for p in prompts], 8)
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.close()
            thread.join(timeout=60)
    pipeline = server.pipeline
    batches = list(server.batch_sizes)
    codes = [p.exitcode for p in pipeline.procs]
    got = [flash_k3(c) for c in (pipeline.rank_launches or [])]
    want = [with_k3(expected_launches(MODEL["num_layers"], True))] * 2
    want = [{n: len(batches) * c for n, c in w.items()} for w in want]
    lat = sorted(s for _, _, s in results)
    print(f"parallel (f) serve --data-parallel 2 (TinyLlama-1.1B widths, bf16, "
          f"remat, gloo on the one card): up in {t_up:.1f} s (two ranks loading "
          f"the checkpoint); {len(prompts)} requests from 8 clients in "
          f"{t1 - t0:.3f} s ({len(prompts) / (t1 - t0):.3f} heatmaps/s, p50 "
          f"{lat[len(lat) // 2]:.3f} s), coalesced batches {batches} (the first "
          f"the warm-up request's); launches per "
          f"process {got} (expected {want}: batches x one attribution's, no "
          f"rotation pass under kv_begin); the spawned rank exited {codes} [{card}]",
          flush=True)
    if got != want or codes != [0]:
        failures.append(f"parallel serve launches {got} / exit {codes}")
    pipe = AttributionPipeline(pipeline.model, WordTokenizer(cfg.vocab_size))
    ok, _ = served_maps_gate(card, "--data-parallel 2 against the single process",
                             results, prompts, pipe, RING_BF16_BAR)
    if not ok:
        failures.append("parallel serve maps")
    del pipe, pipeline, server
    gc.collect()
    torch.cuda.empty_cache()
    return failures, got


def phase_parallel(card):
    """Phase 19: multi-device attribution on the one card. The
    single-process references in this process, then PAR_WORLD processes over
    gloo (parallel_rank), then the data-parallel server. Returns (failures,
    the launches summed over every process of the driven runs and the
    served traffic)."""
    import torch
    from lxt_tpu_torch.ops import flash_attention as fa
    failures = []
    t_phase = time.perf_counter()
    L, (B, T) = PAR_GATE_LAYERS, PAR_DPTP
    refs = {"dptp32": par_reference("llama", L, "float32", PAR_SEED, (B, T)),
            "nf4": par_reference("llama", L, "float32", PAR_SEED + 2, (B, T), bits="nf4"),
            "ep": par_reference("mixtral", L, "float32", PAR_SEED + 3,
                                (B, PAR_MIXTRAL_T), bits="nf4"),
            "pp32": par_reference("llama", L, "float32", PAR_SEED + 4, PAR_PP_GATE),
            "sptp": par_reference("llama", L, "float32", PAR_SEED + 6, (1, PAR_SP_T),
                                  remat=False),
            "checks": par_check_reference()}
    t_refs = time.perf_counter() - t_phase
    ranks, err = par_spawn({k: {"tokens": v["tokens"]} for k, v in refs.items()})
    if err:
        return [err], {}
    print(f"parallel: {PAR_WORLD} processes on the one card over gloo (collectives "
          f"and point-to-point staged through host copies; wall times are not "
          f"scaling numbers), references {t_refs:.1f} s, processes "
          f"{time.perf_counter() - t_phase - t_refs:.1f} s [{card}]", flush=True)
    gate = with_k3(expected_launches(L, True))
    failures += par_report(card, f"(a) Llama-3-8B width dp 2 x tp 2 float32 L{L} "
                           f"B{B}x{T} remat", ranks, "dptp32", [gate] * PAR_WORLD,
                           refs["dptp32"], PARITY_BAR)
    failures += par_report(card, f"(a) the same shards in bf16 against float32 sharded",
                           ranks, "dptp16", [with_k3(expected_launches(
                               L, True, HOPPER_BODIES[128]))] * PAR_WORLD,
                           bar=DIVERGENCE_BAR, against="dptp32")
    failures += par_report(card, f"(a) Llama-3-8B dp 2 x tp 2 bf16 L{LLAMA3_8B['num_layers']} "
                           f"B{B}x{T} remat (local heads 16/4 D128)", ranks, "dptp",
                           [with_k3(expected_launches(LLAMA3_8B["num_layers"], True,
                                                      HOPPER_BODIES[128]))] * PAR_WORLD)
    failures += par_report(card, f"(b) NF4 Llama-3-8B width tp 2 (x dp 2) float32 L{L} "
                           f"B{B}x{T} remat", ranks, "nf4",
                           [with_k3(expected_launches(L, True),
                                    refs["nf4"]["launches"]["nf4_dequant"])] * PAR_WORLD,
                           refs["nf4"], PARITY_BAR)
    # K3 per block run: the four attention projections, the router and three
    # products per non-empty local expert group; the backward once more for
    # each of the forward's (phase 12's count, on each process's own groups)
    ep_want = [with_k3(expected_launches(L, True), 3 * (
        5 * r["ep"]["launches"]["routing_host_reads"]
        + 3 * r["ep"]["launches"]["routing_nonempty_groups"]) // 2) for r in ranks]
    failures += par_report(card, f"(c) NF4 Mixtral-8x7B width ep 2 (x dp 2) float32 "
                           f"L{L} B{B}x{PAR_MIXTRAL_T} remat; group sizes read "
                           f"{[r['ep']['launches']['routing_host_reads'] for r in ranks]} "
                           f"times, local non-empty groups "
                           f"{[r['ep']['launches']['routing_nonempty_groups'] for r in ranks]}",
                           ranks, "ep", ep_want, refs["ep"], PARITY_BAR)
    if any(r["ep"]["launches"]["routing_host_reads"] != 2 * L for r in ranks):
        failures.append("parallel ep host reads")
    Bp = PAR_PP_GATE[0]
    failures += par_report(card, f"(d) pp {PAR_WORLD} float32 L{L} B{Bp}x"
                           f"{PAR_PP_GATE[1]} n_micro {PAR_PP_MICRO} remat", ranks, "pp32",
                           [with_k3(expected_launches(L // PAR_WORLD, True,
                                                      forwards=PAR_PP_MICRO,
                                                      pulls=PAR_PP_MICRO))] * PAR_WORLD,
                           refs["pp32"], PARITY_BAR)
    Lp = LLAMA3_8B["num_layers"]
    failures += par_report(card, f"(d) Llama-3-8B pp {PAR_WORLD} bf16 L{Lp} B{PAR_PP[0]}x"
                           f"{PAR_PP[1]} n_micro {PAR_PP_MICRO} remat", ranks, "pp",
                           [with_k3(expected_launches(Lp // PAR_WORLD, True,
                                                      HOPPER_BODIES[128],
                                                      forwards=PAR_PP_MICRO,
                                                      pulls=PAR_PP_MICRO))] * PAR_WORLD)
    # the ring steps the causal mask leaves visible: sp rank r runs r + 1 of 2
    sp_want = [with_k3({n: (r["sp_rank"] + 1) * L for n in
                        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")} | {"rope_rotate": 0})
               for r in ranks]
    failures += par_report(card, f"(e) sp 2 x tp 2 float32 L{L} B1x{PAR_SP_T} remat off",
                           ranks, "sptp", sp_want, refs["sptp"], PARITY_BAR)
    failures += par_checks_report(card, ranks, refs["checks"])
    launches = {n: sum(r[k]["launches"][n] for r in ranks
                       for k in ("dptp32", "dptp16", "dptp", "nf4", "ep", "pp32", "pp", "sptp"))
                for n in KERNELS}
    del ranks
    gc.collect()
    torch.cuda.empty_cache()
    f, serve = phase_parallel_serve(card)
    failures += f
    for counts in serve:
        for n in KERNELS:
            launches[n] += counts[n]
    fa.reset_launches()
    print(f"phase 19 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return failures, launches


# ---------------------------------------------------------------------------
# phase 20: loading at scale
# ---------------------------------------------------------------------------

def hf_mixtral_state(params, cfg):
    """The port's stacked Mixtral parameters -> an HF Mixtral state dict
    ([out, in] weights; experts w1 / w3 / w2 from wg / wu / wd), bf16
    tensors on the host."""
    state = {"model.embed_tokens.weight": params["embed"],
             "model.norm.weight": params["final_norm"],
             "lm_head.weight": params["lm_head"].T}
    names = {"ln1": "input_layernorm", "ln2": "post_attention_layernorm",
             "wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "w_router": "block_sparse_moe.gate"}
    experts = {"wg": "w1", "wu": "w3", "wd": "w2"}
    for i in range(cfg.num_layers):
        lp = params["layers"]
        for ours, hf in names.items():
            w = lp[ours][i]
            state[f"model.layers.{i}.{hf}.weight"] = w if w.dim() == 1 else w.T
        for ours, hf in experts.items():
            for e in range(cfg.num_experts):
                state[f"model.layers.{i}.block_sparse_moe.experts.{e}.{hf}.weight"] = (
                    lp[ours][i, e].T)
    return {k: v.contiguous().cpu() for k, v in state.items()}


def rss_bytes():
    """This process's resident set, from /proc/self/statm."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def measured_load(fn):
    """``fn()`` timed (host clock, ending in a synchronise), with a thread
    sampling the resident set every 2 ms and the device's peak allocation:
    (result, seconds, peak RSS over the RSS before, peak device bytes over
    the allocation before, resident device bytes after over it)."""
    import threading
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_dev, base_rss = torch.cuda.memory_allocated(), rss_bytes()
    peak = [base_rss]
    done = threading.Event()

    def sample():
        while not done.wait(0.002):
            peak[0] = max(peak[0], rss_bytes())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        done.set()
        thread.join()
    peak[0] = max(peak[0], rss_bytes())
    return (out, seconds, peak[0] - base_rss,
            torch.cuda.max_memory_allocated() - base_dev,
            torch.cuda.memory_allocated() - base_dev)


def plain_model(model_dir, dtype, bits=None):
    """The same checkpoint through the plain numpy reader (every tensor
    copied to the host first) and converted whole, then quantized: the
    order of the work before the native loader."""
    from lxt_tpu_torch import io
    from lxt_tpu_torch.models import registry
    from lxt_tpu_torch.ops.quant import quantize_params
    state = {}
    for path in io.shard_paths(model_dir):
        state.update(io.load_safetensors_ref(path, dtype))
    model = registry._convert(state, registry.read_hf_config(model_dir), None, dtype,
                              "cuda")
    del state
    if bits:
        model.params = quantize_params(model.params, bits=bits, family=model.family)
    return model


def loaded_attribution(card, label, model, model_dir, dtype, bits, ids):
    """Phase 20 (c): one attribution of a loaded model, its launches, and
    its relevance against the plain loader's model's."""
    import torch
    from lxt_tpu_torch.ops import flash_attention as fa
    from lxt_tpu_torch.ops import quant
    fa.reset_launches()
    quant.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, rel = model.attribute(ids)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {**fa.launches, **quant.launches}
    ref = plain_model(model_dir, dtype, bits)
    _, want = ref.attribute(ids)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    equal = torch.equal(rel, want)
    through = all(launches[n] > 0 for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    if bits:
        through = through and launches["nf4_dequant"] > 0
    ok = equal and through and bool(torch.isfinite(rel).all())
    print(f"load (c) {label}: one bf16 attribution 1 x {ids.shape[1]} remat "
          f"{secs:.3f} s, launches {launches}; relevance bit-equal to the plain "
          f"reader's model converted whole{', then quantized' if bits else ''}: "
          f"{equal}" + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
    return ([] if ok else [f"load (c) {label}"]), launches


def phase_load(card):
    """Phase 20: Llama-3-8B (8 layers) and Mixtral-8x7B (2 layers, NF4)
    width checkpoints written here, loaded by the native loader layer by
    layer, and attributed. Returns (failures, launches of the two
    attributions)."""
    import torch
    import lxt_tpu_torch
    from lxt_tpu_torch import io
    from lxt_tpu_torch.models import llama, mixtral
    from lxt_tpu_torch.ops.quant import QuantizedTensor
    t_phase = time.perf_counter()
    failures, launches = [], {n: 0 for n in KERNELS}
    io._native()   # g++ missing or failing fails the phase here
    bf16 = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(40)
    ids = torch.randint(0, 32000, (1, SEQ_8B), generator=gen, device="cuda")

    def add(counts):
        for n in KERNELS:
            launches[n] += counts.get(n, 0)

    # (a) Llama-3-8B width, 8 layers, bf16
    cfg = llama.LlamaConfig(**dict(LLAMA3_8B, num_layers=LOAD_8B_LAYERS), dtype="bfloat16")
    params = llama.init_params(cfg, torch.Generator("cuda").manual_seed(41))
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(LLAMA3_8B_CONFIG, f)
        path = os.path.join(tmp, "model.safetensors")
        t0 = time.perf_counter()
        write_safetensors(path, hf_llama_state(params, cfg))
        t_write, size = time.perf_counter() - t0, os.path.getsize(path)
        model, secs, rss, peak, resident = measured_load(
            lambda: lxt_tpu_torch.from_pretrained(tmp, dtype=bf16))
        exact = all(torch.equal(model.params["layers"][n], params["layers"][n])
                    for n in params["layers"]) and all(
            torch.equal(model.params[n], params[n]) for n in ("embed", "final_norm",
                                                                "lm_head"))
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"load (a) Llama-3-8B width L{LOAD_8B_LAYERS} bf16 checkpoint "
              f"{size / 1e9:.3f} GB (written in {t_write:.2f} s, warm in the page "
              f"cache): from_pretrained(dtype=bfloat16) {secs:.3f} s, "
              f"{size / 1e9 / secs:.3f} GB/s; the load's peak host RSS "
              f"+{rss / 2**30:.3f} GiB (sampled every 2 ms; process ru_maxrss "
              f"{resource_maxrss() / 2**30:.2f} GiB), peak device "
              f"+{peak / 2**30:.3f} GiB for {resident / 2**30:.3f} GiB resident; "
              f"weights bit-equal to the written ones: {exact}"
              + (" PASS" if exact else " FAIL") + f" [{card}]", flush=True)
        if not exact:
            failures.append("load (a) weights")
        f, counts = loaded_attribution(card, f"Llama-3-8B width L{LOAD_8B_LAYERS}",
                                       model, tmp, bf16, None, ids)
        failures += f
        add(counts)
        del model
        gc.collect()
        torch.cuda.empty_cache()

    # (b) Mixtral-8x7B width, 2 layers, bf16 checkpoint, NF4 while converting
    cfg = mixtral.MixtralConfig(**dict(MIXTRAL_8X7B, num_layers=LOAD_MIXTRAL_LAYERS))
    params = mixtral.init_params(cfg, torch.Generator("cuda").manual_seed(42), dtype=bf16)
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(MIXTRAL_8X7B_CONFIG, f)
        path = os.path.join(tmp, "model.safetensors")
        t0 = time.perf_counter()
        write_safetensors(path, hf_mixtral_state(params, cfg))
        t_write, size = time.perf_counter() - t0, os.path.getsize(path)
        layer_bytes = sum(v.numel() * 2 for v in params["layers"].values()) // cfg.num_layers
        del params
        gc.collect()
        torch.cuda.empty_cache()
        model, secs, rss, peak, resident = measured_load(
            lambda: lxt_tpu_torch.from_pretrained(tmp, dtype=bf16, quantize_bits="nf4"))
        lp = model.params["layers"]
        nf4 = all(isinstance(lp[n], QuantizedTensor) and lp[n].bits == "nf4"
                  for n in PROJECTIONS)
        per_layer = sum((v.q.numel() * v.q.element_size() + v.scale.numel() * 4)
                        if isinstance(v, QuantizedTensor) else v.numel() * v.element_size()
                        for v in lp.values()) / cfg.num_layers
        transient = peak - resident
        ok = nf4 and transient <= LOAD_TRANSIENT_BAR * layer_bytes
        full = resident + (MIXTRAL_8X7B["num_layers"] - cfg.num_layers) * per_layer
        print(f"load (b) Mixtral-8x7B width L{LOAD_MIXTRAL_LAYERS} bf16 checkpoint "
              f"{size / 1e9:.3f} GB (written in {t_write:.2f} s, warm): "
              f"from_pretrained(dtype=bfloat16, quantize_bits='nf4') {secs:.3f} s, "
              f"{size / 1e9 / secs:.3f} GB/s, peak host RSS +{rss / 2**30:.3f} GiB; "
              f"device: resident {resident / 2**30:.3f} GiB after, peak "
              f"{peak / 2**30:.3f} GiB during, transient {transient / 2**30:.3f} GiB = "
              f"{transient / layer_bytes:.3f} x one layer's bf16 "
              f"{layer_bytes / 2**30:.3f} GiB (bar {LOAD_TRANSIENT_BAR}); "
              f"layers NF4 {nf4}; projected at {MIXTRAL_8X7B['num_layers']} layers: "
              f"{per_layer / 2**30:.3f} GiB a layer, resident {full / 2**30:.2f} GiB, "
              f"peak {(full + transient) / 2**30:.2f} GiB"
              + (" PASS" if ok else " FAIL") + f" [{card}]", flush=True)
        if not ok:
            failures.append("load (b) NF4 transient")
        f, counts = loaded_attribution(card, f"NF4 Mixtral-8x7B width L{LOAD_MIXTRAL_LAYERS}",
                                       model, tmp, bf16, "nf4", ids)
        failures += f
        add(counts)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 20 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return failures, launches


def resource_maxrss():
    """The process's peak resident set so far (getrusage, bytes)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


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

    if "--serve" in sys.argv[1:]:
        failures, _ = phase_serve(card)
        print(f"failures: {failures}", flush=True)
        return 1 if failures else 0
    if "--vision" in sys.argv[1:]:
        failures, _ = phase_vision(card)
        print(f"failures: {failures}", flush=True)
        return 1 if failures else 0
    if "--explicit" in sys.argv[1:]:
        failures = phase_explicit(card)
        print(f"failures: {failures}", flush=True)
        return 1 if failures else 0
    if "--parallel" in sys.argv[1:]:
        failures, _ = phase_parallel(card)
        print(f"failures: {failures}", flush=True)
        return 1 if failures else 0
    if "--load" in sys.argv[1:]:
        failures, _ = phase_load(card)
        print(f"failures: {failures}", flush=True)
        return 1 if failures else 0
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
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    f, bert_launches = phase_bert(card)
    failures += f
    print(f"phase 14 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    f, decode_launches = phase_decode(card)
    failures += f
    print(f"phase 15 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    f, serve_launches = phase_serve(card)
    failures += f
    print(f"phase 16 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()
    f, vision_launches = phase_vision(card)
    failures += f
    torch.cuda.empty_cache()
    failures += phase_explicit(card)
    torch.cuda.empty_cache()
    f, parallel_launches = phase_parallel(card)
    failures += f
    torch.cuda.empty_cache()
    f, load_launches = phase_load(card)
    failures += f
    print(f"phases 3-20 took {time.perf_counter() - t_start:.1f} s", flush=True)
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1

    # each kernel's numbers at the main path's call (K3: at wg), at the NF4
    # 8B path's call (K3: at wd) and at the other paths' calls (not K3)
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
         "launches_gpt2": gpt2_launches.get(name, 0),
         "launches_bert": bert_launches.get(name, 0),
         "launches_decode": decode_launches.get(name, 0),
         "launches_serve": serve_launches.get(name, 0),
         "launches_vision": vision_launches["vision"].get(name, 0),
         "launches_multimodal": vision_launches["multimodal"].get(name, 0),
         "launches_parallel": parallel_launches.get(name, 0),
         "launches_load": load_launches.get(name, 0)}
        for name, (src, tpu) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
