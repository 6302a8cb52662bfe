"""The DeepSeek-V3 configuration's parts of the benchmark on the CPU: its
useful FLOPs by hand, the frozen MLA work against the frozen flash work at
equal widths, the plain reference against the port in float32, and a
tiny run of its cell end to end (the harness's look for a card skipped)."""

import json
import time
from pathlib import Path

import pytest
import torch
from tiny import bench_copy

from bench_port.harness import flash_work, judge, mla_work, runner, spec

CELL = "moonlight-16b-a3b.docs-8k"
#: the configuration cut for the CPU: every width small, 1 dense layer and
#: 2 mixture layers of 8 experts, top 3
TINY = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
            num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, n_routed_experts=8, num_experts_per_tok=3,
            vocab_size=128)


def tiny_cell(tmp, dtype):
    dst = bench_copy(tmp)
    real = spec.Cell(CELL)
    config = json.loads(json.dumps(real.config))
    config["config"].update(TINY)
    config["dtype"] = dtype
    (dst / "configs" / "tiny.json").write_text(json.dumps(config))
    cell = json.loads(json.dumps(real.spec))
    cell["traffic"].update(batch=3, cycle=2, lengths={
        "dist": "lognormal", "median": 12, "sigma": 0.5, "min": 4, "max": 24})
    cell["compare"] = {"heatmaps": 3, "longest": True}
    (dst / "cells" / "tiny.cell.json").write_text(json.dumps(cell))
    bench = json.loads((Path(tmp) / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "tests",
                             "file": "bench_port/configs/tiny.json",
                             "reduced": sorted(TINY), "why": "tests"})
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny",
                               "traffic": "cell", "chips": 1, "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny.cell")
    return spec.Cell("tiny.cell", bench=bench, bench_dir=dst)


def test_flops_of_a_tiny_config_by_hand():
    cell = spec.Cell(CELL)
    config = dict(cell.config, config=dict(cell.config["config"], **TINY))
    # D 64, H 4, q/k 16 + 8, v 16, kv rank 32, 1 dense layer (I 96) then 2
    # mixture layers (8 experts of 32, top 3, 2 shared), V 128; 10 tokens
    attn = 64 * 4 * 24 + 64 * (32 + 8) + 32 * 4 * 32 + 4 * 16 * 64
    dense = 3 * 64 * 96
    moe = 64 * 8 + 3 * 3 * 64 * 32 + 3 * 64 * 64
    linear = 4 * (3 * attn + dense + 2 * moe) * 10
    attention = 3.5 * 2 * (24 + 16) * 4 * 55 * 3     # 55 causal pairs
    assert cell.family.heatmap_flops(config, 10) == linear + attention + 4 * 64 * 128


def test_the_config_file_repeats_the_published_block_at_its_top_level():
    config = spec.Cell(CELL).config
    assert {k: config[k] for k in config["config"]} == config["config"]


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
def test_mla_work_at_equal_widths_is_the_flash_work(name):
    assert mla_work.work(name, 16, 1024, 128, 128) == flash_work.work(
        name, 1, 16, 16, 1024, 128)
    flops, moved = mla_work.work(name, 16, 1024, 192, 128)
    padded = flash_work.work(name, 1, 16, 16, 1024, 256)
    assert flops < padded[0] and moved < padded[1]


def test_reference_agrees_with_the_port_in_float32(tmp_path):
    from bench_port import control
    cell = tiny_cell(tmp_path, "float32")
    checks, ok, per = control.readings(cell, 2 ** 31 + 3, "program", "cpu")
    numbers = judge.worst(per, list(judge.NUMBERS) + ["route_gap", "route_gap_deep"])
    assert numbers["rel_l2"] < 1e-5 and numbers["map_sin"] < 1e-5, numbers
    assert numbers["value_err"] < 1e-4 and numbers["logit_gap"] == 0, numbers
    assert numbers["route_gap"] < 1e-5 and numbers["route_gap_deep"] < 1e-5, numbers
    assert ok


def test_a_tiny_run_is_correct(tmp_path):
    cell = tiny_cell(tmp_path, "bfloat16")
    torch.manual_seed(0)
    res = runner.run(cell, 5, 0.3, False, "cpu", time.perf_counter())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 3
    assert {m["name"] for m in cell.end_to_end} - {"peak_mem_gib"} <= set(res["metrics"])
    res = runner.run(cell, 6, 0.3, True, "cpu", time.perf_counter())
    assert {"mla_host_ms_per_heatmap", "moe_host_ms_per_heatmap.dsv3",
            "mfu.dsv3"} <= set(res["metrics"])
