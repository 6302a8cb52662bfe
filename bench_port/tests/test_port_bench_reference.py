"""The plain reference against the port's CPU path, and a whole run of a
tiny cell on the CPU (the harness's look for a card skipped)."""

import time

import pytest
import torch
from tiny import tiny_cell

from bench_port.harness import judge, runner


@pytest.mark.parametrize("family", ["mistral", "mixtral"])
def test_reference_agrees_with_the_port_in_float32(tmp_path, family):
    """In float32 the program's heatmaps and explained logits (the port's
    plain versions of its kernels on the CPU) and the reference's agree to
    rounding: the reference computes what the program computes."""
    from bench_port import control
    cell = tiny_cell(tmp_path, family)
    checks, ok, per = control.readings(cell, 2 ** 31 + 3, "program", "cpu")
    numbers = judge.worst(per, judge.NUMBERS)
    assert numbers["rel_l2"] < 1e-5 and numbers["map_sin"] < 1e-5, numbers
    assert numbers["value_err"] < 1e-4 and numbers["logit_gap"] == 0, numbers
    if family == "mixtral":
        assert max(h["route_gap"] for h in per) < 1e-5, per
    assert ok


@pytest.mark.parametrize("family", ["mistral", "mixtral"])
def test_a_tiny_run_is_correct(tmp_path, family):
    """A run of the tiny cell end to end in bf16, the cell's limits held,
    every end-to-end metric of a CPU run present but the card's memory."""
    cell = tiny_cell(tmp_path, family, dtype="bfloat16")
    torch.manual_seed(0)
    res = runner.run(cell, 5, 0.3, False, "cpu", time.perf_counter())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 3
    assert {m["name"] for m in cell.end_to_end} - {"peak_mem_gib"} <= set(res["metrics"])
    assert list(res)[-1] == "checks" and set(res["checks"]) == set(cell.spec["limits"])
