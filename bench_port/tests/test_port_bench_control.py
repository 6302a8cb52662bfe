"""The comparison fails what it must: the control (the reference in the
program's place, every matrix product in fp8) and the faults that a cell can
have, planted underneath a run.

The control at each cell's own size runs on the card (``cuda``); on the CPU
a tiny copy of each cell shows the order of the readings, and every fault
turns ``correct`` false with the real cells' limits."""

import time

import numpy as np
import pytest
from tiny import tiny_cell

from bench_port.harness import judge, runner, spec


@pytest.mark.parametrize("family", ["mistral", "mixtral"])
def test_the_control_reads_farther_than_the_program(tmp_path, family):
    from bench_port import control
    cell = tiny_cell(tmp_path, family, dtype="bfloat16")
    for seed in (1, 2, 3):
        prog = judge.worst(control.readings(cell, seed, "program", "cpu")[2], judge.NUMBERS)
        ctl = judge.worst(control.readings(cell, seed, "control", "cpu")[2], judge.NUMBERS)
        assert ctl["rel_l2"] > prog["rel_l2"] and ctl["map_sin"] > prog["map_sin"], (
            seed, prog, ctl)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in spec.benchmark()["workloads"]])
def test_the_control_fails_at_the_cells_size(workload):
    """Three seeds at the cell's own size: the program holds every limit,
    the control fails one on each."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size on a CUDA device")
    from bench_port import control
    cell = spec.Cell(workload)
    for seed in (9001, 9002, 9003):
        assert control.readings(cell, seed, "program", "cuda")[1], seed
        assert not control.readings(cell, seed, "control", "cuda")[1], seed


def _stale(call):
    """Each call returns the last call's heatmaps: the state left unchanged."""
    last = {}

    def broken(self, prompts, *a, **kw):
        out = last.get("maps") or call(self, prompts, *a, **kw)
        last["maps"] = call(self, prompts, *a, **kw)
        return out
    return broken


def _half(call):
    """Half of each call's prompts explained; the rest given the mean of
    theirs."""
    def broken(self, prompts, *a, **kw):
        keep = max(1, len(prompts) // 2)
        maps = call(self, prompts[:keep], *a, **kw)
        mean = float(np.mean([h.raw_relevance.mean() for h in maps]))
        value = float(np.mean([h.value for h in maps]))
        for p in prompts[keep:]:
            r = np.full(len(p), mean, np.float32)
            maps.append(type(maps[0])(tokens=[str(t) for t in p], relevance=r,
                                      raw_relevance=r, value=value))
        return maps
    return broken


def _altered(call):
    """Each heatmap altered where it is made: its largest relevance negated."""
    def broken(self, prompts, *a, **kw):
        maps = call(self, prompts, *a, **kw)
        for h in maps:
            i = int(np.abs(h.raw_relevance).argmax())
            h.raw_relevance[i] = -h.raw_relevance[i]
        return maps
    return broken


@pytest.mark.parametrize("family", ["mistral", "mixtral"])
@pytest.mark.parametrize("fault", [_stale, _half, _altered], ids=lambda f: f.__name__[1:])
def test_a_fault_underneath_a_run_is_not_correct(tmp_path, monkeypatch, family, fault):
    from lxt_tpu_torch.pipeline import AttributionPipeline
    cell = tiny_cell(tmp_path, family, dtype="bfloat16", batch=4)
    monkeypatch.setattr(AttributionPipeline, "__call__",
                        fault(AttributionPipeline.__call__))
    res = runner.run(cell, 11, 0.3, False, "cpu", time.perf_counter())
    assert res["correct"] is False, res["checks"]


def test_a_token_routed_wrong_is_not_correct(tmp_path, monkeypatch):
    """The router's choice altered where it is made: every layer sends the
    last token of each call to its two least likely experts. The reference
    follows the program's routing, so it is the first layer's route gap
    that catches it."""
    import torch

    from lxt_tpu_torch.models import mixtral
    cell = tiny_cell(tmp_path, "mixtral", dtype="bfloat16")
    cell.config["config"]["hidden_size"] = 1024   # router logits of real spread
    route = mixtral._route

    def wrong(x, lp, cfg, composite):
        top_w, top_idx = route(x, lp, cfg, composite)
        logits = composite.linear(x[-1:], lp["w_router"], site="w_router").float()
        least = torch.sort(logits, dim=-1, stable=True).indices[:, :cfg.experts_per_token]
        top_idx = top_idx.clone()
        top_idx[-1:] = least
        return top_w, top_idx

    monkeypatch.setattr(mixtral, "_route", wrong)
    res = runner.run(cell, 12, 0.3, False, "cpu", time.perf_counter())
    assert res["checks"]["route_gap"]["value"] > res["checks"]["route_gap"]["limit"]
    assert res["correct"] is False


def test_a_router_reading_the_wrong_input_past_the_first_layer_is_not_correct(
        tmp_path, monkeypatch):
    """The routing altered past the first layer only: every later layer
    routes each token by its neighbour's hidden state. The first layer's
    route gap holds; the later layers' mean gap catches it."""
    from lxt_tpu_torch.models import mixtral
    cell = tiny_cell(tmp_path, "mixtral", dtype="bfloat16")
    cell.config["config"]["hidden_size"] = 1024   # router logits of real spread
    route, first = mixtral._route, []

    def wrong(x, lp, cfg, composite):
        w = lp["w_router"]
        layer = getattr(w, "q", w).data_ptr()
        first[:] = first or [layer]
        if layer != first[0]:
            x = x.roll(1, 0)
        return route(x, lp, cfg, composite)

    monkeypatch.setattr(mixtral, "_route", wrong)
    res = runner.run(cell, 13, 0.3, False, "cpu", time.perf_counter())
    checks = res["checks"]
    assert checks["route_gap"]["value"] <= checks["route_gap"]["limit"], checks
    assert checks["route_gap_deep"]["value"] > checks["route_gap_deep"]["limit"], checks
    assert res["correct"] is False
