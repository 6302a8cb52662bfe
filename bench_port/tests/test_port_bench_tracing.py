"""The readers of the program's own spans and counters: each on a hand-built
run and trace, ``moe_idle_share`` on a synthetic timeline, each silent on a
program that lacks what it reads, and all of them in a traced run of a tiny
cell on the CPU."""

import sys
import time
import types

import pytest
from tiny import tiny_cell

from bench_port.harness import program, runner, spec

SPAN_NAMES = ("lxt.pipeline.encode", "lxt.pipeline.finish", "lxt.layer",
              "lxt.layer.recompute", "lxt.moe", "lxt.moe.read")


def reader(name):
    return spec.load_module("metrics", name)


def span_counters(**totals):
    """``run.counters`` of the span totals: ``{"<name>.<field>": value}``
    given with ``_`` for ``.`` in the name, every other key at 0."""
    out = {f"{program.SPANS}.{n}.{f}": 0 for n in SPAN_NAMES
           for f in ("n", "ns", "self_ns")}
    for key, value in totals.items():
        name, field = key.rsplit("__", 1)
        out[f"{program.SPANS}.{name.replace('_', '.')}.{field}"] = value
    return out


def test_pad_share_reads_the_window_positions():
    run = runner.Run(counters={f"{program.POSITIONS}.positions": 4 * 2048,
                               f"{program.POSITIONS}.useful_positions": 2048})
    assert reader("pad_share").read(run) == pytest.approx(75.0)
    run.counters[f"{program.POSITIONS}.positions"] = 0
    assert reader("pad_share").read(run) is None


@pytest.mark.parametrize("name", ["pipeline_self_ms_per_call",
                                  "pipeline_self_ms_per_call.moe"])
def test_pipeline_self_ms_per_call(name):
    run = runner.Run(counters=span_counters(
        lxt_pipeline_encode__n=4, lxt_pipeline_encode__self_ns=2_000_000,
        lxt_pipeline_finish__self_ns=6_000_000, lxt_layer__self_ns=9 ** 9))
    assert reader(name).read(run) == pytest.approx(2.0)
    assert reader(name).read(runner.Run(counters=span_counters())) is None


def test_layer_and_moe_host_ms_per_heatmap():
    run = runner.Run(heatmaps=2, counters=span_counters(
        lxt_layer__n=64, lxt_layer__self_ns=30_000_000,
        lxt_layer_recompute__self_ns=10_000_000,
        lxt_moe__n=64, lxt_moe__ns=90_000_000, lxt_moe__self_ns=50_000_000,
        lxt_moe_read__self_ns=40_000_000))
    assert reader("layer_host_ms_per_heatmap").read(run) == pytest.approx(20.0)
    assert reader("moe_host_ms_per_heatmap").read(run) == pytest.approx(25.0)
    dense = runner.Run(heatmaps=2, counters=span_counters(
        lxt_layer__n=64, lxt_layer__self_ns=30_000_000))
    assert reader("moe_host_ms_per_heatmap").read(dense) is None


def synthetic_trace():
    """Two calls; in the first, a 50 us gap under ``lxt.moe.read`` (inside
    ``lxt.moe`` inside ``lxt.layer``), a 20 us gap under ``lxt.moe`` alone
    and a 30 us gap under ``lxt.layer``; in the second, a 100 us gap under
    ``lxt.layer.recompute`` and a 10 us gap under no span; 1000 us between
    the calls, not counted."""
    calls = [(0, 1000), (2000, 3000)]
    host = [("lxt.layer", 10, 500), ("lxt.moe", 100, 400), ("aten::mm", 110, 120),
            ("lxt.moe.read", 200, 260), ("lxt.layer.recompute", 2100, 2500),
            ("aten::select", 2105, 2110)]
    ops = [("k", 20, 100), ("k", 100, 210), ("k", 260, 280), ("k", 300, 440),
           ("k", 470, 900),
           ("k", 2050, 2110), ("k", 2210, 2600), ("k", 2610, 2700)]
    return types.SimpleNamespace(calls=calls, host=host, traced_ops=ops)


def test_moe_idle_share_puts_each_gap_down_to_its_innermost_span():
    mod = reader("moe_idle_share")
    idle = mod.idle_by_span(synthetic_trace())
    assert idle == {"lxt.moe.read": 50, "lxt.moe": 20, "lxt.layer": 30,
                    "lxt.layer.recompute": 100, None: 10}
    assert mod.read(runner.Run(trace=synthetic_trace())) == pytest.approx(
        100 * 70 / 210)


def test_moe_idle_share_reads_nothing_without_program_spans():
    tr = synthetic_trace()
    tr.host = [h for h in tr.host if not h[0].startswith("lxt.")]
    assert reader("moe_idle_share").read(runner.Run(trace=tr)) is None
    assert reader("moe_idle_share").read(runner.Run(trace=None)) is None


def test_a_reader_names_only_what_the_loaded_program_holds(monkeypatch):
    import lxt_tpu_torch.pipeline  # noqa: F401  (loads tracing too)
    assert program.held(program.SPANS, program.POSITIONS) == [
        program.SPANS, program.POSITIONS]
    assert reader("pad_share").COUNTERS == [program.POSITIONS]
    assert reader("pipeline_self_ms_per_call.moe").COUNTERS == [program.SPANS]
    # an older program: no tracing module, a pipeline without counters
    monkeypatch.delitem(sys.modules, "lxt_tpu_torch.tracing")
    monkeypatch.setitem(sys.modules, "lxt_tpu_torch.pipeline",
                        types.ModuleType("lxt_tpu_torch.pipeline"))
    assert program.held(program.SPANS, program.POSITIONS) == []
    for name in ("pad_share", "pipeline_self_ms_per_call",
                 "pipeline_self_ms_per_call.moe", "layer_host_ms_per_heatmap",
                 "moe_host_ms_per_heatmap"):
        mod = reader(name)
        assert mod.COUNTERS == []
        assert mod.read(runner.Run(counters={}, heatmaps=3)) is None


@pytest.mark.parametrize("family,names", [
    ("mistral", {"pad_share", "pipeline_self_ms_per_call"}),
    ("mixtral", {"pipeline_self_ms_per_call.moe", "layer_host_ms_per_heatmap",
                 "moe_host_ms_per_heatmap"})])
def test_a_traced_tiny_run_reports_the_new_metrics(tmp_path, family, names):
    """The run's own loading of the readers and snapshot of the counters;
    the readers of the device pass, which a CPU run lacks, are left out."""
    cell = tiny_cell(tmp_path, family, dtype="bfloat16")
    cell.per_layer = [m for m in cell.per_layer
                      if m["name"] in names | {"moe_idle_share"}]
    res = runner.run(cell, 2 ** 31 + 7, 0.3, True, "cpu", time.perf_counter())
    assert res["correct"]
    got = {n: m["value"] for n, m in res["metrics"].items()}
    assert names <= set(got), got
    if family == "mistral":
        assert 0 <= got["pad_share"] < 100
    for n in names - {"pad_share"}:
        assert got[n] > 0, (n, got[n])
