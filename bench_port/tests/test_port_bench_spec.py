"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding every part of a cell by its name."""

import json
import re
import shutil

import pytest
from tiny import BENCH, ROOT, bench_copy

from bench_port.harness import spec

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
TEXT = re.compile(r"[^\t\n\r]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench_port"]
    assert 1 <= len(bench["command"]) <= 32
    assert all(TEXT.fullmatch(w) for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51
    cells = 24
    assert 2 + 14 * cells * (bench["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]] + [
        w["name"] for w in bench["workloads"]] + [
        m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n
    for w in bench["workloads"]:
        assert NAME.fullmatch(w["traffic"]) and NAME.fullmatch(w["config"])
        assert TEXT.fullmatch(w["why"]) and w["chips"] in (1, 4)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.fullmatch(k) for k in c["reduced"])


def test_end_to_end_and_per_layer(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and TEXT.fullmatch(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    cells = {w["name"] for w in bench["workloads"]}
    for w in cells:
        reported = spec.metrics_of(bench, w, "end_to_end")
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        layer = spec.metrics_of(bench, w, "per_layer")
        assert layer and all(m["moves"] in {r["name"] for r in reported} for m in layer)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_its_reader(bench, kind):
    for m in bench[kind]:
        reader = spec.load_module("metrics", m["name"])
        assert reader.SOURCE == m["source"] and callable(reader.read)
        if kind == "per_layer":
            assert reader.LAYER == m["layer"]


def test_every_cell_finds_its_parts(bench):
    for w in bench["workloads"]:
        cell = spec.Cell(w["name"], bench=bench)
        assert cell.config_name == w["config"]
        assert (BENCH / "traffic" / f"{cell.spec['traffic']['kind']}.py").is_file()
        assert cell.family.FAMILY in ("mistral", "mixtral")
        assert hasattr(cell.reference, "Model") and hasattr(cell.family, "build")
        assert cell.spec["limits"] and cell.spec["trace_calls"] >= 1
        assert f"bench_port/configs/{w['config']}.json" in {
            c["file"] for c in bench["configs"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_a_new_cell_and_metric_are_found_with_no_edit(tmp_path):
    """A later cell and a later metric are new files and new entries (and
    the cell's name in the lists of the metrics it reports); no file that
    is there changes."""
    dst = bench_copy(tmp_path)
    before = {p: p.read_bytes() for p in dst.rglob("*") if p.is_file()}
    cell = json.loads((dst / "cells" / "mistral-7b-v0.3.batch-mixed.json").read_text())
    cell["traffic"]["batch"] = 4
    (dst / "cells" / "mistral-7b-v0.3.batch-4.json").write_text(json.dumps(cell))
    (dst / "metrics" / "tokens_per_s.py").write_text(
        'SOURCE = "host_clock"\n\n\ndef read(run):\n'
        '    return sum(run.lengths) / run.window_s\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "mistral-7b-v0.3.batch-4",
                               "config": "mistral-7b-v0.3", "traffic": "batch-4",
                               "chips": 1, "why": "tests"})
    for m in bench["end_to_end"]:      # the cell named where its rate is
        if m["name"] == "heatmaps_per_s":
            m["workloads"].append("mistral-7b-v0.3.batch-4")
    bench["end_to_end"].append({"name": "tokens_per_s", "unit": "tokens/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock"})
    found = spec.Cell("mistral-7b-v0.3.batch-4", bench=bench, bench_dir=dst)
    readers = found.readers(trace=False)
    assert "tokens_per_s" in readers and "heatmaps_per_s" in readers
    assert found.spec["traffic"]["batch"] == 4
    assert all(p.read_bytes() == b for p, b in before.items())
    shutil.rmtree(dst)
