"""A tiny copy of a cell for the CPU tests: the benchmark's files copied into
a temporary directory, with a configuration of the same family cut to a few
small layers and a cell of the same kind cut to a few short prompts."""

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.harness import spec  # noqa: E402

TINY = dict(hidden_size=64, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128)
#: the cells whose tiny copies the tests run, one a family
CELLS = {"mistral": "mistral-7b-v0.3.batch-mixed",
         "mixtral": "mixtral-8x7b-nf4.docs-4k"}


def bench_copy(tmp):
    """The benchmark's files and ``BENCHMARK.json`` copied under ``tmp``."""
    dst = Path(tmp) / "bench_port"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", Path(tmp) / "BENCHMARK.json")
    return dst


def tiny_cell(tmp, family, dtype="float32", limits=None, batch=3):
    """``spec.Cell`` of a tiny copy of ``CELLS[family]``: its configuration
    cut to :data:`TINY` in ``dtype``, its traffic to ``batch`` prompts of
    4-24 tokens a call and two calls a cycle; its limits, unless given, as
    the real cell's."""
    dst = bench_copy(tmp)
    real = spec.Cell(CELLS[family])
    config = json.loads(json.dumps(real.config))
    config["config"].update(TINY)
    config["dtype"] = dtype
    (dst / "configs" / "tiny.json").write_text(json.dumps(config))
    cell = json.loads(json.dumps(real.spec))
    cell["traffic"].update(batch=batch, cycle=2, lengths={
        "dist": "lognormal", "median": 12, "sigma": 0.5, "min": 4, "max": 24})
    cell["compare"] = {"heatmaps": 3, "longest": True}
    if limits is not None:
        cell["limits"] = limits
    (dst / "cells" / "tiny.cell.json").write_text(json.dumps(cell))
    bench = json.loads((Path(tmp) / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "tests",
                             "file": "bench_port/configs/tiny.json",
                             "reduced": sorted(TINY), "why": "tests"})
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny",
                               "traffic": "cell", "chips": 1, "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELLS[family] in m.get("workloads", ()):
            m["workloads"].append("tiny.cell")
    return spec.Cell("tiny.cell", bench=bench, bench_dir=dst)
