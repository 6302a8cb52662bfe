"""Find every part of a cell by its name.

``BENCHMARK.json`` (at the checkout's root) names the cells and metrics;
each part lives in a file of its own under ``bench_port/``:

- ``cells/<workload>.json``: the traffic's parameters, the sample that is
  compared and the limits of the comparison;
- ``configs/<config>.json``: the model's sizes as published, and its family;
- ``families/<family>.py``: the tensors of a checkpoint, the builder of the
  program's model and the useful FLOPs of a heatmap;
- ``reference/<family>.py``: the plain reference of the family;
- ``traffic/<kind>.py``: the generator of a traffic kind;
- ``metrics/<metric>.py``: the reader of one metric.

A later cell, configuration, traffic kind or metric is a new file and a new
entry in ``BENCHMARK.json``; nothing here names one.
"""

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


def _checked(name):
    if not NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def load_module(kind, name, bench_dir=None):
    """The module ``<bench_dir>/<kind>/<name>.py``, loaded from its file."""
    path = Path(bench_dir or BENCH_DIR) / kind / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                                f"{name!r}: {path} is missing")
    mod_name = "bench_port_" + kind + "_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(kind, name, bench_dir=None):
    path = Path(bench_dir or BENCH_DIR) / kind / f"{_checked(name)}.json"
    return json.loads(path.read_text())


def benchmark(root=None):
    return json.loads((Path(root or ROOT) / "BENCHMARK.json").read_text())


def metrics_of(bench, workload, kind):
    """The ``kind`` (``end_to_end`` or ``per_layer``) metrics that the cell
    ``workload`` reports: those with no ``workloads`` key, and those that
    list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


class Cell:
    """One workload with its configuration, family, traffic and metrics."""

    def __init__(self, workload, bench=None, bench_dir=None):
        self.bench = bench if bench is not None else benchmark()
        self.bench_dir = Path(bench_dir or BENCH_DIR)
        entry = [w for w in self.bench["workloads"] if w["name"] == workload]
        if not entry:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = entry[0]
        self.name = workload
        self.chips = int(self.entry["chips"])
        self.spec = load_json("cells", workload, self.bench_dir)
        self.config_name = self.entry["config"]
        self.config = load_json("configs", self.config_name, self.bench_dir)
        self.family = load_module("families", self.config["family"],
                                  self.bench_dir)
        self.reference = load_module("reference", self.config["family"],
                                     self.bench_dir)
        traffic = self.spec["traffic"]
        self.traffic = load_module("traffic", traffic["kind"], self.bench_dir)
        self.end_to_end = metrics_of(self.bench, workload, "end_to_end")
        self.per_layer = metrics_of(self.bench, workload, "per_layer")

    def readers(self, trace):
        """``{metric name: (entry, reader module)}`` of this run's metrics:
        the per-layer ones in a traced run, else the end-to-end ones."""
        entries = self.per_layer if trace else self.end_to_end
        return {m["name"]: (m, load_module("metrics", m["name"], self.bench_dir))
                for m in entries}
