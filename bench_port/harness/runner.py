"""One run of one cell: set-up, the measured window, the traced calls, the
metrics and the comparison that decides ``correct``.

The program under test is ``lxt_tpu_torch``: the benchmark builds its
model from a seeded checkpoint through the port's converter and drives
``AttributionPipeline.__call__`` with the cell's calls. Everything else
(traffic, weights, spans, counters read, FLOPs, peaks, the reference and the
comparison) is the benchmark's own.
"""

import gc
import importlib
import math
import sys
import time

import numpy as np

from bench_port.harness import judge, weights
from bench_port.harness import state as state_of
from bench_port.harness.trace import CALL_SPAN, Trace, device_ops

#: top-level modules that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "lxt_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


class Ids:
    """The pipeline's tokenizer for prompts that come as token ids: it
    names the padding id and nothing more."""

    def __init__(self, pad_token_id):
        self.pad_token_id = pad_token_id


class Run:
    """What a metric reader reads: the window's record, the trace
    (``trace`` None in an untraced run) and ``counters``, the change of each
    program counter ``"module:dict.key"`` that a reader names over the
    measured window."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class Counters:
    """Snapshots of the program's counters that this run's readers name
    (``COUNTERS``: ``"module:dict"``), before and after the window."""

    def __init__(self, readers):
        self.dicts = {}
        for _, mod in readers.values():
            for ref in getattr(mod, "COUNTERS", ()):
                module, attr = ref.split(":")
                self.dicts[ref] = getattr(importlib.import_module(module), attr)
        self.before = self._read()

    def _read(self):
        return {f"{ref}.{k}": v for ref, d in self.dicts.items()
                for k, v in d.items()}

    def delta(self):
        after = self._read()
        return {k: after[k] - self.before[k] for k in after}


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warm_shapes(calls, multiple):
    """One call of each padded shape ``(batch, length)`` of the plan,
    largest first: CUDA loads a kernel at its first launch, and cuBLAS
    picks other kernels at other shapes, so a shape first met inside the
    window would load there."""
    shapes = {}
    for c in calls:
        shapes.setdefault((len(c), -(-max(len(p) for p in c) // multiple)
                           * multiple), c)
    return [shapes[k] for k in sorted(shapes, key=lambda k: -k[0] * k[1])]


def _profile(call, calls, device):
    """The traced calls, twice: the device alone, one profile a call; then
    host and device with the operators' shapes, each call inside the
    benchmark's span (see :class:`Trace`)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    call_ops = []
    if device.type == "cuda":
        for prompts in calls:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call(prompts)
                _sync(device)
            call_ops.append(device_ops(prof))
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts, record_shapes=True) as prof:
        for prompts in calls:
            with record_function(CALL_SPAN):
                call(prompts)
        _sync(device)
    return Trace(call_ops, prof, [[len(p) for p in c] for c in calls])


def _sample(cell, seed):
    """The heatmaps compared, drawn from the seed before the window: ``(call
    index in the cycle, position)`` pairs of the plan, and the longest
    prompt's; each judged at its last completion in the window."""
    spec = cell.spec["compare"]
    pool = [(i, j) for i, c in enumerate(cell.calls) for j in range(len(c))]
    rng = np.random.default_rng([int(seed) % 2 ** 64, 0xC0FFEE])
    picked = [pool[i] for i in rng.choice(len(pool), min(int(spec["heatmaps"]),
                                                         len(pool)), replace=False)]
    if spec.get("longest"):
        picked.append(max(pool, key=lambda ij: len(cell.calls[ij[0]][ij[1]])))
    return list(dict.fromkeys(picked))


def compare(cell, done, seed, device):
    """Run the reference over the compared heatmaps ``done``, a list of
    ``(index, position, (relevance, value), state)``: each explaining the
    token that the judged run explained and following its recorded state,
    and judge the run's maps against it. Returns ``(checks, correct,
    per-heatmap numbers)``; with nothing to compare, not correct."""
    import torch
    from bench_port.reference import plain
    plain.no_tf32()
    config = cell.config
    state = weights.SeededState(cell.family.tensors(config), seed,
                                getattr(torch, config["dtype"]), device)
    model = cell.reference.Model(config, state.__getitem__, device)
    per = []
    for i, j, (rel, value), followed in done:
        if followed is None:        # the run recorded nothing of this heatmap
            per.append(dict.fromkeys(judge.NUMBERS, math.inf))
            continue
        ids = torch.as_tensor(cell.calls[i][j], device=device)
        model.follow(followed)
        res = plain.explain(model, ids, followed["token"])
        per.append(dict(judge.heatmap_numbers(rel, value, res), **model.numbers(),
                        length=int(ids.shape[0])))
    names = list(judge.NUMBERS) + [n for n in model.numbers() if n not in judge.NUMBERS]
    numbers = judge.worst(per, names)
    checks, ok = judge.checks(numbers, cell.spec["limits"])
    return checks, ok, per


def run(cell, seed, seconds, trace, device, t0):
    """One run; returns the result's JSON object (None when a forbidden
    module is loaded)."""
    import torch
    from lxt_tpu_torch.pipeline import AttributionPipeline

    device = torch.device(device)
    cuda = device.type == "cuda"
    config = cell.config
    hf = config["config"]
    state = weights.SeededState(cell.family.tensors(config), seed,
                                getattr(torch, config["dtype"]), device)
    t_build = time.perf_counter()
    model = cell.family.build(config, state, device)
    pipe = AttributionPipeline(model, Ids(hf.get("eos_token_id") or 0))
    cell.calls = cell.traffic.plan(cell.spec["traffic"], hf["vocab_size"], seed)
    index_of = {id(c): i for i, c in enumerate(cell.calls)}
    sample = _sample(cell, seed)
    wanted = {}
    for i, j in sample:
        wanted.setdefault(i, []).append(j)
    kept = {}           # (index, position) -> state of its last completion
    recording = state_of.Recording(cell.family, config)

    def call(prompts, keep=True):
        maps = [(h.raw_relevance, h.value) for h in pipe(prompts)]
        i = index_of.get(id(prompts))
        for j, st in recording.take(prompts, wanted.get(i, ()) if keep
                                    else ()).items():
            kept[i, j] = st
        return maps

    with recording:
        _sync(device)
        t_warm = time.perf_counter()
        warm = _warm_shapes(cell.calls, pipe.pad_multiple)
        for prompts in warm:
            call(prompts, keep=False)
        _sync(device)
        log(f"set-up: {t_build - t0:.3f} s to the build, {t_warm - t_build:.3f} s "
            f"weights drawn and converted, {time.perf_counter() - t_warm:.3f} s "
            f"for {len(warm)} warm-up calls")
        readers = cell.readers(trace)
        counters = Counters(readers)
        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t0

        records, window = cell.traffic.drive(call, cell.calls, seconds)
        _sync(device)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        counted = counters.delta()
        tr = (_profile(lambda p: call(p, keep=False),
                       cell.calls[:int(cell.spec["trace_calls"])], device)
              if trace else None)
    last = {rec["index"]: rec for rec in records}
    done = [(i, j, last[i]["out"][j], kept.get((i, j)))
            for i, j in sample if i in last]
    log("first calls of the window (s): " + " ".join(
        f"{rec['index']}:{rec['end'] - rec['due']:.4f}" for rec in records[:4])
        + "; compared (call, position): " + " ".join(f"{i}:{j}" for i, j, *_ in done)
        + f" of {len(sample)} drawn")
    lengths = [len(p) for rec in records for p in cell.calls[rec["index"]]]
    latencies = [rec["end"] - rec["due"] for rec in records
                 for _ in cell.calls[rec["index"]]]
    ctx = Run(cell=cell, config=config, family=cell.family, setup_s=setup_s,
              window_s=window, heatmaps=len(lengths), lengths=lengths,
              latencies=latencies, peak_bytes=peak, counters=counted,
              trace=tr, flops=sum(cell.family.heatmap_flops(config, n)
                                  for n in lengths))
    metrics = {}
    for name, (entry, reader) in readers.items():
        value = reader.read(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": entry["unit"]}
    log(f"window {window:.3f} s, {len(records)} calls, {len(lengths)} heatmaps, "
        f"set-up {setup_s:.3f} s, peak {peak / 2**30:.3f} GiB "
        f"(set-up {setup_peak / 2**30:.3f} GiB)")

    del pipe, model, state, call, kept
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return None
    t_ref = time.perf_counter()
    checks, ok, per = compare(cell, done, seed, device)
    log(f"reference: {len(per)} heatmaps, {time.perf_counter() - t_ref:.3f} s")
    for h in per:
        log("  heatmap " + " ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                                    for k, v in h.items()))
    result = {"correct": ok, "attempted": len(lengths), "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda
                         else device.type,
                         "count": cell.chips,
                         "memory_peak_bytes": int(max(peak, setup_peak))}}
    if tr is not None and tr.ops:
        result["device"].update(busy_s=tr.busy() / 1e6, window_s=tr.window() / 1e6)
        by = sorted(tr.by_class().items(), key=lambda kv: -kv[1][0])
        result["breakdown"] = {
            "device_ops": [[cls, us / 1e6] for cls, (us, _) in by[:10]],
            "idle_gaps": [[label, us / 1e6] for label, us in tr.idle_gaps(10)]}
    result["checks"] = {n: {"value": c["value"] if math.isfinite(c["value"])
                            else None, "limit": c["limit"]}
                        for n, c in checks.items()}
    for n, c in checks.items():
        log(f"check {n} {c['value']!r} limit {c['limit']!r}")
    return result
