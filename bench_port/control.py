#!/usr/bin/env python3
"""The readings that a cell's limits are set from: the comparison's numbers
for the program and for the control, on several seeds, in one process.

    python3 bench_port/control.py --workload <name> --seeds 1,2,3 [--who program,control]

For each seed it draws the cell's plan, picks the heatmaps a run on that
seed compares (``runner._sample``: the same pairs of the cycle) and judges,
against the float32 reference, either

- ``program``: the program's heatmaps of those calls (the model built from
  the seed as a run builds it, each call through
  ``AttributionPipeline.__call__`` at the cell's own sizes); or
- ``control``: the reference itself in the program's place, computed with
  every matrix product in fp8 (e4m3, one scale per row and column), the
  nearest precision below the configuration's bf16.

It prints one line a seed and reading, and a last JSON line with all of
them. The benchmark's own runs never run it; its test
(``tests/test_port_bench_control.py``) holds that the control fails.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed, who, device):
    """``(checks, correct, per-heatmap numbers)`` of ``who`` on ``seed``."""
    import torch

    from bench_port.harness import runner, weights
    from bench_port.harness import state as state_of
    from bench_port.reference import plain

    hf = cell.config["config"]
    cell.calls = cell.traffic.plan(cell.spec["traffic"], hf["vocab_size"], seed)
    sample = runner._sample(cell, seed)
    out, kept = {}, {}
    if who == "program":
        from lxt_tpu_torch.pipeline import AttributionPipeline
        state = weights.SeededState(cell.family.tensors(cell.config), seed,
                                    getattr(torch, cell.config["dtype"]), device)
        pipe = AttributionPipeline(cell.family.build(cell.config, state, device),
                                   runner.Ids(hf.get("eos_token_id") or 0))
        with state_of.Recording(cell.family, cell.config) as recording:
            for i in dict.fromkeys(i for i, _ in sample):
                prompts = cell.calls[i]
                for j, h in enumerate(pipe(prompts)):
                    out[i, j] = (h.raw_relevance, h.value)
                keep = [j for i2, j in sample if i2 == i]
                for j, st in recording.take(prompts, keep).items():
                    kept[i, j] = st
        del pipe, state
    else:
        plain.no_tf32()
        state = weights.SeededState(cell.family.tensors(cell.config), seed,
                                    getattr(torch, cell.config["dtype"]), device)
        model = cell.reference.Model(cell.config, state.__getitem__, device)
        for i, j in sample:
            ids = torch.as_tensor(cell.calls[i][j], device=device)
            model.follow(None)
            model.record = []
            res = plain.explain(model, ids, prec="fp8")
            out[i, j] = (res["relevance"], res["logit"])
            kept[i, j] = {"token": res["token"], "routes": model.record or None}
        del model, state
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return runner.compare(cell, [(i, j, out[i, j], kept.get((i, j)))
                                 for i, j in sample], seed, device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--who", default="program,control")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from bench_port.harness.spec import Cell

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    out = []
    for who in args.who.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            checks, ok, per = readings(cell, seed, who, "cuda")
            row = {"who": who, "seed": seed, "correct": ok,
                   "numbers": {n: c["value"] for n, c in checks.items()},
                   "per_heatmap": per, "seconds": time.perf_counter() - t}
            out.append(row)
            print(f"{who} seed {seed}: correct {ok} " + " ".join(
                f"{n} {v!r}" for n, v in row["numbers"].items())
                + f" ({row['seconds']:.1f} s)", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
