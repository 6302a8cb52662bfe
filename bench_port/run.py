#!/usr/bin/env python3
"""The benchmark of ``lxt_tpu_torch`` on one NVIDIA GPU: one run of one cell.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its parts are files under ``bench_port/`` found by name
(``harness/spec.py``). The run builds the model on the card from the seed,
warms up the cell's call shapes, drives ``AttributionPipeline.__call__`` in
a closed loop for ``--seconds``, with ``--trace 1`` profiles a fixed few
calls after the window, then frees the program and compares a sample of
the window's heatmaps with the plain reference. The last line of standard
output is the result's JSON object; the last lines of standard error give
each number compared beside its limit. Without a CUDA device, or with
fewer than the cell asks for, it exits 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # keep libraries that could load JAX from doing so
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, ROOT)
    import torch

    from bench_port.harness import runner
    from bench_port.harness.spec import Cell

    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        runner.log(f"{args.workload} needs {cell.chips} CUDA device(s); "
                   f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda", T0)
    found = runner.forbidden_modules()
    if result is None or found:
        runner.log(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
