"""The share of the positions that the pipeline pads, over the measured
window, in percent: 1 − the prompts' own tokens over the positions of the
batches it encoded (``lxt_tpu_torch.pipeline.counters``: B × T after the
rounding to ``pad_multiple``, dummy rows included)."""

from bench_port.harness import program

LAYER = "pipeline"
SOURCE = "program_counter"
COUNTERS = program.held(program.POSITIONS)


def read(run):
    positions = run.counters.get(f"{program.POSITIONS}.positions")
    if not positions:
        return None
    useful = run.counters[f"{program.POSITIONS}.useful_positions"]
    return 100.0 * (1.0 - useful / positions)
