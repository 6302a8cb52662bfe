"""Host ms a heatmap in the mixture blocks, over the measured window: the
self time of the span ``lxt.moe`` (routing, sorting, the per-expert
products' launches, the combine, forward and recompute), its one
synchronising read (``lxt.moe.read``) taken out."""

from bench_port.harness import program

LAYER = "MoE"
SOURCE = "program_span"
COUNTERS = program.held(program.SPANS)


def read(run):
    if not program.spans(run, "n", "lxt.moe") or not run.heatmaps:
        return None
    return program.spans(run, "self_ns", "lxt.moe") / 1e6 / run.heatmaps
