"""Host ms a heatmap in latent attention, over the measured window: the
self time of the span ``lxt.mla`` (projections, latent norm,
up-projection, rotation, concatenation, the attention call with its
head-dim padding and kernel launches; forward and recompute)."""

from bench_port.harness import program

LAYER = "model step"
SOURCE = "program_span"
COUNTERS = program.held(program.SPANS)


def read(run):
    if not program.spans(run, "n", "lxt.mla") or not run.heatmaps:
        return None
    return program.spans(run, "self_ns", "lxt.mla") / 1e6 / run.heatmaps
