"""Host ms a heatmap in the model's layers outside the mixture, over the
measured window: the self time of the spans ``lxt.layer`` (each layer's
forward) and ``lxt.layer.recompute`` (its recompute in the backward), the
mixture's span taken out: attention, norms, projections and the rules'
launches. Read where the launch queue stays short (docs-4k); where the
device is the bound, the host waits on a full queue inside these spans."""

from bench_port.harness import program

LAYER = "model step"
SOURCE = "program_span"
COUNTERS = program.held(program.SPANS)


def read(run):
    if not program.spans(run, "n", "lxt.layer") or not run.heatmaps:
        return None
    ns = program.spans(run, "self_ns", "lxt.layer", "lxt.layer.recompute")
    return ns / 1e6 / run.heatmaps
