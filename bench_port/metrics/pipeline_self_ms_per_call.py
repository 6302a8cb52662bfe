"""The pipeline's own host time a call, over the measured window: the self
time of the spans ``lxt.pipeline.encode`` (tokenising, padding, ``ids`` and
``kv_begin``) and ``lxt.pipeline.finish`` (token strings, normalisation,
the heatmaps), in ms, over the calls (``lxt.pipeline.encode``'s count).
The inside counterpart of ``pipeline_host_ms_per_call``, read unprofiled."""

from bench_port.harness import program

LAYER = "pipeline"
SOURCE = "program_span"
COUNTERS = program.held(program.SPANS)


def read(run):
    calls = program.spans(run, "n", "lxt.pipeline.encode")
    if not calls:
        return None
    ns = program.spans(run, "self_ns", "lxt.pipeline.encode", "lxt.pipeline.finish")
    return ns / 1e6 / calls
