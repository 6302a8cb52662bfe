"""``pipeline_self_ms_per_call`` (``pipeline_self_ms_per_call.py``) in the cells whose rate is
``heatmaps_per_s.moe``: those whose mixture blocks wait on the host."""

from bench_port.harness.spec import load_module

LAYER = "pipeline"
SOURCE = "program_span"
_reader = load_module("metrics", "pipeline_self_ms_per_call")
COUNTERS = _reader.COUNTERS
read = _reader.read
