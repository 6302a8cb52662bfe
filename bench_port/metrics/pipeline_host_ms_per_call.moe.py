"""``pipeline_host_ms_per_call`` (``pipeline_host_ms_per_call.py``) in the cells whose rate is
``heatmaps_per_s.moe``: those whose mixture blocks wait on the host."""

from bench_port.harness.spec import load_module

LAYER = "pipeline"
SOURCE = "device_trace"
read = load_module("metrics", "pipeline_host_ms_per_call").read
