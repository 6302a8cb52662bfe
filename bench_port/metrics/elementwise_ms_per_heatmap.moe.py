"""``elementwise_ms_per_heatmap`` (``elementwise_ms_per_heatmap.py``) in the cells whose rate is
``heatmaps_per_s.moe``: those whose mixture blocks wait on the host."""

from bench_port.harness.spec import load_module

LAYER = "model step"
SOURCE = "device_trace"
read = load_module("metrics", "elementwise_ms_per_heatmap").read
