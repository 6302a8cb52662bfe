"""``moe_host_ms_per_heatmap`` (``moe_host_ms_per_heatmap.py``) in the cells
of the DeepSeek-V3 configuration: the routing, the shared experts and the
ragged mixture's launches."""

from bench_port.harness.spec import load_module

LAYER = "MoE"
SOURCE = "program_span"
_reader = load_module("metrics", "moe_host_ms_per_heatmap")
COUNTERS = _reader.COUNTERS
read = _reader.read
