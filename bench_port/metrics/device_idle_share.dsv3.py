"""``device_idle_share`` (``device_idle_share.py``) in the cells of the
DeepSeek-V3 configuration, whose rate is ``heatmaps_per_s.moe``."""

from bench_port.harness.spec import load_module

LAYER = "device"
SOURCE = "device_trace"
read = load_module("metrics", "device_idle_share").read
