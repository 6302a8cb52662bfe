"""``device_idle_share`` (``device_idle_share.py``) in the cells whose rate is
``heatmaps_per_s.moe``: those whose mixture blocks wait on the host."""

from bench_port.harness.spec import load_module

LAYER = "device"
SOURCE = "device_trace"
read = load_module("metrics", "device_idle_share").read
