"""``mfu`` (``mfu.py``) in the cells of the DeepSeek-V3 configuration,
whose rate is ``heatmaps_per_s.moe``."""

from bench_port.harness.spec import load_module

LAYER = "model step"
SOURCE = "host_clock"
read = load_module("metrics", "mfu").read
