"""``flash_roofline`` (``flash_roofline.py``) in the cells whose rate is
``heatmaps_per_s.moe``: those whose mixture blocks wait on the host."""

from bench_port.harness.spec import load_module

LAYER = "kernels"
SOURCE = "device_trace"
read = load_module("metrics", "flash_roofline").read
