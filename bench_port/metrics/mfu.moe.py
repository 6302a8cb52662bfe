"""``mfu`` (``mfu.py``) in the cells whose rate is
``heatmaps_per_s.moe``: those whose mixture blocks wait on the host."""

from bench_port.harness.spec import load_module

LAYER = "model step"
SOURCE = "host_clock"
read = load_module("metrics", "mfu").read
