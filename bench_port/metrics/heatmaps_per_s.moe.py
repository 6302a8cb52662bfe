"""``heatmaps_per_s`` (``heatmaps_per_s.py``) in the cells whose mixture
blocks wait on the host (one synchronising read of the group sizes a block):
there the rate follows the host's load, swings by several percent from run
to run, and takes a bound of its own."""

from bench_port.harness.spec import load_module

SOURCE = "host_clock"
read = load_module("metrics", "heatmaps_per_s").read
