"""Useful model FLOPs of the heatmaps completed in the (unprofiled) window
over the window's length times the card's bf16 peak, in percent. The FLOPs
are the family file's count at each prompt's own length (``heatmap_flops``):
remat's recompute and the padding are not counted, so both lower it."""

from bench_port.harness import peaks

LAYER = "model step"
SOURCE = "host_clock"


def read(run):
    return 100.0 * run.flops / (run.window_s * peaks.BF16_FLOPS)
