"""Heatmaps completed in the measured window over the window's length (the
host's clock, from the first call's start to the last one's end)."""

SOURCE = "host_clock"


def read(run):
    return run.heatmaps / run.window_s
