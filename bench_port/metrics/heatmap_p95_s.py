"""The 95th percentile, over every heatmap completed in the window, of the
seconds from when its prompt was due (its call's start, in a closed loop)
until its map was on the host."""

import numpy as np

SOURCE = "host_clock"


def read(run):
    return float(np.percentile(run.latencies, 95)) if run.latencies else None
