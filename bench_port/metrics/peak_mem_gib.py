"""``torch.cuda.max_memory_allocated()`` over the measured window (reset at
its start), in GiB."""

SOURCE = "device_trace"


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
