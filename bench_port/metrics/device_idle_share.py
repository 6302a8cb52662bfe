"""1 − the device's busy time over its window, in percent, over the
profiled calls traced on the device alone: in each call, the union of the
device operations' intervals over the span from its first operation's
start to its last one's end."""

LAYER = "device"
SOURCE = "device_trace"


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy() / tr.window())
