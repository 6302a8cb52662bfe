"""Host time of a pipeline call outside the device's work: the benchmark's
span around each profiled call minus the interval from its first device
operation's start to its last one's end (encoding, the copies to the host,
normalisation), averaged over the profiled calls."""

LAYER = "pipeline"
SOURCE = "device_trace"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    host = [ms for ms in (tr.host_ms(i) for i in range(len(tr.calls)))
            if ms is not None]
    return sum(host) / len(host) if host else None
