"""Seconds from the process's start to the window's: the kernel library's
build or load, the weights drawn and converted on the card, and the
warm-up calls."""

SOURCE = "host_clock"


def read(run):
    return run.setup_s
