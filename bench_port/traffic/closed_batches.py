"""A closed loop of batched calls: one caller, and the next call is issued
when the last returns, so a prompt is due when its call starts.

The cell gives the batch (prompts a call), the cycle (calls before the
plan repeats) and the distribution of prompt lengths, drawn once with the
cell's own generator seed, so every run of the cell makes the same calls
in the same order. ``--seed`` draws only the token ids, uniform over the
vocabulary: every seed does the same work.

Length distributions (``lengths``):

- ``{"dist": "lognormal", "median", "sigma", "min", "max"}``: exp of a
  normal around log(median), clipped to [min, max];
- ``{"dist": "loguniform", "min", "max"}``: uniform in log length;
- ``{"dist": "fixed", "value"}``.

Lengths are whole tokens, not rounded further.
"""

import time

import numpy as np


def lengths(spec):
    """The plan's prompt lengths, ``[cycle][batch]``."""
    rng = np.random.default_rng(int(spec["generator_seed"]))
    n = int(spec["cycle"]) * int(spec["batch"])
    d = spec["lengths"]
    if d["dist"] == "lognormal":
        x = np.exp(np.log(d["median"]) + d["sigma"] * rng.standard_normal(n))
        x = np.clip(x, d["min"], d["max"])
    elif d["dist"] == "loguniform":
        x = np.exp(rng.uniform(np.log(d["min"]), np.log(d["max"]), n))
    elif d["dist"] == "fixed":
        x = np.full(n, d["value"], np.float64)
    else:
        raise ValueError(f"unknown length distribution {d['dist']!r}")
    x = np.clip(np.rint(x), 1, None).astype(np.int64)
    return x.reshape(int(spec["cycle"]), int(spec["batch"])).tolist()


def plan(spec, vocab, seed):
    """The calls of one cycle: each a list of prompts, each an int64 array
    of token ids drawn from ``seed``."""
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    return [[rng.integers(0, vocab, size=n, dtype=np.int64) for n in call]
            for call in lengths(spec)]


def drive(call, calls, seconds, clock=time.perf_counter):
    """Issue ``calls`` in a closed loop from the plan's first, cycling,
    until ``seconds`` have passed since the first was issued; the call
    running then is finished and counted. Returns ``(records, window)``:
    per call ``{"index", "due", "end", "out"}`` (``out`` what ``call``
    returned), and the seconds from the first call's start to the last
    one's end."""
    records = []
    start = clock()
    i = 0
    while True:
        prompts = calls[i % len(calls)]
        due = clock()
        out = call(prompts)
        end = clock()
        records.append({"index": i % len(calls), "due": due - start,
                        "end": end - start, "out": out})
        i += 1
        if end - start >= seconds:
            return records, end - start
