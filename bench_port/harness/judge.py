"""The comparison that decides ``correct``.

Each compared heatmap is the program's explanation of a prompt's next
token: its raw per-token relevance and its explained logit. The reference
explains the same token (the one the program's run explained, recorded in
``harness/state.py``) and these numbers are taken over every compared
heatmap, at their worst:

- ``rel_l2``: ‖r − r_ref‖ / ‖r_ref‖;
- ``map_sin``: the sine of the angle between r and r_ref, the distance left
  when either map is scaled to fit the other best (a map's scale follows
  its explained logit, which ``value_err`` judges);
- ``logit_gap``: how far the explained token's reference logit lies below
  the reference's best (0 when the program explained the reference's
  argmax);
- ``value_err``: |explained logit − the token's reference logit|;
- and what the family's reference reports besides (``route_gap`` for a
  mixture of experts: see ``reference/mixtral.py``).

A cell compares the numbers that it gives a limit; a number that is not
finite, or missing, fails.
"""

import math

import numpy as np

NUMBERS = ("rel_l2", "map_sin", "logit_gap", "value_err")


def heatmap_numbers(relevance, value, ref):
    """The numbers of one heatmap against the reference's
    (``plain.explain``'s result)."""
    r = np.asarray(relevance, np.float64)
    rr = np.asarray(ref["relevance"], np.float64)
    if r.shape != rr.shape:
        return dict.fromkeys(NUMBERS, math.inf)
    nr, nrr = np.linalg.norm(r), max(np.linalg.norm(rr), 1e-30)
    cos = float(r @ rr) / max(nr * nrr, 1e-30)
    out = {"rel_l2": float(np.linalg.norm(r - rr) / nrr),
           "map_sin": math.sqrt(max(0.0, 1.0 - cos * cos)) if cos > 0 else 1.0,
           "logit_gap": ref["best"] - ref["logit"],
           "value_err": abs(float(value) - ref["logit"])}
    return {n: (v if math.isfinite(v) else math.inf) for n, v in out.items()}


def worst(per_heatmap, names):
    """Each of ``names`` at its worst over the compared heatmaps (missing
    or not finite: infinite)."""
    out = {}
    for n in names:
        vals = [h.get(n, math.inf) for h in per_heatmap] or [math.inf]
        v = max(vals)
        out[n] = v if math.isfinite(v) else math.inf
    return out


def checks(numbers, limits):
    """``{name: {"value", "limit"}}`` of the numbers that ``limits`` bounds,
    and whether all of them hold."""
    out = {n: {"value": numbers.get(n, math.inf), "limit": float(lim)}
           for n, lim in limits.items()}
    return out, bool(out) and all(c["value"] <= c["limit"] for c in out.values())
