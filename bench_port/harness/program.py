"""The program's own spans and counters, as the metric readers see them.

``lxt_tpu_torch.tracing:spans`` (per span name: ``<name>.n`` spans opened,
``<name>.ns`` and ``<name>.self_ns`` their nanoseconds, with and without
their child spans') and ``lxt_tpu_torch.pipeline:counters`` (the positions
of the batches encoded, and the prompts' own tokens among them) are program
counters that the run reads before and after its window
(``runner.Counters``). A reader names one in ``COUNTERS`` only where the
program under test holds it: in a checkout of the program that predates it
the reader has nothing to read, and reads None. :func:`held` asks only the
modules that the run has loaded (it imports the program before it loads
its readers) and imports nothing.
"""

import sys

SPANS = "lxt_tpu_torch.tracing:spans"
POSITIONS = "lxt_tpu_torch.pipeline:counters"


def held(*refs):
    """The ``"module:dict"`` references of ``refs`` that the loaded program
    holds."""
    out = []
    for ref in refs:
        module, attr = ref.split(":")
        if isinstance(getattr(sys.modules.get(module), attr, None), dict):
            out.append(ref)
    return out


def spans(run, field, *names):
    """The window's change of ``<name>.<field>`` summed over ``names``, or
    None where the run read no such span."""
    try:
        return sum(run.counters[f"{SPANS}.{name}.{field}"] for name in names)
    except KeyError:
        return None
