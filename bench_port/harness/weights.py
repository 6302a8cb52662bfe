"""Random checkpoints drawn on the device from ``--seed``.

A tensor is a function of the run's seed and its checkpoint name alone:
:class:`SeededState` draws it when it is asked for, with a generator on the
device seeded from both, so the program's converter and the reference each
draw the same bits by name and never hold the whole model twice. Nothing is
written to disk.
"""

import hashlib
from collections.abc import Mapping

import torch

#: standard deviation of a projection or embedding (the usual init range)
WEIGHT_STD = 0.02
#: spread of a norm's gain around 1, so that the gains are not all equal
NORM_STD = 0.05


def tensor_seed(seed, name):
    """A 63-bit generator seed from the run's seed and a tensor's name."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def draw(seed, name, shape, kind, dtype=torch.bfloat16, device="cuda"):
    """Tensor ``name`` of ``shape``: N(0, 0.02) for a projection or an
    embedding, 1 + N(0, 0.05) for a norm's gain, drawn in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(tensor_seed(seed, name))
    w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    if kind == "norm":
        return w.mul_(NORM_STD).add_(1.0)
    return w.mul_(WEIGHT_STD)


class SeededState(Mapping):
    """A checkpoint as a read-only mapping ``name -> tensor`` on ``device``
    (the HF layout: a linear weight is ``[out, in]``), each tensor drawn
    when it is asked for. ``shapes``: ``name -> (shape, kind)``."""

    def __init__(self, shapes, seed, dtype=torch.bfloat16, device="cuda"):
        self.shapes, self.seed = dict(shapes), int(seed)
        self.dtype, self.device = dtype, torch.device(device)

    def __getitem__(self, name):
        shape, kind = self.shapes[name]
        return draw(self.seed, name, shape, kind, self.dtype, self.device)

    def __iter__(self):
        return iter(self.shapes)

    def __len__(self):
        return len(self.shapes)

    def __contains__(self, name):
        return name in self.shapes
