"""Pipeline-parallel attribution: the layers split over the processes of a
``pp`` mesh dimension (counterpart of
``lxt_tpu/parallel/pipeline_parallel.py``).

A family forward that takes ``layer_driver=`` (llama, gemma3, gpt2, bert,
mixtral) runs its layer loop through the driver; the pipeline driver runs
this stage's L/S contiguous layers on each of ``n_micro`` microbatches in
turn (GPipe: all forwards, then all backwards), receiving each
microbatch's activations from stage s − 1 and sending its output to
s + 1. The layer function gets the global depth, so per-depth rules
(``Composite.for_layer(i, L)``), Gemma-3's local/global layers and GPT-2's
inverse layer scale are those of the whole model on every stage; a stage's
stacked leaves are wrapped in :class:`StageLayers`, indexed by that depth.

``lxt_tpu`` differentiates one program across the stages. Here the
schedule is driven explicitly: the last stage runs the head and seeds the
backward; then, for each microbatch in reverse order, every stage receives
the cotangent of its output from s + 1, pulls it back through its own
layers (``torch.autograd.grad``; a checkpointed layer recomputes there)
and sends the result to s − 1. The point-to-point calls pair up in one
fixed order on every process, so they cannot deadlock. Stage 0 holds the
embeddings' gradient and broadcasts the relevance; the last stage
broadcasts the value. Under gloo a CUDA tensor travels through a host copy.

Stages other than the last run the head on zeros (their logits are not
read); hidden-state collection is not supported, as in ``lxt_tpu``.
"""

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from lxt_tpu_torch.models import common
from lxt_tpu_torch.ops import check
from lxt_tpu_torch.ops import tensor_parallel as tp
from lxt_tpu_torch.ops.quant import QuantizedTensor
from lxt_tpu_torch.parallel.mesh import NamedSharding, shard_params


def pipeline_param_shardings(params, mesh, axis: str = "pp"):
    """Every layer-stacked leaf (under ``params['layers']``) split on its
    layer axis over ``axis``; everything else replicated."""

    def walk(tree, in_layers=False):
        if isinstance(tree, dict):
            return {k: walk(v, in_layers or k == "layers") for k, v in tree.items()}
        return NamedSharding(mesh, Shard(0) if in_layers else Replicate(), axis)

    return walk(params)


class StageLayers:
    """A stage's slice of a layer-stacked leaf (a tensor or a
    ``QuantizedTensor`` of its ``count`` layers), indexed by global depth
    from ``first``."""

    def __init__(self, local, first):
        self.local, self.first = local, first
        self.count = (local.q if isinstance(local, QuantizedTensor)
                      else local).shape[0]

    def __getitem__(self, i):
        if not self.first <= i < self.first + self.count:
            raise IndexError(f"layer {i} is not on the stage of layers "
                             f"[{self.first}, {self.first + self.count})")
        return self.local[i - self.first]


def stage_params(params, first):
    """``params`` whose ``layers`` leaves hold one stage's layers, wrapped
    so that the models index them by global depth from ``first``."""
    return dict(params, layers={k: StageLayers(v, first)
                                for k, v in params["layers"].items()})


class PipelineDriver:
    """The ``layer_driver`` of one stage (see the module docstring):
    ``driver(layer_fn, h, num_layers, remat)`` runs the forwards and keeps
    each microbatch's input and output; :meth:`backward` runs the
    backwards."""

    def __init__(self, group, n_micro=None):
        self.group, self.n_micro = group, n_micro
        self.S, self.s = dist.get_world_size(group), dist.get_rank(group)
        self.runs, self.h = [], None

    def stage_layers(self, num_layers):
        """``(first, count)`` of this stage's layers."""
        if num_layers % self.S:
            raise ValueError(f"{num_layers} layers must split over {self.S} "
                             f"pipeline stages")
        count = num_layers // self.S
        return self.s * count, count

    def __call__(self, layer_fn, h, num_layers, remat):
        check.refuse_parallel("pipeline parallelism")
        first, count = self.stage_layers(num_layers)
        B = h.shape[0]
        M = self.n_micro or min(self.S, B)
        if B % M:
            raise ValueError(f"batch {B} must split into {M} microbatches")
        Bm = B // M
        self.h, self.runs = h, []
        for m in range(M):
            if self.s == 0:
                inp = h[m * Bm:(m + 1) * Bm]
            else:
                inp = tp.recv(h[:Bm], self.s - 1, self.group)
            inp = inp.detach().requires_grad_(True)
            out, _ = common.run_layers(lambda x, j: layer_fn(x, first + j),
                                       inp, count, remat)
            if self.s < self.S - 1:
                tp.send(out, self.s + 1, self.group)
            self.runs.append((inp, out))
        if self.s == self.S - 1:
            return torch.cat([out for _, out in self.runs])
        return torch.zeros_like(h)

    def backward(self, target, x):
        """Pull ``target`` (read on the last stage) back to ``x``, the
        embeddings the forward started from. Returns the gradient of ``x``
        on stage 0, None elsewhere."""
        last = self.s == self.S - 1
        if last:
            cots = torch.autograd.grad(target, [out for _, out in self.runs])
        grads = [None] * len(self.runs)
        for m in reversed(range(len(self.runs))):
            inp, out = self.runs[m]
            cot = cots[m] if last else tp.recv(out, self.s + 1, self.group)
            (g,) = torch.autograd.grad(out, inp, cot)
            if self.s > 0:
                tp.send(g, self.s - 1, self.group)
            grads[m] = g
        self.runs = []
        if self.s > 0:
            return None
        g = torch.cat(grads)
        if self.h is x:
            return g
        return torch.autograd.grad(self.h, x, g)[0]


def make_pipeline_driver(mesh, axis: str = "pp", n_micro=None):
    """A ``layer_driver`` for the family forwards that runs this process's
    stage of the pipeline over mesh dimension ``axis``: its L/S layers, on
    ``n_micro`` microbatches (default min(S, B); B % n_micro == 0). Its
    :meth:`PipelineDriver.backward` runs the backward schedule."""
    return PipelineDriver(mesh.get_group(axis), n_micro)


def attribute_pipeline_parallel(forward_fn, params, cfg, inputs_embeds, mesh,
                                composite, axis: str = "pp", n_micro=None,
                                position: int = -1, shard: bool = True):
    """Pipeline-parallel attribution (Gradient*Input) for a family forward
    that takes ``layer_driver=``; every process of the mesh calls it with
    the same arguments. ``shard=True``: ``params`` are the whole model's,
    and each stage keeps its layers (:func:`pipeline_param_shardings`);
    ``shard=False``: ``params['layers']`` already hold this stage's layers.
    Returns ``(value, relevance [B, T] float32)`` on every process."""
    from lxt_tpu_torch.attribution import select_logit

    driver = make_pipeline_driver(mesh, axis, n_micro)
    if shard:
        params, _ = shard_params(params, pipeline_param_shardings(params, mesh, axis))
    params = stage_params(params, driver.stage_layers(cfg.num_layers)[0])
    x = inputs_embeds.detach().requires_grad_(True)
    with torch.enable_grad():
        logits = forward_fn(params, cfg, x, composite, layer_driver=driver).logits
        target = select_logit(logits, position=position)
        grad = driver.backward(target, x)
    rel = (x.detach().float() * grad.float()).sum(-1) if grad is not None else \
        torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    value = tp.broadcast(target.detach(), driver.S - 1, driver.group)
    return value, tp.broadcast(rel, 0, driver.group)
