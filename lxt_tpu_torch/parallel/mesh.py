"""Meshes, parameter sharding and batched attribution over several
processes (counterpart of ``lxt_tpu/parallel/mesh.py``).

``lxt_tpu`` annotates shardings and lets GSPMD write the collectives. Here
every process of a ``torch.distributed`` group calls the same functions
with the same arguments, holds its own slices of the weights as plain
tensors, and the models call the collectives themselves
(:mod:`lxt_tpu_torch.ops.tensor_parallel`):

- ``data``: each process explains its rows of the batch; no communication
  inside the attribution, then the values are summed and the relevance
  maps gathered, so every process returns the whole batch's;
- ``model``: tensor parallelism. Column-parallel products (q/k/v, gate/up,
  fc; they split the output features: whole heads or MLP columns) follow a
  ``copy``, row-parallel ones (the attention output and down projections;
  they split the input features) end in a ``reduce`` with the bias added
  once after it, and an explicit rule there divides by the summed
  denominators. The embedding and the head are split on the vocabulary.
  Each process runs its share of the heads: ``Hkv % tp == 0``.

Placements are ``torch.distributed.tensor``'s ``Shard(dim)`` and
``Replicate()``; :class:`NamedSharding` ties one to a mesh dimension.
:func:`shard_params` returns each process's slices; quantized leaves stay
:class:`~lxt_tpu_torch.ops.quant.QuantizedTensor`s of local codes and
scales (no re-quantization). No DTensor reaches a kernel.
"""

import contextlib
import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from lxt_tpu_torch.ops import check, tensor_parallel
from lxt_tpu_torch.ops.quant import QuantizedTensor

R = Replicate()


def make_mesh(data=None, model: int = 1) -> DeviceMesh:
    """A ``(data, model)`` mesh over the ranks of the default group, which
    the caller has initialized (every process calls this). ``data``
    defaults to all ranks over ``model``. The mesh's groups use the
    default group's backend: NCCL with one card per process, gloo on the
    CPU or for several processes on one card (NCCL refuses two ranks on one
    device)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "default group")
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"{data}x{model} != {n} processes")
    nccl = dist.get_backend() == dist.Backend.NCCL
    return init_device_mesh("cuda" if nccl else "cpu", (data, model),
                            mesh_dim_names=("data", "model"))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's ``placement`` over the mesh dimension ``dim``."""
    mesh: DeviceMesh
    placement: object = R
    dim: str = "model"


def _named(mesh, tree, dim="model"):
    if isinstance(tree, dict):
        return {k: _named(mesh, v, dim) for k, v in tree.items()}
    return NamedSharding(mesh, tree, dim)


# Per-family tensor-parallel tables (leaf name -> placement over ``model``),
# copied from lxt_tpu. Leaves not named are replicated. ``head_b`` goes
# with its ``head_w`` columns (lxt_tpu leaves it replicated; GSPMD slices
# it). The fused q|k|v leaves are split by head groups within each third
# (:data:`_FUSED_QKV`).
_FAMILY_TP_LAYERS = {
    "llama": {
        "wq": Shard(2), "wk": Shard(2), "wv": Shard(2), "wo": Shard(1),
        "wg": Shard(2), "wu": Shard(2), "wd": Shard(1),
        "bq": Shard(1), "bk": Shard(1), "bv": Shard(1),
    },
    "gemma3": {
        "wq": Shard(2), "wk": Shard(2), "wv": Shard(2), "wo": Shard(1),
        "wg": Shard(2), "wu": Shard(2), "wd": Shard(1),
    },
    "gpt2": {
        "w_attn": Shard(2), "b_attn": Shard(1), "w_proj": Shard(1),
        "w_fc": Shard(2), "b_fc": Shard(1), "w_out": Shard(1),
    },
    "bert": {
        "wq": Shard(2), "bq": Shard(1), "wk": Shard(2), "bk": Shard(1),
        "wv": Shard(2), "bv": Shard(1), "wo": Shard(1),
        "wi": Shard(2), "bi": Shard(1), "wout": Shard(1),
    },
    "siglip": {
        "wq": Shard(2), "bq": Shard(1), "wk": Shard(2), "bk": Shard(1),
        "wv": Shard(2), "bv": Shard(1), "wo": Shard(1),
        "w_fc": Shard(2), "b_fc": Shard(1), "w_out": Shard(1),
    },
    "vit": {
        "w_qkv": Shard(2), "b_qkv": Shard(1), "w_proj": Shard(1),
        "w_fc": Shard(2), "b_fc": Shard(1), "w_out": Shard(1),
    },
}

_FAMILY_TP_TOP = {
    "llama": {"embed": Shard(0), "lm_head": Shard(1)},
    "gemma3": {"embed": Shard(0), "lm_head": Shard(1)},
    "gpt2": {"wte": Shard(0)},
    "bert": {},
    "siglip": {},
    "vit": {"head_w": Shard(1), "head_b": Shard(0)},
}

#: q | k | v fused on the output axis: split into thirds, each third by
#: head groups, so a process's slice is its heads' q, k and v
_FUSED_QKV = ("w_attn", "b_attn", "w_qkv", "b_qkv")


def family_param_specs(family: str, params):
    """The placement tree (tensor parallelism over ``model``) for a
    family's parameter layout; leaves not in the family's table are
    replicated."""
    layer_tbl = _FAMILY_TP_LAYERS[family]
    top_tbl = _FAMILY_TP_TOP.get(family, {})

    def map_tree(tree, tbl):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = map_tree(v, layer_tbl if k == "layers" else tbl)
            else:
                out[k] = tbl.get(k, R)
        return out

    return map_tree(params, top_tbl)


def _scale_placement(p, placement):
    """A quantized leaf's scale follows its codes, except on an axis where
    the scale has size 1 (the per-output-channel scale under a row split),
    which stays replicated."""
    if isinstance(placement, Shard) and p.scale.shape[placement.dim] == 1:
        return R
    return placement


def family_param_shardings(family: str, params, mesh: DeviceMesh):
    """The :class:`NamedSharding` tree of a family's params on ``mesh``
    (see :func:`family_param_specs`). A ``QuantizedTensor`` leaf gets a
    ``QuantizedTensor`` of two shardings: its codes' and its scale's."""
    specs = family_param_specs(family, params)

    def one(p, s):
        if isinstance(p, dict):
            return {k: one(p[k], s[k]) for k in p}
        if isinstance(p, QuantizedTensor):
            return QuantizedTensor(NamedSharding(mesh, s),
                                   NamedSharding(mesh, _scale_placement(p, s)),
                                   p.bits, p.block)
        return NamedSharding(mesh, s)

    return one(params, specs)


def llama_param_shardings(mesh: DeviceMesh):
    """Shardings for the Llama-family tree (``models/llama.py`` layout):
    q/k/v, gate and up column-parallel, o and down row-parallel, norms
    replicated, embedding and lm_head split on the vocabulary."""
    return _named(mesh, {
        "embed": Shard(0), "final_norm": R, "lm_head": Shard(1),
        "layers": dict(_FAMILY_TP_LAYERS["llama"], ln1=R, ln2=R,
                       q_norm=R, k_norm=R),
    })


def mixtral_param_shardings(mesh: DeviceMesh):
    """Shardings for the Mixtral tree (``models/mixtral.py`` layout): expert
    parallelism, the expert axis (axis 1 of ``[L, E, in, out]``) split over
    ``model``; the router replicated; attention sharded as Llama's."""
    return _named(mesh, {
        "embed": Shard(0), "final_norm": R, "lm_head": Shard(1),
        "layers": {
            "ln1": R, "ln2": R,
            "wq": Shard(2), "wk": Shard(2), "wv": Shard(2), "wo": Shard(1),
            "w_router": R, "wg": Shard(1), "wu": Shard(1), "wd": Shard(1),
        },
    })


def model_param_shardings(model, mesh: DeviceMesh):
    """The shardings of an ``AttributionModel``'s params on ``mesh``: the
    tensor-parallel table its family names in ``registry.FAMILIES``
    (``"tp"``); Mixtral's is expert parallelism."""
    from lxt_tpu_torch.models.registry import FAMILIES
    if "tp" not in FAMILIES[model.family]:
        raise NotImplementedError(f"family {model.family!r} has no "
                                  f"tensor-parallel table")
    table = FAMILIES[model.family]["tp"]
    if table == "mixtral":
        return mixtral_param_shardings(mesh)
    return family_param_shardings(table, model.params, mesh)


def _prune_to(params, shardings):
    """The sharding entries of the keys ``params`` has (configs differ in
    optional leaves); a leaf the tree does not name is replicated."""
    if isinstance(params, dict):
        return {k: _prune_to(v, shardings.get(k) if isinstance(shardings, dict)
                             else None) for k, v in params.items()}
    return shardings


def _coord(sharding):
    """This process's index along the sharding's mesh dimension, and the
    dimension's size."""
    g = sharding.mesh.get_group(sharding.dim)
    return dist.get_rank(g), dist.get_world_size(g)


def _slice(t, dim, r, n, what):
    if t.shape[dim] % n:
        raise ValueError(f"{what}: axis {dim} of {t.shape[dim]} does not "
                         f"divide over {n} processes")
    k = t.shape[dim] // n
    # a copy, never a view: a view would keep the whole leaf's storage alive
    return t.narrow(dim, r * k, k).clone(memory_format=torch.contiguous_format)


def _local(name, leaf, sharding):
    """This process's slice of one leaf."""
    if sharding is None:
        return leaf
    if isinstance(leaf, QuantizedTensor):
        return _local_quantized(name, leaf, sharding)
    p = sharding.placement
    if not isinstance(p, Shard):
        return leaf
    r, n = _coord(sharding)
    if name in _FUSED_QKV:
        return torch.cat([_slice(part, p.dim, r, n, name)
                          for part in leaf.chunk(3, dim=p.dim)], dim=p.dim)
    return _slice(leaf, p.dim, r, n, name)


def _local_quantized(name, qt, sharding):
    """Local codes and scales. An input-axis split keeps int4's even/odd
    pairs together (a contiguous slice of packed rows is a contiguous
    slice of rows); NF4's half-split packing is unpacked, sliced and packed
    again, and its split must fall on the absmax blocks."""
    if not isinstance(sharding, QuantizedTensor):
        sharding = QuantizedTensor(sharding, NamedSharding(
            sharding.mesh, _scale_placement(qt, sharding.placement),
            sharding.dim), qt.bits, qt.block)
    pq, ps = sharding.q.placement, sharding.scale.placement
    q, scale = qt.q, qt.scale
    if isinstance(pq, Shard):
        r, n = _coord(sharding.q)
        if qt.bits == "nf4" and pq.dim == q.dim() - 2:
            K = 2 * q.shape[pq.dim]
            if K % (n * qt.block):
                raise ValueError(
                    f"{name}: an NF4 split of {K} input rows over {n} "
                    f"processes cuts its absmax blocks of {qt.block} rows "
                    f"(each process needs whole blocks; quantize with a "
                    f"block dividing {K // n}, or replicate the leaf)")
            codes = torch.cat([q & 0xF, q >> 4], dim=pq.dim)
            local = _slice(codes, pq.dim, r, n, name)
            half = local.shape[pq.dim] // 2
            q = local.narrow(pq.dim, 0, half) | (local.narrow(pq.dim, half, half) << 4)
        else:
            q = _slice(q, pq.dim, r, n, name)
    if isinstance(ps, Shard):
        r, n = _coord(sharding.scale)
        scale = _slice(scale, ps.dim, r, n, name)
    return QuantizedTensor(q.contiguous(), scale, qt.bits, qt.block)


def shard_params(params, shardings):
    """Each process's slices of ``params`` under ``shardings`` (a
    :class:`NamedSharding` tree: :func:`family_param_shardings`,
    :func:`llama_param_shardings`, ...). Returns ``(local params,
    shardings)``, the shardings pruned to the keys of ``params``."""
    shardings = _prune_to(params, shardings)

    def walk(tree, sh):
        return {k: walk(v, sh[k]) if isinstance(v, dict) else _local(k, v, sh[k])
                for k, v in tree.items()}

    return walk(params, shardings), shardings


def model_group(shardings):
    """The group of the mesh dimension a sharding tree splits over (that of
    its first sharded leaf; None when nothing is split)."""
    if isinstance(shardings, dict):
        for v in shardings.values():
            g = model_group(v)
            if g is not None:
                return g
        return None
    if isinstance(shardings, QuantizedTensor):
        shardings = shardings.q
    if isinstance(shardings, NamedSharding) and isinstance(shardings.placement, Shard):
        return shardings.mesh.get_group(shardings.dim)
    return None


@contextlib.contextmanager
def model_parallel(mesh: DeviceMesh):
    """Run the block with the mesh's ``model`` group as the tensor-parallel
    group: forwards called inside it take sharded params (for the entry
    points that do not enter it themselves)."""
    with tensor_parallel.using(mesh.get_group("model")):
        yield


def data_rows(mesh, t):
    """This ``data`` rank's rows of ``t`` (a tensor, an array or a list; what
    :func:`attribute_sharded` hands its target: per-example arguments a target closes over take the
    same rows)."""
    g = mesh.get_group("data")
    n, r = dist.get_world_size(g), dist.get_rank(g)
    if len(t) % n:
        raise ValueError(f"batch {len(t)} must divide over the {n} "
                         f"processes of the data dimension")
    k = len(t) // n
    return t[r * k:(r + 1) * k]


def gather_rows(mesh, t):
    """The rows of every ``data`` rank, concatenated (the inverse of the
    split :func:`attribute_sharded` makes)."""
    g = mesh.get_group("data")
    if dist.get_world_size(g) == 1:
        return t
    return tensor_parallel.all_gather(t, g, dim=0)


def attribute_sharded(target_fn, mesh: DeviceMesh):
    """A batched attribution step with the batch split over ``data``.
    ``target_fn(embeds) -> scalar`` consumes this process's rows of the
    embeds (under tensor parallelism, with the ``model`` group active: its
    params are the local shards). Every process calls ``step(embeds)``
    with the whole ``[B, ...]`` embeds; B must divide over ``data``.
    Returns ``(value, relevance [B, ...])`` on every process: the sum of
    the per-rank targets (``select_logit`` sums per-example logits, whose
    gradients are disjoint) and the gathered maps. Under
    ``ops.check.conservation_check`` and ``nan_check`` the result is that
    of one process running the whole batch (``ops/check.py``): every rule
    site sums over the world, and a NaN raises the same site on every
    process."""
    from lxt_tpu_torch.attribution import input_relevance

    def step(embeds):
        g = mesh.get_group("data")
        with model_parallel(mesh), check.data_parallel(g):
            value, rel = input_relevance(target_fn, data_rows(mesh, embeds))
        if dist.get_world_size(g) > 1:
            value = tensor_parallel.all_reduce(value, g)
        return value, gather_rows(mesh, rel)

    return step
