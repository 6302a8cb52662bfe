"""Multi-process attribution (counterpart of ``lxt_tpu/parallel``): meshes
and parameter sharding with data, tensor and expert parallelism
(``mesh.py``), pipeline parallelism (``pipeline_parallel.py``) and the
sequence-parallel ring (``ring.py``). Every process of a
``torch.distributed`` group calls these with the same arguments; the
collectives are written out (``ops/tensor_parallel.py``), not inserted by a
compiler."""

from lxt_tpu_torch.parallel.mesh import (
    attribute_sharded,
    family_param_shardings,
    family_param_specs,
    llama_param_shardings,
    make_mesh,
    mixtral_param_shardings,
    model_param_shardings,
    shard_params,
)
from lxt_tpu_torch.parallel.pipeline_parallel import (
    attribute_pipeline_parallel,
    make_pipeline_driver,
    pipeline_param_shardings,
)
from lxt_tpu_torch.parallel.ring import (attribute_sequence_parallel,
                                         ring_flash_attention)

__all__ = [
    "make_mesh", "llama_param_shardings", "mixtral_param_shardings",
    "family_param_specs", "family_param_shardings", "model_param_shardings",
    "shard_params", "attribute_sharded",
    "ring_flash_attention", "attribute_sequence_parallel",
    "make_pipeline_driver", "pipeline_param_shardings",
    "attribute_pipeline_parallel",
]
