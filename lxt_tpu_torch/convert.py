"""Parameter conversion from ``lxt_tpu``'s layout.

``lxt_tpu`` parameters are dicts of arrays (per-layer weights stacked
``[L, ...]``, linear weights ``[in, out]``), which is the layout of
``lxt_tpu_torch`` too; this turns their numpy leaves into tensors.
"""

import numpy as np
import torch

from lxt_tpu_torch.ops.quant import QuantizedTensor


def _is_quantized(leaf):
    """``lxt_tpu``'s ``QuantizedTensor`` (or the port's), duck-typed: the
    port imports nothing of ``lxt_tpu``."""
    return all(hasattr(leaf, a) for a in ("q", "scale", "bits", "block"))


def params_from_numpy(tree, device="cuda", dtype=torch.float32):
    """Map a nested dict of numpy arrays (e.g. ``lxt_tpu`` parameters with
    leaves converted by ``np.asarray``) to tensors on ``device`` in
    ``dtype``. Quantized leaves become :class:`QuantizedTensor`s whose codes
    keep their integer dtype and whose scales stay float32."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if _is_quantized(tree):
        q = torch.from_numpy(np.ascontiguousarray(np.asarray(tree.q)))
        scale = torch.from_numpy(np.ascontiguousarray(
            np.asarray(tree.scale, dtype=np.float32)))
        return QuantizedTensor(q.to(device), scale.to(device), tree.bits,
                               tree.block)
    arr = np.asarray(tree, dtype=np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device,
                                                          dtype=dtype)
