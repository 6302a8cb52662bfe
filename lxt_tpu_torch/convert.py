"""Parameter conversion from ``lxt_tpu``'s layout.

``lxt_tpu`` parameters are dicts of arrays (per-layer weights stacked
``[L, ...]``, linear weights ``[in, out]``), which is the layout of
``lxt_tpu_torch`` too; this turns their numpy leaves into tensors.
"""

import numpy as np
import torch


def params_from_numpy(tree, device="cpu", dtype=torch.float32):
    """Map a nested dict of numpy arrays (e.g. ``lxt_tpu`` parameters with
    leaves converted by ``np.asarray``) to tensors on ``device`` in
    ``dtype``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    arr = np.asarray(tree, dtype=np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device,
                                                          dtype=dtype)
