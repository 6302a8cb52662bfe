"""Shared building blocks for the model zoo (counterpart of
``lxt_tpu/models/common.py``).

- Parameters are plain dicts of tensors; per-layer weights are stacked on a
  leading ``[L, ...]`` axis as in ``lxt_tpu``, and the layer driver is a
  Python loop over views of that axis.
- Linear weights are stored ``[in, out]``, so the forward is ``x @ w``.
- Rotary tables are computed in float32 from integer positions, with the
  inverse frequencies in float64 on the host.
"""

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from lxt_tpu_torch import tracing
from lxt_tpu_torch.ops import tensor_parallel
from lxt_tpu_torch.ops.quant import QuantizedTensor, quantize

ACTIVATIONS: Dict[str, Callable] = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation (HF 'gelu_pytorch_tanh')
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "tanh": torch.tanh,
    # OpenCLIP QuickGELU: x * sigmoid(1.702 x)
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}


def _inv_freq(head_dim, theta, scaling, rope_scaling, seq_len=None):
    """Host-side (float64) inverse frequencies + attention scale factor,
    with optional HF-style rope scaling (``None``, ``("linear", f)``,
    ``("llama3", ...)``, ``("longrope", ...)`` or ``("yarn", ...)``; see
    ``lxt_tpu.models.common._inv_freq``, of which this is a copy).
    Returns (inv_freq [head_dim//2] float32 numpy, attention_factor)."""
    half = np.arange(0, head_dim, 2, dtype=np.float64)
    inv = 1.0 / (theta ** (half / head_dim))
    attn_factor = 1.0
    if rope_scaling is not None:
        kind = rope_scaling[0]
        if kind == "linear":
            inv = inv / rope_scaling[1]
        elif kind == "llama3":
            _, factor, low_ff, high_ff, old_ctx = rope_scaling
            wavelen = 2 * np.pi / inv
            low_wl = old_ctx / low_ff
            high_wl = old_ctx / high_ff
            smooth = (old_ctx / wavelen - low_ff) / (high_ff - low_ff)
            inv_scaled = np.where(wavelen > low_wl, inv / factor, inv)
            smoothed = (1 - smooth) * inv / factor + smooth * inv
            is_mid = (wavelen <= low_wl) & (wavelen >= high_wl)
            inv = np.where(is_mid, smoothed, inv_scaled)
        elif kind == "longrope":
            _, short, long, old_ctx, max_ctx, af = rope_scaling
            ext = np.asarray(
                long if (seq_len or 0) > old_ctx else short, np.float64)
            if ext.shape != half.shape:
                raise ValueError(
                    f"longrope factor length {ext.shape[0]} != head_dim//2 "
                    f"({half.shape[0]}) — HF ships one factor per rotary "
                    f"frequency pair")
            inv = 1.0 / (ext * theta ** (half / head_dim))
            factor = max_ctx / old_ctx
            if af is not None:
                attn_factor = af
            elif factor > 1:
                attn_factor = math.sqrt(1 + math.log(factor) / math.log(old_ctx))
        elif kind == "yarn":
            _, factor, beta_fast, beta_slow, old_ctx, af = rope_scaling

            def correction_dim(n_rot):
                return (head_dim * math.log(old_ctx / (n_rot * 2 * math.pi))
                        ) / (2 * math.log(theta))
            low = max(math.floor(correction_dim(beta_fast)), 0)
            high = min(math.ceil(correction_dim(beta_slow)), head_dim - 1)
            if low == high:
                high += 0.001
            ramp = np.clip((np.arange(head_dim // 2, dtype=np.float64) - low)
                           / (high - low), 0.0, 1.0)
            extrap_w = 1.0 - ramp
            inv = (inv / factor) * (1 - extrap_w) + inv * extrap_w
            attn_factor = af if af is not None else 0.1 * math.log(factor) + 1.0
        else:
            raise ValueError(f"unsupported rope scaling: {kind}")
    return (inv / scaling).astype(np.float32), attn_factor


def rope_tables(positions, head_dim, theta=10000.0, scaling=1.0,
                rope_scaling=None, seq_len=None):
    """float32 cos/sin tables (half-frequencies duplicated, HF convention).

    ``positions``: integer tensor ``[T]`` -> tables ``[T, head_dim]``, or
    ``[B, T]`` (per-example positions for left-padded batches) ->
    ``[B, T, head_dim]``. ``seq_len``: the total sequence length, used by
    longrope scaling to pick the short or long factor schedule."""
    inv_freq, attn_factor = _inv_freq(head_dim, theta, scaling, rope_scaling,
                                      seq_len=seq_len)
    inv_freq = torch.from_numpy(inv_freq).to(positions.device)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    if attn_factor != 1.0:
        return torch.cos(emb) * attn_factor, torch.sin(emb) * attn_factor
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _rope_factors(cos, sin, dt):
    if cos.dim() == 3:
        return cos[:, None].to(dt), sin[:, None].to(dt)
    return cos[None, None].to(dt), sin[None, None].to(dt)


def rotate(x, cos, sin):
    """One tensor's rotation as :func:`apply_rope` does it, in x's dtype."""
    c, s = _rope_factors(cos, sin, x.dtype)
    return x * c + rotate_half(x) * s


def apply_rope(q, k, cos, sin):
    """q,k: [B, H, T, D]; cos/sin: [T, D] or [B, T, D] (padded batches).
    The rotation runs in the activation dtype (HF semantics)."""
    c, s = _rope_factors(cos, sin, q.dtype)
    return q * c + rotate_half(q) * s, k * c + rotate_half(k) * s


def padding_setup(attention_mask, kv_begin, positions, T, device):
    """Resolve ``(positions, bias, kv_begin)`` for batched prompts.

    - ``attention_mask`` ([B, T] of 1/0, any pattern): an additive bias,
      which forces the einsum attention path;
    - ``kv_begin`` ([B] int, index of each example's first real token):
      structural, so the flash kernels stay eligible.

    Positions follow the HF convention (0 at the first real token)."""
    bias = None
    if attention_mask is not None:
        if kv_begin is not None:
            raise ValueError("pass attention_mask OR kv_begin, not both")
        mask = torch.as_tensor(attention_mask, device=device)
        if positions is None:
            positions = torch.clamp(torch.cumsum(mask, dim=-1) - 1, min=0)
        # large-but-finite so fully padded query rows softmax to uniform
        # instead of NaN; they never reach real positions
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e30).float()
    elif kv_begin is not None:
        kv_begin = torch.as_tensor(kv_begin, dtype=torch.int32, device=device)
        if positions is None:
            positions = torch.clamp(
                torch.arange(T, dtype=torch.int32, device=device)[None]
                - kv_begin[:, None], min=0)
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=device)
    return positions, bias, kv_begin


def split_heads(x, n_heads, head_dim):
    """[B, T, n*d] -> [B, n, T, d] (a view; the kernels read its strides).
    ``n_heads`` is the config's count; under tensor parallelism each
    process holds its share of them (:func:`tensor_parallel.local_heads`),
    which is the local config a shard runs."""
    b, t, _ = x.shape
    n = tensor_parallel.local_heads(n_heads)
    return x.view(b, t, n, head_dim).transpose(1, 2)


def merge_heads(x):
    """[B, n, T, d] -> [B, T, n*d]"""
    b, n, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, n * d)


def run_layers(layer_fn, h, num_layers, remat, keep_hidden=False,
               driver=None):
    """The layer driver: ``h = layer_fn(h, i)`` for each depth ``i``.

    ``remat=True`` recomputes each layer in the backward (non-reentrant
    ``torch.utils.checkpoint``); ``False`` saves everything. Returns
    ``(h, hiddens)`` with ``hiddens`` the stacked ``[L, B, T, D]`` layer
    outputs when ``keep_hidden``, else None. ``driver`` (a family
    forward's ``layer_driver``, e.g. a pipeline stage's, see
    ``parallel/pipeline_parallel.py``) replaces this loop:
    ``driver(layer_fn, h, num_layers, remat) -> h``."""
    if driver is not None:
        if keep_hidden:
            raise ValueError("hidden states are not collected under a "
                             "layer_driver")
        return driver(layer_fn, h, num_layers, remat), None
    hiddens = []
    layer = _spanned(layer_fn)
    for i in range(num_layers):
        if remat:
            h = checkpoint(layer, h, i, use_reentrant=False)
        else:
            h = layer(h, i)
        if keep_hidden:
            hiddens.append(h)
    return h, (torch.stack(hiddens) if keep_hidden else None)


def _spanned(layer_fn):
    """``layer_fn`` inside the span ``lxt.layer``, or ``lxt.layer.recompute``
    when autograd's engine runs it (remat's recompute in the backward)."""
    def layer(h, i):
        recompute = torch._C._current_graph_task_id() >= 0
        with tracing.span("lxt.layer.recompute" if recompute else "lxt.layer"):
            return layer_fn(h, i)
    return layer


def layer_probes(probes):
    """Per-layer views of ``probes [L, B, T, D]`` (or None), from one
    unbind: in the backward their gradients form one stack. Indexing the
    stacked tensor layer by layer would give each layer's backward a zero
    tensor of the whole ``[L, B, T, D]`` to fill and add."""
    return None if probes is None else probes.unbind(0)


def vocab_head(composite, h, head, embed_table, site=None):
    """``h @ head`` (``embed_table.T`` when ``head`` is None: tied). Under
    tensor parallelism both are split on the vocabulary, so ``h`` takes a
    copy (its relevance is the sum over the shards) and the logits are
    gathered."""
    if head is None:
        head = embed_table.T
    return tensor_parallel.gather_last(
        composite.linear(tensor_parallel.copy(h), head, site=site))


def take_frontier(h, logits_at):
    """Slice the single position whose logits will be computed."""
    return h.narrow(1, logits_at % h.shape[1], 1)


def uniform_init(generator, shape, scale=0.02, dtype=torch.float32,
                 device=None):
    """Normal(0, scale) weights drawn directly in ``dtype`` from ``generator``
    (which must live on ``device``)."""
    w = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return w.mul_(scale)


@dataclasses.dataclass
class ModelOutputs:
    """Forward outputs. ``hidden_states`` is ``[L+1, B, T, D]`` when
    requested (embeddings + each layer output)."""
    logits: Any
    hidden_states: Optional[Any] = None


# ---------------------------------------------------------------------------
# checkpoint conversion
# ---------------------------------------------------------------------------

class HFWeights:
    """Reads an HF state dict (torch tensors, numpy arrays, or an
    ``io.LazyState`` that reads each tensor when asked) into the port's
    layout on ``device`` in ``dtype``: what every family converter shares.

    A stored tensor goes to ``device`` as it is stored (float64 read as
    float32 first, as ``lxt_tpu``'s converters read float32), and the cast
    to ``dtype``, the transposes and the splits run there, into tensors
    allocated once: no float32 copy for a 16-bit target, and no host stack
    of all layers. :meth:`stack` fills each ``[L, ...]`` leaf layer by
    layer. ``quant`` ``(bits, eligible)`` (``ops.quant.eligibility``)
    quantizes each eligible stacked leaf one slice at a time as it is
    converted, with ``lxt_tpu``'s layer-stacked arithmetic (ROADMAP F6),
    into preallocated codes and scales: bit-equal to ``quantize_params``
    after a whole conversion, with no full-precision stack on the way."""

    def __init__(self, state, dtype=torch.float32, device="cuda", prefix="",
                 quant=None):
        self.state, self.prefix, self.quant = state, prefix, quant
        self.dtype, self.device = dtype, torch.device(device)
        self._last = (None, None)   # the last tensor read: fused leaves share it

    def __contains__(self, name):
        return self.prefix + name in self.state

    def get(self, name):
        """Stored tensor ``name`` on the device, in its stored type."""
        if self._last[0] != name:
            self._last = (None, None)
            w = self.state[self.prefix + name]
            w = w.detach() if isinstance(w, torch.Tensor) else torch.from_numpy(
                np.asarray(w))
            if w.dtype not in (torch.float32, torch.bfloat16, torch.float16):
                w = w.float()
            self._last = (name, w.to(self.device))
        return self._last[1]

    def each(self, fmt, transpose=False):
        """The slice function of a stacked leaf: layer i reads
        ``fmt.format(i)``, transposed if asked."""
        if transpose:
            return lambda i: self.get(fmt.format(i)).T
        return lambda i: self.get(fmt.format(i))

    def _cast(self, w):
        out = torch.empty(w.shape, dtype=self.dtype, device=self.device)
        return out.copy_(w)

    def tensor(self, name, fn=None):
        """One leaf: ``fn(stored)`` (a transpose, a reshape) in ``dtype``."""
        w = self.get(name)
        out = self._cast(w if fn is None else fn(w))
        self._last = (None, None)
        return out

    def stack(self, n, leaves):
        """``{key: [n, ...] leaf}`` from ``leaves``: key -> ``fn(i)``, the
        device tensor of layer i, or ``(E, fn(i, e))`` for a leaf stacked
        ``[n, E, ...]`` (Mixtral's experts). Filled layer by layer."""
        out = {}
        for i in range(n):
            for key, spec in leaves.items():
                if isinstance(spec, tuple):
                    E, fn = spec
                    for e in range(E):
                        self._write(out, key, (n, E), (i, e), fn(i, e))
                else:
                    self._write(out, key, (n,), (i,), spec(i))
        self._last = (None, None)
        return out

    def _write(self, out, key, lead, idx, w):
        if key not in out:
            shape = lead + tuple(w.shape)
            out[key] = (QuantizedTensor(None, None, self.quant[0])
                        if self.quant and self.quant[1](key, shape) else
                        torch.empty(shape, dtype=self.dtype, device=self.device))
        dst = out[key]
        if isinstance(dst, torch.Tensor):
            dst[idx].copy_(w)
            return
        # the slice in dtype, then quantize's layer-stacked path; the codes
        # and scales are allocated at the first slice, whose shapes they take
        qt = quantize(self._cast(w)[None], dst.bits)
        if dst.q is None:
            dst.q = torch.empty(lead + tuple(qt.q.shape[1:]), dtype=qt.q.dtype,
                                device=self.device)
            dst.scale = torch.empty(lead + tuple(qt.scale.shape[1:]),
                                    dtype=qt.scale.dtype, device=self.device)
            dst.block = qt.block
        dst.q[idx].copy_(qt.q[0])
        dst.scale[idx].copy_(qt.scale[0])
