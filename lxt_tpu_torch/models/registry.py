"""One-call user surface: HF checkpoint or model of a Llama-family,
Gemma-3 text, Mixtral, GPT-2, BERT or DeepSeek-V3 model ->
:class:`AttributionModel`;
a torchvision ViT, OpenCLIP visual tower or SigLIP tower ->
:class:`VisionAttributionModel`; Gemma-3 image + text ->
:class:`MultimodalAttributionModel` (counterpart of
``lxt_tpu/models/registry.py``).

    import lxt_tpu_torch
    model = lxt_tpu_torch.from_pretrained("/path/to/llama-dir",
                                          quantize_bits="nf4", device="cuda")
    value, relevance = model.attribute(input_ids)
    out = model.generate(input_ids, 32)          # KV-cached decoding
    values, maps = model.attribute_response(out, input_ids.shape[1])

``from_pretrained`` reads ``config.json`` with :mod:`json` and the weights
with the native safetensors loader (:mod:`lxt_tpu_torch.io`), layer by
layer (quantizing as it converts with ``quantize_bits``): it needs
neither ``transformers`` nor ``safetensors``. bitsandbytes-serialized
4-bit and 8-bit checkpoints are ingested on the host and re-quantized in
kind.
"""

import dataclasses
import json
import types
import warnings
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from lxt_tpu_torch import composites
from lxt_tpu_torch.attribution import (_pick, input_relevance,
                                       latent_relevance,
                                       multi_site_latent_relevance,
                                       multi_site_relevance,
                                       multi_token_relevance, topk_relevance)
from lxt_tpu_torch.models import (bert, decode, deepseek_v3, gemma3, gpt2,
                                  llama, mixtral)
from lxt_tpu_torch.io import Renamed
from lxt_tpu_torch.ops.quant import QuantizedTensor, eligibility

_LLAMA = {"config": llama.LlamaConfig, "from_hf": llama.params_from_hf,
          "forward": llama.forward, "tp": "llama",
          "embed": lambda params, ids, cfg: llama.embed(params, ids),
          "prefill": decode.prefill, "decode_step": decode.decode_step}
_GEMMA3 = {"config": gemma3.Gemma3Config, "from_hf": gemma3.params_from_hf,
           "forward": gemma3.forward, "embed": gemma3.embed, "tp": "gemma3",
           "prefill": decode.gemma3_prefill,
           "decode_step": decode.gemma3_decode_step}
#: the families the port has a model for: family -> config class, HF
#: converter, forward and embedding (``embed(params, ids, cfg)``), its
#: tensor-parallel table (``tp``: see ``parallel.model_param_shardings``),
#: and for the causal LMs the KV-cached ``prefill`` and ``decode_step``
#: (``deepseek_v3`` has neither a tensor-parallel table nor decoding)
FAMILIES = {"llama": _LLAMA, "qwen2": _LLAMA, "qwen3": _LLAMA,
            "mistral": _LLAMA, "phi3": _LLAMA, "gemma3": _GEMMA3,
            "gemma3_text": _GEMMA3,
            "gpt2": {"config": gpt2.GPT2Config, "from_hf": gpt2.params_from_hf,
                     "forward": gpt2.forward, "tp": "gpt2",
                     "embed": lambda params, ids, cfg: gpt2.embed(params, ids)[0],
                     "prefill": decode.gpt2_prefill,
                     "decode_step": decode.gpt2_decode_step},
            "bert": {"config": bert.BertConfig, "from_hf": bert.params_from_hf,
                     "forward": bert.forward, "tp": "bert",
                     "embed": lambda params, ids, cfg: bert.embed(params, ids)},
            "mixtral": {"config": mixtral.MixtralConfig,
                        "from_hf": mixtral.params_from_hf,
                        "forward": mixtral.forward, "tp": "mixtral",
                        "embed": lambda params, ids, cfg: mixtral.embed(params, ids),
                        "prefill": decode.mixtral_prefill,
                        "decode_step": decode.mixtral_decode_step},
            "deepseek_v3": {"config": deepseek_v3.DeepseekV3Config,
                            "from_hf": deepseek_v3.params_from_hf,
                            "forward": deepseek_v3.forward,
                            "embed": lambda params, ids, cfg: llama.embed(params, ids)}}
SUPPORTED_FAMILIES = tuple(FAMILIES)
#: the families with no quantized path (``quantize_bits`` is refused)
NOT_QUANTIZED = ("deepseek_v3",)
#: the families whose forward returns ``[B, num_labels]`` classification
#: logits (no positions, no ``logits_at``)
CLASSIFIERS = ("bert",)

_QWEN = dict(vocab_size=151936, hidden_size=4096, intermediate_size=22016,
             num_hidden_layers=32, num_attention_heads=32,
             num_key_value_heads=32, rope_theta=10000.0, rms_norm_eps=1e-6,
             tie_word_embeddings=False, rope_scaling=None,
             use_sliding_window=False, sliding_window=4096,
             max_position_embeddings=32768, hidden_act="silu")

#: transformers' defaults, per ``model_type``, for every key that
#: ``LlamaConfig.from_hf`` reads (and ``hidden_act``): what ``AutoConfig``
#: gives for a key that ``config.json`` leaves out
_HF_DEFAULTS = {
    "llama": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                  num_hidden_layers=32, num_attention_heads=32,
                  num_key_value_heads=None, head_dim=None, rope_theta=10000.0,
                  rms_norm_eps=1e-6, tie_word_embeddings=False,
                  rope_scaling=None, max_position_embeddings=2048,
                  hidden_act="silu"),
    "qwen2": _QWEN,
    "qwen3": dict(_QWEN, head_dim=128),
    "mistral": dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    head_dim=None, rope_theta=10000.0, rms_norm_eps=1e-6,
                    tie_word_embeddings=False, sliding_window=4096,
                    max_position_embeddings=131072, hidden_act="silu"),
    "phi3": dict(vocab_size=32064, hidden_size=3072, intermediate_size=8192,
                 num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=None, rope_theta=10000.0,
                 rms_norm_eps=1e-5, tie_word_embeddings=False,
                 rope_scaling=None, sliding_window=None,
                 max_position_embeddings=4096,
                 original_max_position_embeddings=4096, hidden_act="silu"),
    "gemma3_text": dict(vocab_size=262208, hidden_size=2304,
                        intermediate_size=9216, num_hidden_layers=26,
                        num_attention_heads=8, num_key_value_heads=4,
                        head_dim=256, hidden_activation="gelu_pytorch_tanh",
                        rms_norm_eps=1e-6,
                        tie_word_embeddings=True, rope_theta=1e6,
                        query_pre_attn_scalar=256, sliding_window=4096,
                        layer_types=None, rope_scaling=None,
                        rope_local_base_freq=10000.0),
    "mixtral": dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    rope_theta=1e6, rms_norm_eps=1e-5,
                    tie_word_embeddings=False, num_local_experts=8,
                    num_experts_per_tok=2, sliding_window=None,
                    hidden_act="silu"),
    "gpt2": dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
                 n_head=12, layer_norm_epsilon=1e-5,
                 activation_function="gelu_new",
                 scale_attn_by_inverse_layer_idx=False,
                 reorder_and_upcast_attn=False, tie_word_embeddings=True),
    "bert": dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 layer_norm_eps=1e-12, hidden_act="gelu", num_labels=2),
    "siglip_vision_model": dict(hidden_size=768, intermediate_size=3072,
                                num_hidden_layers=12, num_attention_heads=12,
                                num_channels=3, image_size=224, patch_size=16,
                                hidden_act="gelu_pytorch_tanh",
                                layer_norm_eps=1e-6),
    "deepseek_v3": dict(vocab_size=129280, hidden_size=7168,
                        intermediate_size=18432, moe_intermediate_size=2048,
                        num_hidden_layers=61, num_attention_heads=128,
                        num_key_value_heads=128, n_shared_experts=1,
                        n_routed_experts=256, routed_scaling_factor=2.5,
                        kv_lora_rank=512, q_lora_rank=1536,
                        qk_rope_head_dim=64, v_head_dim=128,
                        qk_nope_head_dim=128, n_group=8, topk_group=4,
                        num_experts_per_tok=8, first_k_dense_replace=3,
                        norm_topk_prob=True, hidden_act="silu",
                        max_position_embeddings=4096, rms_norm_eps=1e-6,
                        tie_word_embeddings=False, rope_theta=10000.0,
                        rope_scaling=None, rope_interleave=True,
                        attention_bias=False),
    # the image + text wrapper's own keys (its text and vision configs are
    # filled as gemma3_text and siglip_vision_model)
    "gemma3": dict(mm_tokens_per_image=256, boi_token_index=255999,
                   eoi_token_index=256000, image_token_index=262144),
}


def read_hf_config(model_dir):
    """``config.json`` of a checkpoint directory as an attribute namespace,
    with the keys it leaves out filled as transformers' config class for
    its ``model_type`` fills them (a ``model_type`` outside the table is
    taken as written). A ``gemma3`` (image + text) config keeps its
    ``text_config`` and ``vision_config``, filled the same way, as nested
    namespaces."""
    return _filled(json.loads((Path(model_dir) / "config.json").read_text()))


def _filled(raw):
    mt = raw.get("model_type")
    if mt == "gemma3":
        text = dict(raw.get("text_config") or {}, model_type="gemma3_text")
        vision = dict(raw.get("vision_config") or {},
                      model_type="siglip_vision_model")
        return types.SimpleNamespace(**{
            **_HF_DEFAULTS[mt], **raw, "text_config": _filled(text),
            "vision_config": _filled(vision)})
    if mt not in _HF_DEFAULTS:
        return types.SimpleNamespace(**raw)
    cfg = dict(_HF_DEFAULTS[mt])
    cfg.update(raw)
    if "num_key_value_heads" in cfg and cfg["num_key_value_heads"] is None:
        cfg["num_key_value_heads"] = cfg["num_attention_heads"]
    if mt == "llama" and cfg["head_dim"] is None:
        cfg["head_dim"] = cfg["hidden_size"] // cfg["num_attention_heads"]
    if mt in ("qwen2", "qwen3") and not cfg["use_sliding_window"]:
        cfg["sliding_window"] = None
    rs = cfg.get("rope_scaling")
    if mt == "phi3" and rs and rs.get("type") in ("su", "yarn"):
        cfg["rope_scaling"] = dict(rs, type="longrope")
    if mt == "bert" and raw.get("id2label"):
        # transformers derives num_labels from the label map it saves
        cfg["num_labels"] = len(raw["id2label"])
    if mt == "gemma3_text" and cfg["layer_types"] is None:
        # configs on the Hub may carry only the older integer pattern
        pattern = cfg.get("sliding_window_pattern", 6)
        cfg["layer_types"] = [
            "sliding_attention" if (i + 1) % pattern else "full_attention"
            for i in range(cfg["num_hidden_layers"])]
    return types.SimpleNamespace(**cfg)


def _tensor(x, device):
    """``x`` (a tensor on any device, an array or a list) as a tensor on
    ``device``."""
    return (x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))).to(device)


def _padding_args(family, kv_begin, attention_mask, kv_end, device):
    """Validated padding keywords for a batch of variable-length prompts.

    Causal families are left-padded (the serving layout): ``kv_begin [B]``
    is each row's first real index (structural: the flash kernels stay
    eligible), or an arbitrary ``attention_mask [B, T]`` (an additive
    bias). BERT is right-padded (the HF convention): ``kv_end [B]`` is each
    row's count of real tokens, or ``attention_mask``."""
    kw = {}
    if family in CLASSIFIERS:
        if kv_begin is not None:
            raise ValueError(
                "BERT batches are right-padded (HF convention): pass "
                "kv_end=[#real tokens per row] or attention_mask, "
                "not kv_begin")
        if kv_end is not None:
            kw["kv_end"] = _tensor(kv_end, device).to(torch.int32)
    else:
        if kv_end is not None:
            raise ValueError(
                "kv_end is the BERT (right-padded) convention; causal "
                "families take kv_begin=[first real index per row] or "
                "attention_mask")
        if kv_begin is not None:
            kw["kv_begin"] = _tensor(kv_begin, device).to(torch.int32)
    if attention_mask is not None:
        if kw:
            raise ValueError("pass attention_mask OR kv_begin/kv_end, not both")
        kw["attention_mask"] = _tensor(attention_mask, device)
    return kw


def _fill_after_eos(buf, T0, eos_token_id):
    """The positions after each row's first ``eos_token_id`` become eos: the
    steps write them so, and this covers the slots that an early stop
    never reached."""
    gen = buf[:, T0:]
    is_eos = (gen == eos_token_id).to(torch.int32)
    gen[(torch.cumsum(is_eos, dim=1) - is_eos) > 0] = eos_token_id
    return buf


def _greedy_update(buf, done, logits, pos, eos_token_id, generator=None,
                   temperature: float = 0.0, top_k=None):
    """One decode step's bookkeeping: the next token from the frontier
    logits ``[B, 1, V]`` (argmax, or with ``generator``, one or a list of
    one a row, a temperature / top-k draw), eos latched on rows that already emitted it, written into
    ``buf`` at ``pos`` in place. Returns the updated ``done``."""
    row = logits[:, 0, :]
    if generator is None:
        nxt = row.argmax(-1)
    else:
        logt = row.float() / temperature
        if top_k is not None:
            kth = torch.topk(logt, int(top_k), dim=-1).values[:, -1:]
            logt = logt.masked_fill(logt < kth, float("-inf"))
        probs = torch.softmax(logt, -1)
        if isinstance(generator, torch.Generator):
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:   # one generator a row
            nxt = torch.cat([torch.multinomial(probs[i:i + 1], 1, generator=g)
                             for i, g in enumerate(generator)])[:, 0]
    nxt = nxt.to(buf.dtype)
    if eos_token_id is not None:
        nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
        done = done | (nxt == eos_token_id)
    buf[:, pos] = nxt
    return done


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _decode(table, params, cfg, comp, ids0, prefix, embed, max_new_tokens,
            eos_token_id, kv_begin, use_cache, sample):
    """The decode loop of ``generate``: ``prefix [B, T0, D]`` embeds the
    prompt ``ids0`` (for an image + text model, with the image tokens
    merged in), ``embed(ids)`` embeds generated tokens. KV-cached: the
    family's prefill over ``prefix``, then one ``decode_step`` a token;
    otherwise the full forward over prefix + the embedded tail per token.
    Stops once every row has emitted ``eos_token_id`` (one host read of the
    ``done`` flags a step). ``sample``: ``_greedy_update``'s sampling
    keywords."""
    N = int(max_new_tokens)
    if N < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {N}")
    B, T0 = ids0.shape
    buf = torch.cat([ids0, ids0.new_zeros((B, N))], dim=1)
    done = torch.zeros(B, dtype=torch.bool, device=ids0.device)

    def pick(logits, pos, done):
        return _greedy_update(buf, done, logits, pos, eos_token_id, **sample)

    def finished():
        if eos_token_id is None:
            return False
        decode.counters["done_reads"] += 1
        return bool(done.all())

    with torch.no_grad():
        if use_cache and "prefill" in table:
            logits, caches = table["prefill"](params, cfg, prefix, T0 + N,
                                              kv_begin=kv_begin, composite=comp)
            done = pick(logits, T0, done)
            for k in range(1, N):
                if finished():
                    break
                logits, caches = table["decode_step"](
                    params, cfg, embed(buf[:, T0 + k - 1:T0 + k]), caches,
                    T0 + k - 1, kv_begin=kv_begin, composite=comp)
                done = pick(logits, T0 + k, done)
        else:
            for k in range(N):
                if finished():
                    break
                e = torch.cat([prefix, embed(buf[:, T0:])], dim=1)
                logits = table["forward"](
                    params, cfg, e, comp, kv_begin=kv_begin, remat=False,
                    logits_at=T0 + k - 1).logits
                done = pick(logits, T0 + k, done)
    return buf if eos_token_id is None else _fill_after_eos(buf, T0, eos_token_id)


def _response_sites(ids, response_start):
    """Map k of a response explains ``ids[:, response_start + k]`` at the
    position that predicted it: ``(positions [K], tokens [K, B])``."""
    T = ids.shape[1]
    if not 1 <= response_start < T:
        raise ValueError(f"response_start must be in [1, T), got "
                         f"{response_start} for T={T}")
    return (list(range(response_start - 1, T - 1)), ids[:, response_start:].T)


_CHECKS = ("nan", "conservation", "conservation+nan")


def _with_check(check, run):
    """``run()`` under the sanitizer ``check`` names (see
    :mod:`lxt_tpu_torch.ops.check`): None runs it as it is; ``'nan'``
    records at every rule backward whether its relevance is finite and
    reads the record to the host once after ``run`` returns, raising
    ``RuntimeError`` on the first non-finite site; ``'conservation'``
    (optionally ``'conservation+nan'``) runs in uniform-redistribution
    mode. The context is held around the forward and the backward, so a
    layer recomputed in the backward (``remat``) keeps the mode."""
    if check is None:
        return run()
    if check not in _CHECKS:
        raise ValueError(
            f"check must be one of {_CHECKS} or None, got {check!r}")
    from lxt_tpu_torch.ops import check as ck
    ctx = (ck.nan_check() if check == "nan"
           else ck.conservation_check(raise_on_nan="nan" in check))
    with ctx:
        return ck.checked(run)()


@dataclasses.dataclass
class AttributionModel:
    """A converted model of one of :data:`FAMILIES` plus its attribution
    entry points. PyTorch runs eagerly, so there is no program cache and no
    ``jit=``. ``check=`` on :meth:`attribute`, :meth:`attribute_multi`,
    :meth:`attribute_topk` and :meth:`attribute_response` runs the call
    under a sanitizer (:func:`_with_check`): the mode is captured when each
    rule's forward runs, and ``'nan'`` reads the device once per call.

    ``remat`` is the family forward's keyword, which every entry point
    passes: True (the default) recomputes each layer in the backward, and
    with it in every pull of the multi-target methods; False keeps each
    layer's activations instead (the main path's setting, where they fit)."""

    family: str
    cfg: Any
    params: Any
    composite: composites.Composite
    remat: bool = True

    @property
    def device(self):
        """The parameters' device: that of the first leaf, whatever the
        family names its embedding."""
        leaf = _first_leaf(self.params)
        return leaf.q.device if isinstance(leaf, QuantizedTensor) else leaf.device

    def embed(self, input_ids):
        ids = _tensor(input_ids, self.device)
        return FAMILIES[self.family]["embed"](self.params, ids.long(), self.cfg)

    def _forward(self, composite=None, kv_begin=None, attention_mask=None,
                 kv_end=None, **kw):
        """``run(embeds, **more) -> ModelOutputs``: the family forward under
        ``composite`` (default: the model's) with this model's weights and
        ``remat``, the validated padding keywords and ``kw``."""
        forward = FAMILIES[self.family]["forward"]
        params, cfg = self.params, self.cfg
        composite = composites.resolve(composite or self.composite)
        kw.update(_padding_args(self.family, kv_begin, attention_mask, kv_end,
                                self.device), remat=self.remat)
        return lambda e, **more: forward(params, cfg, e, composite, **kw, **more)

    def _at(self, position):
        """The forward keywords that compute the logits at ``position``
        alone (none for a classifier, whose logits have no positions)."""
        return {} if self.family in CLASSIFIERS else {"logits_at": position}

    def _row(self, run, position):
        """``row(embeds) -> [B, V]``: the logits at ``position``, or a
        classifier's ``[B, num_labels]``."""
        def row(e):
            logits = run(e, **self._at(position)).logits
            return logits if logits.dim() == 2 else logits[:, -1, :]
        return row

    def canonize(self, *canonizers):
        """A copy with ``canonizers`` applied to (params, cfg): the
        reference's ``Composite(canonizers=...)`` hook as a pure
        pre-transform (see :mod:`lxt_tpu_torch.canonizers`)."""
        from lxt_tpu_torch.canonizers import apply_canonizers
        params, cfg = apply_canonizers(self.params, self.cfg, self.family,
                                       canonizers)
        return dataclasses.replace(self, params=params, cfg=cfg)

    def logits(self, input_ids, composite=None):
        run = self._forward(composite)
        with torch.no_grad():
            return run(self.embed(input_ids)).logits

    def attribute(self, input_ids, *, target: Optional[Callable] = None,
                  position: int = -1, token=None, composite=None,
                  kv_begin=None, attention_mask=None, kv_end=None,
                  check=None):
        """Per-token input relevance, one forward and one backward.

        Default target: the argmax logit at ``position`` (only that row's
        logits are computed), or the ``token [B]`` ids there; for a
        classifier (BERT), the argmax label's logit summed over the batch,
        or the ``token`` labels'. ``target`` maps the full logits to a
        scalar instead. Returns ``(target_value, relevance [B, T])``.
        ``kv_begin`` / ``attention_mask`` mark left padding, ``kv_end`` /
        ``attention_mask`` BERT's right padding (see
        :func:`_padding_args`). ``check``: None, ``'nan'``,
        ``'conservation'`` or ``'conservation+nan'`` (:func:`_with_check`;
        the conservation mode redistributes gradients here, so read its
        map with :func:`lxt_tpu_torch.ops.check.conservation_error`'s
        caveats)."""
        run = self._forward(composite, kv_begin, attention_mask, kv_end)
        row = self._row(run, position)
        tok = None if token is None else _tensor(token, self.device)

        def tgt(e):
            if target is not None:
                return target(run(e).logits)
            if tok is None:
                return row(e).max(dim=-1).values.sum()
            return _pick(row(e), tok).sum()

        embeds = self.embed(input_ids)
        return _with_check(check, lambda: input_relevance(tgt, embeds))

    def attribute_latent(self, input_ids, *, target: Optional[Callable] = None,
                         position: int = -1, composite=None):
        """Input relevance and per-layer latent relevance in ONE backward
        (reference docs/latent-feature-attribution-efficient.rst). Returns
        ``(value, input_rel [B, T], latent_rel [L, B, T, D])``; the default
        target (as :meth:`attribute`'s) computes only the row at
        ``position``."""
        run = self._forward(composite, output_hidden_states=True)
        embeds = self.embed(input_ids)

        def forward_with_probes(e, probes):
            if target is not None:
                out = run(e, probes=probes)
                return target(out.logits), out.hidden_states
            out = run(e, probes=probes, **self._at(position))
            logits = out.logits if out.logits.dim() == 2 else out.logits[:, -1]
            return logits.max(dim=-1).values.sum(), out.hidden_states

        return latent_relevance(forward_with_probes, embeds,
                                (self.cfg.num_layers, *embeds.shape))

    def attribute_multi(self, input_ids, tokens, *, position: int = -1,
                        composite=None, kv_begin=None, attention_mask=None,
                        kv_end=None, check=None, via: str = "scan"):
        """K relevance maps for K candidate tokens sharing ONE forward
        (:func:`lxt_tpu_torch.attribution.multi_token_relevance`).

        ``tokens``: ``[K]`` (the same candidates for every batch row) or
        ``[K, B]`` int ids. Returns ``(values [K, B], relevance [K, B, T])``.
        Padding and ``check`` as in :meth:`attribute`."""
        run = self._forward(composite, kv_begin, attention_mask, kv_end)
        row, embeds = self._row(run, position), self.embed(input_ids)
        tokens = _tensor(tokens, self.device)
        return _with_check(check, lambda: multi_token_relevance(
            row, embeds, tokens, via=via))

    def attribute_topk(self, input_ids, k: int = 5, *, position: int = -1,
                       composite=None, kv_begin=None, attention_mask=None,
                       kv_end=None, check=None, via: str = "scan"):
        """Explain the model's own top-k candidates at ``position`` in one
        forward: ``(tokens [K, B], values [K, B], relevance [K, B, T])``.
        Padding and ``check`` as in :meth:`attribute`."""
        run = self._forward(composite, kv_begin, attention_mask, kv_end)
        row, embeds = self._row(run, position), self.embed(input_ids)
        return _with_check(check, lambda: topk_relevance(row, embeds, k,
                                                         via=via))

    def faithfulness(self, input_ids, *, steps: int = 10, position: int = -1,
                     token=None, composite=None, kv_begin=None,
                     attention_mask=None, kv_end=None, baseline="zero",
                     generator=None):
        """A faithfulness report for this model's own attribution.

        The relevance map is :meth:`attribute`'s, its token pinned to the
        unperturbed argmax (under the same padding) so every perturbation
        step scores the same target; MoRF / LeRF / random perturbation
        curves then evaluate it. Returns the
        :func:`lxt_tpu_torch.utils.faithfulness.faithfulness_report` dict.
        ``attention_mask`` doubles as the curves' ``valid_mask``, so padding
        is never ablated. One forward and backward, then 3 × (steps + 1)
        forwards without a graph. ``generator`` (a ``torch.Generator`` on
        the model's device) draws the random order; by default a fixed seed
        keeps the control reproducible."""
        from lxt_tpu_torch.utils.faithfulness import faithfulness_report

        run = self._forward(composite, kv_begin, attention_mask, kv_end)
        embeds = self.embed(input_ids)
        valid = (None if attention_mask is None
                 else _tensor(attention_mask, self.device).bool())
        if baseline is not None and not isinstance(baseline, str):
            baseline = _tensor(baseline, self.device)
        pinned = {"token": None if token is None
                  else _tensor(token, self.device).reshape(-1)}

        rows = self._row(run, position)       # [B, vocab] at the position

        def target(e):
            row = rows(e)
            if pinned["token"] is None:
                pinned["token"] = row.detach().argmax(-1)
            return _pick(row, pinned["token"]).sum()

        _, rel = input_relevance(target, embeds)
        return faithfulness_report(
            lambda e: _pick(rows(e), pinned["token"]), embeds, rel,
            steps=steps, baseline=baseline, valid_mask=valid,
            generator=generator)

    def generate(self, input_ids, max_new_tokens: int, *,
                 eos_token_id: Optional[int] = None, kv_begin=None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 use_cache: bool = True):
        """Decode a continuation, so that a checkpoint alone can produce the
        response it then explains (``attribute_response(out,
        input_ids.shape[1])``). Greedy by default; with a ``generator`` (a
        ``torch.Generator`` on the model's device, where ``lxt_tpu`` takes a
        key) and ``temperature > 0`` (optionally ``top_k``) it samples.
        ``generator`` may be a list of one generator a row: each row then
        draws from its own, so its tokens depend neither on the other rows
        nor on how the batch is split over processes.

        KV-cached (``models/decode.py``): one prefill over the prompt, then
        one single-token step per new token; ``use_cache=False`` runs the
        full forward over the whole buffer per token instead (exact by
        causal masking: the zero-filled tail cannot reach the frontier).
        A Python loop over the steps, which stops once every row has
        emitted ``eos_token_id``: that costs one host read of the rows'
        ``done`` flags a step (``decode.counters["done_reads"]``). Rows
        that emitted eos keep emitting it. ``kv_begin [B]`` marks left
        padding. Returns ids ``[B, T0 + max_new_tokens]``."""
        if self.family in CLASSIFIERS:
            raise ValueError("generate needs a causal LM head; "
                             "BERT is an encoder")
        if "prefill" not in FAMILIES[self.family]:
            raise NotImplementedError(
                f"generate: family {self.family!r} has no KV-cached decoding "
                f"(its latent attention's cache is not ported)")
        if generator is not None and not temperature > 0:
            raise ValueError("sampling (generator=) needs temperature > 0")
        ids0 = _tensor(input_ids, self.device).long()
        if isinstance(generator, (list, tuple)) and len(generator) != len(ids0):
            raise ValueError(f"{len(generator)} generators for {len(ids0)} rows")
        kb = None if kv_begin is None else _tensor(kv_begin, self.device).to(torch.int32)
        return _decode(FAMILIES[self.family], self.params, self.cfg,
                       composites.resolve(self.composite), ids0,
                       self.embed(ids0), self.embed, max_new_tokens,
                       eos_token_id, kb, use_cache,
                       dict(generator=generator, temperature=float(temperature),
                            top_k=top_k))

    def attribute_response(self, input_ids, response_start: int, *,
                           composite=None, kv_begin=None,
                           contrastive: bool = False, check=None,
                           via: str = "scan"):
        """One relevance map per response token, all from one forward.

        ``input_ids [B, T]`` is prompt + continuation and ``response_start``
        the first continuation position. Map k explains the logit of
        ``input_ids[:, response_start + k]`` at ``response_start + k - 1``:
        one forward and K pulls of its graph
        (:func:`lxt_tpu_torch.attribution.multi_site_relevance`).
        ``contrastive``: each map explains the margin over the strongest
        other token; ``values`` become the margins. ``kv_begin [B]`` marks
        left padding; ``check`` as in :meth:`attribute`. Returns
        ``(values [K, B], relevance [K, B, T])``, ``K = T -
        response_start``."""
        ids = _tensor(input_ids, self.device).long()
        positions, tokens = _response_sites(ids, int(response_start))
        run, embeds = self._forward(composite, kv_begin), self.embed(ids)
        return _with_check(check, lambda: multi_site_relevance(
            lambda e: run(e).logits, embeds, positions, tokens,
            contrastive=contrastive, via=via))

    def attribute_response_latent(self, input_ids, response_start: int, *,
                                  composite=None, via: str = "scan"):
        """Per-layer relevance of every response token from one forward:
        map k's probe gradients times the shared hidden states. Returns
        ``(values [K, B], input_rel [K, B, T], latent_rel [K, L, B, T])``."""
        ids = _tensor(input_ids, self.device).long()
        positions, tokens = _response_sites(ids, int(response_start))
        run = self._forward(composite, output_hidden_states=True)
        embeds = self.embed(ids)

        def forward(e, probes):
            out = run(e, probes=probes)
            return out.logits, out.hidden_states

        return multi_site_latent_relevance(
            forward, embeds, positions, tokens,
            (self.cfg.num_layers, *embeds.shape), via=via)


def _llama_structural_match(hf_config, state_dict) -> bool:
    """True when an out-of-registry architecture is computationally Llama:
    the Llama config attributes with a SiLU gated MLP, and exactly the Llama
    parameter naming (a clone with extra layer-0 computation weights, which
    the converter would drop, does not match)."""
    needed_cfg = ("vocab_size", "hidden_size", "intermediate_size",
                  "num_hidden_layers", "num_attention_heads", "rms_norm_eps")
    if not all(hasattr(hf_config, a) for a in needed_cfg):
        return False
    act = getattr(hf_config, "hidden_act",
                  getattr(hf_config, "hidden_activation", None))
    if act not in ("silu", "swish") or state_dict is None:
        return False
    needed_keys = ("model.layers.0.self_attn.q_proj.weight",
                   "model.layers.0.self_attn.o_proj.weight",
                   "model.layers.0.mlp.gate_proj.weight",
                   "model.layers.0.mlp.up_proj.weight",
                   "model.layers.0.mlp.down_proj.weight",
                   "model.layers.0.input_layernorm.weight",
                   "model.layers.0.post_attention_layernorm.weight",
                   "model.embed_tokens.weight", "model.norm.weight")
    if not all(k in state_dict for k in needed_keys):
        return False
    allowed = {"self_attn.q_proj.weight", "self_attn.k_proj.weight",
               "self_attn.v_proj.weight", "self_attn.o_proj.weight",
               "mlp.gate_proj.weight", "mlp.up_proj.weight",
               "mlp.down_proj.weight",
               # non-computation buffer older HF versions serialize
               "self_attn.rotary_emb.inv_freq"}
    prefix = "model.layers.0."
    return all(k[len(prefix):] in allowed for k in state_dict
               if k.startswith(prefix + "self_attn.")
               or k.startswith(prefix + "mlp."))


def detect_family(hf_config, state_dict=None) -> str:
    mt = getattr(hf_config, "model_type", None)
    if mt in SUPPORTED_FAMILIES:
        return mt
    if _llama_structural_match(hf_config, state_dict):
        warnings.warn(
            f"model_type {mt!r} is not registered, but its config and "
            f"parameter naming match the Llama family exactly — converting "
            f"as 'llama'. Pass family='llama' to silence this, or a "
            f"different family to override.")
        return "llama"
    raise ValueError(
        f"{mt!r} not yet supported by lxt_tpu_torch. Supported models are: "
        f"{', '.join(SUPPORTED_FAMILIES)}. If the architecture matches one "
        f"of these computationally, pass family='<name>' to force it.")


#: the key renames of transformers' ``Gemma3ForConditionalGeneration``
#: (its ``_checkpoint_conversion_mapping``): ``save_pretrained`` writes, and
#: the checkpoints on the Hub hold, the names on the left
_GEMMA3_RENAMES = (("language_model.model.", "model.language_model."),
                   ("language_model.lm_head.", "lm_head."),
                   ("vision_tower.", "model.vision_tower."),
                   ("multi_modal_projector.", "model.multi_modal_projector."))


def _gemma3_names(state_dict):
    """A ``gemma3`` state dict with the module's current key names (a view
    that reads no tensor)."""
    names = {}
    for k in state_dict:
        new_k = k
        for old, new in _GEMMA3_RENAMES:
            if k.startswith(old):
                new_k = new + k[len(old):]
                break
        names[new_k] = k
    return Renamed(state_dict, names)


def _text_model(state_dict, hf_config):
    """A ``gemma3`` (image + text) config and state dict -> its language
    model's (``text_config``, ``model.language_model.*`` weights renamed
    to ``model.*``); the vision weights are left out."""
    prefix = "model.language_model."
    if any(k.startswith(prefix) for k in state_dict):
        names = {"model." + k[len(prefix):]: k for k in state_dict
                 if k.startswith(prefix)}
        if "lm_head.weight" in state_dict:
            names["lm_head.weight"] = "lm_head.weight"
        state_dict = Renamed(state_dict, names)
    return state_dict, hf_config.text_config


def _convert(state_dict, hf_config, composite, dtype, device, family=None,
             text_only=False, quantize_bits=None):
    """state dict (torch tensors, numpy arrays or an ``io.LazyState``) ->
    AttributionModel, or a :class:`MultimodalAttributionModel` for a
    ``gemma3`` checkpoint that holds its vision tower (unless
    ``text_only``). ``quantize_bits``: a text model's converter quantizes
    the family's eligible stacked leaves layer by layer as it converts."""
    if (getattr(hf_config, "model_type", None) == "gemma3"
            and hasattr(hf_config, "text_config")):
        state_dict = _gemma3_names(state_dict)
        if not text_only and any(k.startswith("model.vision_tower.")
                                 for k in state_dict):
            return _convert_multimodal(state_dict, hf_config, composite,
                                       dtype, device)
        state_dict, hf_config = _text_model(state_dict, hf_config)
    if family is not None:
        if family not in SUPPORTED_FAMILIES:
            raise ValueError(f"family={family!r} is not one of: "
                             f"{', '.join(SUPPORTED_FAMILIES)}")
    else:
        family = detect_family(hf_config, state_dict)
    table = FAMILIES[family]
    cfg = table["config"].from_hf(hf_config)
    quant = None if not quantize_bits else (
        quantize_bits, eligibility(quantize_bits, family=family))
    params = table["from_hf"](state_dict, cfg, dtype=dtype or torch.float32,
                              device=device, quant=quant)
    if composite is None:
        composite = composites.cp_lrp if family == "gpt2" else composites.attnlrp
    composite = composites.resolve(composite)
    return AttributionModel(family=family, cfg=cfg, params=params,
                            composite=composite)


def from_hf(hf_model, composite: composites.Composite = None, dtype=None,
            family: str = None, device="cuda", canonizers=None,
            text_only: bool = False):
    """Convert a loaded HF torch model of one of :data:`SUPPORTED_FAMILIES`
    (``.config`` and ``.state_dict()``) into an :class:`AttributionModel` on
    ``device``.
    ``family`` forces a family for an out-of-registry ``model_type`` that
    is computationally one of :data:`SUPPORTED_FAMILIES`; exact Llama clones
    are detected. The composite defaults to AttnLRP (CP-LRP for GPT-2, as
    the reference recommends). ``canonizers``: an
    optional list of ``(params, cfg, family)`` pre-transforms applied to the
    converted model (:meth:`AttributionModel.canonize`).

    Also takes the vision layouts: a config-less torchvision
    ``VisionTransformer``-shaped module or state dict (or an OpenCLIP
    visual tower) and an HF SigLIP vision model give a
    :class:`VisionAttributionModel`; a ``Gemma3ForConditionalGeneration``
    with its vision tower gives a :class:`MultimodalAttributionModel`
    (``text_only=True``: its language model alone)."""
    if not hasattr(hf_model, "config"):   # torchvision / open_clip modules
        sd = hf_model if isinstance(hf_model, dict) else hf_model.state_dict()
        if "conv_proj.weight" in sd:
            return from_torchvision(hf_model, composite=composite, dtype=dtype,
                                    device=device)
        if "conv1.weight" in sd and any(
                k.startswith("transformer.resblocks.") for k in sd):
            return from_openclip(hf_model, composite=composite, dtype=dtype,
                                 device=device)
        raise ValueError(
            "model has no .config and is not a recognized vision layout "
            "(torchvision VisionTransformer / OpenCLIP visual tower)")
    if getattr(hf_model.config, "model_type", None) in (
            "siglip", "siglip_vision_model"):
        return from_siglip(hf_model, composite=composite, dtype=dtype,
                           device=device)
    model = _convert(hf_model.state_dict(), hf_model.config, composite, dtype,
                     device, family, text_only)
    return model.canonize(*canonizers) if canonizers else model


def from_pretrained(model_dir, composite: composites.Composite = None,
                    dtype=None, quantize_bits=None, family: str = None,
                    device="cuda", canonizers=None, text_only: bool = False):
    """Load an :class:`AttributionModel` straight from an HF checkpoint
    directory onto ``device``; no torch model is instantiated.

    The checkpoint is read through an ``io.LazyState`` (the native loader;
    the 16-bit tensors in ``dtype``) and converted layer by layer, so the
    host holds about one layer's tensors at a time.

    ``quantize_bits`` (8, 4 or "nf4") quantizes the family's projections
    (``ops.quant.FAMILY_QUANTIZABLE``): each stacked one slice at a time
    while it is converted, so the device never holds a full-precision stack
    of them (an NF4 Mixtral-8x7B needs its codes and one layer's transient
    bytes, not its 93 GB of bf16), bit-equal to ``quantize_params`` after a
    whole conversion. Two cases keep that order instead (convert, then
    quantize): ``canonizers`` (as in :func:`from_hf`, applied before the
    quantization: they transform full-precision weights), and
    bitsandbytes-serialized checkpoints (keys ending in
    ``.quant_state.bitsandbytes__*`` for 4-bit, ``.SCB`` for 8-bit), which
    are read whole, dequantized on the host and, unless ``quantize_bits``
    says otherwise, re-quantized in kind ("nf4" / 8), which reproduces
    their values exactly. A ``gemma3`` checkpoint with vision weights loads
    as a :class:`MultimodalAttributionModel` (``text_only=True``: its
    language model alone)."""
    from lxt_tpu_torch.io import LazyState, load_checkpoint_state_dict
    from lxt_tpu_torch.ops.quant import ingest_bnb_state_dict, quantize_params

    hf_config = read_hf_config(model_dir)
    if quantize_bits and (family or getattr(hf_config, "model_type", None)
                          ) in NOT_QUANTIZED:
        raise ValueError(f"quantize_bits: family "
                         f"{family or hf_config.model_type!r} has no quantized "
                         f"path")
    # the 16-bit tensors read in the target dtype: a bf16 checkpoint widened
    # to float32 on the host only to be cast back would double its bytes
    state = LazyState(model_dir, dtype)
    bnb = any(k.endswith(".SCB") or ".quant_state.bitsandbytes__" in k
              for k in state)
    if bnb:
        state = load_checkpoint_state_dict(model_dir, dtype)
        had_8bit = any(k.endswith(".SCB") for k in state)
        if ingest_bnb_state_dict(state) and quantize_bits is None:
            quantize_bits = 8 if had_8bit else "nf4"
    model = _convert(state, hf_config, composite, dtype, device, family,
                     text_only, None if canonizers or bnb else quantize_bits)
    if canonizers:
        model = model.canonize(*canonizers)
    if quantize_bits:
        if not isinstance(model, AttributionModel):
            raise ValueError("quantize_bits applies to text models only")
        # what the conversion left: everything in the orders above, the
        # eligible leaves that are not stacked (BERT's pooler) otherwise
        model.params = quantize_params(model.params, bits=quantize_bits,
                                       family=model.family)
    return model


# ---------------------------------------------------------------------------
# Vision: torchvision ViT, OpenCLIP's visual tower, SigLIP
# ---------------------------------------------------------------------------

def _canon_images(images, device):
    """NHWC or NCHW (the torch convention) RGB images -> NHWC on
    ``device``."""
    images = _tensor(images, device)
    if images.dim() != 4:
        raise ValueError(f"expected [B, H, W, 3] images, got {tuple(images.shape)}")
    if images.shape[-1] == 3:
        return images
    if images.shape[1] == 3:
        return images.permute(0, 2, 3, 1)
    # neither axis is RGB (RGBA, grayscale): say so here rather than as a
    # conv shape error
    raise ValueError(
        f"expected RGB images as [B, H, W, 3] or [B, 3, H, W], got "
        f"{tuple(images.shape)}")


@dataclasses.dataclass
class VisionAttributionModel:
    """A converted vision tower plus its attribution entry points.

    ``kind``: 'vit' (classification head), 'openclip' (L2-normalized CLIP
    embedding) or 'siglip' (headless: pass an explicit ``target``). The
    towers recompute their layers in the backward (``remat``)."""

    kind: str
    cfg: Any
    params: Any
    composite: composites.Composite

    @property
    def device(self):
        return _first_leaf(self.params).device

    def _forward(self, composite):
        """``run(images) -> [B, ...]``: class logits, the CLIP embedding or
        SigLIP's patch embeddings under ``composite``."""
        from lxt_tpu_torch.models import siglip, vit
        params, cfg = self.params, self.cfg
        composite = composites.resolve(composite or self.composite)
        if self.kind == "siglip":
            return lambda x: siglip.forward(params, cfg, x, composite)
        return lambda x: vit.forward(params, cfg, x, composite).logits

    def logits(self, images, composite=None):
        """Class logits ('vit'), CLIP embedding ('openclip') or patch
        embeddings ('siglip')."""
        with torch.no_grad():
            return self._forward(composite)(_canon_images(images, self.device))

    def attribute_image(self, images, *, label=None,
                        target: Optional[Callable] = None, composite=None):
        """Pixel relevance heatmap, one forward and one backward.

        Default target: the argmax class logit ('vit'; ``label [B]`` explains
        given classes) or, for 'openclip', the embedding dotted with
        ``target`` (a ``[proj_dim]`` direction, e.g. a text embedding).
        'siglip' has no head: ``target`` (a callable on the ``[B, P, D]``
        patch embeddings) is required. Returns ``(value, heatmap [B, H,
        W])``, relevance summed over the channels."""
        if self.kind == "siglip" and target is None:
            raise ValueError(
                "siglip towers are headless: pass target=<callable on the "
                "[B, P, D] patch embeddings> (e.g. a pooled-probe dot)")
        if target is not None and not callable(target) and self.kind != "openclip":
            raise ValueError("non-callable target (an embedding direction) "
                             "is only meaningful for openclip towers")
        run = self._forward(composite)
        images = _canon_images(images, self.device)
        lab = None if label is None else _tensor(label, self.device)
        direction = (None if target is None or callable(target)
                     else _tensor(target, self.device))

        def tgt(x):
            out = run(x)
            if callable(target):
                return target(out)
            if direction is not None:
                return (out * direction).sum()
            if lab is not None:
                return _pick(out, lab).sum()
            return out.max(dim=-1).values.sum()

        return input_relevance(tgt, images)

    def attribute_topk(self, images, k: int = 5, *, composite=None):
        """Top-k class heatmaps from one forward ('vit' only): ``(labels [K,
        B], values [K, B], heatmaps [K, B, H, W])``, through
        :func:`~lxt_tpu_torch.attribution.topk_relevance` (the ``[B, C]``
        logits are its 2-D rows; summing the features of NHWC pixels sums
        the channels)."""
        if self.kind != "vit":
            raise ValueError(
                "attribute_topk needs a classification head (kind='vit'); "
                f"this tower is {self.kind!r} — use "
                "attribute_image(target=...)")
        return topk_relevance(self._forward(composite),
                              _canon_images(images, self.device), k)


def _state_dict(model_or_sd):
    """``(state_dict, model)`` of a module or a bare state dict."""
    if isinstance(model_or_sd, dict):
        return model_or_sd, model_or_sd
    return model_or_sd.state_dict(), model_or_sd


def _num_heads(num_heads, read):
    if num_heads is not None:
        return num_heads
    try:
        return int(read())
    except AttributeError:
        raise ValueError(
            "num_heads is not recoverable from a bare state dict — pass "
            "num_heads=... or the model object") from None


def from_torchvision(model_or_state_dict, *, num_heads: int = None,
                     composite: composites.Composite = None, dtype=None,
                     device="cuda") -> VisionAttributionModel:
    """Convert a torchvision ``VisionTransformer`` (module or state dict)
    onto ``device``. The geometry comes from the state dict; ``num_heads``
    from the module's ``nn.MultiheadAttention`` (a bare state dict needs it
    given). The composite defaults to CP-LRP, the reference's only ViT map;
    compose it with ``.with_gamma(...)`` for denoised heatmaps."""
    from lxt_tpu_torch.models import vit
    sd, model = _state_dict(model_or_state_dict)
    num_heads = _num_heads(num_heads, lambda: model.encoder.layers[0].self_attention.num_heads)
    D, _, P, _ = sd["conv_proj.weight"].shape
    side = int(round((sd["encoder.pos_embedding"].shape[1] - 1) ** 0.5))
    L = sum(1 for k in sd if k.startswith("encoder.layers.encoder_layer_")
            and k.endswith(".ln_1.weight"))
    cfg = vit.ViTConfig(
        image_size=side * P, patch_size=P, hidden_size=D,
        intermediate_size=sd["encoder.layers.encoder_layer_0.mlp.0.weight"].shape[0],
        num_layers=L, num_heads=num_heads,
        num_classes=sd["heads.head.weight"].shape[0], act="gelu_exact")
    params = vit.params_from_torchvision(sd, cfg, dtype=dtype or torch.float32,
                                         device=device)
    return VisionAttributionModel(
        kind="vit", cfg=cfg, params=params,
        composite=composites.resolve(composite or composites.cp_lrp))


def from_openclip(model_or_state_dict, *, num_heads: int = None,
                  composite: composites.Composite = None,
                  act: str = "quick_gelu", ln_eps: float = 1e-5, dtype=None,
                  device="cuda") -> VisionAttributionModel:
    """Convert an OpenCLIP ``VisualTransformer`` (the ``visual.`` subtree
    of a CLIP checkpoint) onto ``device``. OpenCLIP's stock activation is
    QuickGELU; pass ``act='gelu_exact'`` for ``nn.GELU`` variants."""
    from lxt_tpu_torch.models import vit
    sd, model = _state_dict(model_or_state_dict)
    num_heads = _num_heads(num_heads, lambda: model.transformer.resblocks[0].attn.num_heads)
    D, _, P, _ = sd["conv1.weight"].shape
    side = int(round((sd["positional_embedding"].shape[0] - 1) ** 0.5))
    L = sum(1 for k in sd if k.startswith("transformer.resblocks.")
            and k.endswith(".ln_1.weight"))
    cfg = vit.ViTConfig(
        image_size=side * P, patch_size=P, hidden_size=D,
        intermediate_size=sd["transformer.resblocks.0.mlp.c_fc.weight"].shape[0],
        num_layers=L, num_heads=num_heads, ln_eps=ln_eps, act=act,
        openclip=True, proj_dim=sd["proj"].shape[1])
    params = vit.params_from_openclip(sd, cfg, dtype=dtype or torch.float32,
                                      device=device)
    return VisionAttributionModel(
        kind="openclip", cfg=cfg, params=params,
        composite=composites.resolve(composite or composites.cp_lrp))


def from_siglip(hf_model, composite: composites.Composite = None, dtype=None,
                device="cuda") -> VisionAttributionModel:
    """Convert an HF SigLIP vision tower (``SiglipVisionModel``, or the
    ``vision_model`` of a whole ``SiglipModel``) onto ``device``."""
    from lxt_tpu_torch.models import siglip
    hf_config = hf_model.config
    if hasattr(hf_config, "vision_config"):
        hf_config = hf_config.vision_config
    cfg = siglip.SiglipConfig.from_hf(hf_config)
    sd = hf_model.state_dict()
    prefix = "vision_model." if any(k.startswith("vision_model.") for k in sd) else ""
    params = siglip.params_from_hf(sd, cfg, dtype=dtype or torch.float32,
                                   device=device, prefix=prefix)
    return VisionAttributionModel(
        kind="siglip", cfg=cfg, params=params,
        composite=composites.resolve(composite or composites.cp_lrp))


# ---------------------------------------------------------------------------
# Image + text: Gemma3ForConditionalGeneration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MultimodalAttributionModel:
    """Gemma 3 image + text: ``attribute(input_ids, pixel_values)`` gives
    the relevance of the prompt's tokens and of the pixels from one
    backward. ``remat`` is the text forward's keyword (SigLIP always
    recomputes its layers)."""

    cfg: Any          # gemma3.Gemma3MultimodalConfig
    params: Any
    composite: composites.Composite
    remat: bool = True
    family: str = "gemma3_multimodal"

    @property
    def device(self):
        return self.params["text"]["embed"].device

    def _inputs(self, input_ids, pixel_values):
        """``(ids [B, T], pixels NHWC, placeholder mask [B, T], embeds)``."""
        ids = _tensor(input_ids, self.device).long()
        pix = _canon_images(pixel_values, self.device)
        mask = ids == self.cfg.image_token_id
        return ids, pix, mask, gemma3.embed(self.params["text"], ids, self.cfg.text)

    def _forward(self, mask, composite=None):
        """``run(embeds, pixels, **kw) -> ModelOutputs``: the joint forward
        under ``composite`` (default: the model's)."""
        params, cfg, remat = self.params, self.cfg, self.remat
        composite = composites.resolve(composite or self.composite)
        return lambda e, p, **kw: gemma3.multimodal_forward(
            params, cfg, e, p, mask, composite, remat=remat, **kw)

    def logits(self, input_ids, pixel_values, composite=None):
        _, pix, mask, embeds = self._inputs(input_ids, pixel_values)
        with torch.no_grad():
            return self._forward(mask, composite)(embeds, pix).logits

    def attribute(self, input_ids, pixel_values, *,
                  target: Optional[Callable] = None, position: int = -1,
                  token=None, composite=None):
        """Joint attribution: ``(value, token_relevance [B, T],
        image_heatmap [B, H, W])`` from one backward. The default target is
        the argmax logit at ``position`` (only that row's logits are
        computed), or the ``token [B]`` ids there; ``target`` maps the full
        logits to a scalar instead. Relevance entering through the projected
        image tokens lands on the pixels, so the placeholders' own token
        relevance is 0."""
        _, pix, mask, embeds = self._inputs(input_ids, pixel_values)
        run = self._forward(mask, composite)
        tok = None if token is None else _tensor(token, self.device)
        e, p = embeds.detach().requires_grad_(True), pix.detach().requires_grad_(True)
        with torch.enable_grad():
            if target is not None:
                value = target(run(e, p).logits)
            else:
                row = run(e, p, logits_at=position).logits[:, -1, :]
                value = (row.max(dim=-1).values if tok is None
                         else _pick(row, tok)).sum()
            g_e, g_p = torch.autograd.grad(value, (e, p))
        return (value.detach(), (e.detach().float() * g_e.float()).sum(-1),
                (p.detach().float() * g_p.float()).sum(-1))

    def generate(self, input_ids, pixel_values, max_new_tokens: int, *,
                 eos_token_id: Optional[int] = None, use_cache: bool = True):
        """Greedy decoding conditioned on the image. SigLIP runs once, on
        the prompt: the merged image + text prefix is prefilled into a KV
        cache and each step decodes one token (``models/decode.py``);
        ``use_cache=False`` re-runs the text forward over prefix + tail per
        token. Generated positions are never placeholders. Returns ids
        ``[B, T0 + max_new_tokens]``, for :meth:`attribute_response`."""
        ids0, pix, mask, embeds = self._inputs(input_ids, pixel_values)
        comp = composites.resolve(self.composite)
        with torch.no_grad():
            prefix = gemma3.merge_image_embeds(self.params, self.cfg, embeds,
                                               pix, mask, comp)
        text = self.params["text"]
        return _decode(FAMILIES["gemma3"], text, self.cfg.text, comp, ids0,
                       prefix, lambda ids: gemma3.embed(text, ids, self.cfg.text),
                       max_new_tokens, eos_token_id, None, use_cache, {})

    def attribute_response(self, input_ids, pixel_values, response_start: int,
                           *, composite=None, contrastive: bool = False,
                           via: str = "scan"):
        """One joint token + pixel map per response token, all from one
        forward (:func:`~lxt_tpu_torch.attribution.multi_site_relevance`
        with the pixels as ``aux_input``): which tokens and pixels drove
        each token of the caption. Returns ``(values [K, B],
        token_relevance [K, B, T], image_heatmap [K, B, H, W])``, ``K = T -
        response_start``. On a CUDA device the forward runs over the ids
        right-padded with token 0 to a multiple of 128, so that the text
        side stays on the flash kernels' grid (as ``AttributionPipeline``
        pads); causal attention keeps the pads, which follow every
        explained position, out of every map."""
        ids, pix, mask, embeds = self._inputs(input_ids, pixel_values)
        positions, tokens = _response_sites(ids, int(response_start))
        B, T = ids.shape
        pad = -T % (128 if ids.is_cuda else 1)
        if pad:
            ids = torch.cat([ids, ids.new_zeros((B, pad))], dim=1)
            mask = torch.cat([mask, mask.new_zeros((B, pad))], dim=1)
            embeds = gemma3.embed(self.params["text"], ids, self.cfg.text)
        run = self._forward(mask, composite)
        values, rel_tok, rel_pix = multi_site_relevance(
            lambda e, p: run(e, p).logits, embeds, positions, tokens,
            aux_input=pix, contrastive=contrastive, via=via)
        return values, rel_tok[..., :T], rel_pix


def _convert_multimodal(state_dict, hf_config, composite, dtype,
                        device) -> MultimodalAttributionModel:
    mmcfg = gemma3.Gemma3MultimodalConfig.from_hf(hf_config)
    params = gemma3.multimodal_params_from_hf(
        state_dict, mmcfg, dtype=dtype or torch.float32, device=device)
    return MultimodalAttributionModel(
        cfg=mmcfg, params=params,
        composite=composites.resolve(composite or composites.attnlrp))
