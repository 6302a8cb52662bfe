"""One-call user surface: HF checkpoint or model of a Llama-family,
Gemma-3 text, Mixtral, GPT-2 or BERT model -> :class:`AttributionModel`
(counterpart of ``lxt_tpu/models/registry.py``, for the families the port
has).

    import lxt_tpu_torch
    model = lxt_tpu_torch.from_pretrained("/path/to/llama-dir",
                                          quantize_bits="nf4", device="cuda")
    value, relevance = model.attribute(input_ids)
    out = model.generate(input_ids, 32)          # KV-cached decoding
    values, maps = model.attribute_response(out, input_ids.shape[1])

``from_pretrained`` reads ``config.json`` with :mod:`json` and the weights
with the numpy safetensors reader (:mod:`lxt_tpu_torch.io`): it needs
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
from lxt_tpu_torch.models import bert, decode, gemma3, gpt2, llama, mixtral
from lxt_tpu_torch.ops.quant import QuantizedTensor

_LLAMA = {"config": llama.LlamaConfig, "from_hf": llama.params_from_hf,
          "forward": llama.forward,
          "embed": lambda params, ids, cfg: llama.embed(params, ids),
          "prefill": decode.prefill, "decode_step": decode.decode_step}
_GEMMA3 = {"config": gemma3.Gemma3Config, "from_hf": gemma3.params_from_hf,
           "forward": gemma3.forward, "embed": gemma3.embed,
           "prefill": decode.gemma3_prefill,
           "decode_step": decode.gemma3_decode_step}
#: the families the port has a model for: family -> config class, HF
#: converter, forward and embedding (``embed(params, ids, cfg)``), and for
#: the causal LMs the KV-cached ``prefill`` and ``decode_step``
FAMILIES = {"llama": _LLAMA, "qwen2": _LLAMA, "qwen3": _LLAMA,
            "mistral": _LLAMA, "phi3": _LLAMA, "gemma3": _GEMMA3,
            "gemma3_text": _GEMMA3,
            "gpt2": {"config": gpt2.GPT2Config, "from_hf": gpt2.params_from_hf,
                     "forward": gpt2.forward,
                     "embed": lambda params, ids, cfg: gpt2.embed(params, ids)[0],
                     "prefill": decode.gpt2_prefill,
                     "decode_step": decode.gpt2_decode_step},
            "bert": {"config": bert.BertConfig, "from_hf": bert.params_from_hf,
                     "forward": bert.forward,
                     "embed": lambda params, ids, cfg: bert.embed(params, ids)},
            "mixtral": {"config": mixtral.MixtralConfig,
                        "from_hf": mixtral.params_from_hf,
                        "forward": mixtral.forward,
                        "embed": lambda params, ids, cfg: mixtral.embed(params, ids),
                        "prefill": decode.mixtral_prefill,
                        "decode_step": decode.mixtral_decode_step}}
SUPPORTED_FAMILIES = tuple(FAMILIES)
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
}


def read_hf_config(model_dir):
    """``config.json`` of a checkpoint directory as an attribute namespace,
    with the keys it leaves out filled as transformers' config class for
    its ``model_type`` fills them (a ``model_type`` outside the table is
    taken as written). A ``gemma3`` (image + text) config keeps its
    ``text_config``, filled the same way, as a nested namespace."""
    return _filled(json.loads((Path(model_dir) / "config.json").read_text()))


def _filled(raw):
    mt = raw.get("model_type")
    if mt == "gemma3":
        text = dict(raw.get("text_config") or {}, model_type="gemma3_text")
        return types.SimpleNamespace(**dict(raw, text_config=_filled(text)))
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
    logits ``[B, 1, V]`` (argmax, or with ``generator`` a temperature /
    top-k draw), eos latched on rows that already emitted it, written into
    ``buf`` at ``pos`` in place. Returns the updated ``done``."""
    row = logits[:, 0, :]
    if generator is None:
        nxt = row.argmax(-1)
    else:
        logt = row.float() / temperature
        if top_k is not None:
            kth = torch.topk(logt, int(top_k), dim=-1).values[:, -1:]
            logt = logt.masked_fill(logt < kth, float("-inf"))
        nxt = torch.multinomial(torch.softmax(logt, -1), 1,
                                generator=generator)[:, 0]
    nxt = nxt.to(buf.dtype)
    if eos_token_id is not None:
        nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
        done = done | (nxt == eos_token_id)
    buf[:, pos] = nxt
    return done


@dataclasses.dataclass
class AttributionModel:
    """A converted model of one of :data:`FAMILIES` plus its attribution
    entry points. PyTorch runs eagerly, so there is no program cache and no
    ``jit=``; ``check=`` waits for the port of ``ops/check.py``.

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
        leaf = self.params
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
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
                  kv_begin=None, attention_mask=None, kv_end=None):
        """Per-token input relevance, one forward and one backward.

        Default target: the argmax logit at ``position`` (only that row's
        logits are computed), or the ``token [B]`` ids there; for a
        classifier (BERT), the argmax label's logit summed over the batch,
        or the ``token`` labels'. ``target`` maps the full logits to a
        scalar instead. Returns ``(target_value, relevance [B, T])``.
        ``kv_begin`` / ``attention_mask`` mark left padding, ``kv_end`` /
        ``attention_mask`` BERT's right padding (see
        :func:`_padding_args`)."""
        run = self._forward(composite, kv_begin, attention_mask, kv_end)
        row = self._row(run, position)
        tok = None if token is None else _tensor(token, self.device)

        def tgt(e):
            if target is not None:
                return target(run(e).logits)
            if tok is None:
                return row(e).max(dim=-1).values.sum()
            return _pick(row(e), tok).sum()

        return input_relevance(tgt, self.embed(input_ids))

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
                        kv_end=None, via: str = "scan"):
        """K relevance maps for K candidate tokens sharing ONE forward
        (:func:`lxt_tpu_torch.attribution.multi_token_relevance`).

        ``tokens``: ``[K]`` (the same candidates for every batch row) or
        ``[K, B]`` int ids. Returns ``(values [K, B], relevance [K, B, T])``.
        Padding as in :meth:`attribute`."""
        run = self._forward(composite, kv_begin, attention_mask, kv_end)
        return multi_token_relevance(
            self._row(run, position), self.embed(input_ids),
            _tensor(tokens, self.device), via=via)

    def attribute_topk(self, input_ids, k: int = 5, *, position: int = -1,
                       composite=None, kv_begin=None, attention_mask=None,
                       kv_end=None, via: str = "scan"):
        """Explain the model's own top-k candidates at ``position`` in one
        forward: ``(tokens [K, B], values [K, B], relevance [K, B, T])``.
        Padding as in :meth:`attribute`."""
        run = self._forward(composite, kv_begin, attention_mask, kv_end)
        return topk_relevance(self._row(run, position), self.embed(input_ids),
                              k, via=via)

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
        if generator is not None and not temperature > 0:
            raise ValueError("sampling (generator=) needs temperature > 0")
        N = int(max_new_tokens)
        if N < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {N}")
        table = FAMILIES[self.family]
        params, cfg = self.params, self.cfg
        comp = composites.resolve(self.composite)
        ids0 = _tensor(input_ids, self.device).long()
        B, T0 = ids0.shape
        kb = None if kv_begin is None else _tensor(kv_begin, self.device).to(torch.int32)
        buf = torch.cat([ids0, ids0.new_zeros((B, N))], dim=1)
        done = torch.zeros(B, dtype=torch.bool, device=ids0.device)

        def pick(logits, pos, done):
            return _greedy_update(buf, done, logits, pos, eos_token_id,
                                  generator=generator,
                                  temperature=float(temperature), top_k=top_k)

        def finished():
            if eos_token_id is None:
                return False
            decode.counters["done_reads"] += 1
            return bool(done.all())

        with torch.no_grad():
            if use_cache and "prefill" in table:
                logits, caches = table["prefill"](
                    params, cfg, self.embed(ids0), T0 + N, kv_begin=kb,
                    composite=comp)
                done = pick(logits, T0, done)
                for k in range(1, N):
                    if finished():
                        break
                    logits, caches = table["decode_step"](
                        params, cfg, self.embed(buf[:, T0 + k - 1:T0 + k]),
                        caches, T0 + k - 1, kv_begin=kb, composite=comp)
                    done = pick(logits, T0 + k, done)
            else:
                for k in range(N):
                    if finished():
                        break
                    logits = table["forward"](
                        params, cfg, self.embed(buf), comp, kv_begin=kb,
                        remat=False, logits_at=T0 + k - 1).logits
                    done = pick(logits, T0 + k, done)
        return buf if eos_token_id is None else _fill_after_eos(buf, T0, eos_token_id)

    def _response_sites(self, ids, response_start):
        """Map k of a response explains ``ids[:, response_start + k]`` at
        the position that predicted it: ``(positions [K], tokens [K, B])``."""
        T = ids.shape[1]
        if not 1 <= response_start < T:
            raise ValueError(f"response_start must be in [1, T), got "
                             f"{response_start} for T={T}")
        return (list(range(response_start - 1, T - 1)),
                ids[:, response_start:].T)

    def attribute_response(self, input_ids, response_start: int, *,
                           composite=None, kv_begin=None,
                           contrastive: bool = False, via: str = "scan"):
        """One relevance map per response token, all from one forward.

        ``input_ids [B, T]`` is prompt + continuation and ``response_start``
        the first continuation position. Map k explains the logit of
        ``input_ids[:, response_start + k]`` at ``response_start + k - 1``:
        one forward and K pulls of its graph
        (:func:`lxt_tpu_torch.attribution.multi_site_relevance`).
        ``contrastive``: each map explains the margin over the strongest
        other token; ``values`` become the margins. ``kv_begin [B]`` marks
        left padding. Returns ``(values [K, B], relevance [K, B, T])``,
        ``K = T - response_start``."""
        ids = _tensor(input_ids, self.device).long()
        positions, tokens = self._response_sites(ids, int(response_start))
        run = self._forward(composite, kv_begin)
        return multi_site_relevance(lambda e: run(e).logits, self.embed(ids),
                                    positions, tokens, contrastive=contrastive,
                                    via=via)

    def attribute_response_latent(self, input_ids, response_start: int, *,
                                  composite=None, via: str = "scan"):
        """Per-layer relevance of every response token from one forward:
        map k's probe gradients times the shared hidden states. Returns
        ``(values [K, B], input_rel [K, B, T], latent_rel [K, L, B, T])``."""
        ids = _tensor(input_ids, self.device).long()
        positions, tokens = self._response_sites(ids, int(response_start))
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


def _text_model(state_dict, hf_config):
    """A ``gemma3`` (image + text) config and state dict -> its language
    model's (``text_config``, ``model.language_model.*`` weights renamed
    to ``model.*``). A checkpoint that holds vision weights is refused: the
    port has no SigLIP tower yet, and dropping it would explain a different
    model."""
    vision = [k for k in state_dict if k.startswith(
        ("model.vision_tower.", "model.multi_modal_projector.",
         "vision_tower.", "multi_modal_projector."))]
    if vision:
        raise ValueError(
            f"this gemma3 checkpoint holds vision weights ({vision[0]}, ...): "
            f"the image + text model is not ported to lxt_tpu_torch yet "
            f"(it needs the SigLIP tower); save the language model alone "
            f"(Gemma3ForCausalLM) to attribute its text")
    prefix = "model.language_model."
    if any(k.startswith(prefix) for k in state_dict):
        text = {"model." + k[len(prefix):]: v for k, v in state_dict.items()
                if k.startswith(prefix)}
        if "lm_head.weight" in state_dict:
            text["lm_head.weight"] = state_dict["lm_head.weight"]
        state_dict = text
    return state_dict, hf_config.text_config


def _convert(state_dict, hf_config, composite, dtype, device, family=None):
    """state dict (torch tensors or numpy arrays) -> AttributionModel."""
    if (getattr(hf_config, "model_type", None) == "gemma3"
            and hasattr(hf_config, "text_config")):
        state_dict, hf_config = _text_model(state_dict, hf_config)
    if family is not None:
        if family not in SUPPORTED_FAMILIES:
            raise ValueError(f"family={family!r} is not one of: "
                             f"{', '.join(SUPPORTED_FAMILIES)}")
    else:
        family = detect_family(hf_config, state_dict)
    table = FAMILIES[family]
    cfg = table["config"].from_hf(hf_config)
    params = table["from_hf"](state_dict, cfg, dtype=dtype or torch.float32,
                              device=device)
    if composite is None:
        composite = composites.cp_lrp if family == "gpt2" else composites.attnlrp
    composite = composites.resolve(composite)
    return AttributionModel(family=family, cfg=cfg, params=params,
                            composite=composite)


def from_hf(hf_model, composite: composites.Composite = None, dtype=None,
            family: str = None, device="cuda", canonizers=None):
    """Convert a loaded HF torch model of one of :data:`SUPPORTED_FAMILIES`
    (``.config`` and ``.state_dict()``) into an :class:`AttributionModel` on
    ``device``.
    ``family`` forces a family for an out-of-registry ``model_type`` that
    is computationally one of :data:`SUPPORTED_FAMILIES`; exact Llama clones
    are detected. The composite defaults to AttnLRP (CP-LRP for GPT-2, as
    the reference recommends). ``canonizers``: an
    optional list of ``(params, cfg, family)`` pre-transforms applied to the
    converted model (:meth:`AttributionModel.canonize`)."""
    if not hasattr(hf_model, "config"):
        raise ValueError("from_hf takes an HF model with a .config; the "
                         "vision layouts are not ported to lxt_tpu_torch yet")
    model = _convert(hf_model.state_dict(), hf_model.config, composite, dtype,
                     device, family)
    return model.canonize(*canonizers) if canonizers else model


def from_pretrained(model_dir, composite: composites.Composite = None,
                    dtype=None, quantize_bits=None, family: str = None,
                    device="cuda", canonizers=None):
    """Load an :class:`AttributionModel` straight from an HF checkpoint
    directory onto ``device``; no torch model is instantiated.

    ``quantize_bits`` (8, 4 or "nf4") quantizes the family's projections
    after conversion. bitsandbytes-serialized checkpoints (keys ending in
    ``.quant_state.bitsandbytes__*`` for 4-bit, ``.SCB`` for 8-bit) are
    dequantized on the host and, unless ``quantize_bits`` says otherwise,
    re-quantized in kind ("nf4" / 8), which reproduces their values
    exactly. ``canonizers`` as in :func:`from_hf`, applied before the
    quantization (they transform full-precision weights)."""
    from lxt_tpu_torch.io import load_checkpoint_state_dict
    from lxt_tpu_torch.ops.quant import ingest_bnb_state_dict, quantize_params

    hf_config = read_hf_config(model_dir)
    # the 16-bit tensors read in the target dtype: a bf16 checkpoint widened
    # to a float32 host dict only to be cast back would double its bytes
    state = load_checkpoint_state_dict(model_dir, dtype)
    had_8bit = any(k.endswith(".SCB") for k in state)
    if ingest_bnb_state_dict(state) and quantize_bits is None:
        quantize_bits = 8 if had_8bit else "nf4"
    model = _convert(state, hf_config, composite, dtype, device, family)
    if canonizers:
        model = model.canonize(*canonizers)
    if quantize_bits:
        model.params = quantize_params(model.params, bits=quantize_bits,
                                       family=model.family)
    return model
