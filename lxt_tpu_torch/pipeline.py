"""Batched heatmap pipeline: prompts in, per-token relevances out
(counterpart of ``lxt_tpu/pipeline.py``).

Tokenizes a list of prompts, left-pads them into one batch, runs one
forward and one backward over it, and returns per-prompt tokens and
normalized relevance. Left padding keeps every prompt's target at the last
position; it is passed as per-example ``kv_begin`` indices, so the flash
kernels stay engaged (padded key blocks are skipped in-kernel) and rope
positions follow the HF convention. ``pad_multiple`` rounds the padded
length up (128 on a CUDA device) so that the batch stays on the kernels.

The model runs a batch of mixed lengths as length groups
(:func:`length_groups`): each group's prompts at that group's padded
length, not the longest prompt's, all in the one forward and backward of
the call. Positions are relative to ``kv_begin``, so every token keeps its
position, and the maps are the one-batch maps.

PyTorch runs eagerly, so ``lxt_tpu``'s program cache (``jit_cache_size``)
has no counterpart.

The host's own work of a call runs inside the spans
``lxt.pipeline.encode`` and ``lxt.pipeline.finish`` (``tracing``);
``counters`` counts the positions the model runs, the prompts' tokens
among them and the length groups.

Scale-out: with ``mesh=`` (``parallel.make_mesh``) every process of the
mesh calls the pipeline with the same prompts. The batch is rounded up to
the size of the ``data`` dimension (fully padded dummy rows), each process
explains (or generates and explains) its rows, and the results are gathered
over ``data``, so every process returns every prompt's (as one length
group: the rows are dealt to processes before the model runs). A ``model``
dimension of more than one process runs the model tensor-parallel: the
pipeline keeps this process's shards of the weights
(``parallel.model_param_shardings``; Mixtral: expert parallelism). A
seeded ``respond`` draws each row from a generator of its own, seeded from
the seed and the row's index in the whole batch, so it gives the tokens of
one process.
"""

import contextlib
import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from lxt_tpu_torch import composites, tracing
from lxt_tpu_torch.attribution import (input_relevance, multi_site_relevance,
                                      topk_relevance)
from lxt_tpu_torch.models.common import ModelOutputs
from lxt_tpu_torch.models.registry import CLASSIFIERS
from lxt_tpu_torch.ops import tensor_parallel

#: positions the model runs (Σ rows × length over the length groups, dummy
#: rows included), the prompts' own tokens among them, and the length
#: groups run; :func:`reset_counters` zeroes them
counters = {"positions": 0, "useful_positions": 0, "groups": 0}

#: what one more length group costs, in positions: the host's launches of
#: one more forward and backward, priced as positions the model runs. On an
#: H100 a Mistral-7B pass costs the host ~0.33 s, of which ~0.15 s shows
#: per extra group: the device time of ~1700 positions
GROUP_COST = 2048


def reset_counters():
    for name in counters:
        counters[name] = 0


def length_groups(lengths, multiple, bucket=False):
    """A batch's rows as length groups, ``[(rows, T, size)]``: each group's
    rows (indices into ``lengths``, shortest first), its length (its
    longest row's, rounded up to ``multiple``) and its batch (its row
    count, rounded up to a power of two with ``bucket``).

    Of the contiguous runs of the rows sorted by length, the partition that
    minimises Σ size × T + ``GROUP_COST`` × groups, exactly: a dynamic
    programme over the cut points, O(B²). A dummy row (length 0) counts
    as one token."""
    order = np.argsort(np.asarray(lengths), kind="stable")
    padded = [-(-max(int(lengths[i]), 1) // multiple) * multiple for i in order]

    def size(n):
        return 1 << (n - 1).bit_length() if bucket else n

    best, cut = [0], [0]
    for j in range(1, len(order) + 1):
        cost, i = min((best[i] + size(j - i) * padded[j - 1] + GROUP_COST, i)
                      for i in range(j))
        best.append(cost)
        cut.append(i)
    groups, j = [], len(order)
    while j:
        i = cut[j]
        groups.append((order[i:j], padded[j - 1], size(j - i)))
        j = i
    return groups[::-1]


def _count(groups, ids, kv_begin):
    """Count a call's groups, and the tokens of its batch ``ids``."""
    counters["positions"] += sum(size * T for _, T, size in groups)
    counters["useful_positions"] += int((ids.shape[1] - kv_begin).sum())
    counters["groups"] += len(groups)


def _sharded_model(model, mesh):
    """``model`` with this process's shards of its weights when the mesh's
    ``model`` dimension has more than one process."""
    from lxt_tpu_torch.parallel import mesh as pmesh
    if dist.get_world_size(mesh.get_group("model")) == 1:
        return model
    shardings = pmesh.model_param_shardings(model, mesh)
    return dataclasses.replace(model,
                               params=pmesh.shard_params(model.params, shardings)[0])


@dataclasses.dataclass
class Heatmap:
    tokens: List[str]
    relevance: np.ndarray       # [len(tokens)], normalized to [-1, 1]
    raw_relevance: np.ndarray   # unnormalized
    value: float                # this prompt's explained logit value
    #: set by ``topk>1`` calls and by ``respond``: which token this map
    #: explains
    target_token: Optional[str] = None
    target_token_id: Optional[int] = None


@dataclasses.dataclass
class ResponseAttribution:
    """:meth:`AttributionPipeline.respond` result for one prompt: the
    continuation plus one :class:`Heatmap` PER generated token (map k
    explains why token k was generated; its ``relevance`` spans prompt +
    response, causally zero after the predicting position)."""
    prompt_tokens: List[str]
    response_tokens: List[str]
    response_text: str
    heatmaps: List[Heatmap]


def _row_seed(seed, i):
    """The seed of row ``i``'s generator (row 0's is ``seed``)."""
    return (int(seed) + i * 0x9E3779B97F4A7C15) % 2 ** 64


def _normalized(r):
    return r / (np.abs(r).max() + 1e-12)


class AttributionPipeline:
    """``pipeline(prompts)`` -> list of :class:`Heatmap`.

    ``model`` is an :class:`~lxt_tpu_torch.models.registry.AttributionModel`
    of a causal-LM family (Llama / Qwen / Mistral / Phi-3, Gemma-3, GPT-2,
    Mixtral); a classifier (BERT) has no next token to explain and is
    refused. The batch runs on the model's device.

    ``pad_multiple`` defaults to 128 when the model lives on a CUDA device,
    else 1: ``ops.attention.attention`` takes the flash kernels only when
    the sequence length is a multiple of 128, so a batch padded to any
    other length would run the einsum path on the card.
    ``bucket_batch`` rounds the batch, and each length group's, up to the
    next power of two with fully padded dummy rows (``kv_begin = T``); the
    results are unchanged.
    ``mesh``: a ``(data, model)`` mesh (see the module docstring); every
    process of it calls the pipeline alike. ``model`` is then the whole
    model, of which a tensor-parallel mesh keeps this process's shards.
    Under a mesh a call runs as one length group.
    """

    def __init__(self, model, tokenizer, composite=None, mesh=None,
                 pad_multiple: Optional[int] = None,
                 bucket_batch: bool = False):
        if model.family in CLASSIFIERS:
            raise NotImplementedError(
                f"AttributionPipeline explains a causal LM's next token; "
                f"{model.family!r} is a classifier (call "
                f"AttributionModel.attribute with kv_end instead)")
        self.mesh = mesh
        if mesh is not None:
            model = _sharded_model(model, mesh)
        self.model = model
        self.tokenizer = tokenizer
        self.composite = composites.resolve(composite or model.composite)
        if pad_multiple is None:
            pad_multiple = 128 if model.device.type == "cuda" else 1
        self.pad_multiple = int(pad_multiple)
        self.bucket_batch = bucket_batch

    def _data(self):
        """The mesh's ``data`` group and its size (None, 1 without a
        mesh)."""
        if self.mesh is None:
            return None, 1
        g = self.mesh.get_group("data")
        return g, dist.get_world_size(g)

    def _parallel(self):
        """The tensor-parallel group of the mesh, entered for the model's
        calls."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return tensor_parallel.using(self.mesh.get_group("model"))

    def _rows(self, *arrays):
        """This process's rows of each array (all of them without a
        mesh)."""
        if self.mesh is None:
            return arrays
        from lxt_tpu_torch.parallel.mesh import data_rows
        return tuple(data_rows(self.mesh, a) for a in arrays)

    def _gather(self, t, dim):
        """``t`` of every ``data`` process, concatenated on ``dim``."""
        g, n = self._data()
        return t if n == 1 else tensor_parallel.all_gather(t, g, dim)

    def _pad_id(self):
        pad = getattr(self.tokenizer, "pad_token_id", None)
        if pad is None:
            pad = getattr(self.tokenizer, "eos_token_id", 0) or 0
        return pad

    def _encode(self, prompts):
        with tracing.span("lxt.pipeline.encode"):
            # items may be pre-tokenized id lists (the serving layer tokenizes
            # once for its length guard and passes the ids through)
            seqs = [self.tokenizer(p)["input_ids"] if isinstance(p, str)
                    else list(p) for p in prompts]
            T = max(len(s) for s in seqs)
            m = self.pad_multiple
            T = -(-T // m) * m
            B = len(seqs)
            if self.bucket_batch:
                B = 1 << (B - 1).bit_length()   # next power of two
            n = self._data()[1]
            B = -(-B // n) * n                  # round the batch up to the data axis
            ids = np.full((B, T), self._pad_id(), np.int64)
            kv_begin = np.full((B,), T, np.int32)  # dummy rows: fully padded
            for i, s in enumerate(seqs):
                ids[i, T - len(s):] = s            # left padding
                kv_begin[i] = T - len(s)
            return ids, kv_begin, seqs

    def _tokens_of(self, s):
        return (self.tokenizer.convert_ids_to_tokens(s)
                if hasattr(self.tokenizer, "convert_ids_to_tokens")
                else [str(t) for t in s])

    def respond(self, prompts, max_new_tokens: int, composite=None,
                eos_token_id="auto", temperature: float = 0.0,
                top_k: Optional[int] = None, seed: int = 0,
                contrastive: bool = False) -> List[ResponseAttribution]:
        """Generate a continuation per prompt AND explain every token of
        it: ``generate`` (KV-cached), then ``attribute_response`` (one
        forward, one pull per generated token; the ids right-padded to
        ``pad_multiple``), batched across prompts.
        Greedy by default; ``temperature > 0`` samples (optionally
        ``top_k``-truncated, ``1 <= top_k <= vocab_size``), each prompt from
        a ``torch.Generator`` of its own on the model's device, seeded from
        ``seed`` and the prompt's index in the batch, so a seed gives the
        same tokens, with or without a mesh.

        ``eos_token_id="auto"`` reads the tokenizer; pass ``None`` to
        always emit ``max_new_tokens``. Rows that hit eos are trimmed (the
        eos token itself keeps its map). ``contrastive``: each map explains
        the margin over the strongest rival token; ``Heatmap.value`` becomes
        that margin."""
        N = int(max_new_tokens)
        if N < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {N}")
        if eos_token_id == "auto":
            eos_token_id = getattr(self.tokenizer, "eos_token_id", None)
        composite = composites.resolve(composite or self.composite)
        vocab = self.model.cfg.vocab_size
        if top_k is not None and not 1 <= int(top_k) <= vocab:
            raise ValueError(f"top_k must be in [1, {vocab}], got {top_k}")
        ids, kv_begin, seqs = self._encode(prompts)
        T0 = ids.shape[1]
        _count(self._whole(ids), ids, kv_begin)
        sample_kw = {}
        if temperature > 0:
            gens = [torch.Generator(device=self.model.device).manual_seed(
                _row_seed(seed, i)) for i in range(len(ids))]
            sample_kw = dict(temperature=float(temperature), top_k=top_k,
                             generator=self._rows(gens)[0])
        ids, kv_begin = self._rows(ids, kv_begin)
        with self._parallel():
            out_dev = self.model.generate(ids, N, eos_token_id=eos_token_id,
                                          kv_begin=kv_begin, **sample_kw)
            values, rel = self._response_maps(out_dev, T0, kv_begin, composite,
                                              contrastive)
        out_dev = self._gather(out_dev, 0)
        values, rel = self._gather(values, 1), self._gather(rel, 1)
        # post-processing on the host: one copy of each result, then numpy
        out = out_dev.cpu().numpy()
        values, rel = values.float().cpu().numpy(), rel.cpu().numpy()

        results = []
        for i, s in enumerate(seqs):
            gen = out[i, T0:]
            keep = N
            if eos_token_id is not None:
                hits = np.nonzero(gen == eos_token_id)[0]
                if hits.size:
                    keep = int(hits[0]) + 1     # trim AFTER the first eos
            resp_ids = [int(t) for t in gen[:keep]]
            prompt_tokens = self._tokens_of(s)
            resp_tokens = self._tokens_of(resp_ids)
            tokens = prompt_tokens + resp_tokens
            lo = T0 - len(s)
            maps = []
            for k in range(keep):
                r = rel[k, i, lo:T0 + keep]
                maps.append(Heatmap(
                    tokens=tokens, relevance=_normalized(r), raw_relevance=r,
                    value=float(values[k, i]), target_token=resp_tokens[k],
                    target_token_id=resp_ids[k]))
            text = (self.tokenizer.decode(resp_ids)
                    if hasattr(self.tokenizer, "decode")
                    else " ".join(resp_tokens))
            results.append(ResponseAttribution(
                prompt_tokens=prompt_tokens, response_tokens=resp_tokens,
                response_text=text, heatmaps=maps))
        return results

    def _response_maps(self, out, T0, kv_begin, composite, contrastive):
        """``AttributionModel.attribute_response(out, T0)`` over ``out``
        right-padded to a multiple of ``pad_multiple``, so that the prompt
        plus its response stays on the flash kernels' grid. The pad tokens
        follow every explained position, so causal attention keeps them out
        of every map. Returns ``(values [N, B], relevance [N, B, T])`` for
        ``out [B, T]``, ``N = T - T0``."""
        B, T = out.shape
        Tp = -(-T // self.pad_multiple) * self.pad_multiple
        padded = torch.cat([out, out.new_full((B, Tp - T), self._pad_id())], 1)
        run = self.model._forward(composite, kv_begin)
        values, rel = multi_site_relevance(
            lambda e: run(e).logits, self.model.embed(padded),
            list(range(T0 - 1, T - 1)), out[:, T0:].T, contrastive=contrastive)
        return values, rel[..., :T]

    @staticmethod
    def _whole(ids):
        """The batch ``ids [B, T]`` as one length group."""
        B, T = ids.shape
        return [(np.arange(B), T, B)]

    def _groups(self, ids, kv_begin):
        """The length groups a call runs: :func:`length_groups` of its
        rows, or the whole batch under a mesh."""
        if self.mesh is not None:
            return self._whole(ids)
        return length_groups(ids.shape[1] - kv_begin, self.pad_multiple,
                             self.bucket_batch)

    def _grouped_run(self, composite, kv_begin, groups, T):
        """``run(embeds [B, T, D], **more)`` that runs each length group
        apart: its rows' last ``T_g`` columns (the padding is on the left)
        with ``kv_begin`` shifted by ``T - T_g``, so every token keeps its
        position, and dummy rows (``kv_begin = T_g``) up to its size. The
        logits come back in the rows' order. Nothing here waits for the
        device, so the host launches a group while the device runs the one
        before."""
        device = self.model.device
        order = np.concatenate([rows for rows, _, _ in groups])
        inverse = torch.as_tensor(np.argsort(order), device=device)
        parts = []
        for rows, Tg, size in groups:
            kv = np.full(size, Tg, np.int32)
            kv[:len(rows)] = kv_begin[rows] - (T - Tg)
            parts.append((torch.as_tensor(rows, device=device), T - Tg,
                          size - len(rows), self.model._forward(composite, kv)))

        def run(e, **more):
            logits = []
            for rows, cut, fill, run_g in parts:
                x = e[:, cut:].index_select(0, rows)
                if fill:
                    x = torch.cat([x, x[:1].detach().expand(fill, -1, -1)])
                logits.append(run_g(x, **more).logits[:len(rows)])
            return ModelOutputs(torch.cat(logits).index_select(0, inverse))
        return run

    def _attribute(self, ids, kv_begin, composite, topk):
        """One forward with logits only at the last position, then one
        backward (``topk == 1``: the per-example max logits, summed, whose
        gradients are disjoint) or ``topk`` pulls of its graph, over the
        call's length groups (:meth:`_groups`). Returns
        ``(tokens [K, B] or None, values, relevance)`` on the host (with a
        mesh: this process's rows explained, every row returned)."""
        groups = self._groups(ids, kv_begin)
        _count(groups, ids, kv_begin)
        ids, kv_begin = self._rows(ids, kv_begin)
        with self._parallel():
            run = (self.model._forward(composite, kv_begin) if len(groups) == 1
                   else self._grouped_run(composite, kv_begin, groups, ids.shape[1]))
            row = self.model._row(run, -1)
            embeds = self.model.embed(ids)
            if topk > 1:
                toks, value, rel = topk_relevance(row, embeds, topk)
                toks = self._gather(toks, 1).cpu().numpy()
            else:
                held = {}

                def target(e):
                    per_example = row(e).max(dim=-1).values
                    held["value"] = per_example.detach()
                    return per_example.sum()

                _, rel = input_relevance(target, embeds)
                toks, value = None, held["value"]
        dim = 1 if topk > 1 else 0
        value, rel = self._gather(value.float(), dim), self._gather(rel, dim)
        return toks, value.cpu().numpy(), rel.cpu().numpy()

    def __call__(self, prompts, composite=None, topk: int = 1):
        """``topk=1`` (default): list of :class:`Heatmap`, one per prompt,
        explaining the argmax next token. ``topk>1``: list of LISTS, the k
        candidate heatmaps per prompt, all k sharing one forward pass
        (:func:`lxt_tpu_torch.attribution.topk_relevance`), each tagged with
        its ``target_token``."""
        composite = composites.resolve(composite or self.composite)
        topk = int(topk)
        if topk < 1:
            raise ValueError(f"topk must be >= 1, got {topk}")
        ids, kv_begin, seqs = self._encode(prompts)
        toks, value, rel = self._attribute(ids, kv_begin, composite, topk)
        with tracing.span("lxt.pipeline.finish"):
            out = []
            for i, s in enumerate(seqs):
                tokens = self._tokens_of(s)
                lo = ids.shape[1] - len(s)
                if topk > 1:
                    cands = []
                    for k in range(topk):
                        r = rel[k, i, lo:]
                        tid = int(toks[k, i])
                        cands.append(Heatmap(
                            tokens=tokens, relevance=_normalized(r),
                            raw_relevance=r, value=float(value[k, i]),
                            target_token=self._tokens_of([tid])[0],
                            target_token_id=tid))
                    out.append(cands)
                else:
                    r = rel[i, lo:]
                    out.append(Heatmap(tokens=tokens, relevance=_normalized(r),
                                       raw_relevance=r, value=float(value[i])))
        return out
