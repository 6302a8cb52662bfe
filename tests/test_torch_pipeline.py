"""lxt_tpu_torch.pipeline.AttributionPipeline against lxt_tpu's, on CPU.

Both packages run on the same numpy weights (lxt_tpu's init carried over by
params_from_numpy), float32: a tiny Llama (2 layers, width 64, GQA 4/2),
Gemma-3 (a local and a global layer) and GPT-2. ``__call__`` (single maps,
top-k, ``bucket_batch``, ``pad_multiple=4`` against 1) and ``respond``
(greedy and contrastive) give the same tokens, and values and relevance
within normalized L2 1e-5. The random streams of sampling differ between
the packages, so sampled tokens are held to their own properties: a seed
gives the same tokens, ``top_k=1`` equals greedy. A batch of mixed lengths
run as length groups (``length_groups``, its cost set to 0 so that the
batch splits) gives lxt_tpu's maps and the one-group maps, in the caller's
order, and the one row of explained tokens that the benchmark records.

The lxt_tpu pipelines and their outputs are built once per module: each
distinct shape is a JAX compile.
"""

import dataclasses
import itertools
import zlib

import jax
import numpy as np
import pytest
import torch

import lxt_tpu
import lxt_tpu_torch
from lxt_tpu.models import gemma3 as jgemma
from lxt_tpu.models import gpt2 as jgpt2
from lxt_tpu.models import llama as jllama
from lxt_tpu.models.registry import AttributionModel as JModel
from lxt_tpu.models.registry import _family_table
from lxt_tpu.pipeline import AttributionPipeline as JPipeline
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import gemma3 as tgemma
from lxt_tpu_torch.models import gpt2 as tgpt2
from lxt_tpu_torch.models import llama as tllama
from lxt_tpu_torch.models.registry import AttributionModel as TModel
from lxt_tpu_torch import pipeline as pipeline_mod
from lxt_tpu_torch.pipeline import AttributionPipeline, ResponseAttribution, length_groups

BAR = 1e-5
VOCAB = 128
PROMPTS = ["alpha beta gamma", "one two three four five six", "x y"]
RESPOND_N = 3


class ToyTokenizer:
    """Whitespace words -> ids by crc32 (stable across processes, unlike
    ``hash``); 0 pads, 1 ends a sequence."""

    pad_token_id = 0
    eos_token_id = 1

    def __init__(self, vocab_size=VOCAB):
        self.vocab_size = vocab_size

    def __call__(self, text):
        return {"input_ids": [2 + zlib.crc32(w.encode()) % (self.vocab_size - 2)
                              for w in text.split()]}

    def convert_ids_to_tokens(self, ids):
        return [f"▁t{int(i)}" for i in ids]

    def decode(self, ids):
        return " ".join(self.convert_ids_to_tokens(ids))


def _nl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jax_params(module, cfg, seed):
    return jax.tree.map(np.asarray, module.init_params(cfg, jax.random.PRNGKey(seed)))


def model_pair(family="llama"):
    """(lxt_tpu model, port model) of one tiny float32 config on the same
    weights."""
    if family == "llama":
        cfg = jllama.LlamaConfig(vocab_size=VOCAB, hidden_size=64,
                                 intermediate_size=128, num_layers=2, num_heads=4,
                                 num_kv_heads=2, rms_eps=1e-6)
        params, tcfg = _jax_params(jllama, cfg, 0), tllama.LlamaConfig
    elif family == "gemma3_text":
        cfg = jgemma.Gemma3Config(
            vocab_size=VOCAB, hidden_size=48, intermediate_size=96, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=12, sliding_window=4,
            query_pre_attn_scalar=12.0,
            layer_types=("sliding_attention", "full_attention"))
        params, tcfg = _jax_params(jgemma, cfg, 1), tgemma.Gemma3Config
        rng = np.random.default_rng(2)      # norm weights away from 0
        for name, leaf in params["layers"].items():
            if "norm" in name or name.startswith("ln"):
                params["layers"][name] = (0.1 * rng.standard_normal(
                    leaf.shape)).astype(np.float32)
    else:
        cfg = jgpt2.GPT2Config(vocab_size=VOCAB, hidden_size=48, num_layers=2,
                               num_heads=4, max_positions=64)
        params, tcfg = _jax_params(jgpt2, cfg, 3), tgpt2.GPT2Config
    composite = lxt_tpu.cp_lrp if family == "gpt2" else lxt_tpu.attnlrp
    jm = JModel(family, cfg, jax.tree.map(jax.numpy.asarray, params), composite,
                _family_table()[family])
    tm = TModel(family, tcfg(**dataclasses.asdict(cfg)),
                params_from_numpy(params, device="cpu"),
                lxt_tpu_torch.cp_lrp if family == "gpt2" else lxt_tpu_torch.attnlrp)
    return jm, tm


def assert_same_maps(got, want, bar=BAR):
    """Heatmaps of one call against lxt_tpu's: tokens and targets equal,
    each map's relevance within ``bar``, and the values as one vector (a
    contrastive margin can be near 0, so not each alone)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert g.target_token_id == w.target_token_id
        assert g.target_token == w.target_token
        assert _nl2(g.raw_relevance, w.raw_relevance) <= bar
        assert _nl2(g.relevance, w.relevance) <= bar
        assert np.abs(g.relevance).max() <= 1 + 1e-6
    assert _nl2([g.value for g in got], [w.value for w in want]) <= bar


@pytest.fixture(scope="module")
def families():
    """family -> (lxt_tpu pipeline's maps of PROMPTS, port model)."""
    out = {}
    for family in ("llama", "gemma3_text", "gpt2"):
        jm, tm = model_pair(family)
        out[family] = (JPipeline(jm, ToyTokenizer())(PROMPTS), tm)
    return out


@pytest.fixture(scope="module")
def llama_ref():
    """lxt_tpu's top-k maps and responses (greedy, contrastive) on the
    Llama pair, and the port model."""
    jm, tm = model_pair("llama")
    pipe = JPipeline(jm, ToyTokenizer())
    return {"topk": pipe(PROMPTS, topk=3),
            "greedy": pipe.respond(PROMPTS, RESPOND_N),
            "contrastive": pipe.respond(PROMPTS, RESPOND_N, contrastive=True),
            "model": tm}


@pytest.mark.parametrize("family", ["llama", "gemma3_text", "gpt2"])
def test_call_matches_lxt_tpu(families, family):
    want, tm = families[family]
    got = AttributionPipeline(tm, ToyTokenizer())(PROMPTS)
    assert [len(g.tokens) for g in got] == [len(p.split()) for p in PROMPTS]
    assert_same_maps(got, want)


@pytest.mark.parametrize("option", [{"bucket_batch": True}, {"pad_multiple": 4}],
                         ids=["bucket_batch", "pad_multiple_4"])
def test_padding_options_match_lxt_tpu(families, option):
    """Three prompts bucketed to a batch of 4 (a dummy row with kv_begin =
    T), or padded to T 8: the maps of lxt_tpu's unpadded batch."""
    want, tm = families["llama"]
    pipe = AttributionPipeline(tm, ToyTokenizer(), **option)
    ids, kv_begin, _ = pipe._encode(PROMPTS)
    assert ids.shape == ((4, 6) if "bucket_batch" in option else (3, 8))
    assert kv_begin.tolist()[:3] == [ids.shape[1] - len(p.split()) for p in PROMPTS]
    assert_same_maps(pipe(PROMPTS), want)


def test_topk_matches_lxt_tpu(llama_ref, families):
    tm = llama_ref["model"]
    got = AttributionPipeline(tm, ToyTokenizer())(PROMPTS, topk=3)
    single = families["llama"][0]
    assert len(got) == len(PROMPTS)
    for cands, wants, one in zip(got, llama_ref["topk"], single):
        assert len(cands) == 3
        assert_same_maps(cands, wants)
        # candidate 0 explains the argmax: the topk=1 map
        assert _nl2(cands[0].raw_relevance, one.raw_relevance) <= BAR
        vals = [c.value for c in cands]
        assert vals == sorted(vals, reverse=True)


@pytest.mark.parametrize("mode", ["greedy", "contrastive", "greedy_pad_multiple_4"])
def test_respond_matches_lxt_tpu(llama_ref, mode):
    """``pad_multiple=4``: the prompts left-padded to 8, prompt + response
    (11) right-padded to 12 for the maps; lxt_tpu's pad nothing."""
    tm = llama_ref["model"]
    pad = 4 if mode.endswith("_4") else None
    got = AttributionPipeline(tm, ToyTokenizer(), pad_multiple=pad).respond(
        PROMPTS, RESPOND_N, contrastive=mode == "contrastive")
    mode = mode.split("_")[0]
    assert len(got) == len(PROMPTS)
    for g, w in zip(got, llama_ref[mode]):
        assert isinstance(g, ResponseAttribution)
        assert g.prompt_tokens == w.prompt_tokens
        assert g.response_tokens == w.response_tokens
        assert g.response_text == w.response_text
        assert len(g.heatmaps) == len(g.response_tokens)
        assert all(len(h.tokens) == len(g.prompt_tokens) + len(g.response_tokens)
                   for h in g.heatmaps)
        assert_same_maps(g.heatmaps, w.heatmaps)


def test_respond_trims_at_eos(llama_ref):
    """Whatever greedy emits first becomes the eos: the response is trimmed
    to that token, which keeps its map."""
    pipe = AttributionPipeline(llama_ref["model"], ToyTokenizer())
    first = pipe.respond(PROMPTS[:1], 1, eos_token_id=None)[0]
    eos = first.heatmaps[0].target_token_id
    res = pipe.respond(PROMPTS[:1], 5, eos_token_id=eos)[0]
    assert res.response_tokens == first.response_tokens
    assert len(res.heatmaps) == 1 and res.heatmaps[0].target_token_id == eos
    assert res.heatmaps[0].raw_relevance.shape == (len(res.prompt_tokens) + 1,)
    assert _nl2(res.heatmaps[0].raw_relevance, first.heatmaps[0].raw_relevance) <= BAR


def test_sampled_respond_is_seeded(llama_ref):
    """A seed gives the same tokens, another seed other tokens; top_k=1 is
    greedy; the maps explain the sampled tokens."""
    pipe = AttributionPipeline(llama_ref["model"], ToyTokenizer())

    def draw(seed, **kw):
        return pipe.respond(PROMPTS, 5, eos_token_id=None, temperature=1.0,
                            seed=seed, **kw)

    def tokens(results):
        return [r.response_tokens for r in results]

    a = draw(3)
    assert tokens(a) == tokens(draw(3))
    assert tokens(a) != tokens(draw(4))
    greedy = pipe.respond(PROMPTS, 5, eos_token_id=None)
    assert tokens(draw(3, top_k=1)) == tokens(greedy)
    # the maps explain the sampled ids: generate's with the same seeds (one
    # generator a row, seeded from the seed and the row)
    from lxt_tpu_torch.pipeline import _row_seed
    ids, kv_begin, _ = pipe._encode(PROMPTS)
    out = llama_ref["model"].generate(
        ids, 5, kv_begin=kv_begin, temperature=1.0,
        generator=[torch.Generator().manual_seed(_row_seed(3, i))
                   for i in range(len(ids))])
    for i, r in enumerate(a):
        assert [h.target_token_id for h in r.heatmaps] == out[i, ids.shape[1]:].tolist()


def test_pipeline_refusals(llama_ref, tmp_path):
    import torch.distributed as dist

    from lxt_tpu_torch.parallel import make_mesh
    tm = llama_ref["model"]
    # mesh= works (a mesh of one process gives the plain pipeline's maps;
    # tests/test_torch_parallel_serving.py runs dp 2 x tp 2)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        meshed = AttributionPipeline(tm, ToyTokenizer(), mesh=make_mesh())(PROMPTS)
    finally:
        dist.destroy_process_group()
    assert_same_maps(meshed, AttributionPipeline(tm, ToyTokenizer())(PROMPTS), bar=1e-7)
    bert = TModel("bert", None, {"embed": torch.zeros(1)}, lxt_tpu_torch.attnlrp)
    with pytest.raises(NotImplementedError, match="classifier"):
        AttributionPipeline(bert, ToyTokenizer())
    pipe = AttributionPipeline(tm, ToyTokenizer())
    with pytest.raises(ValueError, match="max_new_tokens"):
        pipe.respond(PROMPTS, 0)
    with pytest.raises(ValueError, match="topk"):
        pipe(PROMPTS, topk=0)


def test_pad_multiple_defaults_to_the_kernels_grid_on_cuda(llama_ref):
    """128 for a model on a CUDA device (the flash kernels' sequence grid),
    1 on the CPU."""
    tm = llama_ref["model"]
    assert AttributionPipeline(tm, ToyTokenizer()).pad_multiple == 1

    class OnCuda:
        family, composite, device = "llama", tm.composite, torch.device("cuda")

    pipe = AttributionPipeline(OnCuda(), ToyTokenizer())
    assert pipe.pad_multiple == 128
    ids, kv_begin, _ = pipe._encode(PROMPTS)
    assert ids.shape == (3, 128) and kv_begin.tolist() == [125, 122, 126]


# ---------------------------------------------------------------------------
# length groups
# ---------------------------------------------------------------------------

#: prompts of widely differing lengths (5, 31, 2, 17, 9 words), not sorted
MIXED = [" ".join(f"w{i}x{j}" for j in range(n)) for i, n in enumerate([5, 31, 2, 17, 9])]


def _cost(groups):
    return (sum(size * T for _, T, size in groups)
            + pipeline_mod.GROUP_COST * len(groups))


def _brute_force(lengths, multiple, bucket):
    """The least cost over every split of the sorted lengths into
    contiguous runs."""
    order = np.argsort(lengths, kind="stable")
    best = None
    for cuts in itertools.product([False, True], repeat=len(order) - 1):
        bounds = [0] + [i + 1 for i, c in enumerate(cuts) if c] + [len(order)]
        groups = []
        for i, j in zip(bounds, bounds[1:]):
            T = -(-max(int(lengths[order[j - 1]]), 1) // multiple) * multiple
            groups.append((order[i:j], T, 1 << (j - i - 1).bit_length() if bucket else j - i))
        best = _cost(groups) if best is None else min(best, _cost(groups))
    return best


@pytest.mark.parametrize("bucket", [False, True], ids=["rows", "bucket_batch"])
@pytest.mark.parametrize("multiple", [1, 128])
def test_length_groups_are_the_cheapest_contiguous_split(bucket, multiple):
    """Random batches of 1-8 rows (dummy rows of length 0 among them): the
    dynamic programme's cost is brute force's least; the groups cover every
    row once, in runs of the sorted lengths, each at a multiple of
    ``multiple`` that holds its rows, each of ``size`` its row count (the
    next power of two with ``bucket``)."""
    rng = np.random.default_rng(multiple + bucket)
    for _ in range(60):
        lengths = rng.integers(0 if bucket else 1, 2049, rng.integers(1, 9))
        groups = length_groups(lengths, multiple, bucket)
        assert _cost(groups) == _brute_force(lengths, multiple, bucket)
        rows = np.concatenate([r for r, _, _ in groups])
        assert sorted(rows.tolist()) == list(range(len(lengths)))
        assert list(lengths[rows]) == sorted(lengths)
        for r, T, size in groups:
            assert T % multiple == 0 and T >= lengths[r].max() and T >= 1
            assert size == (1 << (len(r) - 1).bit_length() if bucket else len(r))


def test_one_prompt_is_one_group():
    assert [(r.tolist(), T, n) for r, T, n in length_groups([700], 128)] == [([0], 768, 1)]
    assert [(r.tolist(), T, n) for r, T, n in length_groups([3], 1, True)] == [([0], 3, 1)]


@pytest.mark.parametrize("option", [{}, {"bucket_batch": True}, {"pad_multiple": 4}],
                         ids=["plain", "bucket_batch", "pad_multiple_4"])
def test_the_default_cost_keeps_short_prompts_in_one_group(families, option):
    """The tests' short prompts stay one group at ``GROUP_COST``: the
    model's own run, as before the grouping; so does a mixed batch of
    30 positions."""
    pipe = AttributionPipeline(families["llama"][1], ToyTokenizer(), **option)
    for prompts in (PROMPTS, MIXED):
        ids, kv_begin, _ = pipe._encode(prompts)
        (rows, T, size), = pipe._groups(ids, kv_begin)
        assert sorted(rows.tolist()) == list(range(len(ids))) and (size, T) == ids.shape


@pytest.fixture(scope="module")
def mixed_ref():
    """lxt_tpu's maps of MIXED per family (and Llama's top 3), and the port
    model."""
    out = {}
    for family in ("llama", "gemma3_text", "gpt2"):
        jm, tm = model_pair(family)
        pipe = JPipeline(jm, ToyTokenizer())
        out[family] = (pipe(MIXED), tm)
        if family == "llama":
            out["topk"] = pipe(MIXED, topk=3)
    return out


def _split(monkeypatch):
    """Every length group at no cost: MIXED runs as several groups."""
    monkeypatch.setattr(pipeline_mod, "GROUP_COST", 0)


@pytest.mark.parametrize("family,option", [("llama", {}), ("gemma3_text", {}), ("gpt2", {}),
                                           ("llama", {"bucket_batch": True})],
                         ids=["llama", "gemma3_text", "gpt2", "llama_bucket_batch"])
def test_grouped_maps_match_lxt_tpu(mixed_ref, monkeypatch, family, option):
    """A batch split into length groups: lxt_tpu's maps of the one batch,
    and the port's one-group maps, each prompt's in the caller's order."""
    want, tm = mixed_ref[family]
    pipe = AttributionPipeline(tm, ToyTokenizer(), **option)
    whole = pipe(MIXED)
    _split(monkeypatch)
    ids, kv_begin, _ = pipe._encode(MIXED)
    assert len(pipe._groups(ids, kv_begin)) >= 2
    before = pipeline_mod.counters["groups"]
    got = pipe(MIXED)
    assert pipeline_mod.counters["groups"] - before >= 2
    assert [len(g.tokens) for g in got] == [len(p.split()) for p in MIXED]
    assert_same_maps(got, want)
    for g, w in zip(got, whole):
        assert g.tokens == w.tokens
        assert _nl2(g.raw_relevance, w.raw_relevance) <= BAR
    assert _nl2([g.value for g in got], [w.value for w in whole]) <= BAR


def test_grouped_topk_matches_lxt_tpu(mixed_ref, monkeypatch):
    _split(monkeypatch)
    got = AttributionPipeline(mixed_ref["llama"][1], ToyTokenizer())(MIXED, topk=3)
    assert len(got) == len(MIXED)
    for cands, wants in zip(got, mixed_ref["topk"]):
        assert len(cands) == 3
        assert_same_maps(cands, wants)


def test_a_grouped_call_records_one_row_of_explained_tokens(mixed_ref, monkeypatch):
    """The benchmark wraps ``AttributionModel._row`` (``Explained``): a
    split call still builds one row and so records one ``[B]`` argmax, in
    the caller's order, each prompt's token as when it runs alone."""
    from bench_port.harness.state import Explained

    pipe = AttributionPipeline(mixed_ref["llama"][1], ToyTokenizer())
    alone = []
    for p in MIXED:
        with Explained() as ex:
            pipe([p])
        (tok,) = ex.tokens
        alone.append(int(tok[0]))
    _split(monkeypatch)
    with Explained() as ex:
        pipe(MIXED)
    (tokens,) = ex.tokens
    assert tokens.tolist() == alone
