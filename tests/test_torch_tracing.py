"""lxt_tpu_torch.tracing: the spans' totals, their nesting per thread, their
events in a torch.profiler trace, and the sites that open them (the
pipeline, the layer loop with and without remat, the mixture), on tiny
float32 models on the CPU; and ``pipeline.counters``' padded and useful
positions and length groups."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from lxt_tpu_torch import attnlrp, tracing
from lxt_tpu_torch import pipeline as pipeline_mod
from lxt_tpu_torch.models import common, llama, mixtral
from lxt_tpu_torch.models.registry import AttributionModel
from lxt_tpu_torch.pipeline import AttributionPipeline
from lxt_tpu_torch.serve import AttributionServer, http_server

VOCAB = 64


class Ids:
    """Prompts come as token ids; a string is split into its words' lengths."""
    pad_token_id = 0

    def __call__(self, text):
        return {"input_ids": [2 + len(w) for w in text.split()]}


def _tiny(family, remat=False, layers=2):
    g = torch.Generator().manual_seed(0)
    if family == "llama":
        cfg = llama.LlamaConfig(vocab_size=VOCAB, hidden_size=32, intermediate_size=64,
                                num_layers=layers, num_heads=4, num_kv_heads=2)
        params = llama.init_params(cfg, g)
    else:
        cfg = mixtral.MixtralConfig(vocab_size=VOCAB, hidden_size=32, intermediate_size=48,
                                    num_layers=layers, num_heads=4, num_kv_heads=2,
                                    num_experts=4, experts_per_token=2)
        params = mixtral.init_params(cfg, g)
    return AttributionModel(family, cfg, params, attnlrp, remat=remat)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, VOCAB, n).tolist() for n in lengths]


def _delta(before):
    return {k: v - before[k] for k, v in tracing.spans.items()}


def test_every_key_exists_at_zero_after_reset_and_a_delta_never_meets_a_new_key():
    assert set(tracing.spans) == {f"{n}.{k}" for n in tracing.NAMES
                                  for k in ("n", "ns", "self_ns")}
    tracing.reset()
    assert set(tracing.spans.values()) == {0}
    before = dict(tracing.spans)
    with tracing.span("lxt.moe.read"):
        pass
    delta = {k: tracing.spans[k] - before[k] for k in tracing.spans}
    assert delta["lxt.moe.read.n"] == 1 and set(delta) == set(before)


def test_an_unknown_name_raises():
    with pytest.raises(KeyError, match="no span"):
        tracing.span("lxt.nothing")


def test_nesting_gives_each_span_its_self_time():
    before = dict(tracing.spans)
    with tracing.span("lxt.layer"):
        time.sleep(0.02)
        with tracing.span("lxt.moe"):
            time.sleep(0.03)
            with tracing.span("lxt.moe.read"):
                time.sleep(0.01)
    d = _delta(before)
    assert d["lxt.layer.n"] == d["lxt.moe.n"] == d["lxt.moe.read.n"] == 1
    assert d["lxt.moe.read.self_ns"] == d["lxt.moe.read.ns"]
    assert d["lxt.moe.self_ns"] == d["lxt.moe.ns"] - d["lxt.moe.read.ns"]
    assert d["lxt.layer.self_ns"] == d["lxt.layer.ns"] - d["lxt.moe.ns"]
    for name, ms in (("lxt.layer", 20), ("lxt.moe", 30), ("lxt.moe.read", 10)):
        assert d[f"{name}.self_ns"] >= ms * 1e6, name
    assert d["lxt.layer.self_ns"] < d["lxt.layer.ns"] - 40e6


def test_spans_nest_per_thread():
    """A span on another thread is no child of this thread's open span."""
    before = dict(tracing.spans)

    def other():
        with tracing.span("lxt.moe"):
            time.sleep(0.02)

    with tracing.span("lxt.layer"):
        t = threading.Thread(target=other)
        t.start()
        t.join()
    d = _delta(before)
    assert d["lxt.layer.self_ns"] == d["lxt.layer.ns"] >= 0.02e9


def test_checkpointed_layers_open_the_forward_and_the_recompute_spans():
    L = 3
    w = torch.randn(8, 8, dtype=torch.float64) / 4

    def layer(h, i):
        return torch.tanh(h @ w) + h

    for remat, recomputes in ((True, L), (False, 0)):
        h0 = torch.randn(2, 8, dtype=torch.float64, requires_grad=True)
        before = dict(tracing.spans)
        h, _ = common.run_layers(layer, h0, L, remat)
        assert _delta(before)["lxt.layer.n"] == L
        assert _delta(before)["lxt.layer.recompute.n"] == 0
        h.sum().backward()
        d = _delta(before)
        assert (d["lxt.layer.n"], d["lxt.layer.recompute.n"]) == (L, recomputes)


def test_spans_are_profiler_events_inside_an_outer_span_and_none_without_one(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    class Counted(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    model = _tiny("llama", remat=True)
    pipe = AttributionPipeline(model, Ids())
    prompts = _prompts([5, 9])
    pipe(prompts)
    assert entered == []           # no profiler: not one record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            pipe(prompts)
    events = list(prof.events())
    (outer,) = [e for e in events if e.name == "outer"]
    spans = [e for e in events if e.name.startswith("lxt.")]
    names = sorted(e.name for e in spans)
    assert names == sorted(["lxt.pipeline.encode", "lxt.pipeline.finish"]
                           + ["lxt.layer"] * 2 + ["lxt.layer.recompute"] * 2)
    assert sorted(entered) == names
    forward = [e for e in spans if e.name != "lxt.layer.recompute"]
    for e in forward:
        assert outer.time_range.start <= e.time_range.start <= e.time_range.end \
            <= outer.time_range.end, e.name
    by_name = {e.name: e for e in spans}
    assert any(e.name.startswith("aten::") for e in by_name["lxt.layer"].cpu_children)


def test_heatmaps_are_bit_identical_with_and_without_a_profiler():
    pipe = AttributionPipeline(_tiny("mixtral", remat=True), Ids())
    prompts = _prompts([4, 11, 7], seed=3)
    plain = pipe(prompts)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = pipe(prompts)
    for a, b in zip(plain, traced):
        assert a.tokens == b.tokens and a.value == b.value
        np.testing.assert_array_equal(a.raw_relevance, b.raw_relevance)


@pytest.mark.parametrize("bucket_batch,pad_multiple", [(False, 1), (True, 8)])
def test_the_pipeline_counts_padded_and_useful_positions(bucket_batch, pad_multiple):
    pipe = AttributionPipeline(_tiny("llama"), Ids(), pad_multiple=pad_multiple,
                               bucket_batch=bucket_batch)
    lengths = [3, 10, 6]
    before = dict(pipeline_mod.counters)
    spans_before = dict(tracing.spans)
    pipe(_prompts(lengths))
    T = -(-max(lengths) // pad_multiple) * pad_multiple
    B = 4 if bucket_batch else 3
    assert pipeline_mod.counters["positions"] - before["positions"] == B * T
    assert pipeline_mod.counters["useful_positions"] - before["useful_positions"] == 19
    assert pipeline_mod.counters["groups"] - before["groups"] == 1
    d = _delta(spans_before)
    assert d["lxt.pipeline.encode.n"] == d["lxt.pipeline.finish.n"] == 1
    assert d["lxt.layer.n"] == 2 and d["lxt.layer.recompute.n"] == 0
    pipeline_mod.reset_counters()
    assert pipeline_mod.counters == {"positions": 0, "useful_positions": 0, "groups": 0}


@pytest.mark.parametrize("bucket_batch,pad_multiple", [(False, 1), (True, 8)])
def test_a_split_call_counts_each_group_at_its_own_length(monkeypatch, bucket_batch,
                                                          pad_multiple):
    """With groups at no cost the call splits: ``positions`` counts Σ rows ×
    length over its groups (dummy rows included), ``groups`` the groups, and
    each group runs the layer loop once."""
    monkeypatch.setattr(pipeline_mod, "GROUP_COST", 0)
    pipe = AttributionPipeline(_tiny("llama"), Ids(), pad_multiple=pad_multiple,
                               bucket_batch=bucket_batch)
    lengths = [3, 10, 6]
    ids, kv_begin, _ = pipe._encode(_prompts(lengths))
    groups = pipe._groups(ids, kv_begin)
    assert len(groups) >= 2
    before = dict(pipeline_mod.counters)
    spans_before = dict(tracing.spans)
    pipe(_prompts(lengths))
    d = {k: pipeline_mod.counters[k] - before[k] for k in before}
    assert d["positions"] == sum(size * T for _, T, size in groups) < ids.size
    if not bucket_batch:
        assert d["positions"] == 19 and d["groups"] == 3
    assert d["groups"] == len(groups) and d["useful_positions"] == 19
    assert _delta(spans_before)["lxt.layer.n"] == 2 * len(groups)


def test_mixture_reads_move_with_the_routing_counter():
    model = _tiny("mixtral", remat=True, layers=3)
    pipe = AttributionPipeline(model, Ids())
    reads = mixtral.routing["host_reads"]
    before = dict(tracing.spans)
    pipe(_prompts([6, 9], seed=1))
    d = _delta(before)
    reads = mixtral.routing["host_reads"] - reads
    assert reads == 6                          # forward and recompute, 3 layers
    assert d["lxt.moe.read.n"] == d["lxt.moe.n"] == reads
    assert d["lxt.layer.n"] == d["lxt.layer.recompute.n"] == 3
    # the read is the mixture's child, the mixture the layer's
    assert d["lxt.moe.self_ns"] == d["lxt.moe.ns"] - d["lxt.moe.read.ns"]
    assert (d["lxt.layer.self_ns"] + d["lxt.layer.recompute.self_ns"]
            == d["lxt.layer.ns"] + d["lxt.layer.recompute.ns"] - d["lxt.moe.ns"])


def test_healthz_returns_the_span_totals_and_the_pipeline_counters():
    server = AttributionServer(AttributionPipeline(_tiny("llama"), Ids()),
                               max_batch=4, max_wait_ms=1.0)
    httpd = http_server(server)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        req = urllib.request.Request(
            f"{base}/v1/attribute", data=json.dumps({"prompt": "ab c def"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert len(json.loads(r.read())["heatmaps"]) == 1
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(timeout=30)
    assert health["ok"] and health["served"] == 1
    assert set(health["spans"]) == set(tracing.spans)
    assert health["spans"]["lxt.pipeline.encode.n"] >= 1
    assert health["spans"]["lxt.layer.n"] >= 2
    assert health["pipeline"]["useful_positions"] >= 3
    assert health["pipeline"]["positions"] >= health["pipeline"]["useful_positions"]
