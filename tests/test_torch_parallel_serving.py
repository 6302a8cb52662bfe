"""The mesh entry points of lxt_tpu_torch against lxt_tpu's, on CPU:
``AttributionPipeline(mesh=)`` and ``python -m lxt_tpu_torch.serve
--data-parallel``.

- ``AttributionPipeline(mesh=make_mesh(data=2, model=2))`` on four spawned
  gloo ranks (``tests/_torch_ranks.py``): ``__call__`` (three prompts, the
  batch rounded up to four with a fully padded row), ``topk=3`` and
  ``respond`` (greedy, two tokens) against lxt_tpu's pipeline on
  ``make_mesh(data=4, model=2)`` over the 8 virtual CPU devices, on the same
  weights (the tiny Llama of tests/test_torch_pipeline.py): tokens and
  targets equal, values rtol 1e-5, relevance atol 1e-4 (respond 2e-4, as
  tests/test_respond.py);
- a seeded sampled ``respond`` (temperature 1, top_k 20; three prompts, so
  the batch gains a dummy row) under the mesh gives the tokens of the
  port's pipeline on one process: each row draws from a generator of its
  own, seeded from the seed and the row;
- ``build_server`` with ``--data-parallel 2 --device cpu`` on a checkpoint
  and tokenizer the test writes: this process is rank 0 and one rank is
  spawned; ``/v1/attribute`` and ``/v1/respond`` answer with the maps of
  the single-process server, and closing the server ends the spawned rank
  and gathers both ranks' launch counts; a killed rank stops the server
  with an error (no fallback to fewer ranks); a call that raises on every
  rank fails with a 500 and the next calls are answered (the ranks agree on
  each call's outcome and stay in step), and a top_k past the vocabulary is
  a 400; ``serve.main`` with ``--data-parallel 2``, when this rank alone
  fails after a call was sent (the spawned rank is left in the call's
  gather), answers 500 once the ranks are found out of step, stops its
  HTTP server and exits with the error.

jax is imported inside the test functions only: each spawned rank imports
this module.
"""

import contextlib
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

import lxt_tpu_torch
from lxt_tpu_torch.convert import params_from_numpy
from lxt_tpu_torch.models import llama as tllama
from lxt_tpu_torch.models.registry import AttributionModel as TModel
from lxt_tpu_torch.parallel import make_mesh
from lxt_tpu_torch.pipeline import AttributionPipeline
from tests._torch_ranks import spawn

VAL_RTOL, REL_ATOL, RESPOND_ATOL = 1e-5, 1e-4, 2e-4
VOCAB = 128
PROMPTS = ["alpha beta gamma", "one two three four five six", "x y"]
RESPOND_PROMPTS = PROMPTS + ["p q r s"]
SAMPLED = dict(eos_token_id=None, temperature=1.0, top_k=20, seed=7)


class ToyTokenizer:
    """Whitespace words -> ids by crc32 (stable across processes); 0 pads,
    1 ends a sequence (tests/test_torch_pipeline.py's)."""

    pad_token_id = 0
    eos_token_id = 1

    def __call__(self, text):
        return {"input_ids": [2 + zlib.crc32(w.encode()) % (VOCAB - 2)
                              for w in text.split()]}

    def convert_ids_to_tokens(self, ids):
        return [f"▁t{int(i)}" for i in ids]

    def decode(self, ids):
        return " ".join(self.convert_ids_to_tokens(ids))


def _maps(heatmaps):
    return [(h.tokens, h.target_token_id, float(h.value), h.raw_relevance)
            for h in heatmaps]


def _pipeline_rank(rank, world, cfg_kw, params_np):
    model = TModel("llama", tllama.LlamaConfig(**cfg_kw),
                   params_from_numpy(params_np, device="cpu"), lxt_tpu_torch.attnlrp)
    pipe = AttributionPipeline(model, ToyTokenizer(), mesh=make_mesh(data=2, model=2))
    # the model dimension keeps this process's shards of the weights
    assert pipe.model.params["layers"]["wq"].shape[-1] == model.params["layers"]["wq"].shape[-1] // 2
    return {"call": _maps(pipe(PROMPTS)),
            "topk": [_maps(c) for c in pipe(PROMPTS, topk=3)],
            "respond": [(r.response_tokens, _maps(r.heatmaps)) for r in
                        pipe.respond(RESPOND_PROMPTS, 2, eos_token_id=None)],
            "sampled": [r.response_tokens for r in pipe.respond(PROMPTS, 4, **SAMPLED)]}


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """(lxt_tpu's mesh pipeline results, the port's from rank 0)."""
    import jax
    from lxt_tpu.models import llama as jllama
    from lxt_tpu.models.registry import AttributionModel as JModel
    from lxt_tpu.models.registry import _family_table
    from lxt_tpu.parallel import make_mesh as jmesh
    from lxt_tpu.pipeline import AttributionPipeline as JPipeline
    import lxt_tpu
    cfg = jllama.LlamaConfig(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
                             num_layers=2, num_heads=4, num_kv_heads=2, rms_eps=1e-6)
    params = jax.tree.map(np.asarray, jllama.init_params(cfg, jax.random.PRNGKey(0)))
    jm = JModel("llama", cfg, jax.tree.map(jax.numpy.asarray, params),
                lxt_tpu.attnlrp, _family_table()["llama"])
    jpipe = JPipeline(jm, ToyTokenizer(), mesh=jmesh(data=4, model=2))
    want = {"call": _maps(jpipe(PROMPTS)),
            "topk": [_maps(c) for c in jpipe(PROMPTS, topk=3)],
            "respond": [(r.response_tokens, _maps(r.heatmaps)) for r in
                        jpipe.respond(RESPOND_PROMPTS, 2, eos_token_id=None)]}
    got = spawn(_pipeline_rank, 4, tmp_path_factory.mktemp("pipe"),
                dataclasses.asdict(cfg), params)
    one = AttributionPipeline(
        TModel("llama", tllama.LlamaConfig(**dataclasses.asdict(cfg)),
               params_from_numpy(params, device="cpu"), lxt_tpu_torch.attnlrp),
        ToyTokenizer())
    want["sampled_one_process"] = [r.response_tokens
                                   for r in one.respond(PROMPTS, 4, **SAMPLED)]
    return want, got


def _same(got, want, atol):
    assert len(got) == len(want)
    for (gt, gid, gv, gr), (wt, wid, wv, wr) in zip(got, want):
        assert gt == wt and gid == wid
        np.testing.assert_allclose(gv, wv, rtol=VAL_RTOL)
        np.testing.assert_allclose(gr, wr, rtol=0, atol=atol)


def test_mesh_pipeline_call_matches_lxt_tpu(pipelines):
    want, got = pipelines
    assert len(got["call"]) == len(PROMPTS)     # the dummy row is dropped
    _same(got["call"], want["call"], REL_ATOL)


def test_mesh_pipeline_topk_matches_lxt_tpu(pipelines):
    want, got = pipelines
    for g, w in zip(got["topk"], want["topk"], strict=True):
        _same(g, w, REL_ATOL)


def test_mesh_pipeline_respond_matches_lxt_tpu(pipelines):
    want, got = pipelines
    for (gtok, g), (wtok, w) in zip(got["respond"], want["respond"], strict=True):
        assert gtok == wtok
        _same(g, w, RESPOND_ATOL)


def test_mesh_pipeline_sampled_respond_matches_one_process(pipelines):
    """A seed gives the same tokens on dp 2 x tp 2 as on one process (the
    batch of three rounded up to four does not move the seeds)."""
    want, got = pipelines
    assert len(got["sampled"]) == len(PROMPTS)
    assert got["sampled"] == want["sampled_one_process"]
    assert got["sampled"] != [r[0] for r in got["respond"][:3]]   # not greedy


# ---------------------------------------------------------------------------
# serve --data-parallel
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _serving(server):
    from lxt_tpu_torch.serve import http_server
    httpd = http_server(server, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(timeout=30)


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _checkpoint(path):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast
    from transformers.models.llama.modeling_llama import LlamaConfig, LlamaForCausalLM
    torch.manual_seed(2)
    LlamaForCausalLM(LlamaConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
        max_position_embeddings=128)).save_pretrained(path)
    tok = Tokenizer(models.WordLevel({f"w{i}": i for i in range(256)}, unk_token="w0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="w1",
                            pad_token="w0").save_pretrained(path)


def _answers(server):
    with _serving(server) as port:
        return (_post(port, "/v1/attribute",
                      {"prompts": ["w3 w4 w5", "w9 w8", "w7 w6 w5 w4"]}),
                _post(port, "/v1/respond", {"prompts": ["w3 w4 w5", "w9 w8"],
                                            "max_new_tokens": 2}))


def test_serve_data_parallel_matches_the_single_process_server(tmp_path):
    import torch.distributed as dist

    from lxt_tpu_torch.serve import DataParallelPipeline, _parse_args, build_server
    _checkpoint(tmp_path)
    argv = ["--model", str(tmp_path), "--device", "cpu", "--dtype", "float32",
            "--max-batch", "4", "--max-prompt-tokens", "64",
            "--max-respond-tokens", "8"]
    want = _answers(build_server(_parse_args(argv)))
    server = build_server(_parse_args(argv + ["--data-parallel", "2"]))
    pipeline = server.pipeline
    assert isinstance(pipeline, DataParallelPipeline)
    assert dist.get_world_size() == 2 and pipeline.mesh is not None
    got = _answers(server)
    assert [p.exitcode for p in pipeline.procs] == [0]   # stopped by close()
    assert len(pipeline.rank_launches) == 2
    assert not dist.is_initialized()
    for (gcode, g), (wcode, w) in zip(got, want):
        assert gcode == wcode == 200 and list(g) == list(w)
        key = next(iter(w))
        for a, b in zip(g[key], w[key], strict=True):
            maps_a = a.get("heatmaps", [a]) if key == "responses" else [a]
            maps_b = b.get("heatmaps", [b]) if key == "responses" else [b]
            for ha, hb in zip(maps_a, maps_b, strict=True):
                assert ha["tokens"] == hb["tokens"]
                assert ha.get("target_token_id") == hb.get("target_token_id")
                np.testing.assert_allclose(ha["value"], hb["value"], rtol=VAL_RTOL)
                np.testing.assert_allclose(ha["relevance"], hb["relevance"],
                                           rtol=0, atol=REL_ATOL)


def test_serve_data_parallel_stops_when_a_rank_dies(tmp_path):
    """No fallback to fewer ranks: once the spawned rank is killed, every
    call fails with the rank's exit, the failure callbacks run (the CLI's
    stops the HTTP server), and closing does not hang."""
    import time
    import urllib.error

    import torch.distributed as dist

    from lxt_tpu_torch.serve import _parse_args, build_server
    _checkpoint(tmp_path)
    server = build_server(_parse_args(["--model", str(tmp_path), "--device", "cpu",
                                       "--dtype", "float32", "--data-parallel", "2"]))
    pipeline = server.pipeline
    stopped = []
    pipeline.on_failure.append(lambda: stopped.append(True))
    (rank1,) = pipeline.procs
    rank1.kill()
    rank1.join(30)
    deadline = time.monotonic() + 30
    while not stopped and time.monotonic() < deadline:
        time.sleep(0.1)
    assert stopped and "exited" in pipeline.failure
    with _serving(server) as port:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, "/v1/attribute", {"prompt": "w3 w4 w5"})
    assert err.value.code == 500
    assert "exited" in json.loads(err.value.read())["error"]
    assert not dist.is_initialized()


def test_serve_data_parallel_survives_a_call_that_fails_on_every_rank(tmp_path):
    """A top_k past the vocabulary is a 400. A call that raises on every
    rank (the same top_k sent to the pipeline itself) raises on rank 0, and
    the ranks, having agreed on the outcome, answer the next requests."""
    from lxt_tpu_torch.serve import _parse_args, build_server
    _checkpoint(tmp_path)
    server = build_server(_parse_args([
        "--model", str(tmp_path), "--device", "cpu", "--dtype", "float32",
        "--data-parallel", "2", "--max-respond-tokens", "8"]))
    pipeline = server.pipeline
    with _serving(server) as port:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, "/v1/respond", {"prompt": "w3 w4", "max_new_tokens": 2,
                                        "temperature": 1.0, "top_k": 10 ** 6})
        assert err.value.code == 400
        assert "top_k must be in [1, 256]" in json.loads(err.value.read())["error"]
        with pytest.raises(ValueError, match="top_k must be in"):
            pipeline.respond(["w3 w4", "w5"], 2, temperature=1.0, top_k=10 ** 6)
        code, body = _post(port, "/v1/attribute", {"prompts": ["w3 w4 w5", "w9 w8"]})
        assert code == 200 and len(body["heatmaps"]) == 2
        code, body = _post(port, "/v1/respond", {
            "prompts": ["w3 w4 w5", "w9 w8"], "max_new_tokens": 2,
            "temperature": 1.0, "top_k": 5, "seed": 3})
        assert code == 200 and [len(r["response_tokens"]) for r in body["responses"]] == [2, 2]
    assert pipeline.failure is None
    assert [p.exitcode for p in pipeline.procs] == [0]   # stopped by close()


def test_serve_main_stops_when_the_ranks_fall_out_of_step(tmp_path, monkeypatch):
    """``serve.main`` with ``--data-parallel 2``: this process (rank 0)
    alone fails after the call was sent, so the spawned rank stays blocked
    in the call's gather. Rank 0 waits ``RANK_TIMEOUT_S`` (5 s here) for the
    other's outcome, answers 500, stops the HTTP server, terminates the rank and
    exits with the error."""
    import torch.distributed as dist

    from lxt_tpu_torch import serve
    _checkpoint(tmp_path)

    def fail_on_rank_0(self, *a, **kw):
        raise RuntimeError("injected on rank 0")

    # the spawned rank imports the pipeline afresh: only rank 0 fails
    monkeypatch.setattr(AttributionPipeline, "_attribute", fail_on_rank_0)
    monkeypatch.setattr(serve, "RANK_TIMEOUT_S", 5.0)
    port = serve._free_port()
    ended = {}

    def run():
        try:
            serve.main(["--model", str(tmp_path), "--device", "cpu",
                        "--dtype", "float32", "--port", str(port),
                        "--data-parallel", "2"])
        except SystemExit as e:
            ended["exit"] = str(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    deadline = time.monotonic() + 120
    while True:
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5).close()
            break
        except (urllib.error.URLError, ConnectionError):
            assert time.monotonic() < deadline and thread.is_alive()
            time.sleep(0.2)
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(port, "/v1/attribute", {"prompt": "w3 w4 w5"})
    assert err.value.code == 500
    assert "out of step" in json.loads(err.value.read())["error"]
    thread.join(60)
    assert not thread.is_alive()
    assert ended["exit"].startswith("error: data-parallel ranks out of step")
    assert "injected on rank 0" in ended["exit"]
    assert not dist.is_initialized()
