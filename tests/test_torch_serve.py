"""lxt_tpu_torch.serve on CPU: micro-batch coalescing, grouping, errors, the
stdlib HTTP frontend (400 / 503 / 504, top-k, respond), the JSON of both
routes against lxt_tpu.serve's on the same weights, and the CLI's
build_server on a checkpoint the test writes.

The server tests compare with the port's own pipeline, which
tests/test_torch_pipeline.py holds to lxt_tpu's; only the JSON test builds
lxt_tpu's pipeline (once per module).
"""

import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import lxt_tpu_torch
from lxt_tpu.pipeline import AttributionPipeline as JPipeline
from lxt_tpu.serve import _result_json as jax_result_json
from lxt_tpu_torch.pipeline import AttributionPipeline, ResponseAttribution
from lxt_tpu_torch.serve import (AttributionServer, PromptTooLongError,
                                 ServerOverloadedError, _parse_args,
                                 build_server, http_server)
from test_torch_pipeline import ToyTokenizer, model_pair

PROMPTS = ["alpha beta gamma", "one two three four", "x y", "p q r s t"]


@pytest.fixture(scope="module")
def pair():
    """(lxt_tpu model, port model) of the tiny Llama, float32."""
    return model_pair("llama")


@pytest.fixture
def pipe(pair):
    return AttributionPipeline(pair[1], ToyTokenizer())


@contextlib.contextmanager
def serving(server, **kw):
    """``http_server`` over ``server`` on a free port, in a thread; yields
    the port, then shuts both down."""
    httpd = http_server(server, **kw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(timeout=30)
        assert not thread.is_alive()


def post(port, path, body):
    """(status, JSON reply) of one POST."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


def assert_same_heatmap(got, want, atol=1e-5):
    assert got.tokens == want.tokens
    np.testing.assert_allclose(got.raw_relevance, want.raw_relevance, rtol=0, atol=atol)
    np.testing.assert_allclose(got.value, want.value, rtol=1e-6)


class SlowPipe:
    """A pipeline that blocks until ``release`` is set."""

    def __init__(self, pipe, release):
        self.pipe, self.release = pipe, release
        self.tokenizer = pipe.tokenizer

    def __call__(self, prompts, composite=None):
        self.release.wait(timeout=60)
        return self.pipe(prompts, composite=composite)


def test_server_coalesces_and_matches_pipeline(pipe):
    direct = pipe(PROMPTS)
    server = AttributionServer(pipe, max_batch=4, max_wait_ms=200.0)
    try:
        results = [f.result(timeout=120) for f in [server.submit(p) for p in PROMPTS]]
    finally:
        server.close()
    for d, r in zip(direct, results):
        assert_same_heatmap(r, d)
    # all four arrived within the wait window: coalesced into one batch
    assert server.requests_served == 4
    assert max(server.batch_sizes) > 1


def test_server_groups_by_composite(pipe):
    server = AttributionServer(pipe, max_batch=4, max_wait_ms=200.0)
    try:
        f1 = server.submit("alpha beta", composite=lxt_tpu_torch.attnlrp)
        f2 = server.submit("alpha beta", composite=lxt_tpu_torch.cp_lrp)
        r1, r2 = f1.result(timeout=120), f2.result(timeout=120)
    finally:
        server.close()
    # one drain, two groups: the same forward value, other rules
    assert list(server.batch_sizes) == [2]
    np.testing.assert_allclose(r1.value, r2.value, rtol=1e-6)
    assert not np.allclose(r1.raw_relevance, r2.raw_relevance)
    assert_same_heatmap(r2, pipe(["alpha beta"], composite=lxt_tpu_torch.cp_lrp)[0])


def test_server_propagates_errors():
    class Boom(Exception):
        pass

    def broken(prompts, composite=None):
        raise Boom("kaput")

    server = AttributionServer(broken, max_batch=2, max_wait_ms=10.0)
    try:
        with pytest.raises(Boom, match="kaput"):
            server.submit("alpha").result(timeout=60)
        # the worker survives and serves the next request's error too
        with pytest.raises(Boom):
            server.submit("beta").result(timeout=60)
    finally:
        server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit("gamma")


def test_rejections_are_counted_under_contention():
    """Handler threads reject concurrently; no rejection goes uncounted."""
    server = AttributionServer(lambda prompts, composite=None: [], max_topk=1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def hammer():
        for _ in range(200):
            with pytest.raises(ValueError, match="topk"):
                server.submit("a", topk=2)

    threads = [threading.Thread(target=hammer) for _ in range(32)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        server.close()
    assert server.requests_rejected == 32 * 200


def test_http_roundtrip(pipe):
    # a burst of concurrent clients fits the listen backlog, and no reply
    # waits on Nagle's algorithm
    server = AttributionServer(pipe, max_batch=4, max_wait_ms=50.0)
    httpd = http_server(server)
    assert httpd.request_queue_size >= 128
    assert httpd.RequestHandlerClass.disable_nagle_algorithm
    httpd.server_close()
    with serving(server) as port:
        code, out = post(port, "/v1/attribute", {"prompts": PROMPTS[:2]})
        assert code == 200 and len(out["heatmaps"]) == 2
        for hm_json, hm in zip(out["heatmaps"], pipe(PROMPTS[:2])):
            assert hm_json["tokens"] == hm.tokens
            np.testing.assert_allclose(hm_json["relevance"], hm.relevance,
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(hm_json["value"], hm.value, rtol=1e-6)
        health = get(port, "/healthz")
        assert health["ok"] and health["served"] == 2 and health["batches"]
        for bad in ({"prompts": "alpha"}, {"nothing": 1}, [1, 2]):
            assert post(port, "/v1/attribute", bad)[0] == 400
        assert post(port, "/v1/other", {"prompt": "a"})[0] == 404


def test_overload_returns_503_and_prompt_guard_400(pipe):
    release = threading.Event()
    server = AttributionServer(SlowPipe(pipe, release), max_batch=1,
                               max_wait_ms=1.0, max_queue=2, max_prompt_tokens=4)
    try:
        with serving(server) as port:
            # the worker takes the first request and blocks; two fill the queue
            first = server.submit("a b")
            deadline = time.monotonic() + 30
            while server._queue.qsize() and time.monotonic() < deadline:
                time.sleep(0.01)
            fills = [server.submit("a b") for _ in range(2)]
            with pytest.raises(ServerOverloadedError):
                server.submit("a b")
            assert post(port, "/v1/attribute", {"prompt": "a b"})[0] == 503
            with pytest.raises(PromptTooLongError):
                server.submit("w x y z q")
            assert post(port, "/v1/attribute", {"prompt": "w x y z q"})[0] == 400
            release.set()
            for f in [first, *fills]:
                assert f.result(timeout=120).tokens == pipe(["a b"])[0].tokens
            assert get(port, "/healthz")["rejected"] == 4
    finally:
        release.set()


def test_http_request_timeout_504(pipe):
    release = threading.Event()
    server = AttributionServer(SlowPipe(pipe, release), max_batch=1, max_wait_ms=1.0)
    try:
        with serving(server, request_timeout_s=0.5) as port:
            code, out = post(port, "/v1/attribute", {"prompt": "a b"})
            assert code == 504 and "timed out" in out["error"]
            release.set()
    finally:
        release.set()


def test_server_tokenizes_each_prompt_once(pair):
    class CountingTokenizer(ToyTokenizer):
        calls = 0

        def __call__(self, text):
            type(self).calls += 1
            return super().__call__(text)

    pipe = AttributionPipeline(pair[1], CountingTokenizer())
    direct = pipe(["alpha beta gamma"])
    CountingTokenizer.calls = 0
    server = AttributionServer(pipe, max_batch=2, max_wait_ms=50.0)
    try:
        hm = server.submit("alpha beta gamma").result(timeout=120)
    finally:
        server.close()
    assert CountingTokenizer.calls == 1
    assert_same_heatmap(hm, direct[0])


def test_topk_in_server_and_over_http(pipe):
    single = pipe(PROMPTS[:1])[0]
    # a topk and a topk=1 request coalesce into one drain but group apart
    server = AttributionServer(pipe, max_batch=4, max_wait_ms=200.0, max_topk=4)
    try:
        f1, f3 = server.submit(PROMPTS[0]), server.submit(PROMPTS[0], topk=3)
        r1, r3 = f1.result(timeout=120), f3.result(timeout=120)
        with pytest.raises(ValueError, match="topk"):
            server.submit("alpha", topk=5)
    finally:
        server.close()
    assert_same_heatmap(r1, single)
    assert isinstance(r3, list) and len(r3) == 3
    assert_same_heatmap(r3[0], single)

    server = AttributionServer(pipe, max_batch=2, max_wait_ms=10.0, max_topk=4)
    with serving(server) as port:
        code, payload = post(port, "/v1/attribute", {"prompt": "alpha beta", "topk": 2})
        (cands,) = payload["heatmaps"]
        assert code == 200 and isinstance(cands, list) and len(cands) == 2
        assert {"tokens", "relevance", "value", "target_token",
                "target_token_id"} <= set(cands[0])
        assert cands[0]["value"] >= cands[1]["value"]
        assert post(port, "/v1/attribute", {"prompt": "alpha", "topk": 99})[0] == 400


def test_respond_in_server_and_over_http(pipe):
    server = AttributionServer(pipe, max_batch=4, max_wait_ms=50.0,
                               max_respond_tokens=8)
    with serving(server) as port:
        res = server.attribute("alpha beta gamma", respond_tokens=2)
        assert isinstance(res, ResponseAttribution)
        assert len(res.heatmaps) == len(res.response_tokens) == 2
        want = pipe.respond(["alpha beta gamma"], 2)[0]
        assert res.response_tokens == want.response_tokens
        code, payload = post(port, "/v1/respond",
                             {"prompt": "alpha beta gamma", "max_new_tokens": 2})
        (resp,) = payload["responses"]
        assert code == 200 and resp["response_tokens"] == res.response_tokens
        np.testing.assert_allclose(resp["heatmaps"][0]["relevance"],
                                   res.heatmaps[0].relevance, atol=1e-6)
        # the same seed samples the same tokens
        body = {"prompt": "alpha beta", "max_new_tokens": 4, "temperature": 1.0,
                "seed": 5}
        a, b = post(port, "/v1/respond", body)[1], post(port, "/v1/respond", body)[1]
        assert a["responses"][0]["response_tokens"] == b["responses"][0]["response_tokens"]
        # guards: missing max_new_tokens, over the cap, topk conflict
        for bad in ({"prompt": "x"}, {"prompt": "x", "max_new_tokens": 99},
                    {"prompt": "x", "max_new_tokens": 2, "topk": 3}):
            assert post(port, "/v1/respond", bad)[0] == 400, bad
        with pytest.raises(ValueError, match="temperature"):
            server.submit("alpha", temperature=1.0)


@pytest.fixture(scope="module")
def jax_json(pair):
    """lxt_tpu.serve's JSON of lxt_tpu's pipeline output: two prompts
    attributed in one batch, their top-2 maps, one response of 2 tokens."""
    jpipe = JPipeline(pair[0], ToyTokenizer())
    return {"attribute": [jax_result_json(h) for h in jpipe(PROMPTS[:2])],
            "topk": [jax_result_json(h) for h in jpipe(PROMPTS[:2], topk=2)],
            "respond": [jax_result_json(r) for r in jpipe.respond(PROMPTS[:1], 2)]}


def assert_same_json(got, want, path="$"):
    """The same keys, nesting and strings; numbers within 1e-5."""
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, path
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_same_json(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_json(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-5, (path, got, want)
    else:
        assert got == want, path


def test_json_matches_lxt_tpu_serve(pair, jax_json):
    server = AttributionServer(AttributionPipeline(pair[1], ToyTokenizer()),
                               max_batch=4, max_wait_ms=200.0)
    with serving(server) as port:
        got = {"attribute": post(port, "/v1/attribute", {"prompts": PROMPTS[:2]}),
               "topk": post(port, "/v1/attribute", {"prompts": PROMPTS[:2], "topk": 2}),
               "respond": post(port, "/v1/respond",
                               {"prompt": PROMPTS[0], "max_new_tokens": 2})}
    for route, key in (("attribute", "heatmaps"), ("topk", "heatmaps"),
                       ("respond", "responses")):
        code, payload = got[route]
        assert code == 200 and list(payload) == [key]
        assert_same_json(payload[key], jax_json[route], route)


def test_cli_build_server_serves_a_checkpoint(tmp_path):
    """python -m lxt_tpu_torch.serve's assembly: a checkpoint directory
    (written here: a tiny HF Llama and a WordLevel tokenizer) ->
    from_pretrained on the CPU -> pipeline -> server, answering HTTP."""
    import torch
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast
    from transformers.models.llama.modeling_llama import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(2)
    LlamaForCausalLM(LlamaConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
        max_position_embeddings=128)).save_pretrained(tmp_path)
    tok = Tokenizer(models.WordLevel({f"w{i}": i for i in range(256)}, unk_token="w0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="w1",
                            pad_token="w0").save_pretrained(tmp_path)

    args = _parse_args(["--model", str(tmp_path), "--device", "cpu", "--dtype",
                        "float32", "--max-batch", "2", "--max-prompt-tokens", "64",
                        "--max-respond-tokens", "8"])
    server = build_server(args)
    assert server.pipeline.model.device.type == "cpu"
    assert server.pipeline.pad_multiple == 1
    with serving(server) as port:
        code, out = post(port, "/v1/attribute", {"prompt": "w3 w4 w5"})
        (hm,) = out["heatmaps"]
        assert code == 200 and hm["tokens"] == ["w3", "w4", "w5"]
        assert np.isfinite(hm["relevance"]).all()
        code, out = post(port, "/v1/respond", {"prompt": "w3 w4 w5",
                                               "max_new_tokens": 2})
        assert code == 200 and 1 <= len(out["responses"][0]["heatmaps"]) <= 2

    # --data-parallel 2 works: rank 0 here, one spawned rank, the same map
    dp = build_server(_parse_args(["--model", str(tmp_path), "--device", "cpu",
                                   "--dtype", "float32", "--data-parallel", "2"]))
    with serving(dp) as port:
        code, out = post(port, "/v1/attribute", {"prompt": "w3 w4 w5"})
    assert code == 200 and out["heatmaps"][0]["tokens"] == hm["tokens"]
    np.testing.assert_allclose(out["heatmaps"][0]["relevance"], hm["relevance"],
                               rtol=0, atol=1e-4)
    help_text = subprocess.run([sys.executable, "-m", "lxt_tpu_torch.serve", "--help"],
                               capture_output=True, text=True, timeout=120, check=True,
                               cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert "--device" in help_text.stdout and "--bits" in help_text.stdout
