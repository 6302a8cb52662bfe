"""Attribution serving: continuous micro-batching and a minimal HTTP endpoint
(counterpart of ``lxt_tpu/serve.py``).

One attribution over a batch costs barely more device time than over one
prompt, so a server that groups concurrent requests into one
:class:`~lxt_tpu_torch.pipeline.AttributionPipeline` call multiplies
heatmap throughput by the batch size.

Two pieces, composable:

- :class:`AttributionServer`: a worker thread pulls requests from a queue
  and coalesces them (up to ``max_batch``, waiting at most ``max_wait_ms``
  after the first arrival) into single pipeline calls. Requests carrying
  different composites, ``topk`` or respond settings are grouped apart
  within a drain. Results resolve ``concurrent.futures.Future``s, so any
  frontend (HTTP, notebook threads) can sit on top. The worker thread runs
  all device work; it relies on no grad mode of the caller's thread (torch
  keeps those per thread): the pipeline enters the modes it needs.
- :func:`http_server`: a stdlib-only JSON-over-HTTP frontend
  (``POST /v1/attribute``, ``POST /v1/respond``, ``GET /healthz``).
  Handler threads block on futures while the single worker keeps the
  device busy.

The pipeline pads prompts to a shared length (``pad_multiple``, 128 on a
CUDA device), so mixed-length batches stay on the flash kernels.

    python -m lxt_tpu_torch.serve --model <checkpoint dir> [--device cuda]

``--data-parallel N`` starts N ranks (this process is rank 0, the others
are spawned, each on ``cuda:{rank % device_count}``; NCCL when every rank
has a card of its own, else gloo). Rank 0 runs the HTTP frontend and the
worker; for each coalesced call its pipeline first sends the call to the
other ranks (``broadcast_object_list``), which make the same call, and the
mesh pipeline splits the batch over the ranks and gathers the maps. Every
rank ends each call by posting its outcome to the group's store and reading
the others': a call that raised on any rank fails (a 500) and the ranks go
on in step. Closing the server sends the others a stop message. A rank that
dies, or a call that does not end on every rank within
:data:`RANK_TIMEOUT_S` (the ranks are out of step), stops the server with
an error; it never carries on with fewer ranks.
"""

import collections
import concurrent.futures
import dataclasses
import json
import queue
import threading
import time
from typing import Optional

from lxt_tpu_torch import tracing
from lxt_tpu_torch.pipeline import (AttributionPipeline, Heatmap,
                                    ResponseAttribution)
from lxt_tpu_torch.pipeline import counters as pipeline_counters


@dataclasses.dataclass
class _Request:
    prompt: str
    composite: Optional[object]
    future: "concurrent.futures.Future"
    # token ids from submit()'s length guard, reused by the pipeline so the
    # hot path tokenizes each prompt once, not twice
    ids: Optional[list] = None
    # explain the k most likely next tokens (k>1: the Future resolves to a
    # LIST of Heatmaps, all k sharing one forward pass)
    topk: int = 1
    # generate-and-explain: emit up to this many tokens and resolve the
    # Future to a ResponseAttribution (one Heatmap per generated token)
    respond_tokens: Optional[int] = None
    # sampling controls for respond (0.0 = greedy); requests sharing the
    # same (temperature, top_k, seed) coalesce into one decode batch
    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: int = 0
    # respond maps explain the margin over the strongest rival token
    contrastive: bool = False


class ServerOverloadedError(RuntimeError):
    """The request queue is full: shed load (HTTP 503)."""


class PromptTooLongError(ValueError):
    """The prompt exceeds ``max_prompt_tokens`` (HTTP 400): an unbounded
    prompt length would otherwise take unbounded device memory."""


class AttributionServer:
    """Micro-batching front of an :class:`AttributionPipeline`.

    ``max_batch``: largest coalesced batch. ``max_wait_ms``: how long the
    worker holds the FIRST request of a batch waiting for company; the
    latency cost of batching is bounded by this. ``max_queue``: pending
    requests beyond this are rejected with :class:`ServerOverloadedError`
    (backpressure instead of unbounded handler-thread pileup).
    ``max_prompt_tokens``: prompts tokenizing past this raise
    :class:`PromptTooLongError` at submit time. ``max_topk``: cap on the
    per-request ``topk`` (each candidate is one more pull of the graph).
    ``max_respond_tokens``: cap on per-request ``respond_tokens`` (each
    token is one more decode step and one more pull).
    """

    def __init__(self, pipeline: AttributionPipeline, max_batch: int = 8,
                 max_wait_ms: float = 10.0, max_queue: int = 256,
                 max_prompt_tokens: int = 4096, max_topk: int = 32,
                 max_respond_tokens: int = 256):
        self.pipeline = pipeline
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_prompt_tokens = int(max_prompt_tokens)
        self.max_topk = int(max_topk)
        self.max_respond_tokens = int(max_respond_tokens)
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(
            maxsize=int(max_queue))
        # bounded: a long-running server must not leak one int per batch
        self.batch_sizes = collections.deque(maxlen=1024)
        self.requests_served = 0
        self.requests_rejected = 0
        self._closed = False
        self._submit_lock = threading.Lock()
        # handler threads reject concurrently: the count's read-modify-write
        self._rejected_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="lxt-attribution-worker")
        self._worker.start()

    # -- client side --------------------------------------------------------

    def _reject(self, error):
        with self._rejected_lock:
            self.requests_rejected += 1
        return error

    def submit(self, prompt: str, composite=None, topk: int = 1,
               respond_tokens: Optional[int] = None,
               temperature: float = 0.0, top_k: Optional[int] = None,
               seed: int = 0,
               contrastive: bool = False) -> "concurrent.futures.Future":
        """Enqueue one prompt; the Future resolves to a :class:`Heatmap`
        (with ``topk>1``, a list of the k candidate Heatmaps; with
        ``respond_tokens``, a :class:`ResponseAttribution`: the
        continuation plus one map per generated token).

        Raises :class:`PromptTooLongError`, :class:`ServerOverloadedError`
        (queue full) or ``ValueError`` (``topk`` out of ``[1, max_topk]``,
        ``respond_tokens`` out of ``[1, max_respond_tokens]``, both given,
        a ``temperature`` without ``respond_tokens``, or ``top_k`` out of
        ``[1, vocabulary size]``) without enqueuing.
        """
        topk = int(topk)
        if not 1 <= topk <= self.max_topk:
            raise self._reject(ValueError(
                f"topk must be in [1, {self.max_topk}], got {topk}"))
        if respond_tokens is not None:
            respond_tokens = int(respond_tokens)
            if topk != 1:
                raise self._reject(ValueError(
                    "topk and respond_tokens are exclusive"))
            if not 1 <= respond_tokens <= self.max_respond_tokens:
                raise self._reject(ValueError(
                    f"respond_tokens must be in [1, "
                    f"{self.max_respond_tokens}], got {respond_tokens}"))
        temperature = float(temperature)
        if temperature < 0 or (temperature > 0 and respond_tokens is None):
            raise self._reject(ValueError(
                "temperature needs respond_tokens and must be >= 0"))
        if top_k is not None:
            top_k, vocab = int(top_k), self._vocab_size()
            if top_k < 1 or (vocab is not None and top_k > vocab):
                raise self._reject(ValueError(
                    f"top_k must be in [1, {vocab or 'vocab size'}], got "
                    f"{top_k}"))
        tokenizer = getattr(self.pipeline, "tokenizer", None)
        ids = None
        if tokenizer is not None:   # bare-callable pipelines skip the guard
            enc = tokenizer(prompt)["input_ids"]
            if len(enc) > self.max_prompt_tokens:
                raise self._reject(PromptTooLongError(
                    f"prompt is {len(enc)} tokens; server limit is "
                    f"{self.max_prompt_tokens}"))
            if isinstance(self.pipeline, AttributionPipeline):
                ids = enc   # reuse: _encode accepts pre-tokenized lists
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        # lock so no request can land BEHIND the shutdown sentinel (it
        # would never resolve); close() takes the same lock
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("AttributionServer is closed")
            try:
                self._queue.put_nowait(
                    _Request(prompt, composite, fut, ids, topk,
                             respond_tokens, temperature, top_k, int(seed),
                             bool(contrastive)))
            except queue.Full:
                raise self._reject(ServerOverloadedError(
                    f"request queue full ({self._queue.maxsize} pending)"
                )) from None
        return fut

    def _vocab_size(self):
        """The model's vocabulary size (None for a bare-callable
        pipeline)."""
        cfg = getattr(getattr(self.pipeline, "model", None), "cfg", None)
        return getattr(cfg, "vocab_size", None)

    def attribute(self, prompt: str, composite=None, topk: int = 1,
                  respond_tokens: Optional[int] = None, **kw):
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(prompt, composite, topk=topk,
                           respond_tokens=respond_tokens, **kw).result()

    def close(self):
        """Reject new submissions; the worker exits after in-flight work
        (then the ``--data-parallel`` ranks are stopped)."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._worker.join()
        if isinstance(self.pipeline, DataParallelPipeline):
            self.pipeline.close()

    # -- worker side --------------------------------------------------------

    def _drain(self):
        """Block for one request, then coalesce arrivals until the batch is
        full or ``max_wait_s`` after the first. Returns [] on shutdown."""
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                req = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if req is None:
                self._queue.put(None)   # re-post shutdown for the outer loop
                break
            batch.append(req)
        return batch

    @staticmethod
    def _resolve(fut, result=None, error=None):
        """Resolve a future, tolerating client-side cancellation (a
        set_result on a CANCELLED future raises InvalidStateError and
        would otherwise kill the worker)."""
        if not fut.set_running_or_notify_cancel():
            return False
        if error is not None:
            fut.set_exception(error)
            return False
        fut.set_result(result)
        return True

    def _process(self, batch):
        # one pipeline call per distinct (composite, topk, respond,
        # sampling) in the drain (Composites are hashable frozen
        # dataclasses; None = default)
        groups = {}
        for req in batch:
            groups.setdefault(
                (req.composite, req.topk, req.respond_tokens,
                 req.temperature, req.top_k, req.seed,
                 req.contrastive), []).append(req)
        for (composite, topk, respond_tokens, temperature, top_k,
             seed, contrastive), reqs in groups.items():
            try:
                prompts = [r.prompt if r.ids is None else r.ids
                           for r in reqs]
                if respond_tokens is not None:
                    heatmaps = self.pipeline.respond(
                        prompts, respond_tokens, composite=composite,
                        temperature=temperature, top_k=top_k, seed=seed,
                        contrastive=contrastive)
                else:
                    kw = {"topk": topk} if topk > 1 else {}
                    heatmaps = self.pipeline(prompts, composite=composite,
                                             **kw)
                if len(heatmaps) != len(reqs):
                    raise RuntimeError(
                        f"pipeline returned {len(heatmaps)} heatmaps for "
                        f"{len(reqs)} prompts")
            except Exception as e:  # noqa: BLE001 — propagate to callers
                for r in reqs:
                    self._resolve(r.future, error=e)
                continue
            for r, hm in zip(reqs, heatmaps):
                if self._resolve(r.future, hm):
                    self.requests_served += 1

    def _run(self):
        while True:
            batch = self._drain()
            if not batch:
                return
            self.batch_sizes.append(len(batch))
            try:
                self._process(batch)
            except Exception as e:  # noqa: BLE001 — the worker must survive
                for r in batch:
                    if not r.future.done():
                        self._resolve(r.future, error=e)


# ---------------------------------------------------------------------------
# HTTP frontend (stdlib only)
# ---------------------------------------------------------------------------

def _heatmap_json(hm: Heatmap):
    out = {
        "tokens": list(hm.tokens),
        "relevance": [float(x) for x in hm.relevance],
        "value": hm.value,
    }
    if hm.target_token_id is not None:
        out["target_token"] = hm.target_token
        out["target_token_id"] = hm.target_token_id
    return out


def _result_json(res):
    """A Heatmap, (topk>1) the list of candidate Heatmaps, or
    (respond) a ResponseAttribution."""
    if isinstance(res, Heatmap):
        return _heatmap_json(res)
    if isinstance(res, ResponseAttribution):
        return {
            "response": res.response_text,
            "response_tokens": list(res.response_tokens),
            "prompt_tokens": list(res.prompt_tokens),
            "heatmaps": [_heatmap_json(h) for h in res.heatmaps],
        }
    return [_heatmap_json(h) for h in res]


def http_server(server: AttributionServer, host: str = "127.0.0.1",
                port: int = 0, request_timeout_s: Optional[float] = None):
    """Build a ``ThreadingHTTPServer`` frontend for ``server``.

    Routes:
      - ``POST /v1/attribute`` body ``{"prompt": str}`` or
        ``{"prompts": [str, ...]}`` (optional ``"topk": k``: each entry of
        ``heatmaps`` becomes the LIST of k candidate maps, each tagged with
        its ``target_token``) -> ``{"heatmaps": [...]}``. Prompts in one
        request are submitted individually, so they coalesce with OTHER
        concurrent requests too. 400 on over-long prompts or bad ``topk``,
        503 when the queue is full, 504 when ``request_timeout_s`` elapses
        first.
      - ``POST /v1/respond`` body ``{"prompt": str, "max_new_tokens": N}``
        (or ``"prompts"``; optional ``"temperature"`` / ``"top_k"`` /
        ``"seed"`` / ``"contrastive"``: temperature 0 is greedy, > 0
        samples) -> ``{"responses": [{"response": str, "response_tokens":
        [...], "prompt_tokens": [...], "heatmaps": [...]}]}``: the
        continuation plus one heatmap per generated token (trimmed at eos).
        Same 400/503/504 semantics; ``max_new_tokens`` is capped by
        ``max_respond_tokens``.
      - ``GET /healthz`` -> ``{"ok": true, "served": N, "rejected": N,
        "batches": [...], "spans": {...}, "pipeline": {...}}``: the last 32
        coalesced batch sizes, the totals of the program's spans
        (``tracing.spans``) and the pipeline's padded and useful positions
        (``pipeline.counters``), all since the process started.

    Returns the ``http.server.ThreadingHTTPServer`` (call
    ``serve_forever()``, typically in a thread, then ``shutdown()`` and
    ``server_close()``). Port 0 picks a free port
    (``httpd.server_address[1]``).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        # TCP_NODELAY: the headers and the body go out in two writes, and
        # Nagle's algorithm would hold the body for the client's delayed ACK
        disable_nagle_algorithm = True

        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {
                    "ok": True,
                    "served": server.requests_served,
                    "rejected": server.requests_rejected,
                    "batches": list(server.batch_sizes)[-32:],
                    "spans": dict(tracing.spans),
                    "pipeline": dict(pipeline_counters),
                })
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path not in ("/v1/attribute", "/v1/respond"):
                self._reply(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
                prompts = req.get("prompts")
                if prompts is None:
                    prompts = [req["prompt"]]
                if (not isinstance(prompts, list)
                        or not all(isinstance(p, str) for p in prompts)):
                    raise ValueError("'prompts' must be a list of strings")
                topk = int(req.get("topk", 1))
                respond_tokens = None
                sample_kw = {}
                if self.path == "/v1/respond":
                    respond_tokens = int(req["max_new_tokens"])
                    sample_kw = {
                        "temperature": float(req.get("temperature", 0.0)),
                        "top_k": (int(req["top_k"]) if "top_k" in req
                                  else None),
                        "seed": int(req.get("seed", 0)),
                        "contrastive": bool(req.get("contrastive", False)),
                    }
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            futures = []
            try:
                for p in prompts:
                    futures.append(server.submit(
                        p, topk=topk, respond_tokens=respond_tokens,
                        **sample_kw))
            except (PromptTooLongError, ValueError) as e:
                self._reply(400, {"error": str(e)})
                return
            except ServerOverloadedError as e:
                self._reply(503, {"error": str(e)})
                return
            finally:
                if len(futures) != len(prompts):   # partial submit: cancel
                    for f in futures:
                        f.cancel()
            try:
                # one deadline for the whole request, not per future: a
                # multi-prompt body must 504 after timeout_s total, not N x
                deadline = (None if request_timeout_s is None
                            else time.monotonic() + request_timeout_s)
                heatmaps = [
                    f.result(timeout=(None if deadline is None
                                      else max(0.0,
                                               deadline - time.monotonic())))
                    for f in futures]
            except concurrent.futures.TimeoutError:
                for f in futures:
                    f.cancel()
                self._reply(504, {"error": "attribution timed out after "
                                           f"{request_timeout_s}s"})
                return
            except Exception as e:  # noqa: BLE001 — surface as 500
                self._reply(500, {"error": str(e)})
                return
            payload = [_result_json(h) for h in heatmaps]
            key = ("responses" if self.path == "/v1/respond"
                   else "heatmaps")
            self._reply(200, {key: payload})

        def log_message(self, *args):  # quiet (observability via /healthz)
            pass

    class Server(ThreadingHTTPServer):
        # the listen backlog (socketserver's default is 5): connections of a
        # burst of concurrent clients beyond it are dropped and retried by
        # the client a second later
        request_queue_size = 128

    return Server((host, port), Handler)


# ---------------------------------------------------------------------------
# --data-parallel: the ranks behind rank 0's pipeline
# ---------------------------------------------------------------------------

class DataParallelPipeline(AttributionPipeline):
    """Rank 0's pipeline under ``--data-parallel``: each call is first sent
    to the other ranks (``procs``, which loop in :func:`_follow`), then made
    here, and every rank ends it with :func:`_agree`; the mesh pipeline does
    the rest. A call that raised on some rank raises here (a 500), and the
    ranks go on in step. A rank that exited, or ranks out of step, stop the
    pipeline: ``failure`` says why, every later call raises, and the
    ``on_failure`` callbacks run (the CLI's stops the HTTP server). A
    watchdog thread notices an exited rank between calls. :meth:`close`
    collects every rank's kernel launch counts into ``rank_launches``."""

    def __init__(self, model, tokenizer, mesh, procs, store):
        super().__init__(model, tokenizer, mesh=mesh)
        self.procs = procs
        self.failure = None
        self.on_failure = []
        self.rank_launches = None
        self._store = store
        self._calls = 0
        self._closing = threading.Event()
        self._failure_lock = threading.Lock()
        threading.Thread(target=self._watch, daemon=True,
                         name="lxt-rank-watchdog").start()

    def _dead(self):
        return [(r + 1, p.exitcode) for r, p in enumerate(self.procs)
                if not p.is_alive()]

    def _fail(self, why):
        with self._failure_lock:
            if self.failure is not None:
                return
            self.failure = f"{why}; the server stops"
        for fn in self.on_failure:
            fn()

    def _watch(self):
        while not self._closing.wait(0.5):
            dead = self._dead()
            if dead:
                self._fail(f"data-parallel ranks exited (rank, exit code): "
                           f"{dead}")
                return

    def _call(self, name, *a, **kw):
        """Make the call ``name`` on every rank, then agree on its outcome."""
        import torch.distributed as dist
        dead = self._dead()
        if dead:
            self._fail(f"data-parallel ranks exited (rank, exit code): {dead}")
        if self.failure is not None:
            raise RuntimeError(self.failure)
        world = dist.get_world_size()
        dist.broadcast_object_list([(name, a, kw)], src=0)
        n, self._calls = self._calls, self._calls + 1
        out = error = None
        try:
            out = getattr(AttributionPipeline, name)(self, *a, **kw)
        except Exception as e:  # noqa: BLE001 — agreed on below
            error = e
        try:
            failed = _agree(self._store, n, 0, world,
                            None if error is None
                            else f"{type(error).__name__}: {error}",
                            RANK_TIMEOUT_S, self._dead)
        except RuntimeError as e:
            self._fail(str(e))
            raise RuntimeError(self.failure) from error
        if n:   # every rank has read call n - 1's outcomes
            for r in range(world):
                self._store.delete_key(_agree_key(n - 1, r))
        if error is not None:
            raise error
        if failed:
            r = min(failed)
            raise RuntimeError(f"data-parallel rank {r} failed: {failed[r]}")
        return out

    def __call__(self, prompts, composite=None, topk: int = 1):
        return self._call("__call__", prompts, composite=composite, topk=topk)

    def respond(self, prompts, max_new_tokens: int, **kw):
        return self._call("respond", prompts, max_new_tokens, **kw)

    def close(self):
        """Stop the other ranks and leave the process group (after a
        failure, the ranks left are terminated)."""
        import torch.distributed as dist
        if self._closing.is_set():
            return
        self._closing.set()
        if self.failure is None and not self._dead():
            dist.broadcast_object_list([None], src=0)
            counts = [None] * dist.get_world_size()
            dist.gather_object(_launches(), counts, dst=0)
            self.rank_launches = counts
        # leave the group before waiting: the other ranks' teardown may wait
        # for this one's
        dist.destroy_process_group()
        for p in self.procs:
            p.join(60 if self.failure is None else 0)
            if p.is_alive():
                p.terminate()
                p.join(10)


#: ``--data-parallel``: seconds a rank that ended a call waits for the
#: others to end it; past it the ranks are out of step (one is blocked in a
#: collective that a failed rank left) and the server stops
RANK_TIMEOUT_S = 300.0


def _agree_key(n, rank):
    return f"lxt/call/{n}/{rank}"


def _agree(store, n, rank, world, error, timeout_s, dead=lambda: []):
    """The step that ends call ``n`` of ``--data-parallel`` on every rank:
    each rank posts its outcome (``error``: None, or the text of the
    exception it raised) to the group's store and reads every rank's.
    Returns ``{rank: error}`` of the ranks that failed (empty: the call
    succeeded everywhere). When every rank posts, none is blocked in a
    collective, so the ranks are in step for the next call. Raises
    ``RuntimeError`` when ``dead()`` names an exited rank, or when a rank
    has not posted within ``timeout_s``: it is then blocked in a collective
    that a failed rank left, and the ranks are out of step."""
    store.set(_agree_key(n, rank), "ok" if error is None else f"!{error}")
    keys = [_agree_key(n, r) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    while not store.check(keys):
        exited = dead()
        if exited:
            raise RuntimeError(f"data-parallel ranks exited (rank, exit "
                               f"code): {exited}")
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"data-parallel ranks out of step: call {n} did not end on "
                f"every rank within {timeout_s} s of rank {rank}'s end"
                + ("" if error is None else f" (rank {rank}: {error})"))
        time.sleep(0.002)
    outcomes = [store.get(k).decode() for k in keys]
    return {r: o[1:] for r, o in enumerate(outcomes) if o != "ok"}


def _launches():
    """This process's kernel launch counts (the flash kernels, the rotation
    pass and K3)."""
    from lxt_tpu_torch.ops import flash_attention, quant
    return {**flash_attention.launches, **quant.launches}


def _rank_device(device, rank):
    import torch
    if device != "cuda":
        return device
    return f"cuda:{rank % torch.cuda.device_count()}"


def _backend(device, world):
    import torch
    if device == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _load(args, device, tokenizer=None):
    """``(model, tokenizer)`` of the checkpoint, the model on ``device``;
    ``tokenizer()`` makes the tokenizer (default: transformers'
    AutoTokenizer of the checkpoint)."""
    import torch

    import lxt_tpu_torch
    from lxt_tpu_torch.models.registry import from_pretrained

    composite = {"attnlrp": lxt_tpu_torch.attnlrp,
                 "cp_lrp": lxt_tpu_torch.cp_lrp, None: None}[args.composite]
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.dtype]
    model = from_pretrained(args.model, composite=composite, dtype=dtype,
                            quantize_bits=args.bits, device=device)
    if tokenizer is None:
        from transformers import AutoTokenizer
        return model, AutoTokenizer.from_pretrained(args.model)
    return model, tokenizer()


def _follow(rank, world, port, arg_dict, tokenizer=None):
    """Rank ``rank`` > 0 of ``--data-parallel``: load the model, then make
    each call rank 0 sends and agree on its outcome (:func:`_agree`), until
    the stop message. A call that raised here is reported to rank 0;
    ranks out of step end this process with an error."""
    import argparse

    import torch
    import torch.distributed as dist

    from lxt_tpu_torch.parallel import make_mesh

    args = argparse.Namespace(**arg_dict)
    args.device = getattr(args, "device", "cuda")
    device = _rank_device(args.device, rank)
    if device.startswith("cuda"):
        torch.cuda.set_device(device)
    store = dist.TCPStore("127.0.0.1", port, world, is_master=False)
    dist.init_process_group(_backend(args.device, world), store=store,
                            rank=rank, world_size=world)
    try:
        pipeline = AttributionPipeline(*_load(args, device, tokenizer),
                                       mesh=make_mesh(data=world))
        n = 0
        while True:
            call = [None]
            dist.broadcast_object_list(call, src=0)
            if call[0] is None:
                break
            name, a, kw = call[0]
            error = None
            try:
                getattr(pipeline, name)(*a, **kw)
            except Exception as e:  # noqa: BLE001 — reported to rank 0
                error = f"{type(e).__name__}: {e}"
            _agree(store, n, rank, world, error, RANK_TIMEOUT_S)
            n += 1
        dist.gather_object(_launches(), None, dst=0)
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _data_parallel_pipeline(args, tokenizer=None):
    """Start ranks 1..N-1, join them as rank 0 and return rank 0's
    :class:`DataParallelPipeline`."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from lxt_tpu_torch.parallel import make_mesh

    world = int(args.data_parallel)
    args.device = getattr(args, "device", "cuda")
    if dist.is_initialized():
        raise RuntimeError("--data-parallel starts its own process group; "
                           "this process already has one")
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_follow,
                         args=(r, world, port, vars(args), tokenizer),
                         daemon=True) for r in range(1, world)]
    for p in procs:
        p.start()
    device = _rank_device(args.device, 0)
    if device.startswith("cuda"):
        torch.cuda.set_device(device)
    # the group's store also carries the agreement that ends each call
    store = dist.TCPStore("127.0.0.1", port, world, is_master=True)
    dist.init_process_group(_backend(args.device, world), store=store,
                            rank=0, world_size=world)
    model, tok = _load(args, device, tokenizer)
    return DataParallelPipeline(model, tok, make_mesh(data=world), procs,
                                store)


# ---------------------------------------------------------------------------
# CLI: python -m lxt_tpu_torch.serve --model <hf checkpoint dir>
# ---------------------------------------------------------------------------

def build_server(args, tokenizer=None) -> AttributionServer:
    """Checkpoint directory -> ready :class:`AttributionServer` (its
    tokenizer and pipeline are reachable as ``server.pipeline``). Split
    from :func:`main` so deployments (and tests) can wire their own
    frontend. ``args.data_parallel > 1`` starts the other ranks (see the
    module docstring); :meth:`AttributionServer.close` stops them.
    ``tokenizer``: a picklable callable that makes the tokenizer, on every
    rank (default: transformers' AutoTokenizer of the checkpoint)."""
    if getattr(args, "data_parallel", 1) > 1:
        pipeline = _data_parallel_pipeline(args, tokenizer)
    else:
        pipeline = AttributionPipeline(*_load(args, getattr(args, "device", "cuda"),
                                              tokenizer))
    return AttributionServer(pipeline, max_batch=args.max_batch,
                             max_wait_ms=args.max_wait_ms,
                             max_queue=args.max_queue,
                             max_prompt_tokens=args.max_prompt_tokens,
                             max_respond_tokens=args.max_respond_tokens)


def _parse_args(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m lxt_tpu_torch.serve",
        description="Serve AttnLRP attributions over HTTP (continuous "
                    "micro-batching on a CUDA device).")
    ap.add_argument("--model", required=True,
                    help="HF checkpoint directory (config.json + safetensors "
                         "+ tokenizer files)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default cuda)")
    ap.add_argument("--composite", choices=["attnlrp", "cp_lrp"], default=None)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--bits", type=int, choices=[4, 8], default=None,
                    help="weight-only quantization (fit big models on one card)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--max-queue", type=int, default=256,
                    help="pending-request bound; beyond it requests get 503")
    ap.add_argument("--max-prompt-tokens", type=int, default=4096,
                    help="reject longer prompts with 400")
    ap.add_argument("--max-respond-tokens", type=int, default=256,
                    help="cap /v1/respond max_new_tokens")
    ap.add_argument("--request-timeout-s", type=float, default=None,
                    help="per-request deadline; 504 when exceeded")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="split request batches over this many ranks (one "
                         "process each, on cuda:{rank %% device_count})")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse_args(argv)
    server = build_server(args)
    httpd = http_server(server, args.host, args.port,
                        request_timeout_s=args.request_timeout_s)
    pipeline = server.pipeline
    if isinstance(pipeline, DataParallelPipeline):
        pipeline.on_failure.append(
            lambda: threading.Thread(target=httpd.shutdown, daemon=True).start())
    print(f"lxt_tpu_torch attribution server on "
          f"http://{args.host}:{httpd.server_address[1]} "
          f"(POST /v1/attribute, POST /v1/respond, GET /healthz)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()   # release the listening socket
        server.close()
    failure = getattr(pipeline, "failure", None)
    if failure is not None:
        raise SystemExit(f"error: {failure}")


if __name__ == "__main__":
    main()
