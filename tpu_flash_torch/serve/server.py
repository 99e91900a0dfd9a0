"""OpenAI-style HTTP serving on top of the port's :class:`InferenceEngine`.

The port of ``tpu_flash/serve/server.py``. Stdlib-only (``http.server``
plus threads): the engine is single-threaded by design, so exactly one
worker thread drives ``engine.step()`` and owns all engine state, while
HTTP handler threads only exchange messages with it through queues. The
endpoint shapes follow the OpenAI completions convention so existing
clients can point at it.

Endpoints
---------
``POST /v1/completions``
    ``{"prompt": [token ids] | "text", "max_tokens": N, "temperature",
    "top_k", "top_p", "min_p", "n", "stop": [ids], "stream": bool,
    "logit_bias": {"<token id>": bias}, "lora": "<adapter>",
    "priority": int}``. With ``stream: true`` the response is SSE
    (``data: {...}`` per step, ``data: [DONE]`` at the end). Text prompts
    need a tokenizer (see :class:`ByteTokenizer`); token-id prompts work
    without one. A request the engine refuses (a prompt the page pool can
    never hold, an unknown adapter, a bias token outside the vocabulary)
    gets a 400; an engine step that fails answers every waiting client
    with a 500.
``GET /v1/models``   -- the served model's name.
``GET /health``      -- engine metrics summary plus prefix-cache stats.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from tpu_flash_torch.engine.sampling import SamplingParams


class ByteTokenizer:
    """UTF-8 byte-level codec for demos/tests: token = byte value + offset
    (ids below ``offset`` stay reserved for specials)."""

    def __init__(self, offset: int = 3):
        self.offset = offset
        self.vocab_size = 256 + offset

    def encode(self, text: str) -> List[int]:
        return [b + self.offset for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        lo, hi = self.offset, self.offset + 256
        data = bytes(i - lo for i in ids if lo <= i < hi)
        return data.decode("utf-8", errors="replace")


@dataclasses.dataclass
class _Submission:
    prompt: List[int]
    max_tokens: int
    sampling: SamplingParams
    stop: List[int]
    n: int
    priority: int
    lora: Optional[str]
    logit_bias: Optional[Dict[int, float]]
    out: "queue.Queue"  # events: ("tokens", rid, [tok]) / ("done", info)
    stream: bool


class EngineServer:
    """Drives one engine from a worker thread; thread-safe ``submit``.

    Events pushed to a submission's queue:
      ("accepted", req_id)
      ("tokens", completion_index, [new tokens])     (streaming only)
      ("done", {"choices": [...], "usage": {...}})
      ("error", message, internal)   internal=True -> HTTP 500, else 400
    """

    def __init__(self, engine, tokenizer=None,
                 model_name: str = "tpu-flash-torch"):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.inbox: "queue.Queue[_Submission]" = queue.Queue()
        self.cancels: "queue.Queue[int]" = queue.Queue()
        self._stop = False
        self._error: Optional[str] = None
        # req_id (root) -> submission bookkeeping; worker-thread-only.
        self._live: Dict[int, dict] = {}
        self._worker = threading.Thread(
            target=self._loop, name="engine-worker", daemon=True
        )
        self._worker.start()

    # -- worker thread ---------------------------------------------------------

    def _loop(self):
        while not self._stop:
            self._drain_cancels()
            self._drain_inbox(block=not self.engine.scheduler.has_work())
            if self._stop:
                return
            if not self.engine.scheduler.has_work():
                continue
            try:
                self.engine.step()
            except Exception as e:  # surface to every waiting client
                msg = f"{type(e).__name__}: {e}"
                for st in self._live.values():
                    st["q"].put(("error", msg, True))
                self._live.clear()
                self._error = msg  # fail fast on future submits
                self._stop = True
                # Anything enqueued concurrently must still get a reply —
                # handlers block on their queue.
                while True:
                    try:
                        sub = self.inbox.get_nowait()
                    except queue.Empty:
                        return
                    sub.out.put(("error", msg, True))
            self._publish()

    def _drain_inbox(self, block: bool):
        try:
            sub = (
                self.inbox.get(timeout=0.05) if block
                else self.inbox.get_nowait()
            )
        except queue.Empty:
            return
        while True:
            try:
                rid = self.engine.submit(
                    sub.prompt,
                    max_new_tokens=sub.max_tokens,
                    sampling=sub.sampling,
                    stop_tokens=sub.stop,
                    n=sub.n,
                    priority=sub.priority,
                    lora=sub.lora,
                    logit_bias=sub.logit_bias,
                )
                sub.out.put(("accepted", rid))
                self._live[rid] = {
                    "q": sub.out,
                    "stream": sub.stream,
                    "stop": set(sub.stop),
                    "max_tokens": sub.max_tokens,
                    "prompt_len": len(sub.prompt),
                    "seen": {},  # completion rid -> tokens published
                }
            except Exception as e:
                sub.out.put(("error", f"{type(e).__name__}: {e}", False))
            try:
                sub = self.inbox.get_nowait()
            except queue.Empty:
                return

    def _drain_cancels(self):
        while True:
            try:
                rid = self.cancels.get_nowait()
            except queue.Empty:
                return
            self.engine.cancel(rid)
            st = self._live.pop(rid, None)
            if st is not None:
                st["q"].put(("error", "cancelled", False))

    def _publish(self):
        eng = self.engine
        waiting_ids = {r.req_id for r in eng.scheduler.waiting}
        for rid, st in list(self._live.items()):
            comp_ids = eng.branches(rid)
            if st["stream"]:
                for idx, cid in enumerate(comp_ids):
                    toks = eng.outputs.get(cid, [])
                    seen = st["seen"].get(cid, 0)
                    if len(toks) > seen:
                        st["q"].put(("tokens", idx, toks[seen:]))
                        st["seen"][cid] = len(toks)
            live = any(
                c in waiting_ids or c in eng.scheduler.active
                for c in comp_ids
            )
            if live:
                continue
            choices = []
            n_completion = 0
            for idx, cid in enumerate(comp_ids):
                toks = list(eng.outputs.get(cid, []))
                lps = list(eng.logprobs.get(cid, []))
                n_completion += len(toks)
                finish = (
                    "stop"
                    if toks and toks[-1] in st["stop"]
                    else "length"
                )
                choices.append(
                    {
                        "index": idx,
                        "tokens": toks,
                        "token_logprobs": lps,
                        "finish_reason": finish,
                    }
                )
            usage = {
                "prompt_tokens": st["prompt_len"],
                "completion_tokens": n_completion,
                "total_tokens": st["prompt_len"] + n_completion,
            }
            st["q"].put(("done", {"choices": choices, "usage": usage}))
            del self._live[rid]

    # -- client-side API ---------------------------------------------------------

    def submit(self, body: dict, stream: bool) -> "queue.Queue":
        """Validate an HTTP request body and enqueue it; returns the event
        queue. Raises ValueError on bad input (handler maps it to 400)."""
        if self._error is not None:
            raise ValueError(f"engine failed: {self._error}")
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError(
                    "text prompts need a tokenizer; send token ids"
                )
            prompt = self.tokenizer.encode(prompt)
        if not isinstance(prompt, list) or not all(
            isinstance(t, int) for t in prompt
        ):
            raise ValueError("prompt must be a string or a list of token ids")
        max_tokens = int(body.get("max_tokens", 16))
        sampling = SamplingParams(
            temperature=float(body.get("temperature", 0.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            min_p=float(body.get("min_p", 0.0)),
        )
        stop = body.get("stop") or []
        if isinstance(stop, int):
            stop = [stop]
        if not all(isinstance(t, int) for t in stop):
            raise ValueError("stop must be a token id or list of token ids")
        raw_bias = body.get("logit_bias") or None
        logit_bias = (
            {int(k): float(v) for k, v in raw_bias.items()}
            if raw_bias
            else None
        )
        out: "queue.Queue" = queue.Queue()
        self.inbox.put(
            _Submission(
                prompt=prompt,
                max_tokens=max_tokens,
                sampling=sampling,
                stop=list(stop),
                n=int(body.get("n", 1)),
                priority=int(body.get("priority", 0)),
                lora=body.get("lora"),
                logit_bias=logit_bias,
                out=out,
                stream=stream,
            )
        )
        if self._error is not None:
            # TOCTOU with the worker's failure drain: if the engine died
            # between the check above and our put, the worker's final
            # inbox drain may already have run — drain again ourselves so
            # this (and any concurrent) submission gets a prompt error
            # instead of blocking until the handler timeout. A submission
            # answered twice is harmless (handlers take the first event).
            msg = self._error
            while True:
                try:
                    sub = self.inbox.get_nowait()
                except queue.Empty:
                    break
                sub.out.put(("error", msg, True))
        return out

    def cancel_request(self, req_id: int):
        """Thread-safe: ask the worker to cancel (client disconnected).
        The engine stops decoding it on the next step."""
        self.cancels.put(req_id)

    def close(self):
        self._stop = True
        self._worker.join(timeout=5)


def _make_handler(server: EngineServer):
    tok = server.tokenizer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet test runs
            pass

        def _json(self, code: int, obj: dict):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/v1/models":
                self._json(
                    200,
                    {
                        "object": "list",
                        "data": [
                            {"id": server.model_name, "object": "model"}
                        ],
                    },
                )
            elif self.path == "/health":
                eng = server.engine
                self._json(
                    200,
                    {
                        "status": "ok",
                        "metrics": eng.metrics.summary(),
                        "prefix_cache": eng.prefix_stats(),
                    },
                )
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/completions":
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("request body must be a JSON object")
                stream = bool(body.get("stream", False))
                q = server.submit(body, stream)
            except (ValueError, TypeError, KeyError, AttributeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            rid = str(uuid.uuid4())[:8]
            root_rid = None
            if not stream:
                while True:
                    try:
                        event = q.get(timeout=600)
                    except queue.Empty:
                        if root_rid is not None:
                            server.cancel_request(root_rid)
                        self._json(504, {"error": "generation timed out"})
                        return
                    kind, *payload = event
                    if kind == "accepted":
                        root_rid = payload[0]
                        continue
                    if kind == "error":
                        internal = len(payload) > 1 and payload[1]
                        self._json(
                            500 if internal else 400,
                            {"error": payload[0]},
                        )
                        return
                    payload = payload[0]
                    break  # done
                resp = {
                    "id": f"cmpl-{rid}",
                    "object": "text_completion",
                    "model": server.model_name,
                    **payload,
                }
                if tok is not None:
                    for c in resp["choices"]:
                        c["text"] = tok.decode(c["tokens"])
                self._json(200, resp)
                return
            # SSE streaming
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()

            def emit(obj):
                self.wfile.write(
                    b"data: " + json.dumps(obj).encode() + b"\n\n"
                )
                self.wfile.flush()

            try:
                self._stream_events(q, rid, emit)
            except (BrokenPipeError, ConnectionResetError):
                # Client went away: stop decoding for it.
                if self._root_rid is not None:
                    server.cancel_request(self._root_rid)

        _root_rid = None

        def _stream_events(self, q, rid, emit):
            while True:
                try:
                    kind, *payload = q.get(timeout=600)
                except queue.Empty:
                    if self._root_rid is not None:
                        server.cancel_request(self._root_rid)
                    emit({"error": "generation timed out"})
                    # OpenAI-style clients read until the DONE sentinel;
                    # end the stream cleanly on failure paths too.
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                    return
                if kind == "accepted":
                    self._root_rid = payload[0]
                    continue
                if kind == "error":
                    emit({"error": payload[0]})
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                    break
                if kind == "tokens":
                    idx, toks = payload
                    chunk = {
                        "id": f"cmpl-{rid}",
                        "object": "text_completion.chunk",
                        "choices": [{"index": idx, "tokens": toks}],
                    }
                    if tok is not None:
                        chunk["choices"][0]["text"] = tok.decode(toks)
                    emit(chunk)
                    continue
                final = {
                    "id": f"cmpl-{rid}",
                    "object": "text_completion",
                    **payload[0],
                }
                if tok is not None:
                    for c in final["choices"]:
                        c["text"] = tok.decode(c["tokens"])
                emit(final)
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
                break

    return Handler


def serve(
    engine,
    host: str = "127.0.0.1",
    port: int = 8000,
    tokenizer=None,
    model_name: str = "tpu-flash-torch",
    block: bool = True,
):
    """Start the HTTP server; returns (httpd, EngineServer). With
    ``block=False`` the listener runs on a daemon thread (tests)."""
    es = EngineServer(engine, tokenizer=tokenizer, model_name=model_name)
    httpd = ThreadingHTTPServer((host, port), _make_handler(es))
    httpd.daemon_threads = True
    if block:
        try:
            httpd.serve_forever()
        finally:
            es.close()
        return httpd, es
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, es
