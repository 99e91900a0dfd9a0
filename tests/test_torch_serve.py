"""The port's HTTP serving layer (``tpu_flash_torch.serve``): OpenAI-style
completions over the port's engine, the cases of ``tests/test_serve.py``.

Torch only: a real ThreadingHTTPServer on an ephemeral port in front of
the port's engine on a tiny seeded CPU model (the kernels' plain
versions). Greedy decode is deterministic, so HTTP responses are held
token for token against an identical engine driven offline.
"""

import http.client
import json
import time

import pytest
import torch

from tpu_flash_torch.core.config import CacheConfig, EngineConfig
from tpu_flash_torch.engine import InferenceEngine
from tpu_flash_torch.models import TINY_TEST, FlashTransformer
from tpu_flash_torch.serve import ByteTokenizer, EngineServer, serve


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors: the suite
    runs several test workers on a few cores, where each worker's default
    torch thread pool slows such ops tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _engine():
    model = FlashTransformer(TINY_TEST, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cfg = EngineConfig(
        max_batch_size=4,
        max_seq_len=256,
        prefill_chunk=64,
        cache=CacheConfig(page_size=32, num_pages=64, max_pages_per_seq=8),
    )
    return InferenceEngine(model, params, cfg)


@pytest.fixture(scope="module")
def served(one_torch_thread):
    httpd, es = serve(
        _engine(), port=0, tokenizer=ByteTokenizer(offset=0),
        model_name="tiny-test", block=False,
    )
    yield httpd.server_address
    httpd.shutdown()
    es.close()


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=300)
    conn.request(
        method, path,
        body=json.dumps(body) if body is not None else None,
        headers={"Content-Type": "application/json"},
    )
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_models_and_health(served):
    status, data = _request(served, "GET", "/v1/models")
    assert status == 200
    assert json.loads(data)["data"][0]["id"] == "tiny-test"
    status, data = _request(served, "GET", "/health")
    assert status == 200
    health = json.loads(data)
    assert health["status"] == "ok"
    assert health["prefix_cache"]["enabled"] == 1.0
    assert "steps" in health["metrics"]


def test_greedy_completion_matches_offline(served):
    prompt = [1, 2, 3, 4, 5]
    status, data = _request(
        served, "POST", "/v1/completions",
        {"prompt": prompt, "max_tokens": 8},
    )
    assert status == 200
    resp = json.loads(data)
    assert resp["object"] == "text_completion"
    (choice,) = resp["choices"]
    offline = _engine()
    rid = offline.submit(prompt, max_new_tokens=8)
    expected = offline.run()[rid]
    assert choice["tokens"] == expected
    assert choice["finish_reason"] == "length"
    assert len(choice["token_logprobs"]) == 8
    assert resp["usage"] == {
        "prompt_tokens": 5, "completion_tokens": 8, "total_tokens": 13,
    }


def test_streaming_matches_non_streaming(served):
    prompt = [9, 8, 7, 6]
    status, data = _request(
        served, "POST", "/v1/completions",
        {"prompt": prompt, "max_tokens": 6, "stream": True},
    )
    assert status == 200
    events = [
        json.loads(line[len(b"data: "):])
        for line in data.split(b"\n\n")
        if line.startswith(b"data: ") and b"[DONE]" not in line
    ]
    assert data.rstrip().endswith(b"data: [DONE]")
    streamed = [
        t for e in events if e["object"] == "text_completion.chunk"
        for t in e["choices"][0]["tokens"]
    ]
    final = [e for e in events if e["object"] == "text_completion"]
    assert len(final) == 1
    assert streamed == final[0]["choices"][0]["tokens"]
    status2, data2 = _request(
        served, "POST", "/v1/completions",
        {"prompt": prompt, "max_tokens": 6},
    )
    assert streamed == json.loads(data2)["choices"][0]["tokens"]


def test_parallel_sampling_n2(served):
    status, data = _request(
        served, "POST", "/v1/completions",
        {"prompt": [5, 5, 5], "max_tokens": 4, "n": 2,
         "temperature": 0.9, "top_p": 0.9},
    )
    assert status == 200
    choices = json.loads(data)["choices"]
    assert [c["index"] for c in choices] == [0, 1]
    assert all(len(c["tokens"]) == 4 for c in choices)


def test_text_prompt_and_decode(served):
    status, data = _request(
        served, "POST", "/v1/completions",
        {"prompt": "hi", "max_tokens": 3},
    )
    assert status == 200
    (choice,) = json.loads(data)["choices"]
    assert ByteTokenizer(offset=0).decode(choice["tokens"]) == choice["text"]


def test_logit_bias_forces_stop(served):
    # +100 bias forces token 5 every step; stop=[5] ends generation at 1.
    status, data = _request(
        served, "POST", "/v1/completions",
        {"prompt": [1, 2, 3], "max_tokens": 8, "stop": [5],
         "logit_bias": {"5": 100.0}},
    )
    assert status == 200
    (choice,) = json.loads(data)["choices"]
    assert choice["tokens"] == [5]
    assert choice["finish_reason"] == "stop"


@pytest.mark.parametrize("body,error", [
    ({"prompt": "x" * 10**6}, "more KV pages"),  # the pool can never fit it
    ({"prompt": {"not": "valid"}}, "prompt must be"),
    ({"prompt": [1, 2], "lora": "x"}, "unknown adapter 'x'"),
    ({"prompt": [1, 2], "logit_bias": {"999999": 1.0}}, "outside vocab"),
], ids=["too-long", "not-a-prompt", "lora", "bias-outside-vocab"])
def test_bad_requests(served, body, error):
    status, data = _request(served, "POST", "/v1/completions", body)
    assert status == 400
    assert error in json.loads(data)["error"]


def test_unknown_path(served):
    status, _ = _request(served, "POST", "/v1/unknown", {})
    assert status == 404


def test_engine_server_direct_api():
    # EngineServer without HTTP: queue protocol end to end.
    es = EngineServer(_engine())
    q = es.submit({"prompt": [4, 4, 4, 4], "max_tokens": 5}, stream=False)
    kind, rid = q.get(timeout=300)
    assert kind == "accepted"
    kind, payload = q.get(timeout=300)
    assert kind == "done"
    assert len(payload["choices"][0]["tokens"]) == 5
    es.close()


def test_engine_step_failure_reaches_every_client():
    # A step that raises answers every waiting client with an internal
    # error (HTTP 500), and later submits fail fast.
    eng = _engine()

    def broken_step():
        raise RuntimeError("device lost")

    eng.step = broken_step
    es = EngineServer(eng)
    q = es.submit({"prompt": [1, 2, 3], "max_tokens": 4}, stream=False)
    assert q.get(timeout=300)[0] == "accepted"
    assert q.get(timeout=300) == ("error", "RuntimeError: device lost", True)
    with pytest.raises(ValueError, match="engine failed"):
        es.submit({"prompt": [1], "max_tokens": 1}, stream=False)
    es.close()


def test_engine_cancel():
    # cancel() of an active request frees its pages and stops decoding;
    # a waiting request is dropped before admission.
    eng = _engine()
    r1 = eng.submit([1, 2, 3], max_new_tokens=64)
    for _ in range(3):
        eng.step()
    assert r1 in eng.scheduler.active
    emitted = len(eng.outputs[r1])
    assert eng.cancel(r1)
    eng.step()
    assert r1 not in eng.scheduler.active
    assert not eng.scheduler.has_work()
    assert len(eng.outputs[r1]) <= emitted + eng.config.max_decode_burst
    # pool fully recovered: a new request admits and completes
    r2 = eng.submit([4, 5, 6], max_new_tokens=4)
    out = eng.run()
    assert len(out[r2]) == 4
    assert eng.scheduler.allocator.num_free == \
        eng.config.cache.num_pages - 1 - eng.prefix_index.num_indexed_pages
    # waiting-queue cancellation
    r3 = eng.submit([7, 8], max_new_tokens=4)
    assert eng.cancel(r3)
    assert not eng.scheduler.has_work()
    assert not eng.cancel(r3)  # nothing live anymore


def test_server_cancel_request():
    es = EngineServer(_engine())
    q = es.submit({"prompt": [3, 3, 3], "max_tokens": 200}, stream=True)
    kind, rid = q.get(timeout=300)
    assert kind == "accepted"
    # wait for first tokens, then cancel mid-generation
    while True:
        ev = q.get(timeout=300)
        if ev[0] == "tokens":
            break
    es.cancel_request(rid)
    # worker acknowledges with a non-internal error event
    while True:
        ev = q.get(timeout=300)
        if ev[0] == "error":
            assert ev[1] == "cancelled"
            break
        assert ev[0] == "tokens"
    # engine is idle afterwards (pages released, nothing decoding)
    for _ in range(100):
        if not es.engine.scheduler.has_work():
            break
        time.sleep(0.05)
    assert not es.engine.scheduler.has_work()
    es.close()
