"""Multi-LoRA serving in the port (``tpu_flash_torch.engine.lora``), the
cases of ``tests/test_lora.py``.

Against the JAX package: ``apply_lora`` on the same stacks (decode and
prefill rows), and the model forward with each row's adapter applied by
``proj_hook`` (TINY_TEST in f32, Pallas in interpret mode; logits within
1e-5, only summation order differs). The JAX engine's adapted tokens are
held in ``tests/test_torch_preemption.py``. Everything else is torch
against torch: an adapter's greedy stream is the stream of an engine on
merged weights (W + A B) on every route, a mixed batch keeps each row's
stream (base rows bit for bit an adapter-free engine's), an unknown name
is refused, the prefix cache never shares adapter KV, the store's
validation, alpha and rank padding, the HTTP server with an adapter, and
config 6 of the bench with ``lora_rank``.
"""

import http.client
import json

import numpy as np
import pytest
import torch

from tpu_flash_torch.core.config import CacheConfig, EngineConfig
from tpu_flash_torch.engine import InferenceEngine, LoRAStore, apply_lora
from tpu_flash_torch.models import TINY_TEST, FlashTransformer


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors: the suite
    runs several test workers on a few cores, where each worker's default
    torch thread pool slows such ops tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _adapter(cfg, seed, scale=0.5, rank=4):
    """Seeded rank-``rank`` factors on several projections of both
    layers, large enough to change greedy tokens."""
    rng = np.random.default_rng(seed)
    h, qd, inter = cfg.hidden_size, cfg.num_q_heads * cfg.head_dim, \
        cfg.intermediate_size
    kvd = cfg.num_kv_heads * cfg.head_dim

    def ab(fan_in, fan_out):
        return ((rng.standard_normal((fan_in, rank), dtype=np.float32)
                 * (scale / fan_in ** 0.5)),
                rng.standard_normal((rank, fan_out), dtype=np.float32))

    return {0: {"wq": ab(h, qd), "wv": ab(h, kvd), "w_up": ab(h, inter)},
            1: {"wk": ab(h, kvd), "wo": ab(qd, h), "w_gate": ab(h, inter),
                "w_down": ab(inter, h)}}


@pytest.fixture(scope="module")
def mp():
    model = FlashTransformer(TINY_TEST, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _merged(params, adapters):
    """The base params with every adapter delta folded into its weight."""
    layers = [dict(layer) for layer in params["layers"]]
    for li, projs in adapters.items():
        for proj, (a, b) in projs.items():
            w = layers[li][proj]
            layers[li][proj] = (w.float() + torch.from_numpy(a @ b)).to(
                w.dtype)
    return dict(params, layers=layers)


ROUTES = {
    "gathered": dict(paged_prefill=False, fused_mixed_step=False),
    "defaults": {},
}


def _engine(model, params, *, route="gathered", prefix_cache=False,
            draft=None, spec=0, max_batch=4):
    eng = InferenceEngine(model, params, EngineConfig(
        max_batch_size=max_batch, max_seq_len=128, prefill_chunk=8,
        max_decode_burst=4,
        cache=CacheConfig(page_size=8, num_pages=64, max_pages_per_seq=8,
                          kv_dtype="float32", recent_window=0),
        prefix_cache=prefix_cache, **ROUTES[route]), draft=draft)
    eng.speculation_k = spec
    return eng


def _solo(model, params, prompt, n=6, **kw):
    eng = _engine(model, params, **kw)
    rid = eng.submit(prompt, n)
    eng.run()
    return eng.outputs[rid]


PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]


# -- against the JAX package -------------------------------------------------


def test_apply_lora_matches_jax():
    """``apply_lora`` on stacks both stores built from the same adapters,
    with rows of every adapter id, decode [b, fan] and prefill [b, s, fan]
    rows."""
    import jax.numpy as jnp

    from tpu_flash.engine.lora import LoRAStore as JStore
    from tpu_flash.engine.lora import apply_lora as j_apply

    ads = [_adapter(TINY_TEST, s) for s in (1, 2)]
    js, ts = JStore(TINY_TEST.num_layers), LoRAStore(TINY_TEST.num_layers,
                                                    device="cpu")
    for i, a in enumerate(ads):
        js.register(f"a{i}", a, alpha=2.0)
        ts.register(f"a{i}", a, alpha=2.0)
    rng = np.random.default_rng(3)
    ids = np.array([0, 1, 2, 1], np.int32)
    for shape in ((4, 64), (4, 5, 64)):
        x = rng.standard_normal(shape, dtype=np.float32)
        y = rng.standard_normal(shape[:-1] + (128,), dtype=np.float32)
        want = j_apply(js.stacks(), 0, "w_up", jnp.asarray(x),
                       jnp.asarray(y), jnp.asarray(ids))
        got = apply_lora(ts.stacks(), 0, "w_up", torch.from_numpy(x),
                         torch.from_numpy(y), torch.from_numpy(ids).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_forward_with_adapters_matches_jax():
    """The model forward with each row's adapter applied through
    ``proj_hook`` (rows of the base, adapter 1 and adapter 2): the JAX
    forward's logits."""
    import jax
    import jax.numpy as jnp

    from tpu_flash.engine.lora import LoRAStore as JStore
    from tpu_flash.engine.lora import apply_lora as j_apply
    from tpu_flash.models import TINY_TEST as J_TINY_TEST
    from tpu_flash.models import FlashTransformer as JFlashTransformer
    from tpu_flash_torch.checkpoint import params_from_jax

    jm = JFlashTransformer(J_TINY_TEST)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = FlashTransformer(TINY_TEST, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ads = [_adapter(TINY_TEST, s) for s in (1, 2)]
    js, ts = JStore(2), LoRAStore(2, device="cpu")
    for i, a in enumerate(ads):
        js.register(f"a{i}", a)
        ts.register(f"a{i}", a)
    tokens = np.random.default_rng(4).integers(0, 256, (3, 16))
    ids = np.array([0, 1, 2], np.int32)
    jstacks, tstacks = js.stacks(), ts.stacks()
    jids, tids = jnp.asarray(ids), torch.from_numpy(ids).long()
    want = jm.forward(
        jp, jnp.asarray(tokens, jnp.int32), interpret=True,
        proj_hook=lambda li, n, x, y: j_apply(jstacks, li, n, x, y, jids))
    got = tm.forward(
        tp, torch.from_numpy(tokens),
        proj_hook=lambda li, n, x, y: apply_lora(tstacks, li, n, x, y, tids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    base = tm.forward(tp, torch.from_numpy(tokens))
    assert torch.equal(got[0], base[0])  # the null adapter adds nothing
    assert not torch.allclose(got[1], base[1], atol=1e-3)


# -- torch against torch -----------------------------------------------------


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_adapter_matches_merged_weights(mp, route):
    """Chunked prefill and burst decode (gathered), or the defaults (paged
    prefill, fused steps, speculative verify with the merged model
    drafting): the adapter's stream is the merged weights' stream."""
    model, params = mp
    adapters = _adapter(TINY_TEST, 1)
    merged = _merged(params, adapters)
    spec = dict(spec=8, draft=(model, merged)) if route == "defaults" else {}
    want = _solo(model, merged, PROMPT, route=route, **spec)
    eng = _engine(model, params, route=route, **spec)
    eng.register_lora("style-a", adapters)
    rid = eng.submit(PROMPT, 6, lora="style-a")
    eng.run()
    assert eng.outputs[rid] == want
    if route == "defaults":
        assert eng.speculation_stats()["accepted"] > 0


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_mixed_batch_isolation(mp, route):
    """A base request and two adapters' requests decode together; each
    stream is its own single-model stream, the base one bit for bit (its
    log-probs too) an adapter-free engine's."""
    model, params = mp
    ad1, ad2 = _adapter(TINY_TEST, 2), _adapter(TINY_TEST, 3, scale=0.9)
    prompts = (PROMPT, [7, 7, 2, 9], [9, 8, 7])
    base_eng = _engine(model, params, route=route)
    b0 = base_eng.submit(PROMPT, 6)
    base_eng.run()
    want = [base_eng.outputs[b0],
            _solo(model, _merged(params, ad1), prompts[1], route=route),
            _solo(model, _merged(params, ad2), prompts[2], route=route)]
    eng = _engine(model, params, route=route)
    eng.register_lora("a1", ad1)
    eng.register_lora("a2", ad2)
    ids = [eng.submit(p, 6, lora=lora)
           for p, lora in zip(prompts, (None, "a1", "a2"))]
    eng.run()
    assert [eng.outputs[i] for i in ids] == want
    assert eng.logprobs[ids[0]] == base_eng.logprobs[b0]
    assert want[1] != _solo(model, params, prompts[1], route=route)


def test_unknown_adapter_rejected(mp):
    eng = _engine(*mp)
    eng.register_lora("a", _adapter(TINY_TEST, 1))
    with pytest.raises(ValueError, match="unknown adapter 'nope'"):
        eng.submit(PROMPT, 4, lora="nope")
    assert not eng.scheduler.has_work()


def test_prefix_cache_never_aliases_adapter_kv(mp):
    """The same prompt as base, then through an adapter, then as base
    again on a prefix-caching engine: the adapted request shares no base
    page, and the second base request reuses the first's pages; each
    stream stays its reference's."""
    model, params = mp
    adapters = _adapter(TINY_TEST, 4)
    prompt = PROMPT * 2  # 22 tokens: pages and chunks over
    want_lora = _solo(model, _merged(params, adapters), prompt, n=5)
    want_base = _solo(model, params, prompt, n=5)
    eng = _engine(model, params, prefix_cache=True)
    eng.register_lora("a", adapters)
    got = []
    for lora in (None, "a", None):
        r = eng.submit(prompt, 5, lora=lora)
        eng.run()
        got.append(eng.outputs[r])
    assert got == [want_base, want_lora, want_base]
    stats = eng.prefix_stats()
    assert stats["hits_tokens"] > 0
    # Only the base prompt's pages were ever indexed.
    assert stats["indexed_pages"] == len(prompt) // 8


def test_store_validation():
    ts = LoRAStore(2, device="cpu")
    a, b = np.ones((64, 4), np.float32), np.ones((4, 128), np.float32)
    ts.register("x", {0: {"w_up": (a, b)}})
    with pytest.raises(ValueError, match="already registered"):
        ts.register("x", {0: {"w_up": (a, b)}})
    with pytest.raises(ValueError, match="unknown projection"):
        ts.register("y", {0: {"w_in": (a, b)}})
    with pytest.raises(ValueError, match="matching r"):
        ts.register("y", {0: {"w_up": (a, b.T)}})
    with pytest.raises(ValueError, match="out of range"):
        ts.register("y", {2: {"w_up": (a, b)}})
    with pytest.raises(ValueError, match="shape mismatch"):
        ts.register("y", {0: {"w_up": (np.ones((32, 4), np.float32), b)}})
    # A refused adapter leaves the store as it was.
    assert ts.names == ["x"] and ts.id_of(None) == 0
    assert ts.register("y", {1: {"w_up": (a, b)}}) == 2
    assert ts.stacks()[0]["w_up"][0].shape == (3, 64, 4)


def test_alpha_and_rank_padding():
    """alpha / r folds into B; a rank-2 and a rank-4 adapter on one
    projection pad to rank 4 and give their own deltas."""
    rng = np.random.default_rng(5)
    a2, b2 = rng.standard_normal((64, 2), np.float32), \
        rng.standard_normal((2, 128), np.float32)
    a4, b4 = rng.standard_normal((64, 4), np.float32), \
        rng.standard_normal((4, 128), np.float32)
    ts = LoRAStore(1, device="cpu")
    ts.register("r2", {0: {"w_up": (a2, b2)}}, alpha=8.0)
    ts.register("r4", {0: {"w_up": (a4, b4)}})
    A, B = ts.stacks()[0]["w_up"]
    assert A.shape == (3, 64, 4) and B.shape == (3, 4, 128)
    x = torch.from_numpy(rng.standard_normal((3, 64), np.float32))
    y = torch.zeros(3, 128)
    got = apply_lora(ts.stacks(), 0, "w_up", x, y, torch.tensor([0, 1, 2]))
    assert torch.equal(got[0], y[0])
    np.testing.assert_allclose(got[1].numpy(), x[1].numpy() @ a2 @ b2 * 4.0,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), x[2].numpy() @ a4 @ b4,
                               rtol=1e-4, atol=1e-4)
    assert apply_lora(ts.stacks(), 0, "wq", x, y, None) is y


def test_server_serves_an_adapter(mp):
    """A request naming a registered adapter gets that adapter's tokens
    (those of ``submit(lora=...)`` offline); an unknown name gets the
    JAX server's 400, "ValueError: " and the engine's message."""
    from tpu_flash_torch.serve import ByteTokenizer, serve

    model, params = mp
    adapters = _adapter(TINY_TEST, 6)
    offline = _engine(model, params)
    offline.register_lora("a", adapters)
    rid = offline.submit(PROMPT, 6, lora="a")
    want = offline.run()[rid]
    eng = _engine(model, params)
    eng.register_lora("a", adapters)
    httpd, es = serve(eng, port=0, tokenizer=ByteTokenizer(offset=0),
                      model_name="tiny-test", block=False)
    try:
        def post(body):
            conn = http.client.HTTPConnection(*httpd.server_address,
                                              timeout=300)
            conn.request("POST", "/v1/completions", body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = json.loads(resp.read())
            conn.close()
            return resp.status, data

        status, data = post({"prompt": PROMPT, "max_tokens": 6,
                             "lora": "a"})
        assert status == 200
        assert data["choices"][0]["tokens"] == want
        status, data = post({"prompt": PROMPT, "max_tokens": 6,
                             "lora": "nope"})
        assert status == 400
        assert data["error"] == "ValueError: unknown adapter 'nope'"
    finally:
        httpd.shutdown()
        es.close()
    assert want != _solo(model, params, PROMPT)


def test_bench_config6_with_adapters():
    """Config 6's engine bench with ``lora_rank``: every request through
    one of two rank-4 adapters over every layer and projection, at a tiny
    size on the plain versions."""
    from tpu_flash_torch.bench.suite import bench_engine_tokens_per_s

    tps, wall, m, _ = bench_engine_tokens_per_s(
        num_layers=2, hidden=64, num_q_heads=4, num_kv_heads=2,
        head_dim=16, batch=2, prompt_len=16, new_tokens=4, page_size=8,
        lora_rank=4, lora_count=2, device="cpu")
    assert tps > 0 and wall > 0
    assert m["decode_tokens"] == 2 * 4 - 2  # first tokens come from prefill
