"""The port's engine serving the trained checkpoint from int4 and
int4g32 caches, greedy token for token against the JAX engine; and the
engine's auto cache layout. ``test_torch_engine_tiers_k8v4_fp8.py`` runs
the same cases on the k8v4 and fp8 tiers with this module's helpers.

Each tier serves two prompts of 51 and 53 bytes (two 32-token chunks, so
the second chunk reads cached history) for 9 greedy tokens (one from
prefill, one burst of 8), batch 2, with explicit 32-token pages and no
recent ring, so that every decode step reads all its context from the
quantized pages. One JAX engine run per tier (gathered history, unfused,
no speculation; ~10-13 s in interpret mode) sits in a module fixture;
the port serves the same requests on the gathered route and on the paged
route (paged prefill over int4 pages; int4g32 always gathers, as in JAX).

Greedy near-ties. The two engines' K/V projections differ by bf16 ulps,
and a 4-bit cache turns some of those into whole quantization levels:
chosen-token log-probs were measured up to 0.22 apart (int4; int8: 0.03).
So each request's tokens are compared up to its first token whose top-2
logit margin on the port's engine is under MARGIN = 0.5; with these
prompts each tier compares 13 to 17 of its 18 tokens, and the test
asserts at least MIN_COMPARED.
"""

import contextlib
import os

import pytest
import torch

from tpu_flash.checkpoint.convert import load_hf_dir as j_load_hf_dir
from tpu_flash.core.config import CacheConfig as JCacheConfig
from tpu_flash.core.config import EngineConfig as JEngineConfig
from tpu_flash.engine.runner import InferenceEngine as JEngine
from tpu_flash.utils.tuning import resolve_cache_config as j_resolve
from tpu_flash_torch.checkpoint import load_hf_dir
from tpu_flash_torch.core.config import CacheConfig, EngineConfig
from tpu_flash_torch.engine import InferenceEngine

CKPT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "checkpoints", "tiny-byte-llama")
LAYOUT = dict(page_size=32, num_pages=12, max_pages_per_seq=4,
              recent_window=0)
ENGINE = dict(max_batch_size=2, max_seq_len=128, prefill_chunk=32,
              max_decode_burst=8, paged_prefill=False,
              fused_mixed_step=False)
PROMPTS = [list(b"def quantize(x, scale):\n    return clip(round(x / s"),
           list(b"class Engine:\n    def __init__(self, model, config):\n")]
NEW_TOKENS = 9
MARGIN = 0.5
MIN_COMPARED = 12
# torch's default thread count, for the JAX engine runs: torch's setting
# also bounds the OpenMP pool that XLA's CPU compiles use (one thread made
# a JAX engine run here ~40% slower).
JAX_THREADS = torch.get_num_threads()


@contextlib.contextmanager
def torch_threads(n):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors (the suite
    runs several workers on a few cores)."""
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def trained():
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    jm, jp = j_load_hf_dir(CKPT, dtype="bfloat16")
    tm, tp = load_hf_dir(CKPT, dtype="bfloat16", device="cpu")
    return jm, jp, tm, tp


def jax_tokens(trained, kv_dtype):
    """The JAX engine's greedy tokens per prompt for a tier."""
    jm, jp = trained[:2]
    eng = JEngine(jm, jp, JEngineConfig(
        cache=JCacheConfig(kv_dtype=kv_dtype, **LAYOUT), **ENGINE),
        interpret=True)
    eng.speculation_k = 0
    ids = [eng.submit(p, NEW_TOKENS) for p in PROMPTS]
    with torch_threads(JAX_THREADS):
        out = eng.run()
    eng.close()
    return [out[i] for i in ids]


def port_engine(trained, kv_dtype, **over):
    tm, tp = trained[2:]
    eng = InferenceEngine(tm, tp, EngineConfig(
        cache=CacheConfig(kv_dtype=kv_dtype, **LAYOUT),
        **dict(ENGINE, **over)))
    eng.speculation_k = 0
    return eng


def margins(trained, kv_dtype, prompt):
    """Top-2 logit margin of each greedy token of ``prompt`` served
    alone by the port (row 0 of every sampling call; the first chunk's
    sample is not a token)."""
    eng = port_engine(trained, kv_dtype)
    seen, sample = [], eng._sample

    def record(logits, *args):
        top = logits.float().topk(2, dim=-1).values
        seen.append(float(top[0, 0] - top[0, 1]))
        return sample(logits, *args)

    eng._sample = record
    eng.submit(prompt, NEW_TOKENS)
    eng.run()
    eng.close()
    return seen[-NEW_TOKENS:]


def check_tier(trained, want, kv_dtype, **over):
    """The port's tokens equal the JAX engine's up to each request's
    first near-tie."""
    eng = port_engine(trained, kv_dtype, **over)
    ids = [eng.submit(p, NEW_TOKENS) for p in PROMPTS]
    out = eng.run()
    eng.close()
    compared = 0
    for i, p, w in zip(ids, PROMPTS, want):
        m = margins(trained, kv_dtype, p)
        n = next((k for k, x in enumerate(m) if x < MARGIN), NEW_TOKENS)
        assert out[i][:n] == w[:n], (bytes(out[i]), bytes(w), m)
        assert len(out[i]) == NEW_TOKENS
        compared += n
    assert compared >= MIN_COMPARED, compared
    return eng


@pytest.fixture(scope="module", params=["int4", "int4g32"])
def tier(request, trained):
    return request.param, jax_tokens(trained, request.param)


@pytest.mark.parametrize("paged", [False, True], ids=["gathered", "paged"])
def test_tier_greedy_tokens_match_jax(trained, tier, paged):
    kv_dtype, want = tier
    eng = check_tier(trained, want, kv_dtype, paged_prefill=paged)
    # int4 history is read from the pages on the paged route; int4g32
    # always gathers.
    assert eng._paged_enabled() == (paged and kv_dtype == "int4")


def test_default_engine_config_resolves_the_auto_layout(trained):
    """``EngineConfig()`` and an all-auto ``CacheConfig`` per tier: the
    engine resolves the layout JAX's ``resolve_cache_config`` gives, builds
    its cache in it, and serves."""
    tm, tp = trained[2:]
    eng = InferenceEngine(tm, tp, EngineConfig())
    cfg = EngineConfig()
    j = j_resolve(JCacheConfig(), max_seq_len=cfg.max_seq_len,
                  max_batch_size=cfg.max_batch_size)
    c = eng.config.cache
    assert (c.page_size, c.num_pages, c.max_pages_per_seq,
            c.recent_window) == (j.page_size, j.num_pages,
                                 j.max_pages_per_seq, j.recent_window)
    assert eng.cache.k_pages.shape[2:4] == (j.num_pages, j.page_size)
    rid = eng.submit(PROMPTS[0], 3)
    assert len(eng.run()[rid]) == 3
    eng.close()
    for kv_dtype in ("int4", "int4g32", "k8v4", "fp8"):
        eng = InferenceEngine(tm, tp, EngineConfig(
            max_batch_size=2, max_seq_len=64, prefill_chunk=32,
            cache=CacheConfig(kv_dtype=kv_dtype)))
        j = j_resolve(JCacheConfig(kv_dtype=kv_dtype), max_seq_len=64,
                      max_batch_size=2)
        c = eng.config.cache
        assert (c.page_size, c.num_pages, c.max_pages_per_seq,
                c.recent_window) == (j.page_size, j.num_pages,
                                     j.max_pages_per_seq, j.recent_window)
        assert eng.cache.recent_window == 64  # the ring, clamped
        rid = eng.submit(PROMPTS[1][:40], 2)
        assert len(eng.run()[rid]) == 2
        eng.close()
