"""The port's engine surface for the HTTP server: ``logit_bias`` on every
sampling path, ``n > 1`` forks over shared prompt pages, ``lora=None``
and ``stream()``.

One JAX engine run (TINY_TEST in f32, Pallas in interpret mode, the
gathered unfused route without speculation), in a module fixture, serves
a ban request, a force request and an ``n=3`` greedy group beside a
neighbour; the port's engine on the same weights (carried across by
``params_from_jax``) must give the same tokens, with log-probs within
1e-4 (f32 on both sides: only summation order differs). Everything else
is torch against torch: the ban on each of the four sampling paths
against a cache-free greedy loop over the biased logits, bias isolation
between slots, forks on every cache tier against a solo request,
shared pages, group admission, JAX's validation messages, per-branch
stops, seeds, ``stream()`` and ``copy_pages`` byte for byte.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tpu_flash.core.config import CacheConfig as JCacheConfig
from tpu_flash.core.config import EngineConfig as JEngineConfig
from tpu_flash.engine.runner import InferenceEngine as JEngine
from tpu_flash.models import TINY_TEST as J_TINY_TEST
from tpu_flash.models import FlashTransformer as JFlashTransformer
from tpu_flash_torch.checkpoint import load_hf_dir, params_from_jax
from tpu_flash_torch.core.config import CacheConfig, EngineConfig
from tpu_flash_torch.engine import InferenceEngine, SamplingParams
from tpu_flash_torch.engine import cache as tcache
from tpu_flash_torch.models import TINY_TEST, FlashTransformer

CKPT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "checkpoints", "tiny-byte-llama")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors: the suite
    runs several test workers on a few cores, where each worker's default
    torch thread pool slows such ops tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- one JAX engine run --------------------------------------------------------

PARITY_CACHE = dict(page_size=8, num_pages=30, max_pages_per_seq=6,
                    kv_dtype="float32", recent_window=0)
PARITY_ENGINE = dict(max_batch_size=6, max_seq_len=48, prefill_chunk=16,
                     max_decode_burst=4, paged_prefill=False,
                     fused_mixed_step=False)
# Prompts of one 16-token chunk and 1 + 2 bursts of 4 new tokens: the
# JAX engine compiles one prefill, one decode and one fork program.
PARITY_NEW = 9
BAN = {t: -100.0 for t in range(0, 256, 2)}  # every even token
FORCE = {7: 100.0}


def _parity_requests(eng):
    """Submit the parity scenario; returns its request ids: a ban, a
    force, an n=3 greedy group and an unbiased neighbour."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n).tolist() for n in (13, 9, 14, 11)]
    return [
        eng.submit(prompts[0], PARITY_NEW, logit_bias=BAN),
        eng.submit(prompts[1], PARITY_NEW, logit_bias=FORCE),
        eng.submit(prompts[2], PARITY_NEW, n=3),
        eng.submit(prompts[3], PARITY_NEW),
    ]


def _completions(eng, ids):
    """(tokens, log-probs) of every completion of ``ids``, in order."""
    cids = [c for rid in ids for c in eng.branches(rid)]
    return ([eng.outputs[c] for c in cids], [eng.logprobs[c] for c in cids])


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine's completions of the parity scenario, its params as
    numpy arrays, and the engine itself (for its validation messages)."""
    jm = JFlashTransformer(J_TINY_TEST)
    jp = jm.init(jax.random.PRNGKey(0))
    eng = JEngine(jm, jp, JEngineConfig(cache=JCacheConfig(**PARITY_CACHE),
                                        **PARITY_ENGINE), interpret=True)
    eng.speculation_k = 0
    ids = _parity_requests(eng)
    eng.run()
    out = _completions(eng, ids)
    eng.close()
    return out, jax.tree.map(np.asarray, jp), eng


def _parity_engine(np_params):
    model = FlashTransformer(TINY_TEST, device="cpu")
    eng = InferenceEngine(
        model, params_from_jax(np_params, device="cpu"),
        EngineConfig(cache=CacheConfig(**PARITY_CACHE), **PARITY_ENGINE))
    eng.speculation_k = 0
    return eng


def test_bias_and_forks_match_jax(jax_run):
    """The ban, the force, the n=3 group and the neighbour: the JAX
    engine's tokens, log-probs (of the biased logits) within 1e-4."""
    (jout, jlps), np_params, _ = jax_run
    eng = _parity_engine(np_params)
    ids = _parity_requests(eng)
    eng.run()
    out, lps = _completions(eng, ids)
    assert out == jout
    assert all(len(o) == PARITY_NEW for o in out)
    assert not any(t % 2 == 0 for t in out[0])  # the ban held
    assert out[1] == [7] * PARITY_NEW
    assert out[2] == out[3] == out[4]  # greedy branches
    np.testing.assert_allclose(np.concatenate(lps), np.concatenate(jlps),
                               atol=1e-4)
    eng.close()


def test_validation_messages_equal_jax(jax_run):
    """Each refused submit raises the JAX engine's ValueError, word for
    word."""
    _, np_params, jeng = jax_run
    eng = _parity_engine(np_params)
    cases = [
        dict(prompt=[1, 2], max_new_tokens=4, n=0),
        dict(prompt=[1, 2], max_new_tokens=0, n=2),
        dict(prompt=[1, 2], max_new_tokens=4, n=7),
        dict(prompt=[1] * 300, max_new_tokens=8),
        dict(prompt=[1] * 4, max_new_tokens=40, n=6),  # the children's own
        dict(prompt=[1, 2], max_new_tokens=4, logit_bias={256: 1.0}),
        dict(prompt=[1, 2], max_new_tokens=4, logit_bias={-1: 1.0}),
        dict(prompt=[1, 2], max_new_tokens=4, lora="x"),
    ]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            jeng.submit(**kw)
        with pytest.raises(ValueError) as got:
            eng.submit(**kw)
        assert str(got.value) == str(want.value), kw
    assert not eng.scheduler.has_work()
    eng.close()


# -- the ban on every sampling path, against a cache-free loop -------------


@pytest.fixture(scope="module")
def tiny():
    model = FlashTransformer(TINY_TEST, device="cpu")
    return model, model.init(torch.Generator().manual_seed(1))


def _greedy_oracle(model, params, prompt, n, bias=None):
    """Greedy tokens from re-running the whole sequence through the model
    at every step, no cache, ``bias`` ({token: offset}) on the logits."""
    row = torch.zeros(model.config.vocab_size)
    for t, b in (bias or {}).items():
        row[t] = b
    seq = list(prompt)
    for _ in range(n):
        logits = model.forward(params, torch.tensor([seq]))[0, -1] + row
        seq.append(int(logits.argmax()))
    return seq[len(prompt):]


def _small_engine(model, params, kv_dtype="float32", **kw):
    cfg = dict(max_batch_size=4, max_seq_len=48, prefill_chunk=8,
               max_decode_burst=3,
               cache=CacheConfig(page_size=4, num_pages=60,
                                 max_pages_per_seq=12, kv_dtype=kv_dtype,
                                 recent_window=0),
               paged_prefill=False, fused_mixed_step=False)
    cfg.update(kw)
    return EngineConfig(**cfg)


PATHS = ("burst", "verify", "fused")


@pytest.mark.parametrize("path", PATHS)
def test_ban_holds_on_every_path(tiny, path):
    """The tokens an unbiased greedy run emits, banned: the engine gives
    the biased cache-free loop's tokens, none of them banned, through the
    first token's prefill sample and then decode bursts, speculative
    verify (a self-draft proposes the unbiased tokens, which the biased
    target rejects) or fused steps (a second prompt's chunks carry the
    banned request's decode rows)."""
    model, params = tiny
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 256, 11).tolist()
    n = 9
    ban = {t: -100.0 for t in _greedy_oracle(model, params, prompt, n)}
    want = _greedy_oracle(model, params, prompt, n, ban)
    draft = (model, params) if path == "verify" else None
    eng = InferenceEngine(model, params, _small_engine(
        model, params, fused_mixed_step=path == "fused"), draft=draft)
    eng.speculation_k = 4 if path == "verify" else 0
    rid = eng.submit(prompt, n, logit_bias=ban)
    if path == "fused":
        eng.step()  # prefill: the request decodes from here on
        other = eng.submit(rng.integers(0, 256, 30).tolist(), 2)
    out = eng.run()
    assert out[rid] == want
    assert not set(out[rid]) & set(ban)
    routes = eng.metrics.route_counts()
    assert routes[{"burst": "decode", "verify": "speculative",
                   "fused": "fused"}[path]] >= 1
    if path == "fused":
        assert len(out[other]) == 2
    # Log-probs of the biased distribution: a banned token's share is gone.
    lp = torch.log_softmax(model.forward(params, torch.tensor(
        [prompt]))[0, -1] + torch.tensor(
            [ban.get(t, 0.0) for t in range(256)]), -1)
    assert abs(eng.logprobs[rid][0] - float(lp[want[0]])) < 1e-4
    eng.close()


def test_bias_stays_with_its_slot(tiny):
    """A forced request beside an unbiased one leaves the neighbour's
    tokens its solo run's; a later unbiased request that reuses the
    biased slot gets its solo tokens and clears the slot's row."""
    model, params = tiny
    rng = np.random.default_rng(4)
    a, b = (rng.integers(0, 256, m).tolist() for m in (10, 14))

    def solo(prompt):
        eng = InferenceEngine(model, params, _small_engine(model, params))
        rid = eng.submit(prompt, 6)
        return eng.run()[rid]

    eng = InferenceEngine(model, params, _small_engine(model, params))
    forced = eng.submit(a, 6, logit_bias={9: 100.0})
    plain = eng.submit(b, 6)
    out = eng.run()
    assert out[forced] == [9] * 6
    assert out[plain] == solo(b)
    slot = int(np.flatnonzero(eng._slot_bias_req == forced)[0])
    assert eng._slot_bias[slot]
    again = eng.submit(a, 6)
    eng.step()
    assert eng.scheduler.active[again].batch_slot == slot
    out = eng.run()
    assert out[again] == solo(a)
    assert not eng._slot_bias.any()
    assert float(eng.logit_bias.abs().sum()) == 0.0
    eng.close()


# -- forks -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    return load_hf_dir(CKPT, dtype="bfloat16", device="cpu")


FORK_TIERS = [("bfloat16", 0), ("int8", 16), ("int4", 16),
              ("int4g32", 16), ("k8v4", 16)]


@pytest.mark.parametrize("plen", [64, 45], ids=["page-edge", "mid-page"])
@pytest.mark.parametrize("kv_dtype,ring", FORK_TIERS)
def test_greedy_branches_equal_a_solo_request(trained, kv_dtype, ring,
                                              plen):
    """n=3 greedy branches of the trained checkpoint give the tokens of
    the same prompt served alone, on every page tier (the 4-bit tiers'
    packed and transposed tail pages copied at the fork, int8's recent
    ring copied too), for a prompt that ends on a page boundary (no tail
    page to copy) and one that does not."""
    model, params = trained
    prompt = list(b"The cache stores the keys and values of every token "
                  b"the model has seen so far.")[:plen]
    cfg = EngineConfig(
        max_batch_size=4, max_seq_len=128, prefill_chunk=32,
        cache=CacheConfig(page_size=32, num_pages=20, max_pages_per_seq=4,
                          kv_dtype=kv_dtype, recent_window=ring))

    def serve(n):
        eng = InferenceEngine(model, params, cfg)
        rid = eng.submit(prompt, 10, n=n)
        eng.run()
        eng.close()
        return [eng.outputs[c] for c in eng.branches(rid)]

    (solo,) = serve(1)
    assert serve(3) == [solo] * 3


def test_branches_share_the_prompts_full_pages(tiny):
    """After admission the n=3 group holds the prompt's full pages once,
    with refcount 3, and each branch owns the rest (the tail page copy
    and its generation budget); retirement frees every page."""
    model, params = tiny
    eng = InferenceEngine(model, params, _small_engine(
        model, params, prefix_cache=False))
    rid = eng.submit(list(range(1, 11)), 6, n=3)  # 2 full pages + 2
    eng.step()
    alloc = eng.scheduler.allocator
    pages = [alloc.pages_of(c) for c in eng.branches(rid)]
    assert all(len(p) == 4 for p in pages)
    assert pages[0][:2] == pages[1][:2] == pages[2][:2]
    assert all(alloc.refcount(p) == 3 for p in pages[0][:2])
    own = [p for ps in pages for p in ps[2:]]
    assert len(set(own)) == len(own) == 6
    assert all(alloc.refcount(p) == 1 for p in own)
    free = alloc.num_free
    assert free == eng.config.cache.num_pages - 1 - 2 - 6
    eng.run()
    assert alloc.num_free == eng.config.cache.num_pages - 1
    eng.close()


def test_group_waits_for_free_slots(tiny):
    """An n=4 group needs four batch slots at once: while one slot is
    busy it waits (whole), then admits and completes."""
    model, params = tiny
    eng = InferenceEngine(model, params, _small_engine(model, params))
    eng.speculation_k = 0
    first = eng.submit([3, 4, 5], 8)
    eng.step()
    group = eng.submit([6, 7, 8, 9], 5, n=4)
    eng.step()
    assert [r.req_id for r in eng.scheduler.waiting] == [group]
    assert len(eng.scheduler.active) == 1
    out = eng.run()
    assert len(out[first]) == 8
    assert [len(out[c]) for c in eng.branches(group)] == [5] * 4
    eng.close()


def test_stops_count_per_branch(tiny):
    """Sampled branches (n=4, temperature 1) each end at their own first
    stop token or at max_new_tokens, so the group's lengths differ."""
    model, params = tiny
    eng = InferenceEngine(model, params, _small_engine(model, params),
                          seed=5)
    stops = list(range(0, 256, 4))
    rid = eng.submit([1, 2, 3, 4, 5], 12, SamplingParams(temperature=1.0),
                     stop_tokens=stops, n=4)
    eng.run()
    outs = [eng.outputs[c] for c in eng.branches(rid)]
    for o in outs:
        hit = [i for i, t in enumerate(o) if t in stops]
        assert len(o) == (hit[0] + 1 if hit else 12)
    assert len({len(o) for o in outs}) > 1
    eng.close()


def test_sampled_branches_repeat_under_a_seed(tiny):
    """n=3 at temperature 0.9: the same seed gives the same branches,
    another seed others; the branches of one group differ."""
    model, params = tiny

    def serve(seed):
        eng = InferenceEngine(model, params, _small_engine(model, params),
                              seed=seed)
        rid = eng.submit([5, 5, 5, 6], 8, SamplingParams(temperature=0.9),
                         n=3)
        eng.run()
        return [eng.outputs[c] for c in eng.branches(rid)]

    a = serve(0)
    assert a == serve(0)
    assert a != serve(1)
    assert len({tuple(o) for o in a}) > 1


def test_stream_yields_exactly_the_outputs(tiny):
    """``stream()`` yields (request id, index, token) in index order for
    every completion, branches included, and together they are the
    final outputs; a request submitted between yields streams too."""
    model, params = tiny
    eng = InferenceEngine(model, params, _small_engine(model, params))
    a = eng.submit([1, 2, 3], 6, n=2)
    got = {}
    late = None
    for rid, i, tok in eng.stream():
        assert i == len(got.setdefault(rid, []))
        got[rid].append(tok)
        if late is None:
            late = eng.submit([4, 5], 3, logit_bias={11: 100.0})
    assert got == {c: eng.outputs[c] for c in eng.branches(a) + [late]}
    assert got[late] == [11] * 3
    eng.close()


# -- page and ring copies ----------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float32", "int8", "int4",
                                      "int4g32", "k8v4", "fp8"])
def test_copy_pages_is_the_source_page_byte_for_byte(kv_dtype):
    """copy_pages(src, dst) on every tier: each destination page is the
    source page byte for byte in every layer and head (payloads of both
    sides and their scales); other pages keep their bytes. copy_recent
    gives each destination slot the source slot's ring."""
    rng = np.random.default_rng(6)
    L, hkv, d, ps = 2, 2, 64, 8
    cache = tcache.PagedKVCache.create(
        L, hkv, d, CacheConfig(page_size=ps, num_pages=6,
                               max_pages_per_seq=3, kv_dtype=kv_dtype,
                               recent_window=4),
        num_slots=3, device="cpu")
    for li in range(L):
        for page in (1, 2, 5):
            k, v = (torch.from_numpy(rng.standard_normal(
                (ps, hkv, d), dtype=np.float32)).bfloat16()
                for _ in range(2))
            cache.append(li, k, v, torch.full((ps,), page),
                         torch.arange(ps), slots=torch.zeros(ps).long(),
                         positions=torch.arange(ps))
    names = [n for n in ("k_pages", "v_pages", "k_scales", "v_scales")
             if getattr(cache, n) is not None]

    def page_bytes(name, page):
        t = getattr(cache, name)[:, :, page].contiguous()
        return t.view(torch.uint8).numpy().tobytes()

    before = {n: [page_bytes(n, p) for p in range(6)] for n in names}
    cache.copy_pages([1, 1], [3, 4])
    for n in names:
        assert page_bytes(n, 3) == page_bytes(n, 4) == before[n][1], n
        for p in (0, 1, 2, 5):
            assert page_bytes(n, p) == before[n][p], (n, p)
    if cache.k_recent is not None:
        cache.copy_recent(0, [1, 2])
        for ring in (cache.k_recent, cache.v_recent):
            assert torch.equal(ring[:, 1], ring[:, 0])
            assert torch.equal(ring[:, 2], ring[:, 0])
            assert ring[:, 0].abs().sum() > 0


def test_lora_none_serves_and_a_name_is_refused(tiny):
    model, params = tiny
    eng = InferenceEngine(model, params, _small_engine(model, params))
    rid = eng.submit([1, 2, 3], 2, lora=None)
    with pytest.raises(ValueError, match="unknown adapter 'base'"):
        eng.submit([1, 2, 3], 2, lora="base")
    assert len(eng.run()[rid]) == 2
    assert eng.scheduler.active == {} and eng.branches(rid) == [rid]
    eng.close()
