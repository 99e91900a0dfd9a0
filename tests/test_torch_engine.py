"""The port's engine layer against the JAX package: KV-cache bytes after
the same appends, the scheduler's plans, the sampling filters, and greedy
serving of the trained checkpoint, token for token.

The token-parity test holds the gathered-history, unfused,
no-speculation route (``paged_prefill=False``, ``fused_mixed_step=False``,
``speculation_k = 0`` on both sides) against JAX; the engine's default
routes are held in ``test_torch_engine_routes.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.checkpoint.convert import load_hf_dir as j_load_hf_dir
from tpu_flash.core.config import CacheConfig as JCacheConfig
from tpu_flash.core.config import EngineConfig as JEngineConfig
from tpu_flash.engine import cache as jcache
from tpu_flash.engine import scheduler as jsched
from tpu_flash.engine.allocator import PageAllocator as JPageAllocator
from tpu_flash.engine.prefix import PrefixIndex as JPrefixIndex
from tpu_flash.engine.runner import InferenceEngine as JEngine
from tpu_flash.engine.sampling import filtered_logits as j_filtered
from tpu_flash_torch.checkpoint import load_hf_dir
from tpu_flash_torch.core.config import CacheConfig, EngineConfig
from tpu_flash_torch.engine import InferenceEngine
from tpu_flash_torch.engine import cache as tcache
from tpu_flash_torch.engine import scheduler as tsched
from tpu_flash_torch.engine.allocator import PageAllocator
from tpu_flash_torch.engine.prefix import PrefixIndex
from tpu_flash_torch.engine.sampling import filtered_logits, sample_tokens


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors: the suite
    runs several test workers on a few cores, where each worker's default
    torch thread pool slows such ops tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CKPT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "checkpoints", "tiny-byte-llama")
LAYOUT = dict(page_size=32, num_pages=12, max_pages_per_seq=4)
ENGINE = dict(max_batch_size=2, max_seq_len=128, prefill_chunk=32,
              max_decode_burst=7, paged_prefill=False,
              fused_mixed_step=False)
PROMPTS = [
    list(b"The quick brown fox jumps over the lazy dog. ")[:40],
    list(b"def quantize(x, scale):\n    return clip(round(x / s")[:50],
]
# The first token comes from prefill, the rest from one 7-step burst.
# Greedy parity holds where the top-2 logits differ; the logits are bf16,
# and the tightest step here wins by one bf16 ulp on both sides (a 9th
# int8 token is an exact tie, decided by summation order).
NEW_TOKENS = 8


@pytest.mark.parametrize(
    "kv_dtype,ring", [("bfloat16", 0), ("float32", 0), ("int8", 0),
                      ("int8", 8)],
)
def test_cache_bytes_match_jax_after_same_appends(kv_dtype, ring):
    """Two appends into one layer: a 24-token chunk (longer than the
    ring, so ring rows are written twice in one call) with pad tokens on
    the trash page and trash slot, then one decode token per slot."""
    rng = np.random.default_rng(0)
    L, hkv, d, slots = 2, 2, 16, 3
    cfg_kw = dict(page_size=8, num_pages=6, max_pages_per_seq=3,
                  kv_dtype=kv_dtype, recent_window=ring)
    jc = jcache.PagedKVCache.create(L, hkv, d, JCacheConfig(**cfg_kw),
                                    num_slots=slots)
    tc = tcache.PagedKVCache.create(L, hkv, d, CacheConfig(**cfg_kw),
                                    num_slots=slots, device="cpu")
    trash_page, trash_slot = 5, 2
    pos = np.arange(24)
    appends = [
        (np.where(pos < 20, np.array([3, 0, 4])[pos // 8], trash_page),
         pos % 8, np.where(pos < 20, 0, trash_slot), pos),
        (np.array([4, 1]), np.array([4, 0]), np.array([0, 1]),
         np.array([20, 0])),
    ]
    for pages, offs, slot_ids, positions in appends:
        k = rng.standard_normal((len(pages), hkv, d), dtype=np.float32)
        v = rng.standard_normal((len(pages), hkv, d), dtype=np.float32)
        ji = [jnp.asarray(a, jnp.int32)
              for a in (pages, offs, slot_ids, positions)]
        ti = [torch.from_numpy(np.asarray(a, np.int64))
              for a in (pages, offs, slot_ids, positions)]
        jc = jc.append(1, jnp.asarray(k, jnp.bfloat16),
                       jnp.asarray(v, jnp.bfloat16), ji[0], ji[1],
                       slots=ji[2], positions=ji[3])
        tc.append(1, torch.from_numpy(k).bfloat16(),
                  torch.from_numpy(v).bfloat16(), ti[0], ti[1],
                  slots=ti[2], positions=ti[3])
    live = slice(0, trash_page)  # the trash page holds whatever landed
    names = ["k_pages", "v_pages"]
    if kv_dtype == "int8":
        names += ["k_scales", "v_scales"]
    for name in names:
        jx = np.asarray(getattr(jc, name)[:, :, live])
        tx = getattr(tc, name)[:, :, live]
        assert tx.view(torch.uint8).numpy().tobytes() == \
            jx.view(np.uint8).tobytes(), name
    if ring:
        for name in ("k_recent", "v_recent"):
            jx = np.asarray(getattr(jc, name)[:, :trash_slot], np.float32)
            tx = getattr(tc, name)[:, :trash_slot].float().numpy()
            np.testing.assert_array_equal(tx, jx, err_msg=name)
    kview, _ = tc.layer_view(1)
    assert tc.recent_window == ring
    if kv_dtype == "int8":
        assert tuple(kview.scales.shape) == (hkv, 6, 8, 1)


def _drive_scheduler(sched_mod, alloc, prefix_cls, config_cls, cache_cls):
    """The runner's host-side loop with no device: admit, plan, report one
    token per decoding slot, register prefill pages. Returns every plan
    with its page tables."""
    cfg = config_cls(max_batch_size=3, max_seq_len=96, prefill_chunk=16,
                     cache=cache_cls(page_size=8, num_pages=40,
                                     max_pages_per_seq=12,
                                     kv_dtype="bfloat16", recent_window=0))
    sched = sched_mod.Scheduler(cfg)
    sched.allocator = alloc(cfg.cache.num_pages - 1)
    sched.prefix_index = prefix_cls(sched.allocator, cfg.cache.page_size)
    shared = list(range(1, 33))
    prompts = [shared + [40] * 5, list(range(50, 70)), shared + [41] * 9,
               list(range(70, 73)), list(range(80, 121))]
    budgets = [3, 6, 2, 4, 5]
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        req = sched_mod.Request(req_id=i, prompt_len=len(p),
                                max_new_tokens=n)
        req._prompt = p
        sched.add_request(req)
    plans = []
    while sched.has_work() and len(plans) < 60:
        plan = sched.step()
        for c in plan.prefill:
            req = sched.active[c.req_id]
            sched.prefix_index.register(req._prompt[:c.start + c.length],
                                        sched.page_table(c.req_id))
            if c.start + c.length >= req.prompt_len:
                sched.report_decoded(c.req_id)
        for s in plan.decode_slots:
            sched.report_decoded(sched.slots[s])
        plans.append((
            [(c.req_id, c.batch_slot, c.start, c.length)
             for c in plan.prefill],
            list(plan.decode_slots), list(plan.finished),
            {rid: sched.page_table(rid) for rid in sched.active},
        ))
    return plans


def test_scheduler_plans_match_jax():
    """Same submissions (two sharing a 4-page prefix) -> the same prefill
    chunks, decode slots, retirements and page tables every step, with
    the JAX engine's own allocator against the port's."""
    j = _drive_scheduler(
        jsched, lambda n: JPageAllocator(n), JPrefixIndex, JEngineConfig,
        JCacheConfig,
    )
    t = _drive_scheduler(tsched, PageAllocator, PrefixIndex, EngineConfig,
                         CacheConfig)
    assert len(j) > 5 and not any(p[0] for p in j[-2:])
    assert t == j


def test_filtered_logits_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((5, 64)).astype(np.float32) * 3
    temps = np.array([0.0, 0.7, 1.0, 1.3, 0.9], np.float32)
    top_k = np.array([0, 5, 0, 0, 10], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 1.0, 0.9], np.float32)
    min_p = np.array([0.0, 0.0, 0.0, 0.1, 0.05], np.float32)
    j = np.asarray(j_filtered(jnp.asarray(logits), jnp.asarray(temps),
                              jnp.asarray(top_k), jnp.asarray(top_p),
                              jnp.asarray(min_p)))
    t = filtered_logits(torch.from_numpy(logits), torch.from_numpy(temps),
                        torch.from_numpy(top_k), torch.from_numpy(top_p),
                        torch.from_numpy(min_p)).numpy()
    kept = j > np.finfo(np.float32).min
    np.testing.assert_array_equal(t > np.finfo(np.float32).min, kept)
    np.testing.assert_allclose(t[kept], j[kept], rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        toks = sample_tokens(
            torch.from_numpy(logits), gen, torch.from_numpy(temps),
            torch.from_numpy(top_k), torch.from_numpy(top_p),
            torch.from_numpy(min_p),
        ).numpy()
        assert toks[0] == logits[0].argmax()
        assert kept[np.arange(5), toks].all()


@pytest.fixture(scope="module")
def trained():
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    jm, jp = j_load_hf_dir(CKPT, dtype="bfloat16")
    tm, tp = load_hf_dir(CKPT, dtype="bfloat16", device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize(
    "kv_dtype,ring", [("bfloat16", 0), ("int8", 0), ("int8", 32)],
    ids=["bf16", "int8", "int8-ring32"],
)
def test_greedy_engine_is_token_exact_vs_jax(trained, kv_dtype, ring):
    """Two prompts of 40 and 50 bytes: the second chunk of each (start 32)
    attends gathered history; 8 greedy tokens each."""
    jm, jp, tm, tp = trained
    cache = dict(LAYOUT, kv_dtype=kv_dtype, recent_window=ring)
    jeng = JEngine(jm, jp, JEngineConfig(cache=JCacheConfig(**cache),
                                         **ENGINE), interpret=True)
    jeng.speculation_k = 0
    jids = [jeng.submit(p, NEW_TOKENS) for p in PROMPTS]
    jout = jeng.run()
    teng = InferenceEngine(tm, tp, EngineConfig(cache=CacheConfig(**cache),
                                                **ENGINE))
    teng.speculation_k = 0
    tids = [teng.submit(p, NEW_TOKENS) for p in PROMPTS]
    tout = teng.run()
    for ji, ti in zip(jids, tids):
        assert len(tout[ti]) == NEW_TOKENS
        assert tout[ti] == jout[ji], (bytes(tout[ti]), bytes(jout[ji]))
    np.testing.assert_allclose(
        np.concatenate([teng.logprobs[i] for i in tids]),
        np.concatenate([jeng.logprobs[i] for i in jids]), atol=0.05,
    )
    assert teng.metrics.decode_tokens == jeng.metrics.decode_tokens
    jeng.close()
    teng.close()


def test_engine_refuses_what_the_slice_does_not_port(trained):
    """Still refused: an admission policy the engine does not know (the
    JAX config's ValueError) and an adapter never registered (the JAX
    engine's "unknown adapter" ValueError). Optimistic admission now
    constructs (tests/test_torch_preemption.py holds it to JAX's tokens;
    n > 1 forks and logit_bias are held in
    tests/test_torch_fork_bias.py). An unresolved cache layout resolves
    (tests/test_torch_engine_tiers.py holds it to JAX's). Paged prefill,
    fused mixed steps and speculation (k = 8 by default) construct and
    step."""
    _, _, tm, tp = trained
    resolved = CacheConfig(**LAYOUT, recent_window=0)
    auto = InferenceEngine(tm, tp, EngineConfig(max_seq_len=256,
                                                cache=CacheConfig()))
    assert auto.config.cache.resolved
    with pytest.raises(ValueError, match="admission"):
        EngineConfig(cache=resolved, admission="eager")
    assert InferenceEngine(tm, tp, EngineConfig(
        cache=resolved, admission="optimistic")).scheduler.preempt_hook
    eng = InferenceEngine(tm, tp, EngineConfig(cache=resolved))
    with pytest.raises(ValueError, match="unknown adapter 'x'"):
        eng.submit([1, 2, 3], 4, lora="x")
    assert eng.cancel(eng.submit([1, 2, 3], 4))
    assert not eng.scheduler.has_work()
    eng = InferenceEngine(tm, tp, EngineConfig(
        cache=resolved, paged_prefill=True, fused_mixed_step=True,
        **{k: v for k, v in ENGINE.items()
           if k not in ("paged_prefill", "fused_mixed_step")}))
    assert eng.speculation_k == 8
    rid = eng.submit(PROMPTS[1], 12)
    eng.step()
    eng.submit(PROMPTS[0], 12)
    out = eng.run()
    assert len(out[rid]) == 12
    assert eng.speculation_stats()["proposed"] >= 0


def test_jax_is_on_cpu():
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize(
    "variant",
    [dict(), dict(sliding_window=6, attn_softcap=8.0, attn_sinks=True),
     dict(attn_alibi=True)],
    ids=["plain", "window-softcap-sinks", "alibi"],
)
def test_engine_matches_cache_free_greedy_loop(variant):
    """The engine's gathered-history route (pages a window can no longer
    see dropped), unfused steps, burst decode and cache on an f32 model
    give the tokens of re-running the whole sequence through the model at
    every step, with no cache at all."""
    import dataclasses

    from tpu_flash_torch.models import TINY_TEST, FlashTransformer

    cfg = dataclasses.replace(TINY_TEST, **variant)
    model = FlashTransformer(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    if cfg.attn_sinks:
        for i, layer in enumerate(params["layers"]):
            layer["sinks"] = torch.linspace(-1.0, 1.0, cfg.num_q_heads) * i
    eng = InferenceEngine(model, params, EngineConfig(
        max_batch_size=2, max_seq_len=48, prefill_chunk=8,
        max_decode_burst=3,
        cache=CacheConfig(page_size=4, num_pages=25, max_pages_per_seq=12,
                          kv_dtype="float32", recent_window=0),
        paged_prefill=False, fused_mixed_step=False,
    ))
    eng.speculation_k = 0
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).tolist() for n in (19, 11)]
    ids = [eng.submit(p, 7) for p in prompts]
    out = eng.run()
    for rid, prompt in zip(ids, prompts):
        seq = list(prompt)
        for _ in range(7):
            logits = model.forward(params, torch.tensor([seq]))
            seq.append(int(logits[0, -1].argmax()))
        assert out[rid] == seq[len(prompt):]


def test_engine_sampling_and_stop_tokens():
    """Temperature/top-k sampling through the engine repeats under the
    same seed and varies across steps, beside a greedy request in the
    same batch; a stop token ends its request early (and is emitted)."""
    from tpu_flash_torch.engine import SamplingParams
    from tpu_flash_torch.models import TINY_TEST, FlashTransformer

    model = FlashTransformer(TINY_TEST, device="cpu")
    params = model.init(torch.Generator().manual_seed(3))

    def serve(seed):
        eng = InferenceEngine(model, params, EngineConfig(
            max_batch_size=2, max_seq_len=32, prefill_chunk=8,
            cache=CacheConfig(page_size=8, num_pages=9, max_pages_per_seq=4,
                              kv_dtype="bfloat16", recent_window=0),
        ), seed=seed)
        sampled = eng.submit([5, 6, 7, 8], 12, SamplingParams(
            temperature=0.8, top_k=3))
        greedy = eng.submit([9, 10, 11], 12)
        out = eng.run()
        return out[sampled], out[greedy], eng

    a, g, eng = serve(0)
    b, g2, _ = serve(0)
    assert a == b and g == g2 and len(a) == 12
    assert len(set(a)) > 1
    stop = g[3]
    eng.submit([9, 10, 11], 12, stop_tokens=[stop])
    out = eng.run()
    assert out[max(out)] == g[:g.index(stop) + 1]
