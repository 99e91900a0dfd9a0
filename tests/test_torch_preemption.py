"""Optimistic admission with recompute and swap preemption in the port's
engine, the cases of ``tests/test_preemption.py``.

One JAX engine run (TINY_TEST in f32, Pallas in interpret mode, reserve
admission on a roomy pool, the gathered unfused route without
speculation), in a module fixture, serves three prompts, one of them
through a LoRA adapter, and is snapshotted once mid-decode. The port's
engine on the same weights (``params_from_jax``) and adapter must give
its tokens under optimistic admission on a pool too small for the three,
in both preemption modes, and its own reserve run's; its snapshot at the
same step must hold the JAX snapshot's arrays (pages, tables, lengths,
slot state; f32, so within 1e-5). Everything else is torch against
torch: a staggered mid-prefill victim, fork groups under pressure, pages
draining to zero, priorities, sampled requests, the int8 + ring, int4
and k8v4 tiers, the engine's default routes, logit bias and adapters
reinstalled after a swap, ``cancel`` of a swapped request and each
restore byte for byte against the pages and ring row swapped out.
Greedy outputs must be exactly the reserve run's: any KV corruption,
token sampled again or lost page shows as divergence.
"""

import numpy as np
import pytest
import torch

from tpu_flash.checkpoint.store import snapshot_engine as j_snapshot_engine
from tpu_flash.core.config import CacheConfig as JCacheConfig
from tpu_flash.core.config import EngineConfig as JEngineConfig
from tpu_flash.engine.runner import InferenceEngine as JEngine
from tpu_flash.models import TINY_TEST as J_TINY_TEST
from tpu_flash.models import FlashTransformer as JFlashTransformer
from tpu_flash_torch.checkpoint import params_from_jax, snapshot_engine
from tpu_flash_torch.core.config import CacheConfig, EngineConfig
from tpu_flash_torch.engine import InferenceEngine, SamplingParams
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


PROMPTS = [
    [3, 1, 4, 1, 5, 9, 2, 6],
    [2, 7, 1, 8, 2, 8, 1, 8],
    [1, 6, 1, 8, 0, 3, 3, 9],
]
# One 8-token chunk and two 4-step bursts after the first token: the JAX
# engine compiles one prefill and one decode program.
BUDGET = 9
# Each request needs ceil((8 + 9) / 4) = 5 pages at full context; 9
# usable pages cannot hold three, so optimistic admission preempts.
ROOMY, TIGHT = 64, 10
ROUTE = dict(paged_prefill=False, fused_mixed_step=False, max_decode_burst=4)
SNAP_STEP = 3  # the prefill step, then two steps of decode


def _adapter(cfg, seed=7, rank=4):
    """Seeded rank-4 LoRA factors on wq and w_up of layer 0 and wo and
    w_down of layer 1, large enough to change greedy tokens."""
    rng = np.random.default_rng(seed)
    h, qd, inter = cfg.hidden_size, cfg.num_q_heads * cfg.head_dim, \
        cfg.intermediate_size

    def ab(fan_in, fan_out):
        return ((rng.standard_normal((fan_in, rank), dtype=np.float32)
                 * (0.5 / fan_in ** 0.5)),
                rng.standard_normal((rank, fan_out), dtype=np.float32))

    return {0: {"wq": ab(h, qd), "w_up": ab(h, inter)},
            1: {"wo": ab(qd, h), "w_down": ab(inter, h)}}


def _submit_all(eng):
    return [eng.submit(p, BUDGET, lora="a" if i == 1 else None)
            for i, p in enumerate(PROMPTS)]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's tokens for the three requests (reserve admission),
    its snapshot's arrays after SNAP_STEP steps, and its params as numpy
    arrays."""
    import jax

    jm = JFlashTransformer(J_TINY_TEST)
    jp = jm.init(jax.random.PRNGKey(0))
    eng = JEngine(jm, jp, JEngineConfig(
        max_batch_size=3, max_seq_len=256, prefill_chunk=8,
        cache=JCacheConfig(page_size=4, num_pages=ROOMY,
                           max_pages_per_seq=16, kv_dtype="float32",
                           recent_window=0),
        prefix_cache=False, **ROUTE), interpret=True)
    eng.speculation_k = 0
    eng.register_lora("a", _adapter(J_TINY_TEST))
    ids = _submit_all(eng)
    for _ in range(SNAP_STEP):
        eng.step()
    snap = tmp_path_factory.mktemp("jax_snap")
    j_snapshot_engine(snap, eng)
    arrays = dict(np.load(snap / "engine_arrays.npz"))
    eng.run()
    out = [eng.outputs[i] for i in ids]
    eng.close()
    return out, arrays, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def model_params(jax_run):
    return (FlashTransformer(TINY_TEST, device="cpu"),
            params_from_jax(jax_run[2], device="cpu"))


def _engine(mp, *, admission="reserve", preemption="recompute",
            num_pages=ROOMY, page_size=4, max_batch=3, prefill_chunk=8,
            kv_dtype="float32", ring=0, route=ROUTE, spec=0, adapter=True,
            prefix_cache=False, draft=None):
    model, params = mp
    eng = InferenceEngine(model, params, EngineConfig(
        max_batch_size=max_batch, max_seq_len=256,
        prefill_chunk=prefill_chunk,
        cache=CacheConfig(page_size=page_size, num_pages=num_pages,
                          max_pages_per_seq=16, kv_dtype=kv_dtype,
                          recent_window=ring),
        prefix_cache=prefix_cache, admission=admission,
        preemption=preemption, **route), draft=draft)
    eng.speculation_k = spec
    if adapter:
        eng.register_lora("a", _adapter(TINY_TEST))
    return eng


def _serve(eng, prompts=PROMPTS, budget=BUDGET, **submit_kw):
    ids = [eng.submit(p, budget, **submit_kw) for p in prompts]
    eng.run()
    return [eng.outputs[i] for i in ids]


@pytest.fixture(scope="module")
def reserve(model_params):
    eng = _engine(model_params)
    ids = _submit_all(eng)
    eng.run()
    return [eng.outputs[i] for i in ids]


def test_reserve_matches_jax(jax_run, reserve):
    """The port's reserve run, the adapted request included, gives the
    JAX engine's tokens."""
    assert reserve == jax_run[0]


@pytest.mark.parametrize("preemption", ["recompute", "swap"])
def test_optimistic_under_pressure_matches_jax(jax_run, model_params,
                                               reserve, preemption):
    """TIGHT pages force preemption; every greedy stream, the adapted one
    included, is the JAX engine's and the reserve run's, and the pool
    drains to where it started."""
    eng = _engine(model_params, admission="optimistic",
                  preemption=preemption, num_pages=TIGHT)
    free0 = eng.scheduler.allocator.num_free
    ids = _submit_all(eng)
    eng.run()
    assert [eng.outputs[i] for i in ids] == jax_run[0] == reserve
    assert eng.scheduler.num_preemptions > 0
    assert eng.scheduler.allocator.num_free == free0
    assert not eng._swapped


def test_snapshot_arrays_match_jax(jax_run, model_params, tmp_path):
    """The port's snapshot after the same steps holds the JAX snapshot's
    keys, and its pages, tables, lengths and slot state (f32 pages within
    1e-5: the two differ only in summation order)."""
    eng = _engine(model_params)
    _submit_all(eng)
    for _ in range(SNAP_STEP):
        eng.step()
    snapshot_engine(tmp_path, eng)
    ours = dict(np.load(tmp_path / "engine_arrays.npz"))
    theirs = jax_run[1]
    assert set(ours) == set(theirs)
    for key in ("k_pages", "v_pages", "logit_bias", "temps", "top_ps",
                "min_ps"):
        np.testing.assert_allclose(ours[key], theirs[key], atol=1e-5,
                                   err_msg=key)
    for key in ("page_tables", "lengths", "last_tokens", "active",
                "top_ks", "lora_ids", "slot_bias"):
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    assert ours["lengths"].max() > len(PROMPTS[0])  # mid-decode


def test_no_pressure_never_preempts(model_params, reserve):
    eng = _engine(model_params, admission="optimistic")
    ids = _submit_all(eng)
    eng.run()
    assert [eng.outputs[i] for i in ids] == reserve
    assert eng.scheduler.num_preemptions == 0


@pytest.mark.parametrize("preemption", ["recompute", "swap"])
def test_staggered_mid_prefill_victims(model_params, preemption):
    """Later arrivals while a long prompt is mid-prefill (4-token chunks):
    preemption can catch a sequence in PREFILL; streams stay the
    reserve run's."""
    long_prompt = (PROMPTS[0] * 3)[:20]

    def run(**kw):
        eng = _engine(model_params, prefill_chunk=4, **kw)
        a = eng.submit(long_prompt, 8)
        eng.step()
        b = eng.submit(PROMPTS[1], 10)
        c = eng.submit(PROMPTS[2], 6, lora="a")
        eng.run()
        return [eng.outputs[i] for i in (a, b, c)], eng

    want, _ = run()
    got, eng = run(admission="optimistic", preemption=preemption,
                   num_pages=TIGHT)
    assert got == want
    assert eng.scheduler.num_preemptions > 0


@pytest.mark.parametrize("preemption", ["recompute", "swap"])
def test_fork_group_under_pressure(model_params, preemption):
    """An n=2 greedy group beside another request on a tight pool: each
    branch gives the prompt's solo stream."""
    ref = _engine(model_params)
    solo, other = _serve(ref, PROMPTS[:2], 8)
    eng = _engine(model_params, admission="optimistic",
                  preemption=preemption, num_pages=TIGHT)
    g = eng.submit(PROMPTS[0], 8, n=2)
    o = eng.submit(PROMPTS[1], 8)
    eng.run()
    assert [eng.outputs[b] for b in eng.branches(g)] == [solo, solo]
    assert eng.outputs[o] == other
    assert eng.scheduler.num_preemptions > 0


@pytest.mark.parametrize("preemption", ["recompute", "swap"])
def test_prefork_group_preemption_detaches_branches(model_params,
                                                    preemption):
    """FORK_WAIT branches and then their prefilling parent preempted: the
    branches re-admit as independent requests (never twice); streams stay
    exact."""
    long_prompt = (PROMPTS[2] * 3)[:20]

    def run(**kw):
        eng = _engine(model_params, prefill_chunk=4, max_batch=4, **kw)
        a = eng.submit(PROMPTS[0], 14)
        eng.step()
        g = eng.submit(long_prompt, 6, n=2)
        eng.run()
        return [eng.outputs[i] for i in [a] + eng.branches(g)], eng

    want, _ = run()
    got, eng = run(admission="optimistic", preemption=preemption,
                   num_pages=11)
    assert got == want
    assert eng.scheduler.num_preemptions > 0


def test_pages_drain_with_prefix_cache(model_params):
    """Swap mode with the prefix cache on: once the index drops its
    retained pages, every page is free and no stash is left."""
    eng = _engine(model_params, admission="optimistic", preemption="swap",
                  num_pages=TIGHT, prefix_cache=True)
    free0 = eng.scheduler.allocator.num_free
    _serve(eng)
    eng.prefix_index.drop_all()
    assert eng.scheduler.allocator.num_free == free0
    assert not eng._swapped


def test_priority_never_evicts_higher(model_params):
    """The low-priority sequence is always the victim; both streams stay
    the reserve run's."""
    ref = _engine(model_params)
    a, b = _serve(ref, PROMPTS[:2], 12)
    eng = _engine(model_params, admission="optimistic", num_pages=8)
    seen = []
    orig = eng.scheduler._preempt
    eng.scheduler._preempt = lambda v: (seen.append(v.req_id), orig(v))[1]
    hi = eng.submit(PROMPTS[0], 12, priority=3)
    lo = eng.submit(PROMPTS[1], 12, priority=0)
    eng.run()
    assert [eng.outputs[hi], eng.outputs[lo]] == [a, b]
    assert seen and hi not in seen


@pytest.mark.parametrize("preemption", ["recompute", "swap"])
def test_sampled_requests_complete(model_params, preemption):
    """Sampled requests under preemption deliver every token of their
    budget with valid log-probs."""
    eng = _engine(model_params, admission="optimistic",
                  preemption=preemption, num_pages=TIGHT)
    sp = SamplingParams(temperature=1.0)
    ids = [eng.submit(p, BUDGET, sampling=sp) for p in PROMPTS]
    eng.run()
    assert eng.scheduler.num_preemptions > 0
    for r in ids:
        assert len(eng.outputs[r]) == BUDGET == len(eng.logprobs[r])
        assert all(lp <= 0.0 for lp in eng.logprobs[r])


def test_submit_rejects_impossible_request(model_params):
    eng = _engine(model_params, admission="optimistic", num_pages=6)
    with pytest.raises(ValueError, match="pages"):
        eng.submit(PROMPTS[0], 40)


# (kv dtype, preemption) with a 4-token ring: the ring is stashed and
# restored with the pages; int4 packs two tokens a byte; k8v4 mixes the
# layouts and gathers its history. Swap restores every byte, so every
# tier holds the reserve run's tokens. Recompute prefills the folded
# tokens again, and their 4-bit codes may round otherwise than those
# decode wrote: in this scenario int4 and k8v4 then leave the reserve
# run's stream at one token of the third request, as the JAX engine's
# recompute does, token for token (ROADMAP, known reference quirks); so
# recompute is held to it on int8.
TIERS = [("int8", "swap"), ("int4", "swap"), ("k8v4", "swap"),
         ("int8", "recompute")]


@pytest.mark.parametrize("kv_dtype,preemption", TIERS)
def test_quantized_tiers(model_params, kv_dtype, preemption):
    kw = dict(kv_dtype=kv_dtype, ring=4)
    want = _serve(_engine(model_params, **kw))
    eng = _engine(model_params, admission="optimistic",
                  preemption=preemption, num_pages=TIGHT, **kw)
    assert _serve(eng) == want
    assert eng.scheduler.num_preemptions > 0


@pytest.mark.parametrize("preemption", ["recompute", "swap"])
def test_default_routes(model_params, preemption):
    """The engine's default routing (paged prefill, fused steps, k 8
    speculation, here with the model drafting for itself, so every
    decode step verifies) under pressure against the reserve run at the
    same defaults."""
    defaults = dict(route={}, spec=8, draft=model_params)
    prompts = [PROMPTS[0] * 2, PROMPTS[1], PROMPTS[2] * 2]
    want = _serve(_engine(model_params, **defaults), prompts)
    eng = _engine(model_params, admission="optimistic",
                  preemption=preemption, num_pages=TIGHT + 2, **defaults)
    assert _serve(eng, prompts) == want
    assert eng.scheduler.num_preemptions > 0
    assert eng.speculation_stats()["proposed"] > 0


def test_swap_reinstalls_bias_and_adapter(model_params):
    """A banned-token request and an adapted one, swapped out and back:
    the ban and the adapter hold after the restore (the streams are the
    reserve run's, no banned token)."""
    ban = {t: -100.0 for t in range(0, 256, 2)}

    def run(**kw):
        eng = _engine(model_params, **kw)
        ids = [eng.submit(PROMPTS[0], BUDGET),
               eng.submit(PROMPTS[1], BUDGET, logit_bias=ban),
               eng.submit(PROMPTS[2], BUDGET, lora="a")]
        eng.run()
        return [eng.outputs[i] for i in ids], eng

    want, _ = run()
    got, eng = run(admission="optimistic", preemption="swap",
                   num_pages=TIGHT)
    assert got == want
    assert not any(t % 2 == 0 for t in got[1])
    assert eng.scheduler.num_preemptions > 0


def test_swap_restore_byte_for_byte(model_params):
    """Every restore writes back, byte for byte, what the victim's pages
    and ring row held when it was swapped out, on every tensor of the
    int8 tier (payloads, scales, ring): a copy taken in the scheduler's
    swap-out hook, before the engine gathers its stash."""
    eng = _engine(model_params, admission="optimistic", preemption="swap",
                  num_pages=TIGHT, kv_dtype="int8", ring=4)
    c = eng.cache
    tiers = (c.k_pages, c.v_pages, c.k_scales, c.v_scales)
    rings = (c.k_recent, c.v_recent)
    before, checked = {}, []
    swap_out, restore = eng.scheduler.swap_out_hook, eng._swap_restore

    def out_spy(req, pages):
        if req.req_id not in before and req.req_id not in eng._swapped:
            before[req.req_id] = (
                pages, [t[:, :, pages].clone() for t in tiers],
                [r[:, req.batch_slot].clone() for r in rings]
                if req.batch_slot >= 0 else [])
        swap_out(req, pages)

    def spy(req):
        restore(req)
        pages, arrays, ring_rows = before.pop(req.req_id)
        new = eng.scheduler.page_table(req.req_id)[:len(pages)]
        for t, a in zip(tiers, arrays, strict=True):
            assert torch.equal(t[:, :, new], a)
        for r, a in zip(rings, ring_rows):
            assert torch.equal(r[:, req.batch_slot], a)
        checked.append(len(ring_rows))

    eng.scheduler.swap_out_hook = out_spy
    eng._swap_restore = spy
    _serve(eng)
    assert checked and all(n == 2 for n in checked)


def test_cancel_drops_a_swapped_stash(model_params):
    eng = _engine(model_params, admission="optimistic", preemption="swap",
                  num_pages=TIGHT)
    ids = _submit_all(eng)
    for _ in range(40):
        if eng._swapped:
            break
        eng.step()
    (victim,) = eng._swapped
    assert eng.cancel(victim)
    assert victim not in eng._swapped
    eng.run()
    assert all(len(eng.outputs[i]) == BUDGET for i in ids if i != victim)
