"""The port's checkpoint store (``tpu_flash_torch.checkpoint.store``), the
cases of ``tests/test_checkpoint.py`` and the snapshot cases of the
preemption, LoRA, fork and logit-bias tests.

One JAX engine run (TINY_TEST, an int8 cache with a 4-token ring, Pallas
in interpret mode, the gathered unfused route without speculation), in a
module fixture, is snapshotted mid-decode and run to its end. The port's
engine on the same weights, snapshotted at the same step, must hold the
JAX snapshot's keys and arrays (int8 payloads within one code and scales
within 1e-6 relative: both quantize the same K/V, which differ only in
summation order), and a fresh engine restored from it must finish with
the JAX engine's tokens. Everything else is torch against torch:
params and train-checkpoint round trips (training resumed from a
checkpoint takes bit for bit the uninterrupted losses), and snapshots
that resume to the uninterrupted tokens with a swapped victim, a
recomputed one, adapters, forks with logit bias and waiting groups, and
sampled requests (the generator's state travels along).
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
from tpu_flash_torch.checkpoint import (
    TrainCheckpointManager,
    params_from_jax,
    restore_engine,
    restore_params,
    save_params,
    snapshot_engine,
)
from tpu_flash_torch.core.config import CacheConfig, EngineConfig
from tpu_flash_torch.engine import InferenceEngine, SamplingParams
from tpu_flash_torch.models import TINY_TEST, FlashTransformer
from tpu_flash_torch.parallel import make_train_step, param_leaves


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
BUDGET = 9  # one prefill and one 4-step decode program in JAX
CACHE = dict(page_size=4, num_pages=64, max_pages_per_seq=16,
             kv_dtype="int8", recent_window=4)
ENGINE = dict(max_batch_size=3, max_seq_len=256, prefill_chunk=8,
              prefix_cache=False, paged_prefill=False,
              fused_mixed_step=False, max_decode_burst=4)
SNAP_STEP = 3


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's snapshot arrays after SNAP_STEP steps, its final
    tokens, and its params as numpy arrays."""
    import jax

    jm = JFlashTransformer(J_TINY_TEST)
    jp = jm.init(jax.random.PRNGKey(0))
    eng = JEngine(jm, jp, JEngineConfig(cache=JCacheConfig(**CACHE),
                                        **ENGINE), interpret=True)
    eng.speculation_k = 0
    ids = [eng.submit(p, BUDGET) for p in PROMPTS]
    for _ in range(SNAP_STEP):
        eng.step()
    snap = tmp_path_factory.mktemp("jax_snap")
    j_snapshot_engine(snap, eng)
    arrays = dict(np.load(snap / "engine_arrays.npz"))
    eng.run()
    out = [eng.outputs[i] for i in ids]
    eng.close()
    return arrays, out, jax.tree.map(np.asarray, jp)


def _int8_engine(params):
    eng = InferenceEngine(FlashTransformer(TINY_TEST, device="cpu"), params,
                          EngineConfig(cache=CacheConfig(**CACHE), **ENGINE))
    eng.speculation_k = 0
    return eng


def test_snapshot_matches_jax_and_resumes(jax_run, tmp_path):
    """Keys and arrays against the JAX snapshot at the same step; the
    restored engine finishes with the JAX engine's tokens."""
    theirs, want, np_params = jax_run
    params = params_from_jax(np_params, device="cpu")
    eng = _int8_engine(params)
    ids = [eng.submit(p, BUDGET) for p in PROMPTS]
    for _ in range(SNAP_STEP):
        eng.step()
    snapshot_engine(tmp_path, eng)
    ours = dict(np.load(tmp_path / "engine_arrays.npz"))
    assert set(ours) == set(theirs)
    for key in ("k_pages", "v_pages"):
        assert ours[key].dtype == np.int8
        np.testing.assert_allclose(ours[key], theirs[key], atol=1,
                                   err_msg=key)
    for key in ("k_scales", "v_scales"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-6,
                                   err_msg=key)
    for key in ("k_recent", "v_recent"):
        np.testing.assert_allclose(ours[key], theirs[key], atol=2e-2,
                                   rtol=2e-2, err_msg=key)  # bf16 rows
    for key in ("page_tables", "lengths", "last_tokens", "active",
                "top_ks", "lora_ids", "slot_bias"):
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    fresh = _int8_engine(params)
    restore_engine(tmp_path, fresh)
    fresh.run()
    assert [fresh.outputs[i] for i in ids] == want


# -- params and training -----------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    model = FlashTransformer(TINY_TEST, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def test_params_round_trip(tiny, tmp_path):
    model, params = tiny
    save_params(tmp_path / "p", params)
    got = restore_params(tmp_path / "p", device="cpu")
    for a, b in zip(param_leaves(got), param_leaves(dict(params))):
        assert torch.equal(a, b)
    with pytest.raises(FileExistsError):
        save_params(tmp_path / "p", params, force=False)
    like = {**params, "embed": params["embed"].double()}
    assert restore_params(tmp_path / "p", like=like)["embed"].dtype == \
        torch.float64
    with pytest.raises(ValueError, match="structure"):
        restore_params(tmp_path / "p", like={"embed": params["embed"]})


def test_train_manager_keeps_n(tiny, tmp_path):
    _, params = tiny
    with TrainCheckpointManager(tmp_path / "ck", max_to_keep=2) as mgr:
        assert mgr.latest_step() is None
        assert mgr.restore_latest() is None
        for step in (1, 2, 3):
            mgr.save(step, {"w": torch.full((2,), float(step))})
        assert mgr.latest_step() == 3
        assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
            ["2", "3"]
        step, got, opt = mgr.restore_latest(device="cpu")
    assert step == 3 and opt is None and torch.equal(got["w"],
                                                     torch.full((2,), 3.0))


def test_training_resumes_bit_for_bit(tmp_path):
    """AdamW with a norm clip: a checkpoint after step 2 restored into
    fresh params and a fresh optimizer takes steps 3-4 with the
    uninterrupted run's losses and weights, bit for bit."""
    model = FlashTransformer(TINY_TEST, device="cpu")
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, 256, (2, 17)))
               for _ in range(4)]

    def fresh():
        params = model.init(torch.Generator().manual_seed(3))
        opt = torch.optim.AdamW(param_leaves(params), lr=1e-2,
                                weight_decay=0.01)
        return params, opt, make_train_step(model, optimizer=opt,
                                            max_grad_norm=1.0)

    params, opt, step = fresh()
    want = [float(step(params, b)) for b in batches]
    params, opt, step = fresh()
    mgr = TrainCheckpointManager(tmp_path / "ck")
    for b in batches[:2]:
        step(params, b)
    mgr.save(2, params, opt.state_dict())
    final = {k: v for k, v in params.items() if k != "layers"}
    del params, opt, step
    params, opt, step = fresh()  # other objects, reset weights
    k, restored, opt_state = mgr.restore_latest(like_params=params)
    assert k == 2
    params = restored
    opt = torch.optim.AdamW(param_leaves(params), lr=1e-2,
                            weight_decay=0.01)
    opt.load_state_dict(opt_state)
    step = make_train_step(model, optimizer=opt, max_grad_norm=1.0)
    got = [float(step(params, b)) for b in batches[2:]]
    assert got == want[2:]
    assert not torch.equal(final["embed"], params["embed"])


# -- engine snapshots, torch against torch -----------------------------------


def _adapter(seed=7, rank=4):
    rng = np.random.default_rng(seed)

    def ab(fan_in, fan_out):
        return ((rng.standard_normal((fan_in, rank), dtype=np.float32)
                 * (0.5 / fan_in ** 0.5)),
                rng.standard_normal((rank, fan_out), dtype=np.float32))

    return {0: {"wq": ab(64, 64), "w_up": ab(64, 128)},
            1: {"wo": ab(64, 64), "w_down": ab(128, 64)}}


def _engine(tiny, *, admission="optimistic", preemption="swap",
            num_pages=10, kv_dtype="int8", ring=4, lora=False, max_batch=3):
    model, params = tiny
    eng = InferenceEngine(model, params, EngineConfig(
        max_batch_size=max_batch, max_seq_len=256, prefill_chunk=8,
        max_decode_burst=4,
        cache=CacheConfig(page_size=4, num_pages=num_pages,
                          max_pages_per_seq=16, kv_dtype=kv_dtype,
                          recent_window=ring),
        prefix_cache=False, admission=admission, preemption=preemption))
    if lora:
        eng.register_lora("a", _adapter())
    return eng


def _resumes(tiny, tmp_path, submit, until, lora=False, **kw):
    """Run ``submit(engine)`` to the end once; run it again to the first
    step ``until(engine)`` holds, snapshot, restore into a fresh engine
    and run that to the end. Returns (uninterrupted outputs, resumed
    outputs, logprobs of both, the snapshotted engine)."""
    ref = _engine(tiny, lora=lora, **kw)
    ids = submit(ref)
    ref.run()
    eng = _engine(tiny, lora=lora, **kw)
    assert submit(eng) == ids
    for _ in range(60):
        if until(eng):
            break
        eng.step()
    assert until(eng), "the scenario never reached its snapshot point"
    snapshot_engine(tmp_path / "snap", eng)
    fresh = _engine(tiny, lora=lora, **kw)
    restore_engine(tmp_path / "snap", fresh)
    fresh.run()
    return ([ref.outputs[i] for i in ref.outputs],
            [fresh.outputs[i] for i in ref.outputs],
            ([ref.logprobs[i] for i in ref.outputs],
             [fresh.logprobs[i] for i in ref.outputs]), eng)


def _submit_three(eng, **kw):
    return [eng.submit(p, 12, **kw) for p in PROMPTS]


def test_snapshot_with_swapped_victim(tiny, tmp_path):
    want, got, _, eng = _resumes(tiny, tmp_path, _submit_three,
                                 lambda e: bool(e._swapped))
    assert got == want and eng.scheduler.num_preemptions > 0


def test_snapshot_with_recomputed_victim(tiny, tmp_path):
    """Snapshot while a folded victim waits with its resume token (f32
    pages: recompute is exact there)."""
    def folded(e):
        return any(r.resume_token is not None for r in e.scheduler.waiting)

    want, got, _, _ = _resumes(tiny, tmp_path, _submit_three, folded,
                               preemption="recompute", kv_dtype="float32",
                               ring=0)
    assert got == want


def test_snapshot_with_adapters(tiny, tmp_path):
    """Adapted requests mid-decode; a fresh engine without the adapter is
    refused, with it the streams resume."""
    def submit(e):
        return [e.submit(p, 12, lora="a" if i != 1 else None)
                for i, p in enumerate(PROMPTS)]

    want, got, _, eng = _resumes(tiny, tmp_path, submit,
                                 lambda e: bool(e._swapped), lora=True)
    assert got == want
    with pytest.raises(ValueError, match="re-register"):
        restore_engine(tmp_path / "snap", _engine(tiny))


def test_snapshot_with_forks_bias_and_waiting_group(tiny, tmp_path):
    """A running n=2 group with a ban, a neighbour, and a waiting n=2
    group (its children inline in the snapshot) on a reserve engine with
    two slots too few for all of them."""
    ban = {t: -100.0 for t in range(0, 256, 3)}

    def submit(e):
        return [e.submit(PROMPTS[0], 10, n=2, logit_bias=ban),
                e.submit(PROMPTS[1], 10),
                e.submit(PROMPTS[2], 10, n=2)]

    def mid(e):
        return (e.scheduler.waiting and e.scheduler.waiting[0]._children_reqs
                and any(len(o) > 2 for o in e.outputs.values()))

    want, got, _, _ = _resumes(tiny, tmp_path, submit, mid,
                               admission="reserve", num_pages=64,
                               max_batch=3)
    assert got == want
    assert not any(t % 3 == 0 for t in want[0])


def test_snapshot_sampled_requests(tiny, tmp_path):
    """Sampled requests: the generator's state travels in the snapshot,
    so the resumed draws (and log-probs) are the uninterrupted run's."""
    sp = SamplingParams(temperature=0.9, top_k=20)
    want, got, (lp_want, lp_got), _ = _resumes(
        tiny, tmp_path, lambda e: _submit_three(e, sampling=sp),
        lambda e: any(len(o) >= 4 for o in e.outputs.values()),
        admission="reserve", num_pages=64)
    assert got == want and lp_got == lp_want


def test_restore_refuses_another_layout(tiny, tmp_path):
    eng = _engine(tiny)
    _submit_three(eng)
    eng.step()
    snapshot_engine(tmp_path, eng)
    with pytest.raises(ValueError, match="kv_dtype"):
        restore_engine(tmp_path, _engine(tiny, kv_dtype="float32", ring=0))
    with pytest.raises(ValueError, match="cache shape"):
        restore_engine(tmp_path, _engine(tiny, num_pages=12))
