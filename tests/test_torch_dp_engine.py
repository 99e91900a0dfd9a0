"""The port's data-parallel engine (``tpu_flash_torch/engine/dp.py``), in
process on ``devices=["cpu", "cpu"]`` (two replicas sharing the CPU, each
stepping in a thread of its own), and the kernel build's thread safety
that replica threads rely on (``ops/build.py``).

The cases of ``tests/test_dp_engine.py`` and the DP snapshot cases of
``tests/test_checkpoint.py``, torch against torch on
``checkpoints/tiny-byte-llama`` (f32 weights: batch composition changes
no greedy token there). Each request's tokens equal that request served
alone through one engine; routing is least-loaded with a round-robin
tie-break; too few devices, ``tp > 1`` and a missing card are refused;
an adapter registers on every replica; a snapshot mid-decode, in JAX's
layout (``replica_<i>/`` and ``dp_meta.json``), restores into a fresh DP
engine that finishes with the uninterrupted run's tokens.
"""

import json
import threading
import time

import pytest
import torch
import torch_dist_worker as W

from tpu_flash.checkpoint import store as j_store
from tpu_flash_torch.checkpoint import restore_dp_engine, snapshot_dp_engine
from tpu_flash_torch.core.config import CacheConfig, EngineConfig
from tpu_flash_torch.engine import DataParallelEngine, InferenceEngine
from tpu_flash_torch.ops import build

CPUS = ["cpu", "cpu"]
CONFIG = EngineConfig(
    cache=CacheConfig(**W.LAYOUT, kv_dtype="int8", recent_window=8),
    **W.ENGINE, **W.GATHERED)
PROMPTS = W.PROMPTS + W.SPEC_PROMPTS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained():
    return W.trained()


def _dp(model, params, replicas=2, **kw):
    dp = DataParallelEngine(model, params, CONFIG, replicas=replicas,
                            devices=CPUS, **kw)
    for eng in dp.engines:
        eng.speculation_k = 0
    return dp


@pytest.fixture(scope="module")
def solo(trained):
    """Each prompt served alone through one engine."""
    model, params = trained
    out = []
    for p in PROMPTS:
        eng = InferenceEngine(model, params, CONFIG)
        eng.speculation_k = 0
        rid = eng.submit(p, W.NEW_TOKENS)
        out.append(eng.run()[rid])
        eng.close()
    return out


def test_dp_matches_solo_runs(trained, solo):
    model, params = trained
    dp = _dp(model, params)
    ids = [dp.submit(p, W.NEW_TOKENS) for p in PROMPTS]
    out = dp.run()
    assert [out[i] for i in ids] == solo
    st = dp.stats()
    assert st["replicas"] == 2 and st["tp"] == 1
    assert [p["decode_tokens"] for p in st["per_replica"]] == [14, 14]
    assert len(dp.logprobs[ids[0]]) == W.NEW_TOKENS
    # The replicas share the weights (same device: nothing copied).
    w = params["layers"][0]["wq"]
    assert all(e.params["layers"][0]["wq"] is w for e in dp.engines)
    dp.close()


def test_routing_balances_load(trained):
    """Least-loaded first; among equal loads round-robin, so a burst
    spreads 0, 1, 0, 1, 0; an n=2 request's branches stay on its replica
    with fleet ids of their own."""
    model, params = trained
    dp = _dp(model, params)
    ids = [dp.submit(PROMPTS[i % 4][:20], 2) for i in range(5)]
    assert [dp._route[i][0] for i in ids] == [0, 1, 0, 1, 0]
    per = dp.stats()["per_replica"]
    assert [p["waiting"] + p["active"] for p in per] == [3, 2]
    rid = dp.submit(PROMPTS[0][:20], 3, n=2)
    assert dp._route[rid][0] == 1  # the less loaded
    assert dp.branches(rid) == [rid, rid + 1]
    assert dp._route[rid + 1][0] == 1
    out = dp.run()
    assert out[rid] == out[rid + 1] and len(out[rid]) == 3  # greedy
    dp.close()


def test_refusals(trained, monkeypatch):
    model, params = trained
    with pytest.raises(ValueError, match="needs 3 devices; 2 present"):
        DataParallelEngine(model, params, CONFIG, replicas=3, devices=CPUS)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        DataParallelEngine(model, params, CONFIG, replicas=1, tp=2,
                           devices=CPUS)
    with pytest.raises(ValueError, match="at least 1 replica"):
        DataParallelEngine(model, params, CONFIG, replicas=0, devices=CPUS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataParallelEngine(model, params, CONFIG, replicas=1)


def test_register_lora_reaches_every_replica(trained):
    model, params = trained
    dp = _dp(model, params)
    adapter = W.lora_adapter(model)
    assert dp.register_lora("a", adapter) == 1
    assert all(e.lora.names == ["a"] for e in dp.engines)
    ids = [dp.submit(PROMPTS[0], 4), dp.submit(PROMPTS[0], 4, lora="a")]
    out = dp.run()
    assert dp._route[ids[1]][0] == 1
    eng = InferenceEngine(model, params, CONFIG)
    eng.speculation_k = 0
    eng.register_lora("a", adapter)
    rid = eng.submit(PROMPTS[0], 4, lora="a")
    assert out[ids[1]] == eng.run()[rid]
    dp.close()


def test_dp_snapshot_round_trip(trained, tmp_path):
    model, params = trained
    dp = _dp(model, params)
    ids = [dp.submit(p, W.NEW_TOKENS) for p in PROMPTS]
    ids.append(dp.submit(PROMPTS[0][:24], 4, n=2))
    for _ in range(3):
        dp.step()
    snapshot_dp_engine(tmp_path, dp)
    want = dp.run()
    dp.close()
    # JAX's layout: one engine snapshot a replica, the routing table.
    assert j_store._DP_META == "dp_meta.json"
    meta = json.loads((tmp_path / "dp_meta.json").read_text())
    assert set(meta) == {"replicas", "tp", "route", "branch_ids", "next_id",
                         "rr"}
    assert meta["replicas"] == 2 and meta["next_id"] == len(want)
    for i in range(2):
        assert (tmp_path / f"replica_{i}" / "engine_meta.json").exists()
        assert (tmp_path / f"replica_{i}" / "engine_arrays.npz").exists()
    fresh = _dp(model, params)
    restore_dp_engine(tmp_path, fresh)
    assert fresh.branches(ids[-1]) == [ids[-1], ids[-1] + 1]
    assert fresh.run() == want
    fresh.close()
    with pytest.raises(ValueError, match="replicas"):
        restore_dp_engine(tmp_path, _dp(model, params, replicas=1))


# -- thread safety of the kernel build and the launch counts ------------------

class _StubLib:
    """A loaded library's stand-in: its entry returns 0 (no CUDA error)."""

    def __init__(self, symbol):
        setattr(self, symbol, self._entry)

    @staticmethod
    def _entry(*args):
        return 0


def test_first_build_runs_once_across_threads(tmp_path, monkeypatch):
    """Two replica threads that find the library unbuilt: one nvcc, one
    load, and both get the same entry point."""
    k = build.CudaKernel("stub", "stub_entry", [], replaces="none")
    lib_path = tmp_path / "libstub.so"
    builds, loads = [], []
    monkeypatch.setattr(k, "library_path", lambda: lib_path)

    def start_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)  # the window in which a second thread would race
        return "proc"

    def finish_build(proc):
        assert proc == "proc"
        lib_path.write_bytes(b"")

    monkeypatch.setattr(k, "start_build", start_build)
    monkeypatch.setattr(k, "finish_build", finish_build)

    def cdll(path):
        loads.append(path)
        return _StubLib("stub_entry")

    monkeypatch.setattr(build.ctypes, "CDLL", cdll)
    gate = threading.Barrier(2)
    got = []

    def call():
        gate.wait()
        got.append(k.function())

    threads = [threading.Thread(target=call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) == 2 and got[0] == got[1]


def test_launch_counts_are_not_lost_across_threads(monkeypatch):
    k = build.CudaKernel("stub", "stub_entry", [], replaces="none")
    k._lib = _StubLib("stub_entry")
    gate = threading.Barrier(8)

    def launches():
        gate.wait()
        for _ in range(500):
            k.launch(tag="t")

    threads = [threading.Thread(target=launches) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert k.launches == 4000 and k.launches_by_tag == {"t": 4000}
