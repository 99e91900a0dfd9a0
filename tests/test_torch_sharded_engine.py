"""Tensor-parallel serving in the port: ``InferenceEngine(mesh=...)`` on a
gloo CPU process group of 2 ranks, against the port's one-device engine
and the JAX package's ``InferenceEngine(mesh=...)`` at TP 2.

The checkpoint is ``checkpoints/tiny-byte-llama`` (4 q / 2 kv heads of
128, f32 weights), not random weights, whose greedy argmaxes sit on a
knife edge: TP changes the summation order of the row-sharded
projections, so token equality with one device holds only away from
near-ties. One spawned group (``tests/torch_dist_worker.py``, a module
fixture) runs every scenario of ``SCENARIOS`` on both ranks -- the
gathered route the JAX run takes, the default routes (paged prefill,
fused mixed steps, speculative verify) on f32 and int8 + ring with
staggered arrivals, sampled requests, swap preemption on a small pool, a
snapshot mid-decode, LoRA logits, ALiBi logits -- and the test process
runs the same functions on one device. One JAX engine run (f32 cache, one 32-token
chunk each, Pallas in interpret mode, TP 2 on the virtual CPU mesh)
shares a module fixture. Tolerances: tokens equal; LoRA logits within
5% of max |logit| of the one-device engine's (the bar of the LoRA
tests), ALiBi logits within 1e-4 of it, each with a control that misses.
"""

import os

import numpy as np
import pytest
import torch
import torch_dist_worker as W

from tpu_flash.checkpoint.convert import load_hf_dir as j_load_hf_dir
from tpu_flash.core.config import CacheConfig as JCacheConfig
from tpu_flash.core.config import EngineConfig as JEngineConfig
from tpu_flash.core.config import MeshConfig as JMeshConfig
from tpu_flash.engine.runner import InferenceEngine as JEngine
from tpu_flash.parallel import build_mesh as j_build_mesh
from tpu_flash.parallel.train import param_specs
from tpu_flash_torch.checkpoint import restore_engine
from tpu_flash_torch.models import shard_params

TOKEN_SCENARIOS = ("f32_gathered", "f32_default", "int8_default", "swap")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("tp"))
    return W.spawn("engine", 2, workdir), workdir


@pytest.fixture(scope="module")
def trained():
    return W.trained()


@pytest.fixture(scope="module")
def one_device(trained, tmp_path_factory):
    model, params = trained
    workdir = str(tmp_path_factory.mktemp("one"))
    return {name: fn(model, params, None, workdir)
            for name, fn in W.SCENARIOS.items()}


@pytest.fixture(scope="module")
def jax_tp():
    """The JAX engine at TP 2 on the f32_gathered scenario."""
    jm, jp = j_load_hf_dir(W.CKPT, dtype="float32")
    cfg = JEngineConfig(
        cache=JCacheConfig(**W.LAYOUT, kv_dtype="float32", recent_window=0),
        **W.ENGINE, **W.GATHERED)
    eng = JEngine(jm, jp, cfg, interpret=True,
                  mesh=j_build_mesh(JMeshConfig(model=2)))
    eng.speculation_k = 0
    ids = [eng.submit(p[:32], W.NEW_TOKENS) for p in W.PROMPTS]
    out = eng.run()
    eng.close()
    return [out[i] for i in ids]


def _tokens(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("name", TOKEN_SCENARIOS)
def test_tp_tokens_match_one_device(tp, one_device, name):
    ranks, _ = tp
    assert _tokens(ranks[0][name]) == _tokens(ranks[1][name])
    assert _tokens(ranks[0][name]) == _tokens(one_device[name])


def test_tp_matches_jax_tp_engine(tp, jax_tp):
    ranks, _ = tp
    assert ranks[0]["f32_gathered"] == jax_tp


def test_routes_and_preemption_under_tp(tp):
    """The default-route run reached fused steps and speculative verify,
    the small pool preempted: every dispatch site ran on the group."""
    ranks, _ = tp
    _, routes = ranks[0]["int8_default"]
    assert routes["fused"] >= 1 and routes["speculative"] >= 1
    assert routes["prefill_group"] >= 1 and routes["decode"] >= 1
    assert ranks[0]["swap"][1] >= 1


def test_each_rank_holds_half_the_kv_heads(tp):
    ranks, _ = tp
    for res in ranks:
        # pages and scales [L, hkv, ...], ring [L, slots, hkv, W, d]
        assert res["cache_heads"] == (1, 1, 1)
        shapes = res["param_shapes"]
        assert shapes["wq"] == (256, 256) and shapes["wk"] == (256, 128)
        assert shapes["wo"] == (256, 256) and shapes["w_down"] == (512, 256)
        assert shapes["attn_norm"] == (256,)


def test_seeded_sampling_agrees_across_ranks(tp):
    ranks, _ = tp
    assert ranks[0]["sampled"] == ranks[1]["sampled"]
    assert all(len(t) == W.NEW_TOKENS for t in ranks[0]["sampled"])


def test_tp_snapshot_restores_into_one_device(tp, trained):
    """Rank 0 wrote the global cache (both kv heads); a one-device engine
    restored from it finishes with the TP engine's uninterrupted
    tokens."""
    ranks, workdir = tp
    snap = os.path.join(workdir, "snap")
    arrays = np.load(os.path.join(snap, "engine_arrays.npz"))
    assert arrays["k_pages"].shape[1] == 2
    assert arrays["k_recent"].shape[2] == 2
    model, params = trained
    eng = W.engine(model, params, None, "int8", ring=8, **W.GATHERED)
    restore_engine(snap, eng)
    eng.run()
    assert [eng.outputs[i] for i in (0, 1)] == ranks[0]["snapshot"]


def test_tp_lora_logits(tp, one_device, trained):
    ranks, _ = tp
    got, ref = ranks[0]["lora_logits"], one_device["lora_logits"]
    assert torch.equal(got, ranks[1]["lora_logits"])
    bar = 0.05 * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= bar
    model, params = trained
    with torch.inference_mode():
        base = model.forward(params, torch.tensor([W.PROMPTS[0]]))
    assert float((base - ref).abs().max()) > bar


def test_tp_alibi_logits(tp, one_device, trained):
    """ALiBi under TP: each rank's engine attends with its own half of
    the slopes. Logits within 1e-4 of max |logit| of the one-device
    engine's (f32; only the row-sharded sums' order differs), a rope
    control missing it."""
    ranks, _ = tp
    got, ref = ranks[0]["alibi_logits"], one_device["alibi_logits"]
    assert torch.equal(got, ranks[1]["alibi_logits"])
    bar = 1e-4 * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= bar
    model, params = trained
    with torch.inference_mode():
        base = model.forward(params, torch.tensor([W.PROMPTS[0]]))
    assert float((base - ref).abs().max()) > bar


def test_indivisible_heads_rejected(tp):
    ranks, _ = tp
    for res in ranks:
        assert "must divide q heads (3)" in res["odd_heads"]


def test_shard_params_follows_jax_param_specs(trained):
    """Each weight splits along the dim JAX's param_specs shards on
    "model" (or not at all), and the two shards put together are the
    weight."""
    _, params = trained
    params = {**params, "layers": [dict(params["layers"][0],
                                        sinks=torch.arange(4.0))]}
    specs = param_specs(params)["layers"][0]
    shards = [shard_params(params, r, 2)["layers"][0] for r in range(2)]
    for name, w in params["layers"][0].items():
        spec = tuple(specs[name])
        if "model" in spec:
            dim = spec.index("model")
            assert shards[0][name].shape[dim] == w.shape[dim] // 2, name
            assert torch.equal(torch.cat([s[name] for s in shards], dim), w)
        else:
            assert all(s[name] is w for s in shards), name
    assert shard_params(params, 0, 1) is params
