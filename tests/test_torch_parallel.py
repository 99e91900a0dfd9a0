"""The port's multi-device attention (``tpu_flash_torch/parallel``) on gloo
CPU process groups, against the JAX package's ``parallel`` on its virtual
8-device CPU mesh and against the port's one-device kernels.

One group of 4 spawned ranks (``tests/torch_dist_worker.py``, a module
fixture; the ranks import no JAX) runs every case of ``ATTN_CASES`` --
``sharded_flash_attention`` and ``sharded_paged_attention`` on a model
axis of 4 (and data 2 x model 2), ring attention on a seq axis of 4
(causal; a window whose blocks are diagonal, dense, banded with rows
that see no key, and empty; ALiBi; sinks; non-causal; seq 2 x model 2
with sliced slopes), Ulysses on seq 4 (causal; window with softcap;
sinks with ALiBi) -- plus ``merge_over_axis`` and Ulysses' refusal of
indivisible heads. Each case is reassembled from its ranks' blocks.
Tolerances: ring outputs within 3e-5 (the JAX ring tests' bar: the merge
sums blocks in another order than one pass); sharded and Ulysses outputs
bit for bit the one-device call's (each rank runs the same plain version
on a slice of heads, and no row depends on another head); against JAX
3e-5, 2e-5 for paged decode (the JAX tests' bars). The single-process
ring schedule (``ring_attention_schedule``, what one card runs) is
checked torch against torch in-process, and against the distributed ring
bit for bit.

The same spawn takes the gradients of seven of the cases (``GRAD_CASES``:
ring causal, window with softcap, ALiBi, sinks, seq 2 x model 2 with
ALiBi and a window; Ulysses causal, sinks with ALiBi) for a seeded dO:
each rank's q, k, v (and sinks) gradients on the global inputs, summed
over the ranks, against the port's one-device ``flash_attention``
autograd (ring within 3e-5, the forward's bar: the gradient flows back
through the same merges; Ulysses bit for bit, as its forward), and the
ring's causal and window cases against ``jax.vjp`` of the JAX
``ring_attention`` on its 4-device seq mesh (3e-5). The output taken
with autograd on is the forward's, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch
import torch_dist_worker as W

from tpu_flash.core.config import MeshConfig as JMeshConfig
from tpu_flash.parallel import build_mesh as j_build_mesh
from tpu_flash.parallel import ring_attention as j_ring_attention
from tpu_flash.parallel import sharded_flash_attention as j_sharded_flash
from tpu_flash.parallel import sharded_paged_attention as j_sharded_paged
from tpu_flash.parallel import ulysses_attention as j_ulysses
from tpu_flash.parallel.mesh import mesh_for as j_mesh_for
from tpu_flash_torch.core.config import MeshConfig
from tpu_flash_torch.core.softmax import (
    empty_state,
    finalize,
    finalize_with_sinks,
    merge_softmax_states,
)
from tpu_flash_torch.ops.decode import paged_attention
from tpu_flash_torch.ops.flash import flash_attention
from tpu_flash_torch.ops.quant import QuantizedTensor, quantize_int8_rows
from tpu_flash_torch.parallel import build_mesh, initialize_multihost
from tpu_flash_torch.parallel.mesh import mesh_config_for
from tpu_flash_torch.parallel.ring import (
    block_kind,
    ring_attention_schedule,
    ring_block_state,
)

RING_TOL = dict(atol=3e-5, rtol=3e-5)
JAX_CASES = ("flash_tp", "paged_tp", "ring_causal", "ring_window",
             "ulysses_causal")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors (the suite
    runs several test workers on a few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return W.spawn("attention", 4, str(tmp_path_factory.mktemp("attn")))


def _inputs(name):
    return {k: torch.from_numpy(v) for k, v in W.attn_inputs(name).items()}


def _int8_pages(x):
    q, s = quantize_int8_rows(x)
    return QuantizedTensor(q, s, "int8", "lanes")


def _one_device(name):
    """The case on one device: the port's flash or paged call over the
    whole inputs."""
    _, entry, _, opts = W.ATTN_CASES[name]
    x = _inputs(name)
    if entry == "sharded_paged":
        kp, vp = x["k"], x["v"]
        if opts.get("int8"):
            kp, vp = _int8_pages(kp), _int8_pages(vp)
        return paged_attention(x["q"], kp, vp, x["lengths"], x["table"],
                               pages_per_compute_block=4)
    kw = {k: v for k, v in opts.items()
          if k in ("causal", "window", "softcap")}
    return flash_attention(x["q"], x["k"], x["v"], sinks=x.get("sinks"),
                           alibi=x.get("alibi"), **kw)


def _jax(name):
    """The case through the JAX package's own sharded function on the
    same mesh (Pallas in interpret mode)."""
    sizes, entry, _, opts = W.ATTN_CASES[name]
    x = W.attn_inputs(name)
    mesh = j_build_mesh(JMeshConfig(**sizes))
    kw = {k: v for k, v in opts.items()
          if k in ("causal", "window", "softcap")}
    if entry == "sharded_flash":
        out = j_sharded_flash(mesh, interpret=True, **kw)(
            x["q"], x["k"], x["v"])
    elif entry == "sharded_paged":
        out = j_sharded_paged(mesh, interpret=True)(
            x["q"], x["k"], x["v"], x["lengths"], x["table"])
    elif entry == "ring":
        out = j_ring_attention(x["q"], x["k"], x["v"], mesh, interpret=True,
                               **kw)
    else:
        out = j_ulysses(mesh, interpret=True, **kw)(x["q"], x["k"], x["v"])
    return np.asarray(out)


def _gathered(group, name):
    return W.assemble([res[name] for res in group])


@pytest.mark.parametrize("name", sorted(W.ATTN_CASES))
def test_case_against_one_device(group, name):
    got = _gathered(group, name)
    ref = _one_device(name)
    assert got.shape == ref.shape
    if W.ATTN_CASES[name][1] == "ring":
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **RING_TOL)
    else:
        assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("name", JAX_CASES)
def test_case_against_jax(group, name):
    got = _gathered(group, name).numpy()
    tol = 2e-5 if W.ATTN_CASES[name][1] == "sharded_paged" else 3e-5
    np.testing.assert_allclose(got, _jax(name), atol=tol, rtol=tol)


def _grad_sum(group, name):
    """Each input's gradient summed over the ranks (each rank's is zero
    outside the blocks it read)."""
    grads = [res[f"{name}:grad"] for res in group]
    return {k: sum(g[k] for g in grads) for k in grads[0]}


def _one_device_grads(name):
    _, _, _, opts = W.ATTN_CASES[name]
    x = {k: v.requires_grad_(k in W.GRAD_INPUTS)
         for k, v in _inputs(name).items()}
    kw = {k: v for k, v in opts.items()
          if k in ("causal", "window", "softcap")}
    out = flash_attention(x["q"], x["k"], x["v"], sinks=x.get("sinks"),
                          alibi=x.get("alibi"), **kw)
    (out * torch.from_numpy(W.attn_cotangent(name))).sum().backward()
    return {k: x[k].grad for k in W.GRAD_INPUTS if k in x}


@pytest.mark.parametrize("name", W.GRAD_CASES)
def test_grad_against_one_device(group, name):
    got = _grad_sum(group, name)
    ref = _one_device_grads(name)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.isfinite(got[k]).all(), k
        if W.ATTN_CASES[name][1] == "ring":
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                       err_msg=k, **RING_TOL)
        else:
            assert torch.equal(got[k], ref[k]), (
                k, float((got[k] - ref[k]).abs().max()))
    # The output taken with autograd on is the forward's.
    out = W.assemble([(res[name][0], res[f"{name}:grad_out"])
                      for res in group])
    assert torch.equal(out, _gathered(group, name))


@pytest.mark.parametrize("name", ("ring_causal", "ring_window"))
def test_grad_against_jax(group, name):
    """The gradients against ``jax.vjp`` of the JAX package's
    ``ring_attention`` (Pallas in interpret mode) on its seq mesh."""
    sizes, _, _, opts = W.ATTN_CASES[name]
    x = W.attn_inputs(name)
    mesh = j_build_mesh(JMeshConfig(**sizes))
    kw = {k: v for k, v in opts.items()
          if k in ("causal", "window", "softcap")}

    @jax.jit
    def grads(q, k, v, do):
        _, vjp = jax.vjp(
            lambda q, k, v: j_ring_attention(q, k, v, mesh, interpret=True,
                                             **kw), q, k, v)
        return vjp(do)

    want = grads(x["q"], x["k"], x["v"], W.attn_cotangent(name))
    got = _grad_sum(group, name)
    for k, w in zip("qkv", want):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                   err_msg=k, **RING_TOL)


def test_ring_is_the_single_process_schedule(group):
    """What one card runs (every rank's loop in one process) is the
    distributed ring's output bit for bit, band blocks and all."""
    x = _inputs("ring_window")
    _, _, _, opts = W.ATTN_CASES["ring_window"]
    sched = ring_attention_schedule(x["q"], x["k"], x["v"], 4, **opts)
    assert torch.equal(_gathered(group, "ring_window"), sched)


def test_merge_over_axis(group):
    """Every rank gets the same merged state, the fold of the four
    partial states (f32 sums in another order); the empty state of rank
    2 adds nothing."""
    outs = [res["merge_out"] for res in group]
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            assert torch.equal(a, b)
    states = [res["merge_in"] for res in group]
    fold = states[0]
    for st in states[1:]:
        fold = merge_softmax_states(fold, st)
    without_empty = merge_softmax_states(
        merge_softmax_states(states[0], states[1]), states[3])
    for a, b, c in zip(outs[0], fold, without_empty):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-6,
                                   rtol=1e-6)


def test_ulysses_refuses_indivisible_heads(group):
    for res in group:
        assert "ring attention" in res["ulysses_error"]


def test_ranks_run_gloo_without_jax(group):
    assert [res["backend"] for res in group] == ["gloo"] * 4
    assert not any(res["jax_imported"] for res in group)


# -- in-process: the ring's schedule, block kinds, start-up and the mesh ------

SCHEDULES = {
    "causal_n2": (2, dict(causal=True)),
    "window_softcap_n4": (4, dict(causal=True, window=100, softcap=20.0)),
    "alibi_n4": (4, dict(causal=True, alibi=True)),
    "alibi_window_n4": (4, dict(causal=True, alibi=True, window=70)),
    "sinks_n3": (3, dict(causal=True, sinks=True)),
    "noncausal_n4": (4, dict(causal=False)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_ring_schedule_against_one_pass(name):
    """ring_block_state over every rank's sources, merged, against one
    flash call over the whole sequence (3e-5, the ring tests' bar)."""
    n, opts = SCHEDULES[name]
    rng = np.random.default_rng(len(name))
    b, hq, hkv, s, d = 1, 4, 2, 96 if n == 3 else 128, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, np.float32))
               for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    kw = {k_: v_ for k_, v_ in opts.items() if k_ not in ("alibi", "sinks")}
    if opts.get("alibi"):
        kw["alibi"] = 0.5 ** torch.arange(1.0, hq + 1)
    if opts.get("sinks"):
        kw["sinks"] = torch.from_numpy(rng.standard_normal(hq, np.float32))
    got = ring_attention_schedule(q, k, v, n, **kw)
    ref = flash_attention(q, k, v, **kw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **RING_TOL)
    # The control: the last rank's block states merged without its own
    # (diagonal) one misses.
    blk, my = s // n, n - 1
    q_blk = q[:, :, my * blk:]
    state = empty_state(q_blk.shape[:3], d)
    for src in range(my - 1, -1, -1):
        state = merge_softmax_states(state, ring_block_state(
            q_blk, k[:, :, src * blk:(src + 1) * blk],
            v[:, :, src * blk:(src + 1) * blk],
            distance=my - src if kw["causal"] else 0, n_ring=n,
            **{k_: v_ for k_, v_ in kw.items() if k_ != "sinks"}))
    ctl = (finalize(state) if "sinks" not in kw
           else finalize_with_sinks(state, kw["sinks"]))
    err = float((ctl - ref[:, :, my * blk:]).abs().max())
    assert err > 100 * RING_TOL["atol"]


def test_block_kinds_and_empty_state():
    """JAX's _kind_for over distances, and an empty block's state (m
    -inf, nothing summed)."""
    kinds = [block_kind(d, 64, True, 128) for d in range(-1, 4)]
    assert kinds == ["empty", "diag", "dense", "band", "empty"]
    assert block_kind(2, 64, False, None) == "dense"
    assert block_kind(3, 64, True, None) == "dense"
    q = torch.ones((1, 2, 64, 64))
    st = ring_block_state(q, q, q, distance=3, n_ring=4, causal=True,
                          window=128)
    assert torch.isneginf(st.m).all() and not st.acc.any()
    with pytest.raises(ValueError, match="outside a ring"):
        ring_block_state(q, q, q, distance=4, n_ring=4, causal=True)


def test_initialize_multihost_single_process(monkeypatch):
    """No coordinator and no torchrun environment: a no-op that returns
    False (and starts no group)."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost(device_type="cpu") is False
    assert not torch.distributed.is_initialized()


def test_build_mesh_refuses_too_few_ranks():
    with pytest.raises(ValueError, match="mesh needs 2 devices; 1 present"):
        build_mesh(MeshConfig(model=2), "cpu")
    with pytest.raises(ValueError, match="positive"):
        MeshConfig(seq=0)
    assert MeshConfig(data=2, model=4, seq=3).num_devices == 24


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_factorization_matches_jax(n):
    cfg = mesh_config_for(n)
    assert dict(j_mesh_for(n).shape) == dict(data=cfg.data, seq=cfg.seq,
                                             model=cfg.model)
