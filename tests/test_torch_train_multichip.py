"""The port's DP x TP x SP train step (``tpu_flash_torch/parallel/train.py``,
``make_train_step(model, mesh)``) on an 8-rank gloo CPU group.

One group of 8 spawned ranks (``tests/torch_dist_worker.py`` suite
"train", a module fixture; the ranks import no JAX) takes one SGD step
in every case of ``TRAIN_CASES``: ``tests/test_train_multichip.py``'s
model and meshes (data, seq, model) = (2, 2, 2), (1, 4, 2) and (8, 1, 1),
its four attention variants (window, softcap, sinks, "gemma-like") and
ALiBi and YaRN on (2, 2, 2); then two AdamW steps, a sharded
``TrainCheckpointManager`` checkpoint, two more, and a resume from the
checkpoint into a fresh shard and optimizer. Each case's shard is
reassembled over "model" (``models.SHARD_DIMS``; the data x seq replicas
must agree bit for bit) and held against the port's one-device step on
the same seeded numpy inputs, which ``tests/test_torch_train.py`` holds
to JAX; the "gemma-like" case also against the JAX package's own sharded
step (``make_train_step(..., interpret=True)`` on its 8-device CPU mesh).
Tolerances: JAX's test's, loss rtol 2e-4 and params atol 2e-4, rtol
2e-3, for both (the sharded step sums the loss, the ring's blocks and the
gradients in another order than one device). Against the port's
one-device step the gradients themselves are held too, each within
GRAD_REL of its tensor's largest |g| (f32; they agree to about 1e-6 of
it): one SGD step at lr 1e-2 under JAX's params bar would let a
gradient be off by 2e-2. The resume is bit for bit;
a checkpoint written on the mesh restores onto one device and one
written on one device onto the mesh. The sharded save gathers each
model-sharded leaf onto the mesh's first rank alone. A mesh over ranks
0-3 of the 8 trains, saves and resumes while ranks 4-7 stay out.
"""

import numpy as np
import pytest
import torch
import torch_dist_worker as W

from tpu_flash.core.config import MeshConfig as JMeshConfig
from tpu_flash.models import FlashTransformer as JFlashTransformer
from tpu_flash.models import ModelConfig as JModelConfig
from tpu_flash.parallel.mesh import build_mesh as j_build_mesh
from tpu_flash.parallel.train import make_train_step as j_make_train_step
from tpu_flash_torch.checkpoint import TrainCheckpointManager
from tpu_flash_torch.models.transformer import SHARD_DIMS
from tpu_flash_torch.parallel import (
    loss_and_grads,
    make_train_step,
    param_leaves,
    param_names,
)

LOSS_TOL = dict(rtol=2e-4)
PARAM_TOL = dict(atol=2e-4, rtol=2e-3)
GRAD_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _one_device(variant, steps=1, optimizer=False):
    """(losses, params, optimizer) of the port's one-device step from the
    case's seeded params."""
    model = W.train_model(variant)
    params = W.torch_params(W.train_params(variant))
    opt = (torch.optim.AdamW(param_leaves(params), **W.ADAMW)
           if optimizer else None)
    step = make_train_step(model, learning_rate=W.TRAIN_LR, optimizer=opt)
    tokens = torch.from_numpy(W.train_tokens())
    losses = [float(step(params, tokens)) for _ in range(steps)]
    return losses, params, opt


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """(workdir, each rank's results). Before the spawn the test process
    writes the one-device checkpoint the ranks restore (two AdamW steps,
    ``workdir``/one)."""
    workdir = tmp_path_factory.mktemp("train")
    _, params, opt = _one_device("base", steps=2, optimizer=True)
    with TrainCheckpointManager(workdir / "one") as mgr:
        mgr.save(2, params, opt.state_dict())
    return workdir, W.spawn("train", 8, str(workdir))


def _named(p):
    """{name: tensor} of a params dict."""
    out = {k: v for k, v in p.items() if k != "layers"}
    for i, layer in enumerate(p["layers"]):
        out.update({f"layers.{i}.{n}": w for n, w in layer.items()})
    return out


def _whole(shards):
    """The whole params from every rank's (coords, shard): sharded
    leaves concatenated over the model index; every data x seq replica
    equal to the first bit for bit."""
    first = {}
    for (d, s, m), shard in shards:
        first.setdefault(m, _named(shard))
        for n, w in _named(shard).items():
            assert torch.equal(w, first[m][n]), (n, d, s, m)
    out = {}
    for n in first[0]:
        dim = SHARD_DIMS.get(n.rsplit(".", 1)[-1]) if "." in n else None
        parts = [first[m][n] for m in sorted(first)]
        out[n] = torch.cat(parts, dim) if dim is not None else parts[0]
    return out


def _close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].detach().numpy(),
                                   err_msg=n, **tol)


@pytest.mark.parametrize("name", sorted(W.TRAIN_CASES))
def test_step_against_one_device(group, name):
    _, ranks = group
    results = [r[name] for r in ranks]
    losses = {loss for _, loss, _, _ in results}
    assert len(losses) == 1  # every rank returns the global loss
    variant = W.TRAIN_CASES[name][1]
    (want_loss,), want, _ = _one_device(variant)
    np.testing.assert_allclose(losses.pop(), want_loss, **LOSS_TOL)
    _close(_whole([(c, shard) for c, _, shard, _ in results]), _named(want),
           **PARAM_TOL)
    params = W.torch_params(W.train_params(variant))
    _, grads = loss_and_grads(W.train_model(variant), params,
                              torch.from_numpy(W.train_tokens()))
    got = _whole([(c, g) for c, _, _, g in results])
    for n, g in zip(param_names(params), grads):
        bar = GRAD_REL * float(g.abs().max())
        err = float((got[n] - g).abs().max())
        assert err <= bar, (n, err, bar)


def test_gemma_like_against_jax(group):
    """Mesh (2, 2, 2), "gemma-like", SGD: the port's sharded step against
    the JAX package's on the same seeded inputs."""
    import jax.numpy as jnp

    _, ranks = group
    results = [r["gemma-like_d2s2m2"][:3] for r in ranks]
    model = JFlashTransformer(JModelConfig(**W.train_cfg("gemma-like")))
    params = W.train_params("gemma-like")
    params = {k: ([{n: jnp.asarray(w) for n, w in lw.items()} for lw in v]
                  if k == "layers" else jnp.asarray(v))
              for k, v in params.items()}
    mesh = j_build_mesh(JMeshConfig(data=2, model=2, seq=2))
    shard_params, build = j_make_train_step(
        model, mesh, learning_rate=W.TRAIN_LR, interpret=True)
    step = build(params)
    new_p, loss = step(shard_params(params),
                       jnp.asarray(W.train_tokens(), jnp.int32))
    np.testing.assert_allclose(results[0][1], float(loss), **LOSS_TOL)
    want = {n: torch.from_numpy(np.array(w))
            for n, w in _named(new_p).items()}
    _close(_whole([(c, shard) for c, _, shard in results]), want,
           **PARAM_TOL)


def _adamw(ranks, key, run="adamw"):
    return _whole([(r[run]["coords"], r[run][key]) for r in ranks
                   if run in r])


def test_adamw_against_one_device(group):
    """Two AdamW steps (the optimizer over each rank's shard) against
    the one-device step's."""
    _, ranks = group
    want_losses, want, _ = _one_device("base", steps=2, optimizer=True)
    np.testing.assert_allclose(ranks[0]["adamw"]["losses"][:2], want_losses,
                               **LOSS_TOL)
    _close(_adamw(ranks, "first"), _named(want), **PARAM_TOL)


def test_resume_is_bit_for_bit(group):
    """Two steps from the restored checkpoint: the uninterrupted run's
    losses and shard, bit for bit, on every rank."""
    _, ranks = group
    for r in ranks:
        a = r["adamw"]
        assert a["at"] == 2
        assert a["resumed"] == a["losses"][2:]
    assert all(torch.equal(_adamw(ranks, "resumed_shard")[n], w)
               for n, w in _adamw(ranks, "golden").items())


def test_sharded_save_gathers_to_the_writer_only(group):
    """Each model-sharded leaf (params and both AdamW moments) is
    gathered once, whole onto the writer (data, seq, model) = (0, 0, 0)
    and onto no other rank; ranks off the writer's data x seq plane
    gather nothing."""
    _, ranks = group
    params = W.torch_params(W.train_params("base"))
    sharded = sum(SHARD_DIMS.get(n.rsplit(".", 1)[-1]) is not None
                  for n in param_names(params))
    for r in ranks:
        d, s, m = r["adamw"]["coords"]
        want = [] if (d, s) != (0, 0) else [m == 0] * (3 * sharded)
        assert r["adamw"]["gathered"] == want, (d, s, m)


def test_mesh_over_part_of_the_world(group):
    """A (seq 2, model 2) mesh over ranks 0-3 of the 8: two AdamW steps
    against the one-device step's, the sharded checkpoint resumed bit for
    bit; ranks 4-7 took no part and nothing waited on them."""
    _, ranks = group
    assert ["adamw_part" in r for r in ranks] == [True] * 4 + [False] * 4
    want_losses, want, _ = _one_device("base", steps=2, optimizer=True)
    for r in ranks[:4]:
        a = r["adamw_part"]
        np.testing.assert_allclose(a["losses"][:2], want_losses, **LOSS_TOL)
        assert a["at"] == 2
        assert a["resumed"] == a["losses"][2:]
    _close(_adamw(ranks, "first", "adamw_part"), _named(want), **PARAM_TOL)
    golden = _adamw(ranks, "golden", "adamw_part")
    assert all(torch.equal(_adamw(ranks, "resumed_shard", "adamw_part")[n], w)
               for n, w in golden.items())


def test_mesh_checkpoint_restores_on_one_device(group):
    """The mesh's checkpoint holds the whole tensors: restored on one
    device, the params are the reassembled shards bit for bit, and a
    one-device AdamW step from it takes the mesh run's third loss
    (within the bar)."""
    workdir, ranks = group
    model = W.train_model("base")
    like = W.torch_params(W.train_params("base"))
    with TrainCheckpointManager(workdir / "mesh") as mgr:
        at, params, opt_state = mgr.restore_latest(like_params=like)
    assert at == 2
    whole = _adamw(ranks, "first")
    assert all(torch.equal(_named(params)[n], w) for n, w in whole.items())
    opt = torch.optim.AdamW(param_leaves(params), **W.ADAMW)
    opt.load_state_dict(opt_state)
    step = make_train_step(model, optimizer=opt)
    loss = float(step(params, torch.from_numpy(W.train_tokens())))
    np.testing.assert_allclose(loss, ranks[0]["adamw"]["losses"][2],
                               **LOSS_TOL)


def test_one_device_checkpoint_restores_on_mesh(group):
    """The checkpoint written on one device (two AdamW steps), sliced
    onto the mesh and stepped once, against the one-device third step."""
    _, ranks = group
    want_losses, want, _ = _one_device("base", steps=3, optimizer=True)
    assert {r["adamw"]["at_one"] for r in ranks} == {2}
    np.testing.assert_allclose(ranks[0]["adamw"]["from_one"],
                               want_losses[2], **LOSS_TOL)
    _close(_adamw(ranks, "from_one_shard"), _named(want), **PARAM_TOL)


def test_ranks_run_gloo_without_jax(group):
    _, ranks = group
    assert [r["backend"] for r in ranks] == ["gloo"] * 8
    assert not any(r["jax_imported"] for r in ranks)
    assert {r["torch_threads"] for r in ranks} == {1}


def test_optimizer_keywords_by_path():
    """The mesh step takes an optimizer factory (``make_optimizer``) and
    no ``optimizer`` or ``max_grad_norm``; one device takes the
    optimizer itself and no factory."""
    model = W.train_model("base")
    params = W.torch_params(W.train_params("base"))
    opt = torch.optim.AdamW(param_leaves(params), **W.ADAMW)
    mesh = object()  # refused before the mesh is read
    for kw in (dict(optimizer=opt), dict(max_grad_norm=1.0)):
        with pytest.raises(ValueError, match="make_optimizer"):
            make_train_step(model, mesh, **kw)
    with pytest.raises(ValueError, match="mesh step's"):
        make_train_step(model, make_optimizer=torch.optim.AdamW)
