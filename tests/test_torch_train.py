"""The port's training path on CPU against the JAX package: ``loss_fn``
and its parameter gradients (``jax.value_and_grad(model.loss_fn)``), packed
documents (segment ids), the single-device SGD step, and serving from a
params dict that a training step has touched.

Tolerances. tiny-byte-llama is bf16: its logits (magnitude ~10-16) are
rounded to bf16, where one ulp is 1/16, and a one-ulp gap in a logit
moves that token's softmax weight by 6%. The JAX and torch CPU matmuls
round differently in the last bit, so whole-model bf16 gradients differ
by a few percent; the bar is 5% of each tensor's norm (measured 1.4-2.6%)
and the loss 5e-3 (measured 9e-4), and each bar holds a control: the
gradients of another batch miss it. The f32 TINY_TEST model takes the
same arithmetic in another order: 1e-4 of each tensor's norm.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.checkpoint.convert import load_hf_dir as j_load_hf_dir
from tpu_flash.models import TINY_TEST as J_TINY
from tpu_flash.models import FlashTransformer as JModel
from tpu_flash_torch.checkpoint import load_hf_dir, params_from_jax
from tpu_flash_torch.core.config import CacheConfig, EngineConfig
from tpu_flash_torch.engine import InferenceEngine
from tpu_flash_torch.models import TINY_TEST, FlashTransformer
from tpu_flash_torch.models.transformer import document_positions
from tpu_flash_torch.parallel import (
    loss_and_grads,
    make_train_step,
    param_leaves,
    param_names,
)

REPO = os.path.dirname(os.path.dirname(__file__))
CKPT = os.path.join(REPO, "checkpoints", "tiny-byte-llama")
BF16_GRAD_REL = 0.05
BF16_LOSS_ABS = 5e-3
F32_GRAD_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_leaves(tree):
    out = [tree["embed"]]
    for layer in tree["layers"]:
        out += [layer[n] for n in sorted(layer)]
    out += [tree["final_norm"], tree["lm_head"]]
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in out]


def _grads(model, params, tokens, segment_ids=None):
    """(loss, [grad per leaf] as f32 numpy) of the port's loss_fn."""
    loss, grads = loss_and_grads(model, params, tokens, segment_ids)
    return float(loss), [g.float().numpy() for g in grads]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _readme_windows(n_rows, length, start=1000, stride=4000):
    data = np.frombuffer(open(os.path.join(REPO, "README.md"), "rb").read(),
                         np.uint8)
    return np.stack([data[start + i * stride:start + i * stride + length]
                     for i in range(n_rows)]).astype(np.int32)


@pytest.fixture(scope="module")
def trained():
    """tiny-byte-llama in both packages, JAX's loss and gradients on two
    windows of README.md (2 x 129 bytes), and the port's on the same
    windows and (as the control) on two other windows."""
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    jm, jp = j_load_hf_dir(CKPT, dtype="bfloat16")
    tm, tp = load_hf_dir(CKPT, dtype="bfloat16", device="cpu")
    toks = _readme_windows(2, 129)
    # Eager, so that every op rounds to bf16 where the model says (a jit
    # of the whole step fuses some of those roundings away).
    j_loss, j_grads = jax.value_and_grad(jm.loss_fn)(jp, jnp.asarray(toks))
    t_loss, t_grads = _grads(tm, tp, torch.from_numpy(toks))
    _, control = _grads(tm, tp, torch.from_numpy(_readme_windows(
        2, 129, start=9000)))
    return dict(j_loss=float(j_loss), j_grads=_jax_leaves(j_grads),
                t_loss=t_loss, t_grads=t_grads, control=control,
                names=param_names(tp), model=tm, params=tp)


def test_trained_loss_matches_jax(trained):
    assert abs(trained["t_loss"] - trained["j_loss"]) <= BF16_LOSS_ABS
    assert trained["t_loss"] < 2.5  # a trained byte model, far below ln 256


@pytest.mark.parametrize("index", range(39))
def test_trained_grads_match_jax(trained, index):
    """Each of the 39 parameter tensors' gradient within 5% of its norm,
    and the other batch's gradient outside that bar."""
    assert len(trained["names"]) == 39
    want = trained["j_grads"][index]
    assert np.isfinite(trained["t_grads"][index]).all()
    assert _rel(trained["t_grads"][index], want) <= BF16_GRAD_REL, \
        trained["names"][index]
    assert _rel(trained["control"][index], want) > BF16_GRAD_REL


@pytest.fixture(scope="module")
def tiny_packed():
    """A 2-layer f32 TINY_TEST model with seeded JAX weights carried over
    by params_from_jax, a batch of 2 x 65 tokens packed with two documents
    a row, and JAX's loss and gradients on it."""
    jm = JModel(J_TINY)
    jp = jm.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, J_TINY.vocab_size, (2, 65)).astype(np.int32)
    seg = np.zeros((2, 65), np.int32)
    seg[0, 30:], seg[1, 41:] = 1, 1
    # f32 (no bf16 rounding for a fusion to skip): one jit of the whole
    # step compiles about 3x faster than eager ops.
    j_loss, j_grads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, jnp.asarray(toks), jnp.asarray(seg))
    np_params = jax.tree.map(np.asarray, jp)
    return dict(jm=jm, np_params=np_params, toks=toks, seg=seg,
                j_loss=float(j_loss), j_grads=_jax_leaves(j_grads))


def _tiny_port(tiny_packed):
    tm = FlashTransformer(TINY_TEST, device="cpu")
    return tm, params_from_jax(tiny_packed["np_params"], device="cpu")


def test_packed_loss_and_grads_match_jax(tiny_packed):
    tm, tp = _tiny_port(tiny_packed)
    loss, grads = _grads(tm, tp, torch.from_numpy(tiny_packed["toks"]),
                         torch.from_numpy(tiny_packed["seg"]))
    assert abs(loss - tiny_packed["j_loss"]) <= 1e-5 * tiny_packed["j_loss"]
    for name, g, want in zip(param_names(tp), grads, tiny_packed["j_grads"]):
        assert _rel(g, want) <= F32_GRAD_REL, name
    # Control: without segment ids the same tokens give another gradient.
    _, unpacked = _grads(tm, tp, torch.from_numpy(tiny_packed["toks"]))
    assert _rel(unpacked[-1], tiny_packed["j_grads"][-1]) > F32_GRAD_REL


def test_packed_loss_counts_only_same_document_targets(tiny_packed):
    """The packed loss is the mean NLL over positions whose next token is
    in the same document, with positions restarting per document."""
    tm, tp = _tiny_port(tiny_packed)
    toks = torch.from_numpy(tiny_packed["toks"]).long()
    seg = torch.from_numpy(tiny_packed["seg"])
    with torch.no_grad():
        loss = tm.loss_fn(tp, toks, seg)
        logits = tm.forward(tp, toks[:, :-1], segment_ids=seg[:, :-1])
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, toks[:, 1:, None])[..., 0]
    same = seg[:, :-1] == seg[:, 1:]
    assert int(same.sum()) == 2 * 64 - 2
    torch.testing.assert_close(loss, nll[same].mean(), rtol=1e-6, atol=0)


def test_document_positions_restart_per_segment():
    seg = torch.tensor([[0, 0, 0, 1, 1, 2], [5, 5, 5, 5, 5, 5]])
    assert document_positions(seg).tolist() == [[0, 1, 2, 0, 1, 0],
                                                [0, 1, 2, 3, 4, 5]]


def test_segments_refuse_serving_seams():
    tm = FlashTransformer(TINY_TEST, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    toks = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="kv_hook/attention_fn"):
        tm.forward(tp, toks, segment_ids=torch.zeros(1, 8),
                   attention_fn=lambda q, k, v: q)


def test_sgd_step_matches_jax_update(tiny_packed):
    """One make_train_step SGD step gives the JAX single-device update
    ``w - lr * g`` on the same batch (f32: within 1e-6 of the weights)."""
    lr = 1e-2
    tm, tp = _tiny_port(tiny_packed)
    step = make_train_step(tm, learning_rate=lr)
    loss = step(tp, torch.from_numpy(tiny_packed["toks"]),
                torch.from_numpy(tiny_packed["seg"]))
    assert abs(float(loss) - tiny_packed["j_loss"]) <= 1e-5
    before = _jax_leaves(tiny_packed["np_params"])
    for name, w, w0, g in zip(param_names(tp), param_leaves(tp), before,
                              tiny_packed["j_grads"]):
        np.testing.assert_allclose(w.detach().numpy(), w0 - lr * g,
                                   atol=1e-6, rtol=0, err_msg=name)


def test_sgd_step_rounds_bf16_weights_like_jax():
    """bf16 leaves update as (w - lr * g.float()).to(bf16), the JAX
    step's arithmetic, exactly."""
    cfg = dataclasses.replace(TINY_TEST, dtype="bfloat16", num_layers=1)
    tm = FlashTransformer(cfg, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(1))
    before = [w.clone() for w in param_leaves(tp)]
    toks = torch.randint(0, 256, (2, 17), generator=torch.Generator()
                         .manual_seed(1))
    make_train_step(tm, learning_rate=0.05)(tp, toks)
    for w, w0 in zip(param_leaves(tp), before):
        want = (w0.float() - 0.05 * w.grad.float()).to(torch.bfloat16)
        assert torch.equal(w.detach(), want)


def test_adamw_steps_reduce_the_loss_on_a_repeated_batch():
    """With a torch optimizer (AdamW and a norm clip, the chip run's
    step) the loss of a repeated batch falls step after step."""
    tm = FlashTransformer(TINY_TEST, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(2))
    opt = torch.optim.AdamW(param_leaves(tp), lr=3e-3, weight_decay=0.01)
    step = make_train_step(tm, optimizer=opt, max_grad_norm=1.0)
    toks = torch.randint(0, 256, (2, 33), generator=torch.Generator()
                         .manual_seed(2))
    losses = [float(step(tp, toks)) for _ in range(4)]
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


def test_engine_serves_token_exact_after_a_training_step(trained):
    """A training step on the params dict the engine serves: the engine
    builds no autograd graph (its steps run in inference mode) and gives
    the same greedy tokens as an engine on a detached copy of the updated
    weights."""
    tm, tp = trained["model"], trained["params"]
    tp = {"embed": tp["embed"].detach().clone(),
          "layers": [{n: w.detach().clone() for n, w in layer.items()}
                     for layer in tp["layers"]],
          "final_norm": tp["final_norm"].detach().clone(),
          "lm_head": tp["lm_head"].detach().clone()}
    step = make_train_step(tm, learning_rate=1e-3)
    step(tp, torch.from_numpy(_readme_windows(2, 65)))
    assert all(w.requires_grad for w in param_leaves(tp))
    frozen = {"embed": tp["embed"].detach().clone(),
              "layers": [{n: w.detach().clone() for n, w in layer.items()}
                         for layer in tp["layers"]],
              "final_norm": tp["final_norm"].detach().clone(),
              "lm_head": tp["lm_head"].detach().clone()}
    prompts = [list(b"def quantize(x, scale):\n    return "),
               list(b"The cache stores the keys and values of")]
    outs = []
    for params in (tp, frozen):
        eng = InferenceEngine(tm, params, EngineConfig(
            max_batch_size=2, max_seq_len=128, prefill_chunk=32,
            cache=CacheConfig(page_size=32, num_pages=12,
                              max_pages_per_seq=4, kv_dtype="bfloat16",
                              recent_window=0)))
        ids = [eng.submit(p, 8) for p in prompts]
        out = eng.run()
        assert not eng.cache.k_pages.requires_grad
        eng.close()
        outs.append([out[i] for i in ids])
    assert outs[0] == outs[1]
    assert all(len(o) == 8 for o in outs[0])
