"""One rank of the gloo process groups that the port's multi-rank tests
spawn (``tests/test_torch_parallel.py``, ``tests/test_torch_sharded_engine.py``,
``tests/test_torch_train_multichip.py``).

    python tests/torch_dist_worker.py <suite> <rank> <world> <dir>

Each rank joins a CPU process group started from a ``file://`` store in
``<dir>`` (no TCP port to clash between test workers; a 60 s collective
timeout), runs every case of ``<suite>`` on its shard and writes
``<dir>/<suite>-<rank>.pt``: each case's output shard with its mesh
coordinates, and whether JAX was imported (it must not be: the port
imports none of it). The case definitions and their seeded inputs live
here, so that the test process builds the same inputs for its references.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CKPT = os.path.join(REPO, "checkpoints", "tiny-byte-llama")

# -- the attention suite (4 ranks) --------------------------------------------

# name -> (mesh {axis: size}, entry, (b, hq, hkv, s, d), options). Each
# case's output is this rank's block; ``dims`` in run_attention map the
# mesh axes to the output's dims, so the test reassembles the whole.
ATTN_CASES = {
    "flash_tp": (dict(model=4), "sharded_flash", (2, 8, 4, 64, 64),
                 dict(causal=True)),
    "flash_dp_tp": (dict(data=2, model=2), "sharded_flash", (2, 4, 2, 48, 64),
                    dict(causal=False)),
    "paged_tp": (dict(model=4), "sharded_paged", (2, 8, 4, 0, 64), {}),
    "paged_tp_int8": (dict(model=4), "sharded_paged", (2, 8, 4, 0, 64),
                      dict(int8=True)),
    "ring_causal": (dict(seq=4), "ring", (1, 2, 2, 256, 64),
                    dict(causal=True)),
    # Blocks of 64 under a 128-token window: distance 0 diagonal, 1 dense,
    # 2 banded (its late rows see no key), 3 empty.
    "ring_window": (dict(seq=4), "ring", (1, 2, 2, 256, 64),
                    dict(causal=True, window=128, softcap=30.0)),
    "ring_alibi": (dict(seq=4), "ring", (1, 2, 2, 256, 64),
                   dict(causal=True, alibi=True)),
    "ring_sinks": (dict(seq=4), "ring", (1, 4, 2, 256, 64),
                   dict(causal=True, sinks=True)),
    "ring_noncausal": (dict(seq=4), "ring", (1, 2, 2, 256, 64),
                       dict(causal=False)),
    "ring_2d_alibi": (dict(seq=2, model=2), "ring", (1, 4, 4, 256, 64),
                      dict(causal=True, alibi=True, window=100)),
    "ulysses_causal": (dict(seq=4), "ulysses", (1, 4, 4, 256, 64),
                       dict(causal=True)),
    "ulysses_window": (dict(seq=4), "ulysses", (2, 8, 4, 128, 64),
                       dict(causal=True, window=50, softcap=20.0)),
    "ulysses_sinks_alibi": (dict(seq=4), "ulysses", (1, 8, 4, 128, 64),
                            dict(causal=True, sinks=True, alibi=True)),
}
PAGED = dict(page_size=16, num_pages=16, pages_per_seq=4,
             lengths=(50, 23))


def attn_inputs(name: str):
    """Seeded f32 numpy inputs of a case: q, k, v (paged cases: q
    [b, hq, d], pages [hkv, num_pages, ps, d], lengths, page table), and
    sinks / slopes where the case takes them."""
    _, entry, (b, hq, hkv, s, d), opts = ATTN_CASES[name]
    rng = np.random.default_rng(sorted(ATTN_CASES).index(name))
    f = np.float32
    if entry == "sharded_paged":
        ps, npg, pps = PAGED["page_size"], PAGED["num_pages"], \
            PAGED["pages_per_seq"]
        return dict(
            q=rng.standard_normal((b, hq, d), f),
            k=rng.standard_normal((hkv, npg, ps, d), f),
            v=rng.standard_normal((hkv, npg, ps, d), f),
            lengths=np.asarray(PAGED["lengths"], np.int32),
            table=rng.permutation(npg)[:b * pps].reshape(b, pps)
            .astype(np.int32),
        )
    out = dict(q=rng.standard_normal((b, hq, s, d), f),
               k=rng.standard_normal((b, hkv, s, d), f),
               v=rng.standard_normal((b, hkv, s, d), f))
    if opts.get("sinks"):
        out["sinks"] = rng.standard_normal((hq,), f)
    if opts.get("alibi"):
        out["alibi"] = (0.5 ** (np.arange(hq, dtype=f) + 1)).astype(f)
    return out


# The cases whose gradients the attention suite takes too (ring: every
# block kind, ALiBi's shifted dense blocks, sinks, ring x heads; Ulysses).
GRAD_CASES = ("ring_causal", "ring_window", "ring_alibi", "ring_sinks",
              "ring_2d_alibi", "ulysses_causal", "ulysses_sinks_alibi")
GRAD_INPUTS = ("q", "k", "v", "sinks")


def attn_cotangent(name: str):
    """The seeded f32 output cotangent dO of a case, [b, hq, s, d]."""
    _, _, (b, hq, _, s, d), _ = ATTN_CASES[name]
    rng = np.random.default_rng(1000 + sorted(ATTN_CASES).index(name))
    return rng.standard_normal((b, hq, s, d), np.float32)


def _attn_call(mesh, sizes, entry, opts, x):
    """(coords, output block) of one case on this rank: coords {dim:
    (index, count)} place the block in the whole output."""
    from tpu_flash_torch.ops.quant import QuantizedTensor, quantize_int8_rows
    from tpu_flash_torch.parallel import (
        ring_attention,
        sharded_flash_attention,
        sharded_paged_attention,
        ulysses_attention,
    )

    def coord(axis, dim):
        return dim, (mesh.get_local_rank(axis), sizes.get(axis, 1))

    kw = {k: v for k, v in opts.items()
          if k in ("causal", "window", "softcap")}
    if entry == "sharded_flash":
        out = sharded_flash_attention(mesh, **kw)(x["q"], x["k"], x["v"])
        dims = dict([coord("data", 0), coord("model", 1)])
    elif entry == "sharded_paged":
        kp, vp = x["k"], x["v"]
        if opts.get("int8"):
            kq, ks = quantize_int8_rows(kp)
            vq, vs = quantize_int8_rows(vp)
            kp = QuantizedTensor(kq, ks, "int8", "lanes")
            vp = QuantizedTensor(vq, vs, "int8", "lanes")
        out = sharded_paged_attention(mesh)(
            x["q"], kp, vp, x["lengths"], x["table"])
        dims = dict([coord("model", 1)])
    elif entry == "ring":
        out = ring_attention(x["q"], x["k"], x["v"], mesh,
                             sinks=x.get("sinks"), alibi=x.get("alibi"),
                             **kw)
        dims = dict([coord("seq", 2), coord("model", 1)])
    else:
        out = ulysses_attention(mesh, sinks=x.get("sinks"),
                                alibi=x.get("alibi"), **kw)(
            x["q"], x["k"], x["v"])
        dims = dict([coord("seq", 2)])
    return {d: c for d, c in dims.items() if c[1] > 1}, out


def _mesh(sizes):
    from tpu_flash_torch.core.config import MeshConfig
    from tpu_flash_torch.parallel.mesh import build_mesh

    return build_mesh(MeshConfig(**sizes), "cpu")


def run_attention(rank: int):
    """Every attention case on this rank: {name: (coords, output)} with
    coords {dim: (index, count)}; for GRAD_CASES the input gradients
    (``<name>:grad``) and the output they were taken through
    (``<name>:grad_out``); plus the merge and error cases."""
    import torch
    import torch.distributed as dist

    from tpu_flash_torch.core.softmax import SoftmaxState, merge_over_axis
    from tpu_flash_torch.parallel import ulysses_attention

    res = {}
    meshes = {}
    for name, (sizes, entry, _, opts) in ATTN_CASES.items():
        key = tuple(sorted(sizes.items()))
        if key not in meshes:
            meshes[key] = _mesh(sizes)
        x = {k: torch.from_numpy(v) for k, v in attn_inputs(name).items()}
        res[name] = _attn_call(meshes[key], sizes, entry, opts, x)

    # Gradients: each rank's q, k, v (and sinks) gradients of <out, dO>
    # over its output block, on the global inputs (zero outside the
    # rank's blocks); the test sums them over the ranks.
    for name in GRAD_CASES:
        sizes, entry, _, opts = ATTN_CASES[name]
        mesh = meshes[tuple(sorted(sizes.items()))]
        x = {k: torch.from_numpy(v).requires_grad_(k in GRAD_INPUTS)
             for k, v in attn_inputs(name).items()}
        coords, out = _attn_call(mesh, sizes, entry, opts, x)
        do = torch.from_numpy(attn_cotangent(name))
        for dim, (i, n) in coords.items():
            do = do.chunk(n, dim)[i]
        (out * do).sum().backward()
        res[f"{name}:grad"] = {k: x[k].grad for k in GRAD_INPUTS if k in x}
        res[f"{name}:grad_out"] = out.detach()

    # merge_over_axis: each rank one partial state; rank 2's is empty.
    rng = np.random.default_rng(100 + rank)
    shape = (1, 2, 3)
    st = SoftmaxState(
        acc=torch.from_numpy(rng.standard_normal((*shape, 8), np.float32)),
        m=torch.from_numpy(rng.standard_normal((*shape, 1), np.float32)),
        l=torch.from_numpy(rng.uniform(0.5, 2.0, (*shape, 1))
                           .astype(np.float32)),
    )
    if rank == 2:
        st = SoftmaxState(acc=torch.zeros_like(st.acc),
                          m=torch.full_like(st.m, -torch.inf),
                          l=torch.zeros_like(st.l))
    res["merge_in"] = st
    res["merge_out"] = merge_over_axis(st, dist.group.WORLD)

    # Ulysses refuses heads the seq axis does not divide.
    mesh = meshes[(("seq", 4),)]
    q = torch.zeros((1, 4, 64, 64))
    kv = torch.zeros((1, 2, 64, 64))
    try:
        ulysses_attention(mesh)(q, kv, kv)
        res["ulysses_error"] = None
    except ValueError as e:
        res["ulysses_error"] = str(e)
    return res


# -- the tensor-parallel engine suite (2 ranks) -------------------------------

LAYOUT = dict(page_size=32, num_pages=12, max_pages_per_seq=4)
ENGINE = dict(max_batch_size=2, max_seq_len=128, prefill_chunk=32,
              max_decode_burst=7)
GATHERED = dict(paged_prefill=False, fused_mixed_step=False)
PROMPTS = [
    list(b"The quick brown fox jumps over the lazy dog. ")[:40],
    list(b"def quantize(x, scale):\n    return clip(round(x / s")[:50],
]
# Prompt lookup drafts from these (each repeats a phrase).
SPEC_PROMPTS = [
    list(b"the cat sat on the mat. the cat sat on the mat. the cat"),
    list(b"one two three four, one two three four, one two"),
]
NEW_TOKENS = 8


def trained(dtype="float32"):
    """tiny-byte-llama (4 q / 2 kv heads of 128) on the CPU."""
    from tpu_flash_torch.checkpoint import load_hf_dir

    return load_hf_dir(CKPT, dtype=dtype, device="cpu")


def engine(model, params, mesh=None, kv_dtype="float32", ring=0,
           speculation=0, **config):
    from tpu_flash_torch.core.config import CacheConfig, EngineConfig
    from tpu_flash_torch.engine import InferenceEngine

    cfg = EngineConfig(cache=CacheConfig(**LAYOUT, kv_dtype=kv_dtype,
                                         recent_window=ring),
                       **{**ENGINE, **config})
    eng = InferenceEngine(model, params, cfg, mesh=mesh)
    eng.speculation_k = speculation
    return eng


def staggered(eng, prompts, new_tokens, **submit):
    """The first prompt alone for two steps, then the second: chunks at
    mixed stages (ragged or fused steps) and decode beside prefill."""
    ids = [eng.submit(prompts[0], new_tokens, **submit)]
    eng.step()
    eng.step()
    ids.append(eng.submit(prompts[1], new_tokens, **submit))
    eng.run()
    return [eng.outputs[i] for i in ids]


def lora_adapter(model):
    from tpu_flash_torch.engine.lora import seeded_adapter

    return seeded_adapter(model.config, 4, 0.5, np.random.default_rng(7))


# Scenario name -> fn(model, params, mesh, workdir) -> outputs; the TP
# workers and the test's one-device references run the same functions.
def sc_f32_gathered(model, params, mesh, _):
    """The route the JAX comparison takes: one 32-token chunk each, then
    7-step bursts (one JAX prefill and one decode program)."""
    eng = engine(model, params, mesh, **GATHERED)
    ids = [eng.submit(p[:32], NEW_TOKENS) for p in PROMPTS]
    eng.run()
    return [eng.outputs[i] for i in ids]


def sc_int8_default(model, params, mesh, _):
    """The default routes (paged prefill, fused steps) on int8 + ring,
    staggered, then speculation by prompt lookup."""
    eng = engine(model, params, mesh, "int8", ring=8)
    out = staggered(eng, PROMPTS, NEW_TOKENS)
    eng.speculation_k = 4
    ids = [eng.submit(p, 12) for p in SPEC_PROMPTS]
    eng.run()
    routes = eng.metrics.route_counts()
    return out + [eng.outputs[i] for i in ids], routes


def sc_f32_default(model, params, mesh, _):
    eng = engine(model, params, mesh)
    return staggered(eng, PROMPTS, NEW_TOKENS)


def sc_sampled(model, params, mesh, _):
    from tpu_flash_torch.engine import SamplingParams

    eng = engine(model, params, mesh, **GATHERED)
    sp = SamplingParams(temperature=0.9, top_k=20, top_p=0.95)
    ids = [eng.submit(p, NEW_TOKENS, sampling=sp) for p in PROMPTS]
    eng.run()
    return [eng.outputs[i] for i in ids]


def sc_swap(model, params, mesh, _):
    """Optimistic admission on a 6-page pool under swap preemption."""
    from tpu_flash_torch.core.config import CacheConfig, EngineConfig
    from tpu_flash_torch.engine import InferenceEngine

    cfg = EngineConfig(
        cache=CacheConfig(page_size=16, num_pages=7, max_pages_per_seq=4,
                          kv_dtype="int8", recent_window=8),
        max_batch_size=3, max_seq_len=64, prefill_chunk=16,
        admission="optimistic", preemption="swap", **GATHERED)
    eng = InferenceEngine(model, params, cfg, mesh=mesh)
    eng.speculation_k = 0
    ids = [eng.submit(p[:30], 16) for p in PROMPTS + SPEC_PROMPTS[:1]]
    eng.run()
    return [eng.outputs[i] for i in ids], eng.scheduler.num_preemptions


def sc_snapshot(model, params, mesh, workdir):
    """Four steps, a snapshot (into ``workdir``/snap), then on to the end:
    the uninterrupted tokens."""
    from tpu_flash_torch.checkpoint import snapshot_engine

    eng = engine(model, params, mesh, "int8", ring=8, **GATHERED)
    ids = [eng.submit(p, NEW_TOKENS) for p in PROMPTS]
    for _ in range(4):
        eng.step()
    snapshot_engine(os.path.join(workdir, "snap"), eng)
    eng.run()
    return [eng.outputs[i] for i in ids]


def sc_lora_logits(model, params, mesh, _):
    """The first prompt's logits through an adapter over every projection
    (the engine's own hook and params, so TP slices the factors)."""
    import torch

    eng = engine(model, params, mesh, **GATHERED)
    eng.register_lora("a", lora_adapter(model))
    with torch.inference_mode():
        tokens = torch.tensor([PROMPTS[0]])
        return model.forward(eng.params, tokens,
                             proj_hook=eng._lora_hook([1]),
                             tp_group=eng._tp_group)


def sc_alibi_logits(model, params, mesh, _):
    """The first prompt's logits with ALiBi in place of rope (the
    checkpoint's weights) through the engine's params and slopes: under
    TP its shard and its rank's half of the slopes."""
    import dataclasses

    import torch

    from tpu_flash_torch.models import FlashTransformer

    alibi = FlashTransformer(dataclasses.replace(
        model.config, attn_alibi=True), device="cpu")
    eng = engine(alibi, params, mesh, **GATHERED)
    with torch.inference_mode():
        return alibi.forward(eng.params, torch.tensor([PROMPTS[0]]),
                             tp_group=eng._tp_group, alibi=eng._alibi)


SCENARIOS = {
    "f32_gathered": sc_f32_gathered,
    "f32_default": sc_f32_default,
    "int8_default": sc_int8_default,
    "sampled": sc_sampled,
    "swap": sc_swap,
    "snapshot": sc_snapshot,
    "lora_logits": sc_lora_logits,
    "alibi_logits": sc_alibi_logits,
}


def run_engine(rank: int, workdir: str):
    import dataclasses

    import torch

    from tpu_flash_torch.core.config import MeshConfig
    from tpu_flash_torch.engine import InferenceEngine
    from tpu_flash_torch.models import FlashTransformer
    from tpu_flash_torch.parallel.mesh import build_mesh

    model, params = trained()
    mesh = build_mesh(MeshConfig(model=2), "cpu")
    res = {name: fn(model, params, mesh, workdir)
           for name, fn in SCENARIOS.items()}
    eng = engine(model, params, mesh, "int8", ring=8)
    res["cache_heads"] = (eng.cache.k_pages.shape[1],
                          eng.cache.k_scales.shape[1],
                          eng.cache.k_recent.shape[2])
    res["param_shapes"] = {k: tuple(v.shape)
                           for k, v in eng.params["layers"][0].items()}
    # Heads the model axis does not divide are refused.
    odd = FlashTransformer(dataclasses.replace(
        model.config, num_q_heads=3, num_kv_heads=1), device="cpu")
    try:
        InferenceEngine(odd, params, eng.config, mesh=mesh)
        res["odd_heads"] = None
    except ValueError as e:
        res["odd_heads"] = str(e)
    res["torch_threads"] = torch.get_num_threads()
    return res


# -- the training suite (8 ranks) ---------------------------------------------

# tests/test_train_multichip.py's model, meshes and attention variants,
# plus ALiBi and YaRN (the sliced slopes and the q multiplier).
TRAIN_CFG = dict(name="tiny-train", vocab_size=64, hidden_size=32,
                 num_layers=2, num_q_heads=4, num_kv_heads=2, head_dim=8,
                 intermediate_size=64, dtype="float32")
TRAIN_VARIANTS = {
    "base": {},
    "window": dict(sliding_window=12),
    "softcap": dict(attn_softcap=8.0),
    "sinks": dict(attn_sinks=True),
    "gemma-like": dict(sliding_window=10, sliding_window_pattern=2,
                       attn_softcap=6.0, attn_sinks=True),
    "alibi": dict(attn_alibi=True),
    "yarn": dict(rope_scaling="yarn", rope_scaling_factor=4.0),
}
# name -> (mesh {axis: size}, variant): one SGD step each.
TRAIN_CASES = {
    "base_d2s2m2": (dict(data=2, seq=2, model=2), "base"),
    "base_s4m2": (dict(seq=4, model=2), "base"),
    "base_d8": (dict(data=8), "base"),
    **{f"{v}_d2s2m2": (dict(data=2, seq=2, model=2), v)
       for v in ("window", "softcap", "sinks", "gemma-like", "alibi",
                 "yarn")},
}
TRAIN_TOKENS = (8, 32)
TRAIN_LR = 1e-2
ADAMW = dict(lr=3e-3, weight_decay=0.01)
ADAMW_MESH = dict(data=2, seq=2, model=2)
PART_MESH = dict(seq=2, model=2)  # ranks 0-3 of the 8


def train_cfg(variant: str) -> dict:
    return {**TRAIN_CFG, **TRAIN_VARIANTS[variant]}


def train_params(variant: str):
    """Seeded f32 numpy params in the JAX tree's names and layouts
    (dense weights [in, out], N(0, 1/fan_in); norms near one; sink
    logits N(0, 1.5^2) where the variant has them)."""
    cfg = train_cfg(variant)
    rng = np.random.default_rng(7)
    h, d, f = cfg["hidden_size"], cfg["head_dim"], cfg["intermediate_size"]
    qd, kvd = cfg["num_q_heads"] * d, cfg["num_kv_heads"] * d
    f32 = np.float32

    def dense(shape):
        return (rng.standard_normal(shape, f32) * shape[0] ** -0.5).astype(f32)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(h, f32)).astype(f32)

    layers = []
    for _ in range(cfg["num_layers"]):
        layer = dict(attn_norm=norm(), wq=dense((h, qd)), wk=dense((h, kvd)),
                     wv=dense((h, kvd)), wo=dense((qd, h)), mlp_norm=norm(),
                     w_gate=dense((h, f)), w_up=dense((h, f)),
                     w_down=dense((f, h)))
        if cfg.get("attn_sinks"):
            layer["sinks"] = (1.5 * rng.standard_normal(
                cfg["num_q_heads"], f32)).astype(f32)
        layers.append(layer)
    return dict(embed=rng.standard_normal((cfg["vocab_size"], h), f32),
                layers=layers, final_norm=norm(),
                lm_head=dense((h, cfg["vocab_size"])))


def train_tokens():
    rng = np.random.default_rng(8)
    return rng.integers(0, TRAIN_CFG["vocab_size"], TRAIN_TOKENS,
                        dtype=np.int64)


def torch_params(tree):
    """A numpy params tree as torch tensors (copies)."""
    import torch

    if isinstance(tree, dict):
        return {k: torch_params(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [torch_params(v) for v in tree]
    return torch.tensor(tree)


def train_model(variant: str):
    from tpu_flash_torch.models import FlashTransformer, ModelConfig

    return FlashTransformer(ModelConfig(**train_cfg(variant)), device="cpu")


def _detached(local, grad=False):
    """A copy of a shard's tensors (with ``grad``, of their gradients)."""
    def get(w):
        return (w.grad if grad else w).detach().clone()

    return {k: ([{n: get(w) for n, w in lw.items()} for lw in v]
                if k == "layers" else get(v)) for k, v in local.items()}


def _adamw_run(mesh, tokens, ckpt_dir):
    """(results, build, a fresh shard): two AdamW steps on ``mesh``, a
    sharded checkpoint into ``ckpt_dir``, two more (the golden losses and
    shard), then the checkpoint restored into a fresh shard and optimizer
    and two steps again."""
    import functools

    import torch

    from tpu_flash_torch.checkpoint import TrainCheckpointManager
    from tpu_flash_torch.parallel import make_train_step

    shard, build = make_train_step(
        train_model("base"), mesh,
        make_optimizer=functools.partial(torch.optim.AdamW, **ADAMW))
    local = shard(torch_params(train_params("base")))
    step = build(local)
    losses = [float(step(local, tokens)) for _ in range(2)]
    first = _detached(local)
    with TrainCheckpointManager(ckpt_dir) as mgr:
        mgr.save(2, local, step.optimizer.state_dict(), mesh=mesh)
    losses += [float(step(local, tokens)) for _ in range(2)]
    golden = _detached(local)
    fresh = shard(torch_params(train_params("base")))
    with TrainCheckpointManager(ckpt_dir) as mgr:
        at, rp, ros = mgr.restore_latest(like_params=fresh, mesh=mesh)
    step = build(rp)
    step.optimizer.load_state_dict(ros)
    resumed = [float(step(rp, tokens)) for _ in range(2)]
    coords = tuple(mesh.get_local_rank(a) for a in ("data", "seq", "model"))
    return (dict(coords=coords, losses=losses, first=first, golden=golden,
                 at=at, resumed=resumed, resumed_shard=_detached(rp)),
            build, fresh)


def run_train(rank: int, workdir: str):
    """Every training case on this rank: {name: (coords, loss, shard,
    grads)} (coords: this rank's (data, seq, model) indices; the shard
    after one SGD step and its gradients), then :func:`_adamw_run` on
    ADAMW_MESH ("adamw", with "gathered": whether each leaf the sharded
    save gathered came back whole on this rank), the one-device
    checkpoint the test wrote (``workdir``/one) restored onto that mesh
    and stepped once, and :func:`_adamw_run` on PART_MESH, ranks 0-3 of
    the 8 ("adamw_part", on those ranks only)."""
    import torch

    from tpu_flash_torch.checkpoint import TrainCheckpointManager
    from tpu_flash_torch.parallel import make_train_step

    tokens = torch.from_numpy(train_tokens())
    res = {}
    meshes = {}

    def mesh_of(sizes):
        key = tuple(sorted(sizes.items()))
        if key not in meshes:
            meshes[key] = _mesh(sizes)
        return meshes[key]

    def coords(mesh):
        return tuple(mesh.get_local_rank(a) for a in ("data", "seq",
                                                      "model"))

    for name, (sizes, variant) in TRAIN_CASES.items():
        mesh = mesh_of(sizes)
        shard, build = make_train_step(train_model(variant), mesh,
                                       learning_rate=TRAIN_LR)
        local = shard(torch_params(train_params(variant)))
        loss = build(local)(local, tokens)
        res[name] = (coords(mesh), float(loss), _detached(local),
                     _detached(local, grad=True))

    from tpu_flash_torch.checkpoint import store

    calls = []
    gather_leaf = store._gather_leaf

    def recorded(*args):
        whole = gather_leaf(*args)
        calls.append(whole is not None)
        return whole

    store._gather_leaf = recorded
    try:
        mesh = mesh_of(ADAMW_MESH)
        res["adamw"], build, fresh = _adamw_run(
            mesh, tokens, os.path.join(workdir, "mesh"))
    finally:
        store._gather_leaf = gather_leaf
    res["adamw"]["gathered"] = calls
    with TrainCheckpointManager(os.path.join(workdir, "one")) as mgr:
        at_one, op, oos = mgr.restore_latest(like_params=fresh, mesh=mesh)
    step = build(op)
    step.optimizer.load_state_dict(oos)
    res["adamw"].update(at_one=at_one, from_one=float(step(op, tokens)),
                        from_one_shard=_detached(op))
    # A mesh over the first ranks of the world: every rank builds it
    # (DeviceMesh makes its groups over the whole world), only its
    # members train, and none waits on the others.
    mesh = mesh_of(PART_MESH)
    if mesh.get_coordinate() is not None:
        res["adamw_part"] = _adamw_run(
            mesh, tokens, os.path.join(workdir, "part"))[0]
    res["torch_threads"] = torch.get_num_threads()
    return res


def spawn(suite: str, world: int, workdir: str, timeout_s: float = 120.0):
    """Run ``suite`` in ``world`` worker processes and return each rank's
    results; raises with the workers' output if any fails or if the group
    outlives ``timeout_s`` (then every worker is killed)."""
    import subprocess
    import time

    import torch

    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite, str(r),
         str(world), workdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
    ) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f"{suite} group outlived {timeout_s} s")
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise AssertionError(f"{suite} ranks failed {bad}:\n" + "\n".join(
            log[-3000:] for log in logs))
    return [torch.load(os.path.join(workdir, f"{suite}-{r}.pt"),
                       weights_only=False) for r in range(world)]


def assemble(shards):
    """One case's whole output from its ranks' (coords, block) pairs."""
    import torch

    coords, block = shards[0]
    shape = list(block.shape)
    for dim, (_, n) in coords.items():
        shape[dim] *= n
    whole = torch.full(shape, float("nan"), dtype=block.dtype)
    for coords, block in shards:
        idx = [slice(None)] * len(shape)
        for dim, (i, _) in coords.items():
            size = block.shape[dim]
            idx[dim] = slice(i * size, (i + 1) * size)
        whole[tuple(idx)] = block
    return whole


def main() -> int:
    suite, rank, world, workdir = (sys.argv[1], int(sys.argv[2]),
                                   int(sys.argv[3]), sys.argv[4])
    import torch
    import torch.distributed as dist

    from tpu_flash_torch.parallel import initialize_multihost

    torch.set_num_threads(1)
    initialize_multihost(
        init_method=f"file://{os.path.join(workdir, 'store')}",
        num_processes=world, process_id=rank, device_type="cpu",
        timeout_s=60,
    )
    if suite == "attention":
        res = run_attention(rank)
    elif suite == "train":
        res = run_train(rank, workdir)
    else:
        res = run_engine(rank, workdir)
    res["jax_imported"] = "jax" in sys.modules
    res["backend"] = dist.get_backend()
    torch.save(res, os.path.join(workdir, f"{suite}-{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
