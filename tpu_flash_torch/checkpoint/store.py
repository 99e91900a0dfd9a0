"""Checkpoints: weights, training state, and engine snapshots.

The port of ``tpu_flash/checkpoint/store.py``. Three surfaces:

* ``save_params`` / ``restore_params``: one-shot weight checkpoints (the
  params dict, ``torch.save`` into a directory, read back with
  ``torch.load(weights_only=True)``).
* ``TrainCheckpointManager``: step-indexed keep-N checkpoints of the
  params and a ``torch.optim`` state dict, for training resume. With a
  ``mesh`` (the sharded train step, ``parallel/train.py``) every rank
  passes its shard: the model-sharded leaves (and their optimizer state)
  are gathered over "model", one at a time, onto the mesh's first rank,
  which moves each to the host and writes whole tensors in
  ``models.shard_params``' layout; a restore maps the file and each rank
  copies out its own slices. So a checkpoint written on a mesh restores
  onto one device, and the other way round.
* ``snapshot_engine`` / ``restore_engine``: a consistent snapshot of the
  serving engine's paged KV cache and the host state that gives the pages
  meaning (page tables, lengths, allocator ownership, request progress,
  waiting requests, swap stashes), so that an interrupted serving process
  resumes mid-sequence. The files and keys are the JAX package's
  (``engine_meta.json``, ``engine_arrays.npz``), so the two snapshots
  compare key by key; the random state is the engine's
  ``torch.Generator`` state. A tensor-parallel engine's snapshot holds
  the global cache: its kv-head shards are gathered over the model group
  and its rank 0 writes JAX's files; a restore reads them on every rank
  and keeps its own heads, so a TP snapshot restores into a one-device
  engine and the other way round.
* ``snapshot_dp_engine`` / ``restore_dp_engine``: a ``DataParallelEngine``
  as one engine snapshot a replica (``replica_<i>/``) and the routing
  table (``dp_meta.json``), JAX's layout.
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

_PARAMS_FILE = "params.pt"
_STATE_FILE = "state.pt"


def _abs(path) -> pathlib.Path:
    return pathlib.Path(path).absolute()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _detached(tree):
    return _tree_map(lambda t: t.detach(), tree)


def _like(tree, like):
    """``tree``'s tensors cast and moved to those of ``like`` (same
    structure, else ValueError)."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError("checkpoint structure differs from `like`")
        return {k: _like(tree[k], like[k]) for k in like}
    if isinstance(like, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError("checkpoint structure differs from `like`")
        return type(like)(_like(t, lk) for t, lk in zip(tree, like))
    if isinstance(like, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != like.shape:
            raise ValueError("checkpoint tensor shape differs from `like`")
        return tree.to(device=like.device, dtype=like.dtype)
    return tree


# ---------------------------------------------------------------------------
# Params (weights)
# ---------------------------------------------------------------------------


def save_params(path, params, *, force: bool = True) -> None:
    """Write a params dict into the directory ``path`` (made if needed);
    without ``force`` an existing checkpoint there raises."""
    path = _abs(path)
    if (path / _PARAMS_FILE).exists() and not force:
        raise FileExistsError(f"checkpoint exists: {path}")
    path.mkdir(parents=True, exist_ok=True)
    torch.save(_detached(params), path / _PARAMS_FILE)


def restore_params(path, like: Optional[Any] = None, device=None):
    """Read a params dict. ``like`` (a dict of the same structure) pins
    each tensor's dtype and device; without it tensors land on
    ``device`` ("cuda" unless the caller asks for "cpu")."""
    params = torch.load(_abs(path) / _PARAMS_FILE, map_location="cpu",
                        weights_only=True)
    if like is not None:
        return _like(params, like)
    dev = torch.device(device if device is not None else "cuda")
    return _tree_map(lambda t: t.to(dev), params)


# ---------------------------------------------------------------------------
# Training resume
# ---------------------------------------------------------------------------


def _map_sharded(params, opt_state, fn):
    """``params`` and ``opt_state`` with ``fn(tensor, dim)`` applied to
    every tensor split over the model axis (``models.SHARD_DIMS``): each
    sharded param, and each optimizer state tensor of its param's rank
    (Adam's moments; not a scalar ``step``)."""
    from tpu_flash_torch.models.transformer import SHARD_DIMS
    from tpu_flash_torch.parallel.train import param_names

    layers = [{n: w if SHARD_DIMS.get(n) is None else fn(w, SHARD_DIMS[n])
               for n, w in lw.items()} for lw in params["layers"]]
    params = {**params, "layers": layers}
    if opt_state is not None:
        # A torch.optim state dict built over param_leaves numbers the
        # params in that order.
        dims = [SHARD_DIMS.get(n.rsplit(".", 1)[-1])
                for n in param_names(params)]
        order = [i for g in opt_state["param_groups"] for i in g["params"]]
        by_index = {i: dims[j] for j, i in enumerate(order)}
        state = {}
        for i, st in opt_state["state"].items():
            d = by_index[i]
            state[i] = {k: fn(t, d) if d is not None and torch.is_tensor(t)
                        and t.dim() > d else t for k, t in st.items()}
        opt_state = {**opt_state, "state": state}
    return params, opt_state


class TrainCheckpointManager:
    """Step-indexed keep-N checkpoints of {params, opt_state} under one
    directory (a subdirectory a step). Training loops call ``save(step,
    params, optimizer.state_dict())`` every K steps and
    ``restore_latest()`` on restart, then ``optimizer.load_state_dict``
    on an optimizer built over the restored params.

    The sharded train step's ranks pass ``mesh=`` to both: every rank
    calls ``save`` with its shard and its optimizer's state dict (built
    over ``param_leaves`` of the shard); the model-sharded tensors are
    gathered over "model" one at a time onto the mesh's first rank, which
    keeps each on the host and writes whole tensors; the other ranks keep
    nothing, and every rank of the mesh returns once they are written.
    ``restore_latest(..., mesh=)`` maps the file (``mmap``) on every rank
    and copies out its shard (``like_params``, when given, is the
    shard), so a host of several ranks reads one copy through its page
    cache."""

    def __init__(self, directory, *, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError("max_to_keep must be >= 1")
        self._dir = _abs(directory)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._keep = max_to_keep

    def _steps(self):
        return sorted(int(p.name) for p in self._dir.iterdir()
                      if p.is_dir() and re.fullmatch(r"\d+", p.name)
                      and (p / _STATE_FILE).exists())

    def save(self, step: int, params, opt_state=None, *, mesh=None) -> None:
        if mesh is not None:
            from tpu_flash_torch.parallel.mesh import (
                AXIS_ORDER,
                axis_size,
                plane_group,
            )

            writes = all(mesh.get_local_rank(a) == 0 for a in ("data", "seq"))
            n = axis_size(mesh, "model")
            if writes and n > 1:
                group = mesh.get_group("model")
                params, opt_state = _map_sharded(
                    params, opt_state,
                    lambda t, dim: _gather_leaf(t, dim, group, n))
            if writes and mesh.get_local_rank("model") == 0:
                self._write(step, params, opt_state)
            everyone = plane_group(mesh, AXIS_ORDER)
            if everyone is not None:
                dist.barrier(group=everyone)
            return
        self._write(step, params, opt_state)

    def _write(self, step: int, params, opt_state) -> None:
        state = {"params": _detached(params)}
        if opt_state is not None:
            state["opt_state"] = _detached(opt_state)
        target = self._dir / str(int(step))
        tmp = self._dir / f".{int(step)}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state, tmp / _STATE_FILE)
        shutil.rmtree(target, ignore_errors=True)
        tmp.rename(target)
        for old in self._steps()[:-self._keep]:
            shutil.rmtree(self._dir / str(old))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, like_params=None, like_opt_state=None,
                       device=None, *, mesh=None):
        """(step, params, opt_state) of the newest checkpoint, or None.
        ``like_params`` / ``like_opt_state`` pin dtypes and devices as
        :func:`restore_params`'s ``like`` does; without them tensors land
        on ``device`` ("cuda" unless the caller asks for "cpu"). With a
        ``mesh``, this rank's model shard of the params and of the
        optimizer state."""
        step = self.latest_step()
        if step is None:
            return None
        state = torch.load(self._dir / str(step) / _STATE_FILE,
                           map_location="cpu", weights_only=True,
                           mmap=mesh is not None)
        if mesh is not None:
            from tpu_flash_torch.parallel.mesh import axis_size, take_shard

            n, r = axis_size(mesh, "model"), mesh.get_local_rank("model")
            state["params"], opt = _map_sharded(
                state["params"], state.get("opt_state"),
                lambda t, dim: take_shard(t, n, r, dim, "checkpoint tensor"))
            if opt is not None:
                state["opt_state"] = opt
        dev = torch.device(device if device is not None else "cuda")
        params = (_like(state["params"], like_params)
                  if like_params is not None
                  else _tree_map(lambda t: t.to(dev), state["params"]))
        opt_state = state.get("opt_state")
        if opt_state is not None and like_opt_state is not None:
            opt_state = _like(opt_state, like_opt_state)
        return step, params, opt_state

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Engine / KV-cache snapshots
# ---------------------------------------------------------------------------

_ENGINE_META = "engine_meta.json"
_ENGINE_ARRAYS = "engine_arrays.npz"


def _np(x: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 and e4m3 payloads as f32 (lossless for
    both; numpy has neither type), as the JAX snapshot stores them."""
    x = x.detach().cpu()
    if x.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        x = x.float()
    return x.numpy()


def _torch(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=like.device, dtype=like.dtype)


# The kv-head axis of each snapshot array: pages and scales [L, hkv, ...],
# recent rings [L, slots, hkv, W, d]; a swap stash's arrays are pages'
# slices [L, hkv, n, ...] and its ring rows [L, hkv, W, d].
_HEAD_DIM = {"k_pages": 1, "v_pages": 1, "k_scales": 1, "v_scales": 1,
             "k_recent": 2, "v_recent": 2}


def _tp(engine):
    """(group, rank, size) of a tensor-parallel engine's model group, or
    None for an engine on one device (the engine keeps no group for a
    model dimension of one)."""
    group = engine._tp_group
    if group is None:
        return None
    return group, dist.get_rank(group), dist.get_world_size(group)


def _gather_leaf(t: torch.Tensor, dim: int, group, n: int):
    """``t``'s model shards gathered along ``dim`` onto the group's first
    rank and moved to the host there, one whole tensor; None on the
    other ranks, which send their shard and keep nothing."""
    x = t.detach().contiguous()
    first = dist.get_global_rank(group, 0)
    parts = ([torch.empty_like(x) for _ in range(n)]
             if dist.get_rank() == first else None)
    dist.gather(x, parts, dst=first, group=group)
    if parts is None:
        return None
    return torch.cat([p.cpu() for p in parts], dim)


def _global_heads(t: torch.Tensor, dim: int, tp, device) -> torch.Tensor:
    """The kv-head shards of ``t`` gathered over the model group along
    ``dim`` (through ``device``, where the group's backend works); ``t``
    itself without TP."""
    if tp is None:
        return t
    group, _, n = tp
    x = t.to(device).contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _own_heads(a: np.ndarray, dim: int, local: int, tp, name: str):
    """This rank's kv heads of a snapshot's global array: all of them on
    one device, its contiguous block under TP."""
    n, rank = (1, 0) if tp is None else (tp[2], tp[1])
    if a.shape[dim] != local * n:
        raise ValueError(
            f"snapshot {name} has {a.shape[dim]} kv heads; this engine "
            f"holds {local} on each of {n} rank(s)"
        )
    if n == 1:
        return a
    return np.take(a, range(rank * local, (rank + 1) * local), axis=dim)


def snapshot_engine(path, engine) -> None:
    """Snapshot a live ``InferenceEngine`` into the directory ``path``: KV
    pages (and scales, and exact recent rings), page tables, lengths,
    last tokens, slot sampling state, adapters and logit bias, the
    generator state, allocator ownership, every active and waiting
    request (pending fork children inline), outputs and log-probs, branch
    ids, adapter names and swap stashes. The arrays go uncompressed into
    one npz: KV payloads barely compress. Under tensor parallelism every
    rank of the model group calls it: the kv-head shards gather over the
    group, its rank 0 writes, and every rank returns once the files are
    there."""
    path = _abs(path)
    cache = engine.cache
    tp = _tp(engine)
    dev = engine.device

    def whole(name, t):
        return _np(_global_heads(t, _HEAD_DIM[name], tp, dev))

    arrays = {
        "k_pages": whole("k_pages", cache.k_pages),
        "v_pages": whole("v_pages", cache.v_pages),
        "page_tables": _np(engine.page_tables),
        "lengths": _np(engine.lengths),
        "last_tokens": _np(engine.last_tokens).astype(np.int32),
        "active": np.asarray(engine.active),
        "temps": np.asarray(engine.temps),
        "top_ks": np.asarray(engine.top_ks),
        "top_ps": np.asarray(engine.top_ps),
        "min_ps": np.asarray(engine.min_ps),
        "lora_ids": np.asarray(engine.lora_ids),
        "logit_bias": _np(engine.logit_bias),
        "slot_bias": np.asarray(engine._slot_bias),
        "rng": engine._generator.get_state().numpy(),
    }
    if cache.quantized:
        arrays["k_scales"] = whole("k_scales", cache.k_scales)
        arrays["v_scales"] = whole("v_scales", cache.v_scales)
    if cache.k_recent is not None:
        arrays["k_recent"] = whole("k_recent", cache.k_recent)
        arrays["v_recent"] = whole("v_recent", cache.v_recent)
    for rid, stash in engine._swapped.items():
        for j, a in enumerate(stash["arrays"]):
            arrays[f"swap_{rid}_{j}"] = _np(_global_heads(a, 1, tp, dev))
        if "recent" in stash:
            arrays[f"swap_{rid}_rk"] = _np(
                _global_heads(stash["recent"][0], 1, tp, dev))
            arrays[f"swap_{rid}_rv"] = _np(
                _global_heads(stash["recent"][1], 1, tp, dev))
    if tp is not None and tp[1] != 0:
        dist.barrier(group=tp[0])  # rank 0 writes the files
        return
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / _ENGINE_ARRAYS, **arrays)

    sched = engine.scheduler

    def req_dict(req):
        d = {
            "req_id": req.req_id,
            "prompt_len": req.prompt_len,
            "max_new_tokens": req.max_new_tokens,
            "state": req.state.name,
            "batch_slot": req.batch_slot,
            "prefilled": req.prefilled,
            "generated": req.generated,
            "prompt": list(getattr(req, "_prompt", [])),
            "sampling": [
                req.sampling.temperature, req.sampling.top_k,
                req.sampling.top_p, req.sampling.min_p,
            ],
            "stop_tokens": list(req.stop_tokens),
            "stopped": req.stopped,
            "n_branches": req.n_branches,
            "parent_id": req.parent_id,
            "child_ids": list(req.child_ids),
            "resume_token": req.resume_token,
            "swap_npages": req.swap_npages,
            "priority": req.priority,
            "lora_id": req.lora_id,
            "logit_bias": {
                str(t): v
                for t, v in (getattr(req, "_logit_bias", None) or {}).items()
            },
            "arrival": getattr(req, "_arrival", 0),
            "admit_seq": getattr(req, "_admit_seq", 0),
        }
        # A waiting fork parent still carries its un-admitted children:
        # they go inline, so that restore rebuilds the group whole.
        pending = getattr(req, "_children_reqs", None)
        if req.state.name == "WAITING" and pending:
            d["pending_children"] = [req_dict(c) for c in pending]
        return d

    meta = {
        "page_size": cache.page_size,
        "kv_dtype": cache.kv_dtype,
        "requests": {str(rid): req_dict(r) for rid, r in sched.active.items()},
        "waiting": [req_dict(r) for r in sched.waiting],
        # Pages are allocated per request at admission and released at
        # retirement: the active requests own every live page.
        "alloc": {
            str(rid): sched.allocator.pages_of(rid) for rid in sched.active
        },
        "outputs": {str(k): v for k, v in engine.outputs.items()},
        "logprobs": {str(k): v for k, v in engine.logprobs.items()},
        "next_id": engine._next_id,
        "branch_ids": {str(k): list(v) for k, v in engine._branch_ids.items()},
        "lora_names": engine.lora.names,
        "swapped": {
            str(rid): {"n": stash["n"], "k": len(stash["arrays"])}
            for rid, stash in engine._swapped.items()
        },
    }
    (path / _ENGINE_META).write_text(json.dumps(meta))
    if tp is not None:
        dist.barrier(group=tp[0])


@torch.inference_mode()
def restore_engine(path, engine) -> None:
    """Restore a snapshot into a freshly built engine of the same config
    (shapes must match), with the same adapters registered in the same
    order. Decoding resumes where the snapshot left it: page ownership,
    request progress, device state and the generator all round-trip. The
    prefix index restores cold. Each rank of a tensor-parallel engine
    keeps its own kv heads of the snapshot's global cache, whichever
    engine (one device or TP) wrote it."""
    from tpu_flash_torch.engine.sampling import SamplingParams
    from tpu_flash_torch.engine.scheduler import Request, RequestState

    path = _abs(path)
    meta = json.loads((path / _ENGINE_META).read_text())
    data = np.load(path / _ENGINE_ARRAYS)
    cache = engine.cache
    if meta["page_size"] != cache.page_size:
        raise ValueError("snapshot page_size mismatch")
    if meta["kv_dtype"] != cache.kv_dtype:
        raise ValueError("snapshot kv_dtype mismatch")
    tp = _tp(engine)
    local = cache.k_pages.shape[1]
    k_pages = _own_heads(data["k_pages"], 1, local, tp, "k_pages")
    if tuple(k_pages.shape) != tuple(cache.k_pages.shape):
        raise ValueError(
            f"snapshot cache shape {data['k_pages'].shape} != engine "
            f"{tuple(cache.k_pages.shape)}"
        )
    want = meta.get("lora_names", [])
    if want and engine.lora.names != want:
        raise ValueError(
            f"snapshot was taken with LoRA adapters {want}; re-register "
            f"them (same order) before restore: engine has "
            f"{engine.lora.names}"
        )
    names = ["k_pages", "v_pages"]
    if cache.quantized:
        names += ["k_scales", "v_scales"]
    if cache.k_recent is not None and "k_recent" in data:
        names += ["k_recent", "v_recent"]
    for name in names:
        t = getattr(cache, name)
        a = k_pages if name == "k_pages" else _own_heads(
            data[name], _HEAD_DIM[name], local, tp, name)
        t.copy_(_torch(a, t))
    for name in ("page_tables", "lengths", "last_tokens", "logit_bias"):
        t = getattr(engine, name)
        t.copy_(_torch(data[name], t))
    engine.active = np.array(data["active"])
    engine.temps = np.array(data["temps"])
    engine.top_ks = np.array(data["top_ks"])
    engine.top_ps = np.array(data["top_ps"])
    engine.min_ps = np.array(data["min_ps"])
    engine.lora_ids = np.array(data["lora_ids"])
    engine._slot_bias = np.array(data["slot_bias"])
    engine._slot_bias_req[:] = -1  # rows are written again on next install
    engine._generator.set_state(torch.from_numpy(np.array(data["rng"])))
    engine.outputs = {int(k): list(v) for k, v in meta["outputs"].items()}
    engine.logprobs = {int(k): list(v) for k, v in meta["logprobs"].items()}
    engine._next_id = meta["next_id"]

    sched = engine.scheduler
    for sid, pages in meta["alloc"].items():
        # Each sequence takes back its own physical pages (the page tables
        # name them); a page an earlier sequence already took was
        # prefix-shared at snapshot time and is shared again.
        for page in pages:
            if sched.allocator.refcount(page) > 0:
                ok = sched.allocator.share(int(sid), [page])
            else:
                ok = sched.allocator.alloc_exact(int(sid), [page])
            if not ok:
                raise ValueError(
                    f"snapshot page {page} for seq {sid} unavailable in "
                    f"this allocator"
                )

    def build_req(rd):
        t, k, p, min_p = rd["sampling"]
        req = Request(
            req_id=rd["req_id"],
            prompt_len=rd["prompt_len"],
            max_new_tokens=rd["max_new_tokens"],
            sampling=SamplingParams(temperature=t, top_k=int(k), top_p=p,
                                    min_p=min_p),
            stop_tokens=tuple(rd["stop_tokens"]),
            state=RequestState[rd["state"]],
            prefilled=rd["prefilled"],
            generated=rd["generated"],
            stopped=rd["stopped"],
            batch_slot=rd["batch_slot"],
            n_branches=rd["n_branches"],
            parent_id=rd["parent_id"],
            child_ids=tuple(rd["child_ids"]),
            resume_token=rd["resume_token"],
            swap_npages=rd["swap_npages"],
            priority=rd["priority"],
            lora_id=rd["lora_id"],
        )
        req._prompt = list(rd["prompt"])
        if rd["logit_bias"]:
            req._logit_bias = {int(t): float(v)
                               for t, v in rd["logit_bias"].items()}
        req._arrival = rd["arrival"]
        req._admit_seq = rd["admit_seq"]
        if rd.get("pending_children"):
            req._children_reqs = [build_req(c)
                                  for c in rd["pending_children"]]
        return req

    for rid, rd in meta["requests"].items():
        req = build_req(rd)
        sched.active[int(rid)] = req
        if req.batch_slot >= 0:
            sched.slots[req.batch_slot] = req.req_id
    for rd in meta["waiting"]:
        sched.waiting.append(build_req(rd))
    engine._branch_ids = {int(k): list(v)
                          for k, v in meta["branch_ids"].items()}
    # The scheduler's ordering counters resume past every request.
    reqs = list(sched.active.values()) + list(sched.waiting)
    if reqs:
        sched._arrival_counter = 1 + max(r._arrival for r in reqs)
        sched._admit_counter = 1 + max(r._admit_seq for r in reqs)
    # Swap stashes: payloads back in their pages' dtypes, scales f32.
    engine._swapped = {}
    sides = [cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales]
    for rid, info in meta["swapped"].items():
        def own(key):
            return torch.from_numpy(np.ascontiguousarray(
                _own_heads(data[key], 1, local, tp, key)))

        arrays = [own(f"swap_{rid}_{j}").to(sides[j].dtype)
                  for j in range(info["k"])]
        stash = {"n": info["n"], "arrays": arrays}
        if f"swap_{rid}_rk" in data:
            ring = cache.k_recent.dtype
            stash["recent"] = (own(f"swap_{rid}_rk").to(ring),
                               own(f"swap_{rid}_rv").to(ring))
        engine._swapped[int(rid)] = stash


# ---------------------------------------------------------------------------
# Data-parallel engine snapshots
# ---------------------------------------------------------------------------

_DP_META = "dp_meta.json"


def snapshot_dp_engine(path, dp_engine) -> None:
    """Snapshot a ``DataParallelEngine``: one engine snapshot a replica
    (``replica_<i>/``, exactly ``snapshot_engine``'s files) plus the
    request routing table, as the JAX package lays them out."""
    path = _abs(path)
    path.mkdir(parents=True, exist_ok=True)
    for i, eng in enumerate(dp_engine.engines):
        snapshot_engine(path / f"replica_{i}", eng)
    meta = {
        "replicas": dp_engine.replicas,
        "tp": dp_engine.tp,
        "route": {str(k): list(v) for k, v in dp_engine._route.items()},
        "branch_ids": {
            str(k): list(v) for k, v in dp_engine._branch_ids.items()
        },
        "next_id": dp_engine._next_id,
        "rr": dp_engine._rr,
    }
    (path / _DP_META).write_text(json.dumps(meta))


def restore_dp_engine(path, dp_engine) -> None:
    """Restore into a freshly built ``DataParallelEngine`` of the same
    config and replica count (adapters registered as at the snapshot)."""
    path = _abs(path)
    meta = json.loads((path / _DP_META).read_text())
    if meta["replicas"] != dp_engine.replicas:
        raise ValueError(
            f"snapshot has {meta['replicas']} replicas; engine has "
            f"{dp_engine.replicas}"
        )
    for i, eng in enumerate(dp_engine.engines):
        restore_engine(path / f"replica_{i}", eng)
    dp_engine._route = {int(k): tuple(v) for k, v in meta["route"].items()}
    dp_engine._branch_ids = {
        int(k): list(v) for k, v in meta.get("branch_ids", {}).items()
    }
    dp_engine._next_id = meta["next_id"]
    dp_engine._rr = meta.get("rr", 0)
