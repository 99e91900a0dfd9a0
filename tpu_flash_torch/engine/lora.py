"""Multi-LoRA serving: per-request low-rank adapters over one base model.

The port of ``tpu_flash/engine/lora.py``. Any number of adapters register
up front, each request names one (or none), and every batched dispatch of
the engine (chunked and ragged prefill, fused steps, the decode burst,
speculative verify) applies each row's own adapter in the same forward.

Layout: adapters stack into per-layer, per-projection f32 tensors on the
engine's device, padded to the largest rank:

    A: [n_adapters + 1, fan_in,  R]     (index 0 = the null adapter)
    B: [n_adapters + 1, R, fan_out]

A row with adapter id ``i`` adds ``(x @ A[i]) @ B[i]`` to the base
projection; alpha / r folds into B at registration, and ranks below R pad
with zeros, so the null adapter and shorter ranks are zero columns. The
delta is two einsums over the gathered [rows, fan, R] slices: small
products next to the base matmul, outside any attention kernel.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# Projections an adapter may target (the model's layer params).
LORA_PROJS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class LoRAStore:
    """Registered adapters, stacked into device tensors.

    ``register(name, adapters, alpha=...)`` with ``adapters = {layer_idx:
    {proj: (A [in, r], B [r, out])}}`` (numpy arrays or tensors); missing
    layers and projections contribute nothing. Ids are dense ints from 1
    (0 is the null adapter every un-adapted request uses).
    """

    def __init__(self, num_layers: int, device=None):
        self.num_layers = num_layers
        self.device = torch.device(device if device is not None else "cuda")
        self._by_name: Dict[str, int] = {}
        self._adapters = []  # (name, {li: {proj: (A, B)}}) as f32 numpy
        self._stacks = None  # built on registration

    def register(self, name: str, adapters: Mapping, *,
                 alpha: Optional[float] = None) -> int:
        """Add an adapter; returns its id. ``alpha`` scales the delta by
        alpha / r (the LoRA convention); None means 1.0 (pre-scaled
        weights)."""
        if name in self._by_name:
            raise ValueError(f"adapter {name!r} already registered")
        prepared: Dict[int, Dict[str, Tuple[np.ndarray, np.ndarray]]] = {}
        for li, projs in adapters.items():
            li = int(li)
            if not 0 <= li < self.num_layers:
                raise ValueError(f"layer {li} out of range")
            prepared[li] = {}
            for proj, (a, b) in projs.items():
                if proj not in LORA_PROJS:
                    raise ValueError(
                        f"unknown projection {proj!r}; expected one of "
                        f"{LORA_PROJS}"
                    )
                a, b = _as_f32(a), _as_f32(b)
                if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
                    raise ValueError(
                        f"{proj}: A must be [in, r] and B [r, out] with "
                        f"matching r; got {a.shape} / {b.shape}"
                    )
                scale = 1.0 if alpha is None else alpha / a.shape[1]
                prepared[li][proj] = (a, b * np.float32(scale))
        lora_id = len(self._adapters) + 1
        self._adapters.append((name, prepared))
        self._stacks = None
        # Built now, so that factors whose shapes disagree with an earlier
        # adapter's at the same projection raise at registration, and the
        # store keeps the adapters it had.
        try:
            self.stacks()
        except ValueError:
            self._adapters.pop()
            self._stacks = None
            raise
        self._by_name[name] = lora_id
        return lora_id

    def id_of(self, name: Optional[str]) -> int:
        if name is None:
            return 0
        if name not in self._by_name:
            raise ValueError(f"unknown adapter {name!r}")
        return self._by_name[name]

    @property
    def names(self):
        return list(self._by_name)

    @property
    def empty(self) -> bool:
        return not self._adapters

    def stacks(self):
        """{layer_idx: {proj: (A_stack, B_stack)}} on the device, with only
        the (layer, proj) slots some adapter uses."""
        if self._stacks is not None:
            return self._stacks
        n = len(self._adapters)
        used: Dict[int, Dict[str, Tuple[int, int, int]]] = {}
        for _, prepared in self._adapters:
            for li, projs in prepared.items():
                for proj, (a, b) in projs.items():
                    fan_in, r = a.shape
                    out = b.shape[1]
                    prev = used.setdefault(li, {}).get(proj)
                    if prev is not None:
                        pi, po, pr = prev
                        if (pi, po) != (fan_in, out):
                            raise ValueError(
                                f"adapter shape mismatch at layer {li} "
                                f"{proj}: {(fan_in, out)} vs {(pi, po)}"
                            )
                        r = max(r, pr)
                    used[li][proj] = (fan_in, out, r)
        stacks = {}
        for li, projs in used.items():
            stacks[li] = {}
            for proj, (fan_in, out, rmax) in projs.items():
                a_stack = np.zeros((n + 1, fan_in, rmax), np.float32)
                b_stack = np.zeros((n + 1, rmax, out), np.float32)
                for i, (_, prepared) in enumerate(self._adapters):
                    ab = prepared.get(li, {}).get(proj)
                    if ab is None:
                        continue
                    a, b = ab
                    a_stack[i + 1, :, :a.shape[1]] = a
                    b_stack[i + 1, :b.shape[0], :] = b
                stacks[li][proj] = (
                    torch.from_numpy(a_stack).to(self.device),
                    torch.from_numpy(b_stack).to(self.device),
                )
        self._stacks = stacks
        return stacks


def seeded_adapter(cfg, rank: int, scale: float, rng: np.random.Generator):
    """Random factors of one adapter over every projection of every layer
    of a model of ``cfg`` (a ``ModelConfig``), as ``register`` takes them:
    {layer: {proj: (A [in, rank], B [rank, out])}} f32 numpy, drawn from
    ``rng`` layer by layer, A then B, with A ~ N(0, scale^2 / in) and B ~
    N(0, 1)."""
    h, qd = cfg.hidden_size, cfg.num_q_heads * cfg.head_dim
    kvd, inter = cfg.num_kv_heads * cfg.head_dim, cfg.intermediate_size
    dims = dict(wq=(h, qd), wk=(h, kvd), wv=(h, kvd), wo=(qd, h),
                w_gate=(h, inter), w_up=(h, inter), w_down=(inter, h))
    return {li: {p: (rng.standard_normal((fi, rank), np.float32)
                     * np.float32(scale / fi ** 0.5),
                     rng.standard_normal((rank, fo), np.float32))
                 for p, (fi, fo) in dims.items()}
            for li in range(cfg.num_layers)}


def _as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def apply_lora(stacks, li: int, proj: str, x: torch.Tensor, y: torch.Tensor,
               ids: torch.Tensor, tp_rank: Optional[int] = None
               ) -> torch.Tensor:
    """Add each row's adapter delta to a base projection output.

    x: [..., fan_in] activations, y: [..., fan_out] = x @ W_base, ids:
    [batch] adapter ids aligned with x's leading axis; [batch, fan]
    (decode) and [batch, seq, fan] (prefill) rows.

    Under tensor parallelism (``tp_rank``: this rank's index on the model
    axis) the stacks hold global shapes while x and y are this rank's
    slices; the sharded side follows from the local shapes, as in JAX:
    a column-sharded projection takes its slice of B's fan-out, a
    row-sharded one (``wo``, ``w_down``) its slice of A's fan-in, and its
    delta then joins the base before the all-reduce."""
    ab = stacks.get(li, {}).get(proj)
    if ab is None:
        return y
    a_stack, b_stack = ab
    if tp_rank is not None:
        fi, fo = x.shape[-1], y.shape[-1]
        if a_stack.shape[1] != fi:
            a_stack = a_stack[:, tp_rank * fi:(tp_rank + 1) * fi]
        if b_stack.shape[2] != fo:
            b_stack = b_stack[:, :, tp_rank * fo:(tp_rank + 1) * fo]
    a = a_stack[ids]  # [batch, fan_in, R]
    b = b_stack[ids]  # [batch, R, fan_out]
    xf = x.float()
    if x.ndim == 2:
        t = torch.einsum("bi,bir->br", xf, a)
        delta = torch.einsum("br,bro->bo", t, b)
    elif x.ndim == 3:
        t = torch.einsum("bsi,bir->bsr", xf, a)
        delta = torch.einsum("bsr,bro->bso", t, b)
    else:
        raise ValueError(f"unsupported activation rank {x.ndim}")
    return y + delta.to(y.dtype)
