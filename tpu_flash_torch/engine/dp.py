"""Data-parallel serving: R replica engines behind one submit/run API.

The port of ``tpu_flash/engine/dp.py``. Each replica is an independent
``InferenceEngine`` on its own device, and the host routes each request
to the least-loaded replica. Replicas never communicate -- the KV cache,
page pool and scheduler are replica-local -- so, as in JAX, this is one
process with one host thread per replica, not a process group.

Steps run concurrently, one host thread per busy replica, each replica
on a CUDA stream of its own (a replica's step blocks its thread on its
own device fetch), so the replicas' device work overlaps. A device may be
named more than once (PyTorch has one CPU device; one card may hold two
replicas): the replicas then share it. Tensor parallelism inside a
replica (DP x TP over processes) waits for its own slice.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import torch

from tpu_flash_torch.core.config import EngineConfig
from tpu_flash_torch.engine.runner import InferenceEngine
from tpu_flash_torch.engine.sampling import GREEDY, SamplingParams
from tpu_flash_torch.models.transformer import FlashTransformer


def _on_device(tree, device):
    """The params dict with every tensor on ``device``: a tensor already
    there is shared, not copied."""
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on_device(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class DataParallelEngine:
    """R independent ``InferenceEngine`` replicas behind one submit/run API.

    ``replicas * tp`` devices are taken from ``devices`` (default: every
    visible CUDA device; with no card, ``devices`` must be given, e.g.
    ``["cpu", "cpu"]``). Replica i runs a ``FlashTransformer`` on device
    i, its params moved there (or shared where they already lie), and
    samples from seed ``seed + i``.
    """

    def __init__(
        self,
        model: FlashTransformer,
        params,
        config: EngineConfig,
        *,
        replicas: int,
        tp: int = 1,
        seed: int = 0,
        devices=None,
    ):
        if replicas < 1:
            raise ValueError("need at least 1 replica")
        if tp > 1:
            raise NotImplementedError(
                "DataParallelEngine(tp > 1), DP x TP over processes, waits "
                "for its own slice (ROADMAP.md, item 15); serve a TP engine "
                "with InferenceEngine(mesh=...)"
            )
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n == 0:
                raise RuntimeError(
                    "no CUDA device: pass devices=[...] (e.g. ['cpu', 'cpu'])"
                )
            devices = [f"cuda:{i}" for i in range(n)]
        devices = [torch.device(d) for d in devices]
        need = replicas * tp
        if need > len(devices):
            raise ValueError(
                f"DP×TP needs {need} devices; {len(devices)} present"
            )
        self.replicas = replicas
        self.tp = tp
        self.engines: List[InferenceEngine] = []
        self._streams = []
        for i in range(replicas):
            dev = devices[i]
            replica = FlashTransformer(model.config, device=dev)
            self.engines.append(InferenceEngine(
                replica, _on_device(params, dev), config,
                # Decorrelate the replicas' sampling streams.
                seed=seed + i,
            ))
            self._streams.append(
                torch.cuda.Stream(device=dev) if dev.type == "cuda" else None)
        self._route: Dict[int, Tuple[int, int]] = {}  # rid -> (rep, local)
        self._branch_ids: Dict[int, List[int]] = {}  # rid -> [rid, kids...]
        self._next_id = 0
        self._rr = 0  # round-robin tie-break
        self._pool = (ThreadPoolExecutor(max_workers=replicas)
                      if replicas > 1 else None)

    # -- client API ----------------------------------------------------------

    def _load(self, eng: InferenceEngine) -> int:
        return len(eng.scheduler.waiting) + eng.scheduler.num_active()

    def submit(
        self,
        prompt: List[int],
        max_new_tokens: int,
        sampling: SamplingParams = GREEDY,
        stop_tokens: Optional[List[int]] = None,
        n: int = 1,
        priority: int = 0,
        lora: Optional[str] = None,
        logit_bias=None,
    ) -> int:
        """Queue a request on the least-loaded replica (round-robin among
        ties, so a burst of arrivals spreads); returns its fleet id. The
        branches of an ``n > 1`` request stay on that replica, each with a
        fleet id of its own."""
        loads = [self._load(e) for e in self.engines]
        best = min(loads)
        order = [(self._rr + i) % self.replicas for i in range(self.replicas)]
        rep = next(i for i in order if loads[i] == best)
        self._rr = (rep + 1) % self.replicas
        local = self.engines[rep].submit(
            prompt, max_new_tokens, sampling=sampling,
            stop_tokens=stop_tokens, n=n, priority=priority, lora=lora,
            logit_bias=logit_bias,
        )
        rid = self._next_id
        self._next_id += 1
        self._route[rid] = (rep, local)
        branch_rids = [rid]
        for child_local in self.engines[rep].branches(local)[1:]:
            crid = self._next_id
            self._next_id += 1
            self._route[crid] = (rep, child_local)
            branch_rids.append(crid)
        self._branch_ids[rid] = branch_rids
        return rid

    def branches(self, rid: int) -> List[int]:
        """Fleet ids of a request's completions (itself, then its
        parallel-sampling branches)."""
        return list(self._branch_ids.get(rid, [rid]))

    def register_lora(self, name: str, adapters, *, alpha=None) -> int:
        """Register an adapter on every replica (ids are positional, so
        the same on each)."""
        ids = {eng.register_lora(name, adapters, alpha=alpha)
               for eng in self.engines}
        if len(ids) != 1:
            raise RuntimeError(f"replicas gave adapter {name!r} ids {ids}")
        return ids.pop()

    def has_work(self) -> bool:
        return any(e.scheduler.has_work() for e in self.engines)

    def _step_replica(self, i: int, caller) -> None:
        """Replica i's step on its own stream, ordered after the caller's
        stream's work (a restore, for one) and before its later work."""
        stream = self._streams[i]
        if stream is None:
            self.engines[i].step()
            return
        stream.wait_stream(caller[i])
        with torch.cuda.stream(stream):
            self.engines[i].step()
        caller[i].wait_stream(stream)

    def step(self) -> None:
        """One step on every replica that has work, the replicas in
        parallel threads when more than one is busy."""
        caller = [None if s is None else torch.cuda.current_stream(s.device)
                  for s in self._streams]
        busy = [i for i, e in enumerate(self.engines)
                if e.scheduler.has_work()]
        if self._pool is not None and len(busy) > 1:
            futures = [self._pool.submit(self._step_replica, i, caller)
                       for i in busy]
            for f in futures:
                f.result()  # surface exceptions
        else:
            for i in busy:
                self._step_replica(i, caller)

    def run(self) -> Dict[int, List[int]]:
        while self.has_work():
            self.step()
        return self.outputs

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        for eng in self.engines:
            eng.close()

    # -- results & observability ----------------------------------------------

    @property
    def outputs(self) -> Dict[int, List[int]]:
        return {rid: self.engines[rep].outputs[local]
                for rid, (rep, local) in self._route.items()}

    @property
    def logprobs(self) -> Dict[int, List[float]]:
        return {rid: self.engines[rep].logprobs[local]
                for rid, (rep, local) in self._route.items()}

    def stats(self) -> Dict[str, object]:
        per = [{
            "active": eng.scheduler.num_active(),
            "waiting": len(eng.scheduler.waiting),
            "decode_tokens": eng.metrics.decode_tokens,
            "prefill_tokens": eng.metrics.prefill_tokens,
        } for eng in self.engines]
        return {
            "replicas": self.replicas,
            "tp": self.tp,
            "per_replica": per,
            "decode_tokens": sum(p["decode_tokens"] for p in per),
            "prefill_tokens": sum(p["prefill_tokens"] for p in per),
        }
