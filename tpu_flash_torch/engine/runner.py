"""Inference engine: continuous batching over the paged KV cache.

The port of ``tpu_flash/engine/runner.py`` for the serving slice:
``submit`` -> ``step``/``run`` -> prefill groups -> the model forward
(``flash_attention``) -> ``PagedKVCache.append`` -> burst decode
(``paged_attention``) -> sampling.

  * prefill: same-stage chunks (equal start) run as one batch: tokens
    pad to a power-of-two bucket, rows to a power-of-two count (pad rows
    write only the trash page and trash slot). A chunk attends its
    history gathered dense and dequantized from its pages, plus itself,
    with ``q_offset``; its K/V append into its pages. The final chunk's
    last-position logits give the first token.
  * decode: bursts of up to ``max_decode_burst`` single-token steps over
    every batch slot (inactive slots write the trash page), as a Python
    loop with one host fetch of tokens per burst.

Routing in this slice: ``paged_prefill`` "auto"/False take the gathered
history (True raises until the paged-prefill kernel K5 is ported);
``fused_mixed_step`` "auto"/False take the unfused step, and chunks at
different stages run group by group (True raises until the ragged kernel
K6 is ported); speculation is off (``speculation_k`` 0). All three
replaced paths are exact in the JAX engine, so the tokens are the same.
n>1 forks, preemption/swap, LoRA and logit_bias are later slices.

The engine runs on ``model.device`` ("cuda" unless the model was built
for "cpu"); it mutates its cache and slot tensors in place.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_flash_torch.core.config import EngineConfig
from tpu_flash_torch.engine.allocator import PageAllocator
from tpu_flash_torch.engine.cache import PagedKVCache
from tpu_flash_torch.engine.health import (
    DeadlineFetcher,
    HealthConfig,
    HealthMonitor,
    StepTimer,
    watchdog_check,
)
from tpu_flash_torch.engine.metrics import EngineMetrics
from tpu_flash_torch.engine.prefix import PrefixIndex
from tpu_flash_torch.engine.sampling import (
    GREEDY,
    SamplingParams,
    sample_tokens,
)
from tpu_flash_torch.engine.scheduler import Request, Scheduler
from tpu_flash_torch.models.transformer import FlashTransformer, _rms_norm
from tpu_flash_torch.ops.decode import paged_attention
from tpu_flash_torch.ops.quant import QuantizedTensor, dequantize


def _pow2_bucket(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


class InferenceEngine:
    def __init__(
        self,
        model: FlashTransformer,
        params,
        config: EngineConfig,
        seed: int = 0,
    ):
        cfg = model.config
        if not config.cache.resolved:
            raise ValueError(
                "CacheConfig has unresolved auto fields: set page_size, "
                "num_pages, max_pages_per_seq and recent_window explicitly "
                "(the auto layout policy, tpu_flash.utils.tuning."
                "resolve_cache_config, is not ported: ROADMAP queue 1, "
                "item 9)"
            )
        if config.paged_prefill is True:
            raise NotImplementedError(
                "paged_prefill=True needs the paged-prefill kernel (K5), "
                "not ported yet (ROADMAP queue 2)"
            )
        if config.fused_mixed_step is True:
            raise NotImplementedError(
                "fused_mixed_step=True needs the ragged prefill kernel "
                "(K6), not ported yet (ROADMAP queue 2)"
            )
        if config.admission != "reserve":
            raise NotImplementedError(
                "optimistic admission and preemption are not ported yet "
                "(ROADMAP queue 1, item 13)"
            )
        if config.cache.num_pages < 2:
            raise ValueError("need at least 2 pages (one is reserved)")
        self.model = model
        self.params = params
        self.config = config
        self.device = model.device
        self._windows = tuple(
            cfg.layer_window(li) for li in range(cfg.num_layers)
        )
        self._window = (
            cfg.sliding_window if cfg.sliding_window_pattern is None
            else None
        )
        # Page num_pages-1 is the trash page for writes that must land
        # nowhere live; the allocator never hands it out.
        self.trash_page = config.cache.num_pages - 1
        self.scheduler = Scheduler(config)
        self.scheduler.allocator = PageAllocator(config.cache.num_pages - 1)
        self.prefix_index = None
        if config.prefix_cache:
            self.prefix_index = PrefixIndex(
                self.scheduler.allocator, config.cache.page_size
            )
            self.scheduler.prefix_index = self.prefix_index
        # +1 ring slot: row max_batch_size is the trash slot.
        mb = config.max_batch_size
        self.cache = PagedKVCache.create(
            cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, config.cache,
            num_slots=mb + 1, device=self.device,
        )
        self.trash_slot = mb
        pps = config.cache.max_pages_per_seq
        dev = self.device
        self.page_tables = torch.zeros((mb, pps), dtype=torch.int32,
                                       device=dev)
        self.lengths = torch.zeros((mb,), dtype=torch.int32, device=dev)
        self.last_tokens = torch.zeros((mb,), dtype=torch.int64, device=dev)
        self.active = np.zeros((mb,), bool)
        self.temps = np.zeros((mb,), np.float32)
        self.top_ks = np.zeros((mb,), np.int32)
        self.top_ps = np.ones((mb,), np.float32)
        self.min_ps = np.zeros((mb,), np.float32)
        self._generator = torch.Generator(device=dev)
        self._generator.manual_seed(seed)
        self.outputs: Dict[int, List[int]] = {}
        self.logprobs: Dict[int, List[float]] = {}
        self._branch_ids: Dict[int, List[int]] = {}
        self.metrics = EngineMetrics()
        self.health_config = config.health or HealthConfig()
        self.health = HealthMonitor(self.health_config)
        self._fetcher = DeadlineFetcher(self.health_config.step_timeout_s)
        self._next_id = 0
        self.max_decode_burst = config.max_decode_burst
        # Speculative decoding is a later slice (its verify path rides the
        # paged-prefill kernel, K5); 0 keeps every step on burst decode.
        self.speculation_k = 0

    # -- client API ----------------------------------------------------------

    def submit(
        self,
        prompt: List[int],
        max_new_tokens: int,
        sampling: SamplingParams = GREEDY,
        stop_tokens: Optional[List[int]] = None,
        n: int = 1,
        priority: int = 0,
    ) -> int:
        """Queue a request; returns its id. Higher ``priority`` admits
        first. ``n > 1`` (parallel completions) is a later slice."""
        if n != 1:
            raise NotImplementedError(
                "n > 1 parallel sampling is not ported yet (ROADMAP queue "
                "1, item 13)"
            )
        ps = self.config.cache.page_size
        total = -(-(len(prompt) + max_new_tokens) // ps)
        if total > self.config.cache.num_pages - 1:
            raise ValueError(
                "request needs more KV pages than the cache has "
                f"({total} > {self.config.cache.num_pages - 1})"
            )
        req_id = self._next_id
        self._next_id += 1
        req = Request(
            req_id=req_id,
            prompt_len=len(prompt),
            max_new_tokens=max_new_tokens,
            sampling=sampling,
            stop_tokens=tuple(stop_tokens or ()),
            priority=priority,
        )
        req._prompt = list(prompt)
        self.scheduler.add_request(req)
        self.outputs[req_id] = []
        self.logprobs[req_id] = []
        self._branch_ids[req_id] = [req_id]
        return req_id

    def branches(self, req_id: int) -> List[int]:
        """All completion ids of a request (itself, in this slice)."""
        return list(self._branch_ids.get(req_id, [req_id]))

    def cancel(self, req_id: int) -> bool:
        """Cancel a request: a waiting one is dropped, an active one stops
        and retires on the next step. Returns True if it was live."""
        sched = self.scheduler
        comp = set(self.branches(req_id))
        hit = False
        for cid in comp:
            req = sched.active.get(cid)
            if req is not None:
                req.stopped = True
                slot = req.batch_slot
                if slot is not None and sched.slots[slot] == cid:
                    self.active[slot] = False
                hit = True
        kept = [r for r in sched.waiting if r.req_id not in comp]
        if len(kept) != len(sched.waiting):
            sched.waiting.clear()
            sched.waiting.extend(kept)
            hit = True
        return hit

    def run(self) -> Dict[int, List[int]]:
        """Drive the engine until all requests finish."""
        while self.scheduler.has_work():
            self.step()
        return self.outputs

    def close(self) -> None:
        self._fetcher.close()

    # -- engine step -----------------------------------------------------------

    def step(self) -> None:
        if self.speculation_k:
            raise NotImplementedError(
                "speculative decoding (speculation_k > 0) needs the verify "
                "path on the paged-prefill kernel (K5), not ported yet "
                "(ROADMAP queue 1, item 13)"
            )
        self.scheduler.max_step_tokens = self.max_decode_burst
        plan = self.scheduler.step()
        t0 = time.perf_counter()
        n_decoded = 0
        with StepTimer(self.health):
            groups: Dict[int, list] = {}
            for chunk in plan.prefill:
                groups.setdefault(chunk.start, []).append(chunk)
            for group in groups.values():
                self._run_prefill_group(group)
            if plan.decode_slots:
                n_decoded = self._run_decode(plan.decode_slots)
        self.metrics.record_step(
            prefill_tokens=sum(c.length for c in plan.prefill),
            decode_tokens=n_decoded,
            step_seconds=time.perf_counter() - t0,
            batch_occupancy=self.scheduler.num_active()
            / self.config.max_batch_size,
        )

    # -- prefill ---------------------------------------------------------------

    def _gather_history(self, layer: int, table_rows: torch.Tensor,
                        hist_len: int, start_page: int = 0):
        """Dense K/V [B, hkv, hist_len, d] (dequantized to the model
        dtype) of the cached tokens [start_page * ps, start_page * ps +
        hist_len) of a batch of sequences -- the bytes decode would read.
        """
        cache = self.cache
        ps = self.config.cache.page_size
        n_pages = -(-hist_len // ps)
        pages = table_rows[:, start_page:start_page + n_pages].long()
        dtype = self.model.dtype

        def gather(pages_arr, scales_arr):
            vals = pages_arr[layer][:, pages]  # [hkv, B, np, ps, d]
            if cache.quantized:
                scales = scales_arr[layer][:, pages]  # [hkv, B, np, ps]
                dense = dequantize(
                    QuantizedTensor(vals, scales[..., None], cache.kv_dtype),
                    dtype,
                )
            else:
                dense = vals.to(dtype)
            hkv, b, np_, ps_, d = dense.shape
            dense = dense.reshape(hkv, b, np_ * ps_, d)[:, :, :hist_len]
            return dense.transpose(0, 1)

        return (gather(cache.k_pages, cache.k_scales),
                gather(cache.v_pages, cache.v_scales))

    def _chunked_prefill_impl(self, hist_len: int, tokens, table_rows,
                              n_valids, slots):
        """One batch of same-stage chunks: tokens [B, bucket] at positions
        [hist_len, hist_len + bucket) of their sequences. Each row attends
        its gathered history plus itself (q_offset = kept history); the
        first n_valids[b] tokens' K/V append to the row's pages (pads to
        the trash page). Returns (last-valid-position logits [B, vocab],
        finite flag)."""
        ps = self.config.cache.page_size
        pps = self.config.cache.max_pages_per_seq
        b, bucket = tokens.shape
        dev = self.device
        rel = torch.arange(bucket, device=dev)
        positions = hist_len + rel
        valid = rel[None, :] < n_valids[:, None]
        # Pad positions may run past the table; their page is the trash.
        page_ids = torch.where(
            valid,
            table_rows[:, (positions // ps).clamp(max=pps - 1)],
            torch.full_like(table_rows[:, :1], self.trash_page),
        )
        offsets = (positions % ps).expand(b, bucket)
        # Sliding window: drop whole leading pages no row can attend.
        drop_pages = 0
        if self._window is not None and hist_len > 0:
            drop_pages = max(0, hist_len - self._window + 1) // ps
        hist_keep = hist_len - drop_pages * ps
        ring = self.cache.k_recent is not None
        tok_slots = (
            torch.where(valid, slots[:, None],
                        torch.full_like(slots[:, None], self.trash_slot))
            .reshape(-1) if ring else None
        )
        tok_pos = positions.expand(b, bucket).reshape(-1)

        def kv_hook(li, k, v):
            if hist_len:
                hk, hv = self._gather_history(
                    li, table_rows, hist_keep, start_page=drop_pages
                )
                k_all = torch.cat([hk, k.to(hk.dtype)], dim=2)
                v_all = torch.cat([hv, v.to(hv.dtype)], dim=2)
            else:
                k_all, v_all = k, v
            hkv, d = k.shape[1], k.shape[3]
            self.cache.append(
                li,
                k.transpose(1, 2).reshape(b * bucket, hkv, d),
                v.transpose(1, 2).reshape(b * bucket, hkv, d),
                page_ids.reshape(-1), offsets.reshape(-1),
                slots=tok_slots, positions=tok_pos,
            )
            return k_all, v_all

        logits = self.model.forward(
            self.params, tokens, q_offset=hist_keep, kv_hook=kv_hook,
            positions=positions,
        )
        last = logits[torch.arange(b, device=dev), n_valids.long() - 1]
        return last, torch.isfinite(logits).all()

    def _run_prefill_group(self, chunks) -> None:
        """Prefill same-stage chunks (equal start) as one batch."""
        start = chunks[0].start
        bucket = _pow2_bucket(max(max(c.length for c in chunks), 8))
        bb = _pow2_bucket(len(chunks), lo=1)
        pps = self.config.cache.max_pages_per_seq
        tok_rows, table_rs, n_valids, tables, slot_rows = [], [], [], [], []
        for c in chunks:
            req = self.scheduler.active[c.req_id]
            toks = req._prompt[c.start:c.start + c.length]
            tok_rows.append(toks + [0] * (bucket - c.length))
            table = self.scheduler.page_table(c.req_id)
            tables.append(table)
            table_rs.append(table + [self.trash_page] * (pps - len(table)))
            n_valids.append(c.length)
            slot_rows.append(
                req.batch_slot if req.batch_slot >= 0 else self.trash_slot
            )
        for _ in range(bb - len(chunks)):
            # Pad rows write only the trash page; 1 valid token keeps the
            # last-logits index in range.
            tok_rows.append([0] * bucket)
            table_rs.append([self.trash_page] * pps)
            n_valids.append(1)
            slot_rows.append(self.trash_slot)

        def dev_tensor(rows, dtype):
            return torch.tensor(rows, dtype=dtype).to(self.device)

        table_t = dev_tensor(table_rs, torch.int32)
        last_logits, finite = self._chunked_prefill_impl(
            start,
            dev_tensor(tok_rows, torch.int64),
            table_t,
            dev_tensor(n_valids, torch.int64),
            dev_tensor(slot_rows, torch.int64),
        )
        if self.health_config.check_numerics:
            watchdog_check(
                self.health, self._fetcher.fetch(finite),
                phase="prefill", request_ids=[c.req_id for c in chunks],
            )
        for i, c in enumerate(chunks):
            self._finish_prefill_chunk(
                self.scheduler.active[c.req_id], c, table_t[i], tables[i],
                last_logits[i],
            )

    def _sample(self, logits, temps, top_ks, top_ps, min_ps):
        """[rows] tokens from [rows, vocab] logits with host parameter
        arrays; all-greedy batches skip the filters."""
        if bool((temps <= 0.0).all()):
            return logits.argmax(dim=-1)
        dev = logits.device
        return sample_tokens(
            logits, self._generator,
            torch.as_tensor(temps, device=dev),
            torch.as_tensor(top_ks, device=dev),
            torch.as_tensor(top_ps, device=dev),
            torch.as_tensor(min_ps, device=dev),
        )

    def _finish_prefill_chunk(self, req: Request, chunk, table_row, table,
                              last_logits) -> None:
        """Host-side bookkeeping after a prefill chunk."""
        slot = req.batch_slot
        new_len = chunk.start + chunk.length
        self.page_tables[slot] = table_row
        self.lengths[slot] = new_len
        sp = req.sampling
        self.temps[slot] = sp.temperature
        self.top_ks[slot] = sp.top_k
        self.top_ps[slot] = sp.top_p
        self.min_ps[slot] = sp.min_p
        # Index the prompt's full pages written so far for prefix reuse.
        if self.prefix_index is not None:
            self.prefix_index.register(req._prompt[:new_len], table)
        if new_len < req.prompt_len:
            return
        # Final chunk: its last-position logits emit the first token.
        tok = self._sample(
            last_logits[None],
            np.array([sp.temperature], np.float32),
            np.array([sp.top_k], np.int32),
            np.array([sp.top_p], np.float32),
            np.array([sp.min_p], np.float32),
        )[0]
        logp = torch.log_softmax(last_logits, dim=-1)[tok]
        tok_host, logp_host = self._fetcher.fetch(
            torch.stack([tok.double(), logp.double()])
        )
        next_token = int(tok_host)
        self.last_tokens[slot] = tok
        self.active[slot] = True
        self.outputs[req.req_id].append(next_token)
        self.logprobs[req.req_id].append(float(logp_host))
        self.scheduler.report_decoded(req.req_id)
        if next_token in req.stop_tokens:
            req.stopped = True
            self.active[slot] = False

    # -- decode ----------------------------------------------------------------

    def _decode_step_impl(self, tokens, lengths, active_mask, temps,
                          top_ks, top_ps, min_ps):
        """One decode token for every batch slot (inactive slots write the
        trash page; their outputs are ignored). Returns (next_tokens,
        new_lengths, finite, logps)."""
        model = self.model
        cfg = model.config
        params = self.params
        cache = self.cache
        ps = self.config.cache.page_size
        pps = self.config.cache.max_pages_per_seq
        positions = lengths.long()
        x = params["embed"][tokens].to(model.dtype)  # [mb, hidden]
        page_ids = torch.where(
            active_mask,
            self.page_tables.gather(
                1, (positions // ps).clamp(max=pps - 1)[:, None]
            )[:, 0],
            torch.full_like(positions, self.trash_page).to(torch.int32),
        )
        offsets = positions % ps
        attn_lengths = torch.where(
            active_mask, lengths + 1, torch.ones_like(lengths)
        ).clamp(min=1)
        mb = tokens.shape[0]
        ring = cache.k_recent is not None
        slot_ids = torch.arange(mb, device=self.device)
        for li, layer in enumerate(params["layers"]):
            xn = _rms_norm(x, layer["attn_norm"], cfg.rms_eps)
            q, k_new, v_new = model.decode_qkv(params, li, xn, positions)
            cache.append(li, k_new, v_new, page_ids, offsets,
                         slots=slot_ids if ring else None,
                         positions=positions)
            k_view, v_view = cache.layer_view(li)
            # Exact recent ring (quantized caches): pages for
            # [0, max(L - W, 1)), the ring for the rest, one kernel call.
            use_tail = ring and self._windows[li] is None
            attn = paged_attention(
                q, k_view, v_view, attn_lengths, self.page_tables,
                window=None if use_tail else self._windows[li],
                softcap=cfg.attn_softcap, sinks=layer.get("sinks"),
                alibi=model.alibi_for(),
                recent_k=cache.k_recent[li, :mb] if use_tail else None,
                recent_v=cache.v_recent[li, :mb] if use_tail else None,
            )
            x = x + attn.reshape(mb, -1) @ layer["wo"]
            xn = _rms_norm(x, layer["mlp_norm"], cfg.rms_eps)
            x = x + model._mlp(layer, xn)
        x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
        logits = (x @ params["lm_head"]).float()
        sampled = self._sample(logits, temps, top_ks, top_ps, min_ps)
        # Inactive slots keep their token: it is the slot's state.
        next_tokens = torch.where(active_mask, sampled, tokens)
        logps = torch.log_softmax(logits, dim=-1).gather(
            1, next_tokens[:, None]
        )[:, 0]
        new_lengths = torch.where(active_mask, lengths + 1, lengths)
        finite = torch.where(
            active_mask[:, None], torch.isfinite(logits),
            torch.ones_like(logits, dtype=torch.bool),
        ).all()
        return next_tokens, new_lengths, finite, logps

    def _decode_multi_impl(self, n_steps: int, active_mask):
        """``n_steps`` decode steps back to back, with no host sync
        between them. Returns (tokens [n, mb], finite, logps [n, mb])."""
        toks, flags, logps = [], [], []
        for _ in range(n_steps):
            (self.last_tokens, self.lengths, finite, lp) = (
                self._decode_step_impl(
                    self.last_tokens, self.lengths, active_mask,
                    self.temps, self.top_ks, self.top_ps, self.min_ps,
                )
            )
            toks.append(self.last_tokens)
            flags.append(finite)
            logps.append(lp)
        return torch.stack(toks), torch.stack(flags).all(), torch.stack(logps)

    def _run_decode(self, decode_slots: List[int]) -> int:
        mask = np.zeros((self.config.max_batch_size,), bool)
        for s in decode_slots:
            mask[s] = True
        mask &= self.active
        active_mask = torch.from_numpy(mask).to(self.device)
        rids = [
            self.scheduler.slots[s]
            for s in decode_slots
            if mask[s] and self.scheduler.slots[s] is not None
        ]
        # Burst size: as many steps as every active request can still
        # take, capped; single steps while work is waiting (admission).
        remaining = [
            self.scheduler.active[r].max_new_tokens
            - self.scheduler.active[r].generated
            for r in rids
            if r in self.scheduler.active
        ]
        n_steps = max(1, min(remaining + [self.max_decode_burst]))
        if self.scheduler.waiting:
            n_steps = 1
        all_tokens, finite, all_logps = self._decode_multi_impl(
            n_steps, active_mask
        )
        # One host fetch per burst: tokens and log-probs (both exact in
        # float64), then the finite flag as a last row.
        host = self._fetcher.fetch(
            torch.cat([all_tokens.double(), all_logps.double(),
                       finite.double().expand(1, all_tokens.shape[1])]),
            scale=n_steps,
        )
        tokens_host = host[:n_steps].astype(np.int64)
        logps_host = host[n_steps:2 * n_steps]
        if self.health_config.check_numerics:
            watchdog_check(self.health, host[-1, 0], phase="decode",
                           request_ids=rids)
        n = 0
        for s in decode_slots:
            if not mask[s]:
                continue
            rid = self.scheduler.slots[s]
            if rid is None:
                continue
            req = self.scheduler.active.get(rid)
            stops = req.stop_tokens if req is not None else ()
            taken = 0
            for i in range(n_steps):
                tok = int(tokens_host[i, s])
                self.outputs[rid].append(tok)
                self.logprobs[rid].append(float(logps_host[i, s]))
                taken += 1
                if tok in stops:
                    # Stop token included, then generation ends; the
                    # burst's later tokens for this slot are discarded.
                    if req is not None:
                        req.stopped = True
                    break
            self.scheduler.report_decoded(rid, taken)
            if req is not None and req.done:
                self.active[s] = False
            n += taken
        return n
