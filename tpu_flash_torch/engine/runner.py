"""Inference engine: continuous batching over the paged KV cache.

The port of ``tpu_flash/engine/runner.py``: ``submit`` -> ``step``/``run``
-> prefill dispatches -> the model forward -> ``PagedKVCache.append`` ->
burst decode (``paged_attention``) or speculative verify -> sampling.
``step`` routes as the JAX engine does:

  * same-stage chunks (equal start) run as one batch: tokens pad to a
    power-of-two bucket, rows to a power-of-two count (pad rows write only
    the trash page and trash slot). A chunk whose history is page-aligned
    attends it straight from the pages (``paged_prefill_attention``, with
    ``paged_prefill`` "auto"/True); otherwise the history is gathered
    dense and dequantized and the chunk runs ``flash_attention`` with
    ``q_offset``. The final chunk's last-position logits give the first
    token.
  * chunks at different stages go to one ragged dispatch: every row's
    history bound padded to one ``hist_cap``, per-row offsets, attention
    over the pages (paged) or over gathered ``[history | chunk]`` buffers
    (``flash_attention_ragged``). With ``fused_mixed_step`` the step's
    decode slots ride along as length-1 rows at their KV position and
    sample from the same dispatch.
  * decode: with ``speculation_k`` > 0 and nothing waiting, every active
    slot proposes a prompt-lookup draft and all drafts are verified in one
    batched forward (paged prefill over the pages, or an f32 einsum over
    the gathered table with ``paged_prefill=False``), then exact rejection
    sampling; otherwise bursts of up to ``max_decode_burst`` single-token
    steps over every batch slot, one host fetch per burst.

n>1 forks, preemption/swap, draft-model speculation, LoRA and logit_bias
are later slices.

The engine runs on ``model.device`` ("cuda" unless the model was built
for "cpu"); it mutates its cache and slot tensors in place.
"""

from __future__ import annotations

import dataclasses
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
    speculative_sample,
)
from tpu_flash_torch.engine.scheduler import Request, Scheduler
from tpu_flash_torch.models.transformer import FlashTransformer, _rms_norm
from tpu_flash_torch.ops.decode import paged_attention
from tpu_flash_torch.ops.flash import (
    flash_attention_ragged,
    paged_prefill_attention,
)
from tpu_flash_torch.ops.quant import QuantizedTensor, dequantize
from tpu_flash_torch.utils.tuning import resolve_cache_config


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
        # Auto (None) cache-layout fields resolve from the serving regime
        # (kv_dtype, context, batch) by the JAX engine's policy.
        if not config.cache.resolved:
            config = dataclasses.replace(config, cache=resolve_cache_config(
                config.cache, max_seq_len=config.max_seq_len,
                max_batch_size=config.max_batch_size,
            ))
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
        # Speculative decoding by prompt lookup (0 disables): all active
        # decode slots verify their drafts in ONE batched forward (slots
        # without a draft ride along as a plain 1-token sample); the
        # accepted prefix plus one correction/bonus token commit per slot.
        self.speculation_k = 8
        # Verify without paging gathers each row's whole page table dense;
        # cap the TOTAL (row bucket x table) tokens it is worth that for,
        # beyond it burst decode.
        self.speculation_max_table_tokens = 32768
        self._spec_proposed = 0
        self._spec_accepted = 0

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

    @torch.inference_mode()
    def step(self) -> None:
        # Serving never builds autograd graphs, even when the params are
        # leaves that require grad (a trainer's dict shared with the
        # engine). Most tokens one plan can commit per slot: a decode burst
        # or a fully accepted draft plus its bonus token.
        self.scheduler.max_step_tokens = max(
            self.max_decode_burst, self.speculation_k + 1
        )
        plan = self.scheduler.step()
        t0 = time.perf_counter()
        n_decoded = 0
        n_prefill = sum(c.length for c in plan.prefill)
        with StepTimer(self.health):
            groups: Dict[int, list] = {}
            for chunk in plan.prefill:
                groups.setdefault(chunk.start, []).append(chunk)
            fuse = self.config.fused_mixed_step
            decode_live = [
                s for s in plan.decode_slots
                if self.active[s] and self.scheduler.slots[s] is not None
            ]
            if fuse == "auto":
                fuse = 0 < len(decode_live) <= len(plan.prefill)
            record = self.metrics.record_dispatch
            if fuse and plan.prefill and decode_live:
                # One dispatch for the whole step: decode slots ride the
                # ragged prefill as length-1 rows.
                n_decoded, secs = self._timed(
                    self._run_prefill_ragged, plan.prefill,
                    decode_slots=decode_live,
                )
                record("fused", secs, n_prefill)
            else:
                if len(groups) > 1:
                    # Mixed stages: one ragged dispatch for every chunk.
                    _, secs = self._timed(self._run_prefill_ragged,
                                          plan.prefill)
                    record("prefill_ragged", secs, n_prefill)
                else:
                    for group in groups.values():
                        _, secs = self._timed(self._run_prefill_group, group)
                        record("prefill_group", secs,
                               sum(c.length for c in group))
                if plan.decode_slots:
                    (route, n_decoded), secs = self._timed(
                        self._run_decode, plan.decode_slots
                    )
                    record(route, secs, n_decoded)
        self.metrics.record_step(
            prefill_tokens=n_prefill,
            decode_tokens=n_decoded,
            step_seconds=time.perf_counter() - t0,
            batch_occupancy=self.scheduler.num_active()
            / self.config.max_batch_size,
        )

    def _timed(self, fn, *args, **kw):
        """(fn(*args, **kw), its seconds): between device synchronisations
        when ``metrics.sync_dispatches`` is set."""
        sync = self.metrics.sync_dispatches and self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        out = fn(*args, **kw)
        if sync:
            torch.cuda.synchronize(self.device)
        return out, time.perf_counter() - t

    # -- prefill ---------------------------------------------------------------

    def _paged_enabled(self) -> bool:
        """Resolve ``config.paged_prefill`` ("auto" | True | False) for a
        dispatch site: "auto" is True. The int4g32 and k8v4 tiers always
        gather (the JAX paged-prefill kernel has no per-group or mixed
        dequant), whatever the setting."""
        if self.config.cache.kv_dtype in ("int4g32", "k8v4"):
            return False
        mode = self.config.paged_prefill
        return True if mode == "auto" else bool(mode)

    def _attention_opts(self, li: int) -> dict:
        """Layer ``li``'s attention options (window, softcap, sinks,
        ALiBi) for the paged and ragged prefill calls."""
        return dict(
            window=self._windows[li],
            softcap=self.model.config.attn_softcap,
            sinks=self.params["layers"][li].get("sinks"),
            alibi=self.model.alibi_for(),
        )

    def _gather_history(self, layer: int, table_rows: torch.Tensor,
                        hist_len: int, start_page: int = 0):
        """Dense K/V [B, hkv, hist_len, d] (dequantized to the model
        dtype) of the cached tokens [start_page * ps, start_page * ps +
        hist_len) of a batch of sequences -- the bytes decode would read.
        """
        ps = self.config.cache.page_size
        n_pages = -(-hist_len // ps)
        pages = table_rows[:, start_page:start_page + n_pages].long()
        dtype = self.model.dtype

        def gather(side):
            # The layer's pages of each row, [hkv, B, np, rows, d], with
            # their scales; per side, as k8v4 mixes tiers.
            if isinstance(side, QuantizedTensor):
                dense = dequantize(side._replace(
                    values=side.values[:, pages],
                    scales=side.scales[:, pages]), dtype)
            else:
                dense = side[:, pages].to(dtype)
            hkv, b, np_, ps_, d = dense.shape
            dense = dense.reshape(hkv, b, np_ * ps_, d)[:, :, :hist_len]
            return dense.transpose(0, 1)

        k, v = self.cache.layer_view(layer)
        return gather(k), gather(v)

    def _chunked_prefill_impl(self, hist_len: int, tokens, table_rows,
                              n_valids, slots):
        """One batch of same-stage chunks: tokens [B, bucket] at positions
        [hist_len, hist_len + bucket) of their sequences. Each row attends
        its history plus itself: straight from the pages when paging is on
        and the history is page-aligned, else gathered dense (q_offset =
        kept history). The first n_valids[b] tokens' K/V append to the
        row's pages (pads to the trash page). Returns (last-valid-position
        logits [B, vocab], finite flag)."""
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
        # Paged history (each page read once in the kernel) when the stage
        # is page-aligned; otherwise gather-to-dense.
        use_paged = (
            self._paged_enabled() and hist_len > 0 and hist_len % ps == 0
        )
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
        li_cell = [0]

        def kv_hook(li, k, v):
            if hist_len and not use_paged:
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
            li_cell[0] = li
            return k_all, v_all

        attention_fn = None
        if use_paged:
            starts_b = torch.full((b,), hist_len, dtype=torch.int32,
                                  device=dev)

            def attention_fn(q, k, v):
                # k/v are the chunk's own (already appended to the pages;
                # history stays paged below hist_len).
                li = li_cell[0]
                kp, vp = self.cache.layer_view(li)
                return paged_prefill_attention(
                    q, k, v, kp, vp, starts_b, table_rows,
                    hist_cap=hist_len, **self._attention_opts(li),
                )

        logits = self.model.forward(
            self.params, tokens, q_offset=hist_keep, kv_hook=kv_hook,
            positions=positions, attention_fn=attention_fn,
        )
        last = logits[torch.arange(b, device=dev), n_valids.long() - 1]
        return last, torch.isfinite(logits).all()

    def _chunk_rows(self, chunks, bucket: int):
        """Per prefill chunk: its tokens padded to ``bucket``, its page
        table padded with the trash page, the table itself, its valid
        length and its batch slot."""
        pps = self.config.cache.max_pages_per_seq
        rows = dict(tokens=[], table_rows=[], tables=[], n_valids=[],
                    slots=[])
        for c in chunks:
            req = self.scheduler.active[c.req_id]
            toks = req._prompt[c.start:c.start + c.length]
            table = self.scheduler.page_table(c.req_id)
            rows["tokens"].append(toks + [0] * (bucket - c.length))
            rows["table_rows"].append(
                table + [self.trash_page] * (pps - len(table)))
            rows["tables"].append(table)
            rows["n_valids"].append(c.length)
            rows["slots"].append(
                req.batch_slot if req.batch_slot >= 0 else self.trash_slot
            )
        return rows

    def _pad_rows(self, rows, n: int, bucket: int) -> None:
        """Append ``n`` pad rows: they write only the trash page and trash
        slot; 1 valid token keeps the last-logits index in range."""
        pps = self.config.cache.max_pages_per_seq
        for _ in range(n):
            rows["tokens"].append([0] * bucket)
            rows["table_rows"].append([self.trash_page] * pps)
            rows["n_valids"].append(1)
            rows["slots"].append(self.trash_slot)

    def _dev_tensor(self, rows, dtype):
        return torch.tensor(rows, dtype=dtype).to(self.device)

    def _run_prefill_group(self, chunks) -> None:
        """Prefill same-stage chunks (equal start) as one batch."""
        bucket = _pow2_bucket(max(max(c.length for c in chunks), 8))
        rows = self._chunk_rows(chunks, bucket)
        self._pad_rows(rows, _pow2_bucket(len(chunks), lo=1) - len(chunks),
                       bucket)
        table_t = self._dev_tensor(rows["table_rows"], torch.int32)
        last_logits, finite = self._chunked_prefill_impl(
            chunks[0].start,
            self._dev_tensor(rows["tokens"], torch.int64),
            table_t,
            self._dev_tensor(rows["n_valids"], torch.int64),
            self._dev_tensor(rows["slots"], torch.int64),
        )
        if self.health_config.check_numerics:
            watchdog_check(
                self.health, self._fetcher.fetch(finite),
                phase="prefill", request_ids=[c.req_id for c in chunks],
            )
        for i, c in enumerate(chunks):
            self._finish_prefill_chunk(
                self.scheduler.active[c.req_id], c, table_t[i],
                rows["tables"][i], last_logits[i],
            )

    def _ragged_prefill_impl(self, hist_cap: int, tokens, table_rows,
                             starts, n_valids, slots):
        """A batch of chunks at different stages in one dispatch: row b's
        tokens sit at positions [starts[b], starts[b] + n_valids[b]) of
        its own sequence. Attention runs over the pages with per-row
        offsets (paged, when hist_cap is page-aligned) or over each row's
        history gathered to hist_cap plus the chunk
        (``flash_attention_ragged``); the chunk's K/V append to the row's
        pages. Returns (last-valid-position logits [B, vocab], finite)."""
        ps = self.config.cache.page_size
        pps = self.config.cache.max_pages_per_seq
        b, bucket = tokens.shape
        dev = self.device
        rel = torch.arange(bucket, device=dev)
        positions = starts[:, None] + rel[None, :]  # [B, bucket]
        valid = rel[None, :] < n_valids[:, None]
        page_ids = torch.where(
            valid,
            table_rows.gather(1, (positions // ps).clamp(max=pps - 1)),
            torch.full_like(table_rows[:, :1], self.trash_page),
        )
        offsets = positions % ps
        use_paged = self._paged_enabled() and hist_cap % ps == 0
        ring = self.cache.k_recent is not None
        tok_slots = (
            torch.where(valid, slots[:, None],
                        torch.full_like(slots[:, None], self.trash_slot))
            .reshape(-1) if ring else None
        )
        tok_pos = positions.reshape(-1)
        li_cell = [0]

        def kv_hook(li, k, v):
            if use_paged:
                k_all, v_all = k, v  # history stays paged
            else:
                hk, hv = self._gather_history(li, table_rows, hist_cap)
                k_all = torch.cat([hk, k.to(hk.dtype)], dim=2)
                v_all = torch.cat([hv, v.to(hv.dtype)], dim=2)
            hkv, d = k.shape[1], k.shape[3]
            self.cache.append(
                li,
                k.transpose(1, 2).reshape(b * bucket, hkv, d),
                v.transpose(1, 2).reshape(b * bucket, hkv, d),
                page_ids.reshape(-1), offsets.reshape(-1),
                slots=tok_slots, positions=tok_pos,
            )
            li_cell[0] = li
            return k_all, v_all

        def attention_fn(q, k, v):
            li = li_cell[0]
            if use_paged:
                # Per-row offsets bound each row's history read; chunk K/V
                # just appended at or past a row's offset stay masked.
                kp, vp = self.cache.layer_view(li)
                return paged_prefill_attention(
                    q, k, v, kp, vp, starts, table_rows, hist_cap=hist_cap,
                    **self._attention_opts(li),
                )
            return flash_attention_ragged(
                q, k, v, starts, hist_cap=hist_cap,
                **self._attention_opts(li),
            )

        logits = self.model.forward(
            self.params, tokens, kv_hook=kv_hook, positions=positions,
            attention_fn=attention_fn,
        )
        last = logits[torch.arange(b, device=dev), n_valids.long() - 1]
        return last, torch.isfinite(logits).all()

    def _run_prefill_ragged(self, chunks, decode_slots=()) -> int:
        """Prefill chunks at mixed stages in one dispatch; histories pad to
        the power-of-two bucket of the deepest stage. ``decode_slots``
        (fused mixed steps) also fold the step's decode work into it: each
        decoding slot rides as a length-1 row feeding its pending token at
        its KV position ``prefilled + generated - 1``, and its next token
        samples from the row's last logits. Returns the number of decode
        tokens committed."""
        ditems = []
        for s in decode_slots:
            rid = self.scheduler.slots[s]
            req = self.scheduler.active.get(rid)
            if req is None or not self.active[s]:
                continue
            # KV is written for all but the newest emitted token.
            ditems.append((req, s, req.prefilled + req.generated - 1))
        bucket = _pow2_bucket(max(max(c.length for c in chunks), 8))
        bb = _pow2_bucket(len(chunks) + len(ditems), lo=1)
        pps = self.config.cache.max_pages_per_seq
        ps = self.config.cache.page_size
        max_start = max([c.start for c in chunks] + [f for _, _, f in ditems])
        hist_cap = min(
            _pow2_bucket(max_start, lo=max(self.config.prefill_chunk, 8)),
            pps * ps,
        )
        rows = self._chunk_rows(chunks, bucket)
        starts = [c.start for c in chunks]
        for req, s, feed in ditems:
            table = self.scheduler.page_table(req.req_id)
            rows["tokens"].append(
                [self.outputs[req.req_id][-1]] + [0] * (bucket - 1))
            rows["table_rows"].append(
                table + [self.trash_page] * (pps - len(table)))
            rows["n_valids"].append(1)
            rows["slots"].append(s)
            starts.append(feed)
        n_pad = bb - len(chunks) - len(ditems)
        self._pad_rows(rows, n_pad, bucket)
        starts += [0] * n_pad
        table_t = self._dev_tensor(rows["table_rows"], torch.int32)
        last_logits, finite = self._ragged_prefill_impl(
            hist_cap,
            self._dev_tensor(rows["tokens"], torch.int64),
            table_t,
            self._dev_tensor(starts, torch.int64),
            self._dev_tensor(rows["n_valids"], torch.int64),
            self._dev_tensor(rows["slots"], torch.int64),
        )
        if self.health_config.check_numerics:
            watchdog_check(
                self.health, self._fetcher.fetch(finite),
                phase="prefill",
                request_ids=[c.req_id for c in chunks]
                + [it[0].req_id for it in ditems],
            )
        for i, c in enumerate(chunks):
            self._finish_prefill_chunk(
                self.scheduler.active[c.req_id], c, table_t[i],
                rows["tables"][i], last_logits[i],
            )
        if not ditems:
            return 0
        # The fused decode rows: one batched sample with per-row
        # parameters, then the decode step's per-slot bookkeeping.
        dlog = last_logits[len(chunks):len(chunks) + len(ditems)]
        sps = [it[0].sampling for it in ditems]
        toks = self._sample(
            dlog,
            np.array([sp.temperature for sp in sps], np.float32),
            np.array([sp.top_k for sp in sps], np.int32),
            np.array([sp.top_p for sp in sps], np.float32),
            np.array([sp.min_p for sp in sps], np.float32),
        )
        logps = torch.log_softmax(dlog, dim=-1).gather(1, toks[:, None])[:, 0]
        host = self._fetcher.fetch(torch.stack([toks.double(),
                                                logps.double()]))
        for i, (req, s, feed) in enumerate(ditems):
            tok = int(host[0, i])
            self.outputs[req.req_id].append(tok)
            self.logprobs[req.req_id].append(float(host[1, i]))
            self.last_tokens[s] = tok
            self.lengths[s] = feed + 1
            self.scheduler.report_decoded(req.req_id)
            if tok in req.stop_tokens:
                req.stopped = True
            if req.done:
                self.active[s] = False
        return len(ditems)

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

    # -- speculative decoding ----------------------------------------------------

    @staticmethod
    def _find_draft(context: List[int], k: int, ngram: int = 2) -> List[int]:
        """Prompt-lookup drafting: find the latest earlier occurrence of the
        context's final n-gram and propose the tokens that followed it."""
        if len(context) < ngram + 1 or k < 1:
            return []
        key = tuple(context[-ngram:])
        for i in range(len(context) - ngram - 1, -1, -1):
            if tuple(context[i:i + ngram]) == key:
                return list(context[i + ngram:i + ngram + k])
        return []

    def _propose_drafts(self, contexts: List[List[int]],
                        k: int) -> List[List[int]]:
        """Up to k draft tokens per context by prompt lookup (draft-model
        proposals are a later slice)."""
        return [self._find_draft(c, k) for c in contexts]

    def _verify_dense_attention(self, q, k, v, positions, li: int):
        """Verify attention without paging: exact f32 attention of the
        draft rows q [B, hq, n_tok, d] over each row's whole gathered table
        k/v [B, hkv, hist_full, d], masked per row by position (the JAX
        engine's einsum route, outside any kernel)."""
        cfg = self.model.config
        rep = q.shape[1] // k.shape[1]
        kf = k.float().repeat_interleave(rep, dim=1)
        vf = v.float().repeat_interleave(rep, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (
            cfg.head_dim ** -0.5
        )
        softcap = cfg.attn_softcap
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        key_pos = torch.arange(k.shape[2], device=q.device)[None, None, None]
        q_pos = positions[:, None, :, None]
        allow = key_pos <= q_pos
        win = self._windows[li]
        if win is not None:
            allow = allow & (key_pos > q_pos - win)
        alibi = self.model.alibi_for()
        if alibi is not None:
            s = s + alibi.float()[None, :, None, None] * (
                key_pos - q_pos
            ).float()
        s = torch.where(allow, s, torch.full_like(s, -1e30))
        sinks = self.params["layers"][li].get("sinks")
        if sinks is not None:
            sink_col = sinks.float()[None, :, None, None].expand(
                *s.shape[:3], 1
            )
            w = torch.softmax(torch.cat([s, sink_col], dim=-1), dim=-1)
            w = w[..., :-1]
        else:
            w = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", w, vf).to(q.dtype)

    def _verify_impl(self, n_tok: int, tokens, lengths_b, table_rows, temps,
                     top_ks, top_ps, draft_lens, min_ps, slots):
        """Verify a batch of [last_token, draft...] rows [B, n_tok] in one
        forward at per-row offsets ``lengths_b``, then exact rejection
        sampling per row. Every row's n_tok tokens' K/V append to the
        pages (rejected entries are masked by lengths and overwritten when
        their positions are reached); the exact ring takes only the
        accepted rows, after the sampler (the rest go to the trash slot).
        Returns (emit [B, n_tok], n_emit [B], finite, logps [B, n_tok])."""
        ps = self.config.cache.page_size
        pps = self.config.cache.max_pages_per_seq
        hist_full = pps * ps
        b = tokens.shape[0]
        dev = self.device
        positions = lengths_b[:, None].long() + torch.arange(
            n_tok, device=dev
        )[None]
        # Positions past the reserved pages land on the trash page (the
        # table padding), and past the table nowhere live.
        page_idx = positions // ps
        page_ids = torch.where(
            page_idx < pps,
            table_rows.gather(1, page_idx.clamp(max=pps - 1)),
            torch.full_like(table_rows[:, :1], self.trash_page),
        )
        offsets = positions % ps
        use_paged = self._paged_enabled()
        kv_stash = {}
        li_cell = [0]

        def kv_hook(li, k, v):
            hkv, d = k.shape[1], k.shape[3]
            kn = k.transpose(1, 2).reshape(b * n_tok, hkv, d)
            vn = v.transpose(1, 2).reshape(b * n_tok, hkv, d)
            self.cache.append(li, kn, vn, page_ids.reshape(-1),
                              offsets.reshape(-1))
            if self.cache.k_recent is not None:
                kv_stash[li] = (kn, vn)
            li_cell[0] = li
            if use_paged:
                return k, v  # history stays paged
            return self._gather_history(li, table_rows, hist_full)

        def attention_fn(q, k, v):
            li = li_cell[0]
            if use_paged:
                kp, vp = self.cache.layer_view(li)
                return paged_prefill_attention(
                    q, k, v, kp, vp, lengths_b, table_rows,
                    hist_cap=hist_full, **self._attention_opts(li),
                )
            return self._verify_dense_attention(q, k, v, positions, li)

        logits = self.model.forward(
            self.params, tokens, kv_hook=kv_hook, positions=positions,
            attention_fn=attention_fn,
        )  # [B, n_tok, vocab]
        emit, n_emit = speculative_sample(
            logits, tokens[:, 1:], self._generator, temps, top_ks, top_ps,
            draft_lens, min_p=min_ps,
        )
        # Reported log-probs are the raw model distribution's.
        logps = torch.log_softmax(logits, dim=-1).gather(
            -1, emit[..., None]
        )[..., 0]
        finite = torch.isfinite(logits).all()
        if kv_stash:
            accept = torch.arange(n_tok, device=dev)[None] < n_emit[:, None]
            wslots = torch.where(
                accept, slots[:, None],
                torch.full_like(slots[:, None], self.trash_slot),
            ).reshape(-1)
            for li, (kn, vn) in kv_stash.items():
                self.cache.write_recent(li, kn, vn, wslots,
                                        positions.reshape(-1))
        return emit, n_emit, finite, logps

    def _run_speculative(self, items) -> int:
        """Verify every item's draft in one batched forward. ``items``:
        (req, slot, draft) for all active decode slots; items with an empty
        draft ride along as one plain token. Rows pad to a power of two."""
        max_k = max(len(d) for _, _, d in items)
        n_tok = 1 + max_k
        bb = _pow2_bucket(len(items), lo=1)
        pps = self.config.cache.max_pages_per_seq
        tok_rows, dlens, sps = [], [], []
        for req, _slot, draft in items:
            last = (self.outputs[req.req_id] or req._prompt)[-1]
            tok_rows.append([last] + draft + [0] * (max_k - len(draft)))
            dlens.append(len(draft))
            sps.append(req.sampling)
        n_pad = bb - len(items)
        tok_rows += [[0] * n_tok] * n_pad
        dlens += [0] * n_pad
        sps += [GREEDY] * n_pad
        dev = self.device
        slots_t = torch.tensor([slot for _, slot, _ in items],
                               dtype=torch.long, device=dev)
        lengths_b = torch.cat([
            self.lengths[slots_t],
            torch.zeros((n_pad,), dtype=torch.int32, device=dev),
        ])
        table_rows = torch.cat([
            self.page_tables[slots_t],
            torch.full((n_pad, pps), self.trash_page, dtype=torch.int32,
                       device=dev),
        ])
        slot_rows = torch.cat([
            slots_t,
            torch.full((n_pad,), self.trash_slot, dtype=torch.long,
                       device=dev),
        ])

        def param(name, dtype):
            return torch.tensor([getattr(sp, name) for sp in sps],
                                dtype=dtype, device=dev)

        emit, n_emit, finite, logps = self._verify_impl(
            n_tok, torch.tensor(tok_rows, dtype=torch.long, device=dev),
            lengths_b, table_rows, param("temperature", torch.float32),
            param("top_k", torch.int64), param("top_p", torch.float32),
            torch.tensor(dlens, dtype=torch.long, device=dev),
            param("min_p", torch.float32), slot_rows,
        )
        # One host fetch: tokens, log-probs, counts (exact in float64) and
        # the finite flag.
        host = self._fetcher.fetch(torch.cat([
            emit.double(), logps.double(), n_emit.double()[:, None],
            finite.double().expand(bb, 1),
        ], dim=1))
        if self.health_config.check_numerics:
            watchdog_check(
                self.health, host[0, -1], phase="decode",
                request_ids=[r.req_id for r, _, _ in items],
            )
        total = 0
        for i, (req, slot, draft) in enumerate(items):
            n_emit_i = int(host[i, 2 * n_tok])
            emitted = [int(t) for t in host[i, :n_emit_i]]
            emitted = emitted[:req.max_new_tokens - req.generated]
            final: List[int] = []
            for t in emitted:
                final.append(t)
                if t in req.stop_tokens:
                    req.stopped = True
                    break
            self._spec_proposed += len(draft)
            self._spec_accepted += n_emit_i - 1
            self.outputs[req.req_id].extend(final)
            self.logprobs[req.req_id].extend(
                float(host[i, n_tok + j]) for j in range(len(final))
            )
            self.scheduler.report_decoded(req.req_id, len(final))
            self.lengths[slot] += len(final)
            self.last_tokens[slot] = final[-1]
            if req.done:
                self.active[slot] = False
            total += len(final)
        return total

    def speculation_stats(self) -> Dict[str, float]:
        return {
            "proposed": float(self._spec_proposed),
            "accepted": float(self._spec_accepted),
            "acceptance_rate": (
                self._spec_accepted / self._spec_proposed
                if self._spec_proposed else 0.0
            ),
        }

    def _run_decode(self, decode_slots: List[int]):
        """Decode every live slot of ``decode_slots``: one speculative
        verify or one burst. Returns (route, tokens committed)."""
        mask = np.zeros((self.config.max_batch_size,), bool)
        for s in decode_slots:
            mask[s] = True
        mask &= self.active
        rids = [
            self.scheduler.slots[s]
            for s in decode_slots
            if mask[s] and self.scheduler.slots[s] is not None
        ]
        # Speculative path: verify every slot's draft in one batched
        # forward instead of k sequential steps, when nothing waits for
        # admission and the verify batch fits its token cap.
        table_tokens = (self.config.cache.max_pages_per_seq
                        * self.config.cache.page_size)
        if (
            self.speculation_k > 0
            and rids
            and not self.scheduler.waiting
            and table_tokens * _pow2_bucket(len(rids), lo=1)
            <= self.speculation_max_table_tokens
        ):
            items, want = [], []  # want: (items index, context, k)
            for rid in rids:
                req = self.scheduler.active.get(rid)
                if req is None:
                    continue
                k = min(self.speculation_k,
                        req.max_new_tokens - req.generated - 1)
                items.append((req, req.batch_slot, []))
                if k > 0:
                    want.append((len(items) - 1,
                                 req._prompt + self.outputs[req.req_id], k))
            if want:
                proposals = self._propose_drafts(
                    [c for _, c, _ in want], max(k for _, _, k in want)
                )
                for (idx, _, k), d in zip(want, proposals):
                    req, slot, _ = items[idx]
                    items[idx] = (req, slot, d[:k])
            # Engage when the draft mass beats what one burst step would
            # yield anyway.
            if items and sum(len(d) for _, _, d in items) >= len(items):
                return "speculative", self._run_speculative(items)
        active_mask = torch.from_numpy(mask).to(self.device)
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
        return "decode", n
