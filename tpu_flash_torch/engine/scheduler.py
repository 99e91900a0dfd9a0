"""Continuous-batching scheduler (host code, copied from
``tpu_flash/engine/scheduler.py`` with its imports pointed at this
package).

Host-side control plane of the engine: admits requests while batch slots
and physical pages are available, plans chunked prefill for newly
admitted sequences, plans one decode step for running ones, and releases
pages at completion. Page accounting delegates to the allocator
(engine/allocator.py).
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Deque, Dict, List, Optional

from tpu_flash_torch.core.config import EngineConfig
from tpu_flash_torch.engine.allocator import PageAllocator
from tpu_flash_torch.engine.sampling import GREEDY, SamplingParams


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    FORK_WAIT = "fork_wait"  # admitted branch awaiting its parent's prefill
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    req_id: int
    prompt_len: int
    max_new_tokens: int
    sampling: SamplingParams = GREEDY
    stop_tokens: tuple = ()  # generation ends early on any of these
    state: RequestState = RequestState.WAITING
    # progress
    prefilled: int = 0  # prompt tokens already prefetched into the cache
    generated: int = 0
    stopped: bool = False  # hit a stop token before max_new_tokens
    batch_slot: int = -1
    # Parallel sampling (n>1 completions per prompt): the parent prefills
    # once; each child is a decode-only branch sharing the prompt's full
    # pages (allocator refcounts) with its own copy of the partial tail
    # page. Children sit in FORK_WAIT until the parent's final prefill
    # chunk forks them (runner._finish_prefill_chunk).
    n_branches: int = 1
    parent_id: Optional[int] = None
    child_ids: tuple = ()
    # Preemption (optimistic admission): a recomputed victim re-prefills
    # prompt+generated and resumes decode from ``resume_token`` (its
    # already-emitted newest token — never re-sampled); a swapped victim
    # carries ``swap_npages`` so re-admission allocates the same page
    # count for the runner's host-side KV restore.
    resume_token: Optional[int] = None
    swap_npages: int = 0
    # Scheduling priority: higher admits first; preemption victimizes the
    # lowest priority (newest within a tie) and never evicts a sequence
    # of higher priority than the one needing pages.
    priority: int = 0
    # Multi-LoRA: id of the request's adapter (0 = none). Adapted
    # requests bypass prefix-cache sharing — their KV depends on the
    # adapter, so base-model pages must never alias theirs.
    lora_id: int = 0

    @property
    def context_len(self) -> int:
        return self.prefilled + self.generated

    @property
    def done(self) -> bool:
        return self.stopped or self.generated >= self.max_new_tokens


@dataclasses.dataclass
class PrefillChunk:
    req_id: int
    batch_slot: int
    start: int  # first prompt position in this chunk
    length: int  # tokens in this chunk


@dataclasses.dataclass
class StepPlan:
    """What the runner must execute this engine step."""

    prefill: List[PrefillChunk]
    decode_slots: List[int]  # batch slots with one token to decode
    finished: List[int]  # req_ids completed last step (pages released)
    # Optimistic admission: slots whose page table grew this step (the
    # runner re-installs their device rows before decode), and swapped
    # requests re-admitted this step (the runner restores their KV pages
    # from host memory before anything else runs).
    refresh_tables: List[int] = dataclasses.field(default_factory=list)
    swap_in: List[int] = dataclasses.field(default_factory=list)


class Scheduler:
    def __init__(self, config: EngineConfig):
        self.config = config
        self.allocator = PageAllocator(config.cache.num_pages)
        # Optional prefix index (engine/prefix.py); the runner installs it
        # when config.prefix_cache is on. Matching happens at ADMISSION so
        # retained pages can't be evicted between lookup and binding.
        self.prefix_index = None
        self.waiting: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}  # req_id -> Request
        self.slots: List[Optional[int]] = [None] * config.max_batch_size
        self._page_size = config.cache.page_size
        # Optimistic admission (config.admission): the runner sets
        # max_step_tokens to the most tokens one plan can commit per slot
        # (decode burst / speculation k+1); capacity is topped up to that
        # ahead of every decode. Hooks are installed by the runner:
        # preempt_hook(req) folds generated tokens for recompute,
        # swap_out_hook(req, pages) stashes KV pages host-side.
        self.max_step_tokens = 1
        self.preempt_hook = None
        self.swap_out_hook = None
        self.num_preemptions = 0
        self._admit_counter = 0
        self._arrival_counter = 0

    # -- client API ---------------------------------------------------------

    def add_request(self, req: Request) -> None:
        if req.prompt_len <= 0:
            raise ValueError("prompt_len must be >= 1")
        total = req.prompt_len + req.max_new_tokens
        if total > self.config.cache.max_context:
            raise ValueError(
                f"request needs {total} tokens of context; cache supports "
                f"{self.config.cache.max_context}"
            )
        if not hasattr(req, "_arrival"):
            req._arrival = self._arrival_counter
            self._arrival_counter += 1
        self._enqueue(req)

    def _wait_key(self, req: Request):
        # Admission order: priority first (higher = sooner), arrival
        # within a tie — a preempted victim keeps its original arrival
        # stamp, so it resumes ahead of later same-priority work.
        return (-req.priority, getattr(req, "_arrival", 0))

    def _enqueue(self, req: Request) -> None:
        key = self._wait_key(req)
        for i, w in enumerate(self.waiting):
            if self._wait_key(w) > key:
                self.waiting.insert(i, req)
                return
        self.waiting.append(req)

    def num_active(self) -> int:
        return len(self.active)

    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    # -- scheduling ---------------------------------------------------------

    def _pages_needed(self, tokens: int) -> int:
        return -(-tokens // self._page_size)

    def _free_slot(self) -> int:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return -1

    def step(self) -> StepPlan:
        """Plan one engine step. Mutates request states optimistically; the
        runner must execute the plan before the next call."""
        finished: List[int] = []

        # 1. retire finished requests, release pages and slots.
        for req_id in [r for r, q in self.active.items() if q.done]:
            req = self.active.pop(req_id)
            req.state = RequestState.FINISHED
            self.allocator.release(req_id)
            self.slots[req.batch_slot] = None
            finished.append(req_id)

        # 2. admit waiting requests: need a batch slot + all pages for the
        #    full context (prompt + generation budget) up front, so decode
        #    can never fail mid-flight. With a prefix index, the prompt's
        #    longest cached prefix binds as shared pages (refcount++) and
        #    prefill starts past it.
        swap_in: List[int] = []
        while self.waiting:
            req = self.waiting[0]
            # Parallel sampling admits the whole group atomically: the
            # parent plus its n-1 decode-only branches, each needing a
            # batch slot (and pages: shared prompt pages + own tail).
            children = list(getattr(req, "_children_reqs", ()))
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if len(free_slots) < 1 + len(children):
                break
            slot = free_slots[0]
            if req.swap_npages:
                # Swapped-out victim: re-admit with the SAME page count;
                # the runner restores its host-stashed KV into the new
                # pages (plan.swap_in) and resumes where it left off.
                got = self.allocator.alloc(req.req_id, req.swap_npages)
                if got is None and self.prefix_index is not None:
                    self.prefix_index.evict(
                        req.swap_npages - self.allocator.num_free
                    )
                    got = self.allocator.alloc(req.req_id, req.swap_npages)
                if got is None:
                    break
                self.waiting.popleft()
                req.state = (
                    RequestState.RUNNING
                    if req.generated > 0
                    else RequestState.PREFILL
                )
                req.batch_slot = slot
                req._admit_seq = self._admit_counter
                self._admit_counter += 1
                self.slots[slot] = req.req_id
                self.active[req.req_id] = req
                swap_in.append(req.req_id)
                continue
            shared_pages: List[int] = []
            matched = 0
            prompt = getattr(req, "_prompt", None)
            if req.lora_id:
                prompt = None  # adapter-specific KV: no prefix sharing
            if self.prefix_index is not None and prompt:
                # Granularity = prefill_chunk keeps chunk starts on the
                # compile grid the runner already jits for (one prefill
                # program per (start, bucket) — unbounded starts would leak
                # compiled executables).
                shared_pages, matched = self.prefix_index.match(
                    prompt, granularity=self.config.prefill_chunk
                )
                # Deferred same-prefix admission: if a LIVE prefill is
                # about to index a longer shared prefix than what's cached
                # now (its pages register incrementally per chunk), hold
                # this request a step and admit it with the cache hit —
                # a burst of same-system-prompt arrivals prefills the
                # shared pages once instead of once per request. Progress
                # is guaranteed: the live prefill advances every step.
                if self._pending_prefix_tokens(prompt) > matched:
                    break
            if self.config.admission == "optimistic":
                # Prompt pages only; decode capacity tops up per step
                # (preempting the newest sequence if the pool overcommits).
                pages = self._pages_needed(req.prompt_len)
            else:
                pages = self._pages_needed(
                    req.prompt_len + req.max_new_tokens
                )
            n_new = pages - len(shared_pages)
            if shared_pages and not self.allocator.share(
                req.req_id, shared_pages
            ):
                shared_pages, matched = [], 0  # index raced a free; rebind
                n_new = pages
            got = self.allocator.alloc(req.req_id, n_new)
            if got is None and self.prefix_index is not None:
                # Evict cold cached prefixes and retry once.
                self.prefix_index.evict(n_new - self.allocator.num_free)
                got = self.allocator.alloc(req.req_id, n_new)
            if got is None:
                if shared_pages:
                    self.allocator.release(req.req_id)  # unwind the share
                break  # head-of-line blocking keeps admission fair
            if children:
                # Each child shares the prompt's FULL pages (immutable once
                # prefilled; refcount++) and owns the rest — the partial
                # tail page (copied at fork) plus its generation budget.
                parent_pages = self.allocator.pages_of(req.req_id)
                shared_n = req.prompt_len // self._page_size
                child_shared = parent_pages[:shared_n]
                own = pages - shared_n
                ok = True
                admitted = []
                for ch in children:
                    if child_shared and not self.allocator.share(
                        ch.req_id, child_shared
                    ):
                        ok = False
                        break
                    got_c = self.allocator.alloc(ch.req_id, own)
                    if got_c is None and self.prefix_index is not None:
                        self.prefix_index.evict(
                            own - self.allocator.num_free
                        )
                        got_c = self.allocator.alloc(ch.req_id, own)
                    if got_c is None:
                        self.allocator.release(ch.req_id)  # unwind share
                        ok = False
                        break
                    admitted.append(ch)
                if not ok:
                    for ch in admitted:
                        self.allocator.release(ch.req_id)
                    self.allocator.release(req.req_id)
                    break  # the whole group waits together
                for i, ch in enumerate(children):
                    ch.state = RequestState.FORK_WAIT
                    ch.batch_slot = free_slots[1 + i]
                    ch._admit_seq = self._admit_counter + 1 + i
                    self.slots[ch.batch_slot] = ch.req_id
                    self.active[ch.req_id] = ch
            self.waiting.popleft()
            req.state = RequestState.PREFILL
            req.prefilled = matched  # cached tokens skip prefill entirely
            req.batch_slot = slot
            req._admit_seq = self._admit_counter
            self._admit_counter += 1 + len(children)
            self.slots[slot] = req.req_id
            self.active[req.req_id] = req
            if self.prefix_index is not None and prompt:
                # Stats only for admitted work — a head-of-line-blocked
                # request re-matching every step must not inflate hit rate.
                self.prefix_index.record_lookup(matched, len(prompt))

        # 2b. optimistic admission: top every running sequence's page
        #     capacity up to what this step can commit, preempting the
        #     newest sequences when the pool overcommits.
        refresh_tables: List[int] = []
        if self.config.admission == "optimistic":
            refresh_tables = self._ensure_decode_capacity()

        # 3. plan prefill chunks for sequences still prefilling.
        prefill: List[PrefillChunk] = []
        chunk = self.config.prefill_chunk
        for req in self.active.values():
            if req.state is not RequestState.PREFILL:
                continue
            n = min(chunk, req.prompt_len - req.prefilled)
            prefill.append(
                PrefillChunk(
                    req_id=req.req_id,
                    batch_slot=req.batch_slot,
                    start=req.prefilled,
                    length=n,
                )
            )
            req.prefilled += n
            if req.prefilled >= req.prompt_len:
                req.state = RequestState.RUNNING
                # The prefill's last-token logits produce the first new
                # token, counted by the runner via report_decoded.

        # 4. plan one decode token for all running sequences (those that
        #    just finished prefill decode via the prefill logits instead).
        decode_slots = [
            req.batch_slot
            for req in self.active.values()
            if req.state is RequestState.RUNNING
            and not any(c.req_id == req.req_id for c in prefill)
        ]

        return StepPlan(
            prefill=prefill, decode_slots=sorted(decode_slots),
            finished=finished, refresh_tables=refresh_tables,
            swap_in=swap_in,
        )

    # -- optimistic admission: capacity top-up + preemption -------------------

    def _ensure_decode_capacity(self) -> List[int]:
        """Every RUNNING sequence gets enough pages for the most tokens
        one plan can commit (max_step_tokens, bounded by its remaining
        budget), oldest admissions first. When the pool is dry, the
        NEWEST active sequence is preempted — and if a sequence still
        can't be topped up, it preempts itself (its pages come back when
        it re-admits). Returns batch slots whose tables grew."""
        refresh: List[int] = []
        ps = self._page_size
        running = sorted(
            (
                r
                for r in self.active.values()
                if r.state is RequestState.RUNNING
            ),
            key=lambda r: getattr(r, "_admit_seq", 0),
        )
        for req in running:
            if req.req_id not in self.active:
                continue  # preempted as a victim earlier in this loop
            bound = min(
                self.max_step_tokens,
                max(req.max_new_tokens - req.generated, 1),
            )
            need = req.context_len + bound
            have = len(self.allocator.pages_of(req.req_id)) * ps
            if have >= need:
                continue
            n = self._pages_needed(need - have)
            got = self.allocator.alloc(req.req_id, n)
            if got is None and self.prefix_index is not None:
                self.prefix_index.evict(n - self.allocator.num_free)
                got = self.allocator.alloc(req.req_id, n)
            while got is None:
                # The requester is a victim CANDIDATE too: if it is itself
                # the newest lowest-priority sequence, it self-preempts
                # rather than evicting older peers (newest-first policy).
                victim = self._select_victim(max_priority=req.priority)
                if victim is None:
                    self._preempt(req)  # nothing evictable: requeue self
                    break
                self._preempt(victim)
                if victim is req:
                    break
                got = self.allocator.alloc(req.req_id, n)
            if got is None:
                continue
            refresh.append(req.batch_slot)
        return refresh

    def _select_victim(self, max_priority: int):
        """The lowest-priority (then newest-admitted) active sequence at
        or below ``max_priority`` — pages never flow up to a
        lower-priority requester."""
        victim = None
        best = None
        for r in self.active.values():
            if r.done:
                continue
            if r.priority > max_priority:
                continue
            key = (r.priority, -getattr(r, "_admit_seq", 0))
            if best is None or key < best:
                best, victim = key, r
        return victim

    def _preempt(self, victim: Request) -> None:
        """Evict an active sequence and requeue it at the FRONT of the
        waiting line (it is older than anything behind it). FORK_WAIT
        branches have no KV of their own yet and requeue as ordinary
        independent requests; otherwise the configured policy applies:
        swap stashes KV host-side (runner hook), recompute folds the
        generated tokens into the prompt for re-prefill."""
        if victim.state is RequestState.FORK_WAIT:
            # Detach the branch from its pending fork group: it re-admits
            # as an ordinary request and prefills on its own (the parent's
            # fork skips it via the FORK_WAIT-state filter, and must not
            # re-admit it as a pending child if the parent itself is
            # preempted later).
            parent = self.active.get(victim.parent_id)
            if parent is None:
                parent = next(
                    (
                        w
                        for w in self.waiting
                        if w.req_id == victim.parent_id
                    ),
                    None,
                )
            if parent is not None:
                pending = getattr(parent, "_children_reqs", None)
                if pending:
                    parent._children_reqs = [
                        c for c in pending if c.req_id != victim.req_id
                    ]
        has_kv = (
            victim.state is not RequestState.FORK_WAIT
            and victim.prefilled > 0
        )
        if has_kv and self.config.preemption == "swap":
            if self.swap_out_hook is not None:
                self.swap_out_hook(
                    victim, self.allocator.pages_of(victim.req_id)
                )
                victim.swap_npages = len(
                    self.allocator.pages_of(victim.req_id)
                )
        elif has_kv:
            if self.preempt_hook is not None:
                self.preempt_hook(victim)
            victim.prefilled = 0
        else:
            victim.prefilled = 0
        self.allocator.release(victim.req_id)
        if victim.batch_slot >= 0:
            self.slots[victim.batch_slot] = None
        self.active.pop(victim.req_id, None)
        victim.batch_slot = -1
        victim.state = RequestState.WAITING
        self._enqueue(victim)  # original arrival stamp: resumes ahead of
        self.num_preemptions += 1  # later same-priority arrivals

    def _pending_prefix_tokens(self, prompt) -> int:
        """Longest prefix of ``prompt`` (in full pages, rounded to the
        prefill-chunk grid like :meth:`PrefixIndex.match`) that a request
        currently in PREFILL will have indexed once its prefill completes.
        Used to defer admission until the shared pages are reusable."""
        ps = self._page_size
        gran = self.config.prefill_chunk
        usable = len(prompt) - 1  # match() always leaves >= 1 token
        best = 0
        for other in self.active.values():
            if other.state is not RequestState.PREFILL:
                continue
            if other.lora_id:
                continue  # adapted prefills never register prefix pages
            op = getattr(other, "_prompt", None)
            if not op:
                continue
            limit = min(len(op), usable)
            n = 0
            while n < limit and op[n] == prompt[n]:
                n += 1
            n = (n // ps) * ps  # whole pages only
            if gran > 1:
                n -= n % gran
                n -= n % ps
            best = max(best, n)
        return best

    def report_decoded(self, req_id: int, n: int = 1) -> None:
        """The runner reports n generated tokens for a request."""
        req = self.active.get(req_id)
        if req is not None:
            req.generated += n

    def page_table(self, req_id: int) -> List[int]:
        return self.allocator.pages_of(req_id)
