"""Prefix caching: shared-prompt KV pages reused across requests.

Completes the engine's cache-hit story (SURVEY.md §5 metrics: "tokens/s,
batch occupancy, cache hit"). Full pages of a finished prefill are indexed
by a *chain hash* — the key of page i commits to every token in pages
0..i — so a lookup walks the new prompt page-by-page and reuses the longest
indexed prefix. Pages are immutable once fully written (appends only ever
target positions past a sequence's current length), which is what makes
read-sharing safe, including for quantized caches (payload + scale pages
travel together under one page id).

Lifetime: the index holds one retention reference on every indexed page
(allocator refcounts), so cached prefixes survive their originating
request. Under allocation pressure the engine evicts least-recently-used
chains until the pending request fits.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Sequence, Tuple


def _chain_key(prev_key: int, page_tokens: Tuple[int, ...]) -> int:
    return hash((prev_key, page_tokens))


@dataclasses.dataclass
class _Entry:
    page: int
    prev_key: int  # parent chain key (-1 for the first page)
    tokens: Tuple[int, ...]  # the page's tokens — verified on match so a
    # hash collision can never serve another prompt's KV pages


class PrefixIndex:
    """Chain-hash index of immutable full prompt pages.

    Not thread-safe (the engine's control loop is single-threaded).
    """

    def __init__(self, allocator, page_size: int):
        self._alloc = allocator
        self._ps = page_size
        self._entries: Dict[int, _Entry] = {}
        # Chain topology: parent key -> child keys, so eviction can drop a
        # page together with every descendant (a descendant whose ancestor
        # is gone can never match — match() walks from the chain root).
        self._children: Dict[int, List[int]] = {}
        # LRU over chain keys: most-recently-used at the right end.
        self._lru: "collections.OrderedDict[int, None]" = (
            collections.OrderedDict()
        )
        self.hits_tokens = 0
        self.misses_tokens = 0

    # -- lookup ---------------------------------------------------------------

    def match(
        self, prompt: Sequence[int], granularity: int = 1
    ) -> Tuple[List[int], int]:
        """Longest indexed prefix of ``prompt`` in full pages.

        Returns (pages, matched_tokens), with matched_tokens rounded DOWN
        to a multiple of ``granularity`` (the engine passes prefill_chunk
        so chunk starts stay on the pre-existing compile grid — otherwise
        every distinct cached-prefix length would jit a new prefill
        program). Never matches the *entire* prompt: at least one token is
        left for prefill so the request produces first-token logits.

        Pure lookup: call :meth:`record_lookup` after a successful
        admission so blocked retries don't inflate the hit statistics.
        """
        ps = self._ps
        usable = len(prompt) - 1  # always leave >= 1 token to prefill
        pages: List[int] = []
        key = -1
        for i in range(usable // ps):
            chunk = tuple(prompt[i * ps : (i + 1) * ps])
            key = _chain_key(key, chunk)
            entry = self._entries.get(key)
            if entry is None or entry.tokens != chunk:
                break
            pages.append(entry.page)
            self._lru.move_to_end(key)
        matched = len(pages) * ps
        if granularity > 1:
            matched = matched - matched % granularity
            if matched % ps:
                # Keep page-aligned: shared pages must be whole.
                matched = matched - matched % ps
            pages = pages[: matched // ps]
        return pages, matched

    def record_lookup(self, matched: int, prompt_len: int) -> None:
        """Account one admitted request's hit/miss tokens."""
        self.hits_tokens += matched
        self.misses_tokens += prompt_len - matched

    # -- registration ---------------------------------------------------------

    def register(self, prompt: Sequence[int], pages: Sequence[int]) -> int:
        """Index every full page of a completed prefill; retains pages not
        already indexed. Returns how many new pages were indexed."""
        ps = self._ps
        n_full = min(len(prompt) // ps, len(pages))
        key = -1
        added = 0
        for i in range(n_full):
            parent = key
            key = _chain_key(parent, tuple(prompt[i * ps : (i + 1) * ps]))
            if key in self._entries:
                self._lru.move_to_end(key)
                continue
            if not self._alloc.retain([pages[i]]):
                break  # page not live (shouldn't happen mid-prefill)
            self._entries[key] = _Entry(
                page=pages[i], prev_key=parent,
                tokens=tuple(prompt[i * ps : (i + 1) * ps]),
            )
            self._children.setdefault(parent, []).append(key)
            self._lru[key] = None
            added += 1
        return added

    # -- eviction ---------------------------------------------------------------

    def evict(self, n_pages: int) -> int:
        """Release at least ``n_pages`` retained pages, LRU-first, evicting
        each victim together with its whole descendant subtree: once page i
        of a chain is gone, pages i+1.. can never match again (match walks
        from the root), so keeping them would only leak retention until
        their own LRU turn. Returns pages actually freed back to the
        allocator."""
        freed = 0
        while freed < n_pages and self._lru:
            root = next(iter(self._lru))
            root_parent = self._entries[root].prev_key
            siblings = self._children.get(root_parent)
            if siblings is not None and root in siblings:
                siblings.remove(root)
            stack = [root]
            victims: List[int] = []
            while stack:
                key = stack.pop()
                entry = self._entries.pop(key, None)
                if entry is None:
                    continue
                victims.append(entry.page)
                self._lru.pop(key, None)
                stack.extend(self._children.pop(key, ()))
            freed += self._alloc.release_pages(victims)
        return freed

    def drop_all(self) -> int:
        return self.evict(len(self._entries))

    @property
    def num_indexed_pages(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        total = self.hits_tokens + self.misses_tokens
        return self.hits_tokens / total if total else 0.0
