"""Physical-page allocator for the paged KV cache.

A copy of the Python allocator of ``tpu_flash/engine/allocator.py``
behind the same ``PageAllocator(num_pages)`` factory: all-or-nothing
allocation per sequence, per-page refcounts for prefix sharing, pages
handed out in the same order. The native C++ allocator
(``csrc/page_allocator.cpp``, loaded over ctypes) is ROADMAP queue 1,
item 6.
"""

from __future__ import annotations

from typing import List, Optional


class _PythonAllocator:
    """Free-list allocator with per-page refcounts (the JAX package's
    Python reference semantics)."""

    def __init__(self, num_pages: int):
        self._free = list(range(num_pages - 1, -1, -1))
        self._refs = [0] * num_pages
        self._seq_pages: dict[int, List[int]] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_seqs(self) -> int:
        return len(self._seq_pages)

    def alloc(self, seq_id: int, n: int) -> Optional[List[int]]:
        if n < 0 or n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        for p in got:
            self._refs[p] = 1
        self._seq_pages.setdefault(seq_id, []).extend(got)
        return got

    def alloc_exact(self, seq_id: int, pages: List[int]) -> bool:
        if len(set(pages)) != len(pages):
            return False
        free = set(self._free)
        if not all(p in free for p in pages):
            return False
        wanted = set(pages)
        self._free = [p for p in self._free if p not in wanted]
        for p in pages:
            self._refs[p] = 1
        self._seq_pages.setdefault(seq_id, []).extend(pages)
        return True

    def share(self, seq_id: int, pages: List[int]) -> bool:
        if not all(0 <= p < len(self._refs) and self._refs[p] >= 1
                   for p in pages):
            return False
        for p in pages:
            self._refs[p] += 1
        self._seq_pages.setdefault(seq_id, []).extend(pages)
        return True

    def retain(self, pages: List[int]) -> bool:
        if not all(0 <= p < len(self._refs) and self._refs[p] >= 1
                   for p in pages):
            return False
        for p in pages:
            self._refs[p] += 1
        return True

    def release_pages(self, pages: List[int]) -> int:
        freed = 0
        for p in pages:
            if 0 <= p < len(self._refs) and self._refs[p] >= 1:
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    self._free.append(p)
                    freed += 1
        return freed

    def refcount(self, page: int) -> int:
        if not 0 <= page < len(self._refs):
            return -1
        return self._refs[page]

    def release(self, seq_id: int) -> int:
        pages = self._seq_pages.pop(seq_id, [])
        self.release_pages(pages)
        return len(pages)

    def pages_of(self, seq_id: int) -> List[int]:
        return list(self._seq_pages.get(seq_id, []))


def PageAllocator(num_pages: int):
    """Factory, as in the JAX package (Python implementation only)."""
    return _PythonAllocator(num_pages)
