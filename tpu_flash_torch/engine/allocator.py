"""Physical-page allocator for the paged KV cache.

The port of ``tpu_flash/engine/allocator.py``: all-or-nothing allocation
per sequence, per-page refcounts for prefix sharing, pages handed out in
the same order. ``PageAllocator(num_pages)`` returns the native C++
free-list allocator (``tpu_flash_torch/csrc/page_allocator.cpp``): at
first use g++ compiles it into a shared library under
``build/tpu_flash_torch/`` at the repository root (named by a hash of
the source and the flags, so an edited source rebuilds; the compiler's
log kept beside it) and ``ctypes`` loads it. A failed build or load
raises with the compiler's log; nothing falls back. The Python copy of
the JAX package's allocator, ``PythonAllocator``, is its plain version:
the tests build it directly and hold the two to the same pages.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

from tpu_flash_torch.ops.build import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "page_allocator.cpp"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()
_lib = None

_I32, _I64, _H = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
_PI32 = ctypes.POINTER(ctypes.c_int32)
# symbol -> (restype, argtypes): the bindings of the JAX package's loader.
_SIGNATURES = {
    "pa_create": (_H, [_I32]),
    "pa_destroy": (None, [_H]),
    "pa_num_free": (_I32, [_H]),
    "pa_num_seqs": (_I32, [_H]),
    "pa_alloc": (ctypes.c_int, [_H, _I64, _I32, _PI32]),
    "pa_alloc_exact": (ctypes.c_int, [_H, _I64, _PI32, _I32]),
    "pa_share": (ctypes.c_int, [_H, _I64, _PI32, _I32]),
    "pa_retain": (ctypes.c_int, [_H, _PI32, _I32]),
    "pa_release_pages": (_I32, [_H, _PI32, _I32]),
    "pa_page_refcount": (_I32, [_H, _I32]),
    "pa_release": (_I32, [_H, _I64]),
    "pa_get_pages": (_I32, [_H, _I64, _PI32, _I32]),
}


def library_path():
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpage_allocator-{h.hexdigest()[:16]}.so"


def build_native() -> str:
    """Compile the allocator's library unless it is already built;
    returns its path. Raises RuntimeError with the compiler's log when
    g++ fails (or is missing)."""
    out = library_path()
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCE), "-o",
           str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native page allocator: cannot run {cmd[0]}: "
                           f"{e}") from e
    log = proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native page allocator: {' '.join(cmd)} failed (exit "
            f"{proc.returncode}):\n{log}"
        )
    os.replace(tmp, out)
    return str(out)


def load_native():
    """The loaded library (built at first use), once a process."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(build_native())
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _lib = lib
    return _lib


def _pages(pages: List[int]):
    return (ctypes.c_int32 * max(len(pages), 1))(*pages)


class NativeAllocator:
    """The C++ allocator behind the Python allocator's interface."""

    def __init__(self, num_pages: int):
        self._lib = load_native()
        self._h = self._lib.pa_create(num_pages)
        self._num_pages = num_pages

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pa_destroy(self._h)
            self._h = None

    @property
    def num_free(self) -> int:
        return self._lib.pa_num_free(self._h)

    @property
    def num_seqs(self) -> int:
        return self._lib.pa_num_seqs(self._h)

    def alloc(self, seq_id: int, n: int) -> Optional[List[int]]:
        out = (ctypes.c_int32 * max(n, 1))()
        if self._lib.pa_alloc(self._h, seq_id, n, out) != 0:
            return None
        return list(out[:n])

    def alloc_exact(self, seq_id: int, pages: List[int]) -> bool:
        """Bind seq_id to exactly these (currently free) pages: the
        snapshot-restore path."""
        return self._lib.pa_alloc_exact(self._h, seq_id, _pages(pages),
                                        len(pages)) == 0

    def share(self, seq_id: int, pages: List[int]) -> bool:
        """Bind seq_id to live pages owned elsewhere (prefix sharing)."""
        return self._lib.pa_share(self._h, seq_id, _pages(pages),
                                  len(pages)) == 0

    def retain(self, pages: List[int]) -> bool:
        """Refcount++ with no sequence binding (prefix-index retention)."""
        return self._lib.pa_retain(self._h, _pages(pages), len(pages)) == 0

    def release_pages(self, pages: List[int]) -> int:
        """Drop one reference a page; returns the pages freed."""
        return self._lib.pa_release_pages(self._h, _pages(pages),
                                          len(pages))

    def refcount(self, page: int) -> int:
        return self._lib.pa_page_refcount(self._h, page)

    def release(self, seq_id: int) -> int:
        return self._lib.pa_release(self._h, seq_id)

    def pages_of(self, seq_id: int) -> List[int]:
        # A sequence that shares pages may list more than num_pages of
        # them: read again with room to spare until the list fits.
        cap = max(self._num_pages, 1)
        while True:
            out = (ctypes.c_int32 * cap)()
            n = self._lib.pa_get_pages(self._h, seq_id, out, cap)
            if n < cap:
                return list(out[:n])
            cap *= 2


class PythonAllocator:
    """Free-list allocator with per-page refcounts (the JAX package's
    Python reference semantics): the native allocator's plain version."""

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


# The engine's allocator, under the JAX package's name: the native one.
PageAllocator = NativeAllocator
