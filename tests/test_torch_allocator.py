"""The port's native page allocator (``tpu_flash_torch/engine/allocator.py``
over ``tpu_flash_torch/csrc/page_allocator.cpp``, built with g++ at first
use) against its plain version (the port's Python copy) and the JAX
package's ``PageAllocator``, on seeded traces of alloc, alloc_exact,
share, retain, release_pages and release calls: every call's result and
the state after it (free count, sequence count, each page's refcount,
each sequence's pages) the same in all three. Also: the engine's default
is the native allocator, and a failed build raises with the compiler's
log instead of falling back.
"""

import numpy as np
import pytest
import torch

from tpu_flash.engine.allocator import PageAllocator as JPageAllocator
from tpu_flash_torch.core.config import CacheConfig, EngineConfig
from tpu_flash_torch.engine import allocator as A
from tpu_flash_torch.engine.scheduler import Scheduler

NUM_PAGES = 48
SEQS = 6
OPS = ("alloc", "alloc", "alloc_exact", "share", "retain", "release_pages",
       "release", "alloc_bad", "share_bad")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trace(seed, n_ops=400):
    """Seeded calls (name, args); page lists come from a Python
    allocator replayed alongside, so most calls are valid and some are
    refused (too many pages, pages not free, pages not live)."""
    rng = np.random.default_rng(seed)
    shadow = A.PythonAllocator(NUM_PAGES)
    calls = []
    for _ in range(n_ops):
        op = OPS[rng.integers(len(OPS))]
        seq = int(rng.integers(SEQS))
        if len(shadow.pages_of(seq)) > NUM_PAGES // 2:
            # The JAX native allocator reads at most NUM_PAGES of a
            # sequence's pages back; keep below that.
            op = "release"
        live = [p for p in range(NUM_PAGES) if shadow.refcount(p) > 0]
        if op == "alloc":
            args = (seq, int(rng.integers(0, 12)))
        elif op == "alloc_bad":
            op, args = "alloc", (seq, NUM_PAGES + 1)
        elif op == "alloc_exact":
            free = [p for p in range(NUM_PAGES) if shadow.refcount(p) == 0]
            pick = rng.permutation(free)[:rng.integers(0, 5)].tolist()
            if rng.random() < 0.2 and live:
                pick.append(live[0])  # not free: refused
            args = (seq, [int(p) for p in pick])
        elif op in ("share", "retain"):
            pick = rng.permutation(live)[:rng.integers(0, 4)].tolist()
            args = [int(p) for p in pick]
            args = (seq, args) if op == "share" else (args,)
        elif op == "share_bad":
            op, args = "share", (seq, [NUM_PAGES + 3])
        elif op == "release_pages":
            pick = rng.permutation(live)[:rng.integers(0, 4)].tolist()
            args = ([int(p) for p in pick] + [-1],)
        else:
            args = (seq,)
        getattr(shadow, op)(*args)
        calls.append((op, args))
    return calls


def _state(a):
    return (a.num_free, a.num_seqs,
            [a.refcount(p) for p in range(-1, NUM_PAGES + 1)],
            [a.pages_of(s) for s in range(SEQS)])


@pytest.mark.parametrize("seed", range(4))
def test_native_matches_python_and_jax(seed):
    native = A.PageAllocator(NUM_PAGES)
    assert isinstance(native, A.NativeAllocator)
    plain = A.PythonAllocator(NUM_PAGES)
    jax_alloc = JPageAllocator(NUM_PAGES)
    refused = 0
    for i, (op, args) in enumerate(_trace(seed)):
        got = [getattr(a, op)(*args) for a in (native, plain, jax_alloc)]
        assert got[0] == got[1] == got[2], (i, op, args, got)
        refused += got[0] in (None, False)
        states = [_state(a) for a in (native, plain, jax_alloc)]
        assert states[0] == states[1] == states[2], (i, op, args)
    assert refused > 10  # the trace reaches the refusals too


def test_long_shared_page_list():
    """A sequence sharing one page more times than the pool holds pages
    reads its whole list back (the JAX native reader stops at the pool
    size)."""
    native, plain = A.PageAllocator(4), A.PythonAllocator(4)
    for a in (native, plain):
        assert a.alloc(0, 1) == [0]
        assert a.share(1, [0] * 9)
    assert native.pages_of(1) == plain.pages_of(1) == [0] * 9
    assert native.refcount(0) == plain.refcount(0) == 10


def test_engine_defaults_to_native():
    cfg = EngineConfig(cache=CacheConfig(page_size=16, num_pages=8,
                                         max_pages_per_seq=4))
    assert isinstance(Scheduler(cfg).allocator, A.NativeAllocator)


def test_failed_build_raises_with_log(tmp_path, monkeypatch):
    bad = tmp_path / "page_allocator.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(A, "SOURCE", bad)
    monkeypatch.setattr(A, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(A, "_lib", None)
    with pytest.raises(RuntimeError, match="failed") as err:
        A.PageAllocator(8)
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        A.PageAllocator(8)
    # The plain version needs no build.
    assert A.PythonAllocator(8).alloc(0, 3) == [0, 1, 2]
