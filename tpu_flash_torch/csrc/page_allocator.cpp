// Native page allocator + sequence page-table bookkeeping for the paged
// KV cache (the port's copy of the JAX package's csrc/page_allocator.cpp).
// Host-side runtime component on the engine's admission path: O(1) page
// alloc/free via a free-list stack, per-page refcounts for prefix sharing
// and per-sequence page tracking. Exposed to Python over a C ABI via
// ctypes (tpu_flash_torch/engine/allocator.py builds it with g++ at first
// use).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct PageAllocator {
  std::vector<int32_t> free_stack;          // LIFO free list
  std::vector<int32_t> refcount;            // per-page reference count
  std::unordered_map<int64_t, std::vector<int32_t>> seq_pages;
  int32_t num_pages;

  explicit PageAllocator(int32_t n) : refcount(n, 0), num_pages(n) {
    free_stack.reserve(n);
    // Push in reverse so pages are handed out in ascending order initially
    // (keeps early DMA patterns contiguous-ish).
    for (int32_t i = n - 1; i >= 0; --i) free_stack.push_back(i);
  }

  int32_t num_free() const { return static_cast<int32_t>(free_stack.size()); }

  // Allocate n pages for sequence `seq`. All-or-nothing. Returns 0 on
  // success and writes page ids to `out`; -1 if insufficient pages.
  int alloc(int64_t seq, int32_t n, int32_t* out) {
    if (n < 0 || static_cast<size_t>(n) > free_stack.size()) return -1;
    auto& pages = seq_pages[seq];
    for (int32_t i = 0; i < n; ++i) {
      int32_t p = free_stack.back();
      free_stack.pop_back();
      refcount[p] = 1;
      pages.push_back(p);
      out[i] = p;
    }
    return 0;
  }

  // Bind `seq` to already-live pages (prefix sharing): refcount++ each.
  // All-or-nothing; every page must be in range with refcount >= 1.
  int share(int64_t seq, const int32_t* pages, int32_t n) {
    if (n < 0) return -1;
    for (int32_t i = 0; i < n; ++i) {
      if (pages[i] < 0 || pages[i] >= num_pages || refcount[pages[i]] < 1)
        return -1;
    }
    auto& owned = seq_pages[seq];
    for (int32_t i = 0; i < n; ++i) {
      ++refcount[pages[i]];
      owned.push_back(pages[i]);
    }
    return 0;
  }

  // Refcount++ on live pages with no sequence binding (a prefix index
  // retaining them past their sequences' lifetimes).
  int retain(const int32_t* pages, int32_t n) {
    if (n < 0) return -1;
    for (int32_t i = 0; i < n; ++i) {
      if (pages[i] < 0 || pages[i] >= num_pages || refcount[pages[i]] < 1)
        return -1;
    }
    for (int32_t i = 0; i < n; ++i) ++refcount[pages[i]];
    return 0;
  }

  // Drop one reference from each page; pages reaching 0 return to the
  // free list. Returns how many pages were actually freed.
  int32_t release_pages(const int32_t* pages, int32_t n) {
    int32_t freed = 0;
    for (int32_t i = 0; i < n; ++i) {
      int32_t p = pages[i];
      if (p < 0 || p >= num_pages || refcount[p] < 1) continue;
      if (--refcount[p] == 0) {
        free_stack.push_back(p);
        ++freed;
      }
    }
    return freed;
  }

  // Release every page referenced by `seq` (refcount--; freed at 0).
  // Returns the number of pages the sequence referenced.
  int32_t release(int64_t seq) {
    auto it = seq_pages.find(seq);
    if (it == seq_pages.end()) return 0;
    int32_t n = static_cast<int32_t>(it->second.size());
    release_pages(it->second.data(), n);
    seq_pages.erase(it);
    return n;
  }

  // Bind sequence `seq` to exactly the given pages (checkpoint-restore
  // path): every page must currently be free. All-or-nothing; returns 0 on
  // success, -1 if any page is not free or out of range.
  int alloc_exact(int64_t seq, const int32_t* pages, int32_t n) {
    if (n < 0) return -1;
    for (int32_t i = 0; i < n; ++i) {
      if (pages[i] < 0 || pages[i] >= num_pages) return -1;
    }
    // Verify all requested pages are free before mutating anything.
    std::vector<char> wanted(num_pages, 0);
    for (int32_t i = 0; i < n; ++i) {
      if (wanted[pages[i]]) return -1;  // duplicate in request
      wanted[pages[i]] = 1;
    }
    int32_t found = 0;
    for (int32_t p : free_stack)
      if (wanted[p]) ++found;
    if (found != n) return -1;
    free_stack.erase(
        std::remove_if(free_stack.begin(), free_stack.end(),
                       [&](int32_t p) { return wanted[p] != 0; }),
        free_stack.end());
    auto& owned = seq_pages[seq];
    for (int32_t i = 0; i < n; ++i) refcount[pages[i]] = 1;
    owned.insert(owned.end(), pages, pages + n);
    return 0;
  }

  int32_t page_refcount(int32_t page) const {
    if (page < 0 || page >= num_pages) return -1;
    return refcount[page];
  }

  // Copy the page table of `seq` into out (up to cap); returns count.
  int32_t get_pages(int64_t seq, int32_t* out, int32_t cap) const {
    auto it = seq_pages.find(seq);
    if (it == seq_pages.end()) return 0;
    int32_t n = static_cast<int32_t>(it->second.size());
    if (n > cap) n = cap;
    std::memcpy(out, it->second.data(), n * sizeof(int32_t));
    return n;
  }

  int32_t num_seqs() const { return static_cast<int32_t>(seq_pages.size()); }
};

}  // namespace

extern "C" {

void* pa_create(int32_t num_pages) { return new PageAllocator(num_pages); }

void pa_destroy(void* h) { delete static_cast<PageAllocator*>(h); }

int32_t pa_num_free(void* h) {
  return static_cast<PageAllocator*>(h)->num_free();
}

int32_t pa_num_seqs(void* h) {
  return static_cast<PageAllocator*>(h)->num_seqs();
}

int pa_alloc(void* h, int64_t seq, int32_t n, int32_t* out) {
  return static_cast<PageAllocator*>(h)->alloc(seq, n, out);
}

int pa_alloc_exact(void* h, int64_t seq, const int32_t* pages, int32_t n) {
  return static_cast<PageAllocator*>(h)->alloc_exact(seq, pages, n);
}

int pa_share(void* h, int64_t seq, const int32_t* pages, int32_t n) {
  return static_cast<PageAllocator*>(h)->share(seq, pages, n);
}

int pa_retain(void* h, const int32_t* pages, int32_t n) {
  return static_cast<PageAllocator*>(h)->retain(pages, n);
}

int32_t pa_release_pages(void* h, const int32_t* pages, int32_t n) {
  return static_cast<PageAllocator*>(h)->release_pages(pages, n);
}

int32_t pa_page_refcount(void* h, int32_t page) {
  return static_cast<PageAllocator*>(h)->page_refcount(page);
}

int32_t pa_release(void* h, int64_t seq) {
  return static_cast<PageAllocator*>(h)->release(seq);
}

int32_t pa_get_pages(void* h, int64_t seq, int32_t* out, int32_t cap) {
  return static_cast<PageAllocator*>(h)->get_pages(seq, out, cap);
}

}  // extern "C"
