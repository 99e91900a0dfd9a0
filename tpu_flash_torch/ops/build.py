"""Build, load and count the package's hand-written CUDA kernels.

Each kernel is a plain C entry point in a CUDA C++ source in
``tpu_flash_torch/csrc/`` (sources may include the shared ``*.cuh``
headers there; one source may hold several entry points, each a kernel
with its own launch count). At first use the source is compiled by
``nvcc`` for ``sm_90a`` into a shared library under
``build/tpu_flash_torch/`` at the repository root (named by a hash of
the source, every header and the flags, so an edited source or header
rebuilds) and loaded with ``ctypes``. ``csrc/`` is on the include path,
so a source elsewhere (a tool's harness under ``build/``) finds the
headers too. Nothing here runs at import time;
on a machine without ``nvcc`` only the CPU plain versions work.

Every kernel carries ``launches``, a plain integer its wrapper raises by
one per launch, so a run can show which kernels its path went through;
a wrapper that serves several page tiers also counts each launch under
its tier in ``launches_by_tag``. Both are thread-safe: data-parallel
replicas launch from threads of their own, so a first build and load
runs once under a lock (kernels that share a source share its library
and its temporary file), and every count is raised under a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "tpu_flash_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
]

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# What an entry point returns, instead of a CUDA error, for a call whose
# block needs more shared memory than the card gives one block (the
# source checks its own layout against the card's limit).
ERR_SHARED_MEMORY = -2
# One first build-and-load at a time, and the launch counts' updates.
_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def find_nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA "
        "toolkit is installed (set NVCC or put nvcc on PATH)"
    )


class CudaKernel:
    """A C entry point ``symbol`` of a CUDA source (``csrc/<source>.cu``,
    by default ``<name>.cu``) taking ``argtypes`` and returning an int
    (cudaGetLastError())."""

    def __init__(self, name: str, symbol: str, argtypes: List, *,
                 replaces: str, source: Optional[str] = None):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces  # the TPU kernel, file:line
        self.source = CSRC_DIR / f"{source or name}.cu"
        self.launches = 0
        self.launches_by_tag: Dict[str, int] = {}
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._lib = None

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{h.hexdigest()[:16]}.so"

    def log_path(self) -> Path:
        """nvcc's log (its -Xptxas -v report) kept beside the library."""
        return self.library_path().with_suffix(".log")

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc (returns the process), or None when the library for
        the current sources is already built with its log."""
        out = self.library_path()
        if out.exists() and self.log_path().exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        self._t0 = time.perf_counter()
        self._tmp = tmp
        return subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
             str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            self.build_seconds = 0.0
            self.build_log = self.log_path().read_text()
            return
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source.name} "
                f"(exit {proc.returncode}):\n{log}"
            )
        self.log_path().write_text(log)
        os.replace(self._tmp, self.library_path())
        self.build_seconds = time.perf_counter() - self._t0

    def function(self):
        """The loaded C entry point (building the library if needed)."""
        if self._lib is None:
            with _BUILD_LOCK:
                if self._lib is None:
                    if not self.library_path().exists():
                        self.finish_build(self.start_build())
                    lib = ctypes.CDLL(str(self.library_path()))
                    fn = getattr(lib, self.symbol)
                    fn.argtypes = self.argtypes
                    fn.restype = ctypes.c_int
                    self._lib = lib
        return getattr(self._lib, self.symbol)

    def entry(self, name: str, argtypes: List):
        """Another C entry point of the same library (a query, not a
        kernel: it has no launch count)."""
        self.function()
        fn = getattr(self._lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def launch(self, *args, tag: Optional[str] = None) -> None:
        """Run the entry point; raise on a CUDA error; count the launch
        (and, with a ``tag``, count it under the tag too)."""
        rc = self.function()(*args)
        if rc == ERR_SHARED_MEMORY:
            raise ValueError(
                f"{self.name} kernel: this call's block needs more shared "
                "memory than the card gives one block; use a narrower kv "
                "block (fewer pages per compute block)"
            )
        if rc != 0:
            raise RuntimeError(
                f"{self.name} kernel launch failed: CUDA error {rc}"
            )
        with _COUNT_LOCK:
            self.launches += 1
            if tag is not None:
                self.launches_by_tag[tag] = (
                    self.launches_by_tag.get(tag, 0) + 1)


_FLASH_FWD_ARGS = [P] * 10 + [L] + [I] * 10 + [F, I, I, I, F, F, P]
FLASH_FWD = CudaKernel(
    "flash_fwd", "flash_fwd", _FLASH_FWD_ARGS,
    replaces="tpu_flash/ops/flash/forward.py:102",
)
# The same source's order-exact entry (the order-exact prefill tile over
# dense K/V in both dtypes), which the serving engine takes.
FLASH_FWD_EXACT = CudaKernel(
    "flash_fwd_exact", "flash_fwd_exact", _FLASH_FWD_ARGS,
    source="flash_fwd", replaces="tpu_flash/ops/flash/forward.py:102",
)
# The FA2 backward pair: one source, two entry points (K8; K9 is a TPU
# geometry of the same two computations).
_FLASH_BWD_ARGS = [P] * 11 + [I] * 8 + [F, I, I, I, F, F, P]
FLASH_BWD_DKV = CudaKernel(
    "flash_bwd_dkv", "flash_bwd_dkv", _FLASH_BWD_ARGS, source="flash_bwd",
    replaces="tpu_flash/ops/flash/backward.py:102",
)
FLASH_BWD_DQ = CudaKernel(
    "flash_bwd_dq", "flash_bwd_dq", _FLASH_BWD_ARGS, source="flash_bwd",
    replaces="tpu_flash/ops/flash/backward.py:211",
)
PAGED_DECODE = CudaKernel(
    "paged_decode", "paged_decode",
    [P] * 14 + [I] * 12 + [F, I, F, F, I, P],
    replaces="tpu_flash/ops/decode/paged.py:122",
)
PAGED_PREFILL = CudaKernel(
    "paged_prefill", "paged_prefill",
    [P] * 13 + [L] + [I] * 14 + [F, I, F, F, P],
    replaces="tpu_flash/ops/flash/paged_prefill.py:69",
)
RAGGED_PREFILL = CudaKernel(
    "ragged_prefill", "ragged_prefill",
    [P] * 8 + [L] + [I] * 9 + [F, I, F, F, P],
    replaces="tpu_flash/ops/flash/ragged.py:56",
)
# K10: the tiled quantized-input forward and the int8 staircase, one
# source (the staircase launches under the tag "onepass").
QUANT_FWD = CudaKernel(
    "quant_fwd", "quant_fwd",
    [P] * 9 + [L] * 3 + [I] * 11 + [F] * 3 + [P],
    replaces="tpu_flash/ops/flash/quantized.py:99",
)
QUANTIZE_ROWS = CudaKernel(
    "quantize_rows", "quantize_rows",
    [P] * 3 + [L, I, I, P],
    replaces="tpu_flash/ops/quant/quantize.py:253",
)
ATTN_WEIGHTS = CudaKernel(
    "attn_weights", "attn_weights",
    [P] * 5 + [I] * 8 + [F] + [I] * 3 + [F, F, P],
    replaces="tpu_flash/ops/flash/debug.py:40",
)
# K13: the causal-forward variant harness's kernel (bench/experiments.py).
VARIANT_FWD = CudaKernel(
    "variant_fwd", "variant_fwd",
    [P] * 4 + [I] * 4 + [F] + [I] * 5 + [P],
    replaces="tpu_flash/bench/experiments.py:30",
)
KERNELS: Dict[str, CudaKernel] = {
    k.name: k for k in (FLASH_FWD, FLASH_FWD_EXACT, PAGED_DECODE,
                        PAGED_PREFILL, RAGGED_PREFILL, FLASH_BWD_DKV,
                        FLASH_BWD_DQ, QUANT_FWD, QUANTIZE_ROWS,
                        ATTN_WEIGHTS, VARIANT_FWD)
}


def build_all() -> Dict[str, float]:
    """Build every kernel source, one nvcc per source, all started
    together. Returns each source's build seconds (0.0 when already
    built)."""
    owners = {}  # one kernel per source runs its build
    for k in KERNELS.values():
        owners.setdefault(k.source, k)
    procs = [(k, k.start_build()) for k in owners.values()]
    for k, proc in procs:
        k.finish_build(proc)
    return {k.source.stem: k.build_seconds for k in owners.values()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.launches_by_tag = {}


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel, and of each tagged launch as
    ``"<kernel>:<tag>"``."""
    out = {name: k.launches for name, k in KERNELS.items()}
    for name, k in KERNELS.items():
        out.update({f"{name}:{t}": n for t, n in k.launches_by_tag.items()})
    return out


def stream_handle(tensor) -> int:
    """The current CUDA stream of the tensor's device, as an int."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


def aligned(tensor):
    """``tensor`` contiguous and starting on a 16-byte boundary (kernels
    that read rows in 16-byte pieces need it); copied only where not."""
    t = tensor.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ptr(tensor) -> Optional[int]:
    """data_ptr() of a tensor, None (a C null pointer) for None."""
    return None if tensor is None else tensor.data_ptr()
