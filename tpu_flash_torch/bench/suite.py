"""Benchmark harness: the port of ``tpu_flash/bench/suite.py`` for the
parts that the kernel-level configs (1-5, 7, 8 and 11) use.

Timing is eager and differential (:func:`time_per_call`): n and then 2n
calls between two ``torch.cuda.synchronize()``, n grown until one window
lasts at least 0.15 s, the best of 4 repeats of each; the difference over
n cancels the launch of the first call and the final synchronise. Eager
PyTorch runs every call it is given, so no data-dependent chain is needed
against common-subexpression elimination as under ``jit``. Inputs are
seeded (``torch.Generator``) on the bench's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from tpu_flash_torch.ops.flash import flash_attention
from tpu_flash_torch.utils.device import device_info


def attention_flops(
    batch: int, heads: int, q_len: int, kv_len: int, head_dim: int,
    causal: bool,
) -> float:
    """Matmul FLOPs of one attention call (QK^T + PV, 2*M*N*K each)."""
    full = 4.0 * batch * heads * q_len * kv_len * head_dim
    return full / 2 if causal else full


def attention_hbm_bytes(
    batch, q_heads, kv_heads, q_len, kv_len, head_dim, itemsize
) -> float:
    q = batch * q_heads * q_len * head_dim
    kv = 2 * batch * kv_heads * kv_len * head_dim
    o = q
    return (q + kv + o) * itemsize


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _wall(fn: Callable[[], None], n: int, device) -> float:
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(device)
    return time.perf_counter() - t0


def time_per_call(
    fn: Callable[[], object],
    *,
    device="cuda",
    inner: int = 16,
    repeats: int = 4,
    target_window: float = 0.15,
    max_inner: int = 4096,
) -> float:
    """Seconds per call of ``fn`` by differential timing (module
    docstring); ``inner`` is the calibration floor."""
    fn()  # warm-up: builds and loads the kernels, allocator caches
    n = max(inner, 1)
    while n < max_inner:
        w = _wall(fn, n, device)
        if w >= target_window:
            break
        grow = max(2.0, target_window / max(w, 1e-6))
        n = min(max_inner, max(n + 1, int(n * min(grow, 16.0))))
    t1 = min(_wall(fn, n, device) for _ in range(repeats))
    t2 = min(_wall(fn, 2 * n, device) for _ in range(repeats))
    return max((t2 - t1) / n, 1e-9)


@dataclasses.dataclass
class BenchResult:
    name: str
    seconds: float
    tflops: float
    roofline_tflops: float
    hbm_gbps: float

    @property
    def roofline_frac(self) -> float:
        return self.tflops / self.roofline_tflops if self.roofline_tflops else 0.0


def _randn(g: torch.Generator, shape, dtype, device) -> torch.Tensor:
    return torch.randn(*shape, generator=g, device=device).to(dtype)


def bench_flash_prefill(
    batch: int = 1,
    num_q_heads: int = 32,
    num_kv_heads: int = 32,
    seq: int = 2048,
    head_dim: int = 128,
    dtype=torch.bfloat16,
    causal: bool = True,
    iters: int = 20,
    device="cuda",
    seed: int = 0,
) -> BenchResult:
    """BASELINE config 2 by default: Llama-2-7B prefill shapes, through
    the port's ``flash_attention``."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = _randn(g, (batch, num_q_heads, seq, head_dim), dtype, device)
    k = _randn(g, (batch, num_kv_heads, seq, head_dim), dtype, device)
    v = _randn(g, (batch, num_kv_heads, seq, head_dim), dtype, device)
    with torch.no_grad():
        secs = time_per_call(
            lambda: flash_attention(q, k, v, causal=causal), device=device,
            inner=max(4, iters // 2),
        )
    flops = attention_flops(batch, num_q_heads, seq, seq, head_dim, causal)
    bytes_ = attention_hbm_bytes(
        batch, num_q_heads, num_kv_heads, seq, seq, head_dim,
        q.element_size(),
    )
    roofline = device_info(device).roofline_attention_tflops(flops, bytes_)
    return BenchResult(
        name=f"flash_prefill b{batch} h{num_q_heads} s{seq} d{head_dim} "
        f"{str(dtype).removeprefix('torch.')}{' causal' if causal else ''}",
        seconds=secs,
        tflops=flops / secs / 1e12,
        roofline_tflops=roofline,
        hbm_gbps=bytes_ / secs / 1e9,
    )


def bench_decode_tokens_per_s(
    batch: int = 8,
    num_q_heads: int = 32,
    num_kv_heads: int = 8,
    head_dim: int = 128,
    context: int = 4096,
    page_size: int = 128,
    kv_quant: Optional[str] = "int8",
    pages_per_compute_block: int = 8,
    iters: int = 20,
    fp_dtype=torch.float32,
    window: Optional[int] = None,
    device="cuda",
    seed: int = 0,
):
    """BASELINE config 3 by default: Llama-3-8B GQA decode, int8 KV, 4K
    context, through the port's ``paged_attention``. ``kv_quant`` is a
    page tier (int8, int4, ...) or None; ``fp_dtype`` sets the
    unquantized page payload. ``window`` benches sliding-window decode:
    the kernel starts its walk at the window's first block, and the GB/s
    figure counts only attended bytes. Returns (tokens_per_second,
    seconds_per_step, hbm_gbps)."""
    from tpu_flash_torch.ops.decode import paged_attention
    from tpu_flash_torch.ops.quant import quantize_pages

    pages_per_seq = context // page_size
    num_pages = batch * pages_per_seq + 1
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (num_kv_heads, num_pages, page_size, head_dim)
    k_pages = _randn(g, shape, torch.float32, device)
    v_pages = _randn(g, shape, torch.float32, device)
    if kv_quant:
        k_pages = quantize_pages(k_pages, kv_quant)
        v_pages = quantize_pages(v_pages, kv_quant)
    else:
        k_pages, v_pages = k_pages.to(fp_dtype), v_pages.to(fp_dtype)
    page_indices = torch.arange(
        batch * pages_per_seq, dtype=torch.int32, device=device
    ).reshape(batch, pages_per_seq)
    lengths = torch.full((batch,), context, dtype=torch.int32, device=device)
    q = _randn(g, (batch, num_q_heads, head_dim), torch.float32, device)

    def step():
        return paged_attention(
            q, k_pages, v_pages, lengths, page_indices,
            pages_per_compute_block=pages_per_compute_block, window=window,
        )

    with torch.no_grad():
        secs = time_per_call(step, device=device, inner=max(4, iters // 2))
    attended = min(window, context) if window else context
    kv_bytes = kv_cache_bytes(batch * num_kv_heads * attended, head_dim,
                              kv_quant, fp_dtype)
    return batch / secs, secs, kv_bytes / secs / 1e9


def kv_cache_bytes(tokens: int, head_dim: int, kv_quant: Optional[str],
                   fp_dtype=torch.bfloat16) -> float:
    """Bytes of K and V for ``tokens`` (token, kv head) rows of a cache
    tier: the payload (4-bit tiers half a byte an element) and the scales
    (an f32 per token, or int4g32's (scale, zero) pair per 32-group)."""
    from tpu_flash_torch.ops.quant.quantize import int4g32_num_groups

    itemsize = (1 if kv_quant
                else torch.empty((), dtype=fp_dtype).element_size())
    kv_bytes = 2 * tokens * head_dim * itemsize
    if kv_quant in ("int4", "int4g32"):
        kv_bytes /= 2
    if kv_quant == "int4g32":
        kv_bytes += 2 * tokens * 2 * int4g32_num_groups(head_dim) * 4
    elif kv_quant:
        kv_bytes += 2 * tokens * 4
    return kv_bytes


def bench_paged_prefill_chunk(
    batch: int = 1,
    num_q_heads: int = 32,
    num_kv_heads: int = 8,
    head_dim: int = 128,
    hist: int = 8192,
    chunk: int = 512,
    page_size: int = 128,
    kv_quant: Optional[str] = None,
    fp_dtype=torch.bfloat16,
    window: Optional[int] = None,
    iters: int = 32,
    device="cuda",
    seed: int = 0,
):
    """One engine prefill-chunk attention over the paged cache (the
    paged-prefill kernel): a ``chunk``-token chunk over ``hist`` tokens of
    history. ``window``: the kernel starts its history walk at the first
    block the window reaches, so chunk cost should track the window, not
    the history. Returns (seconds_per_chunk, attended_kv_gbps)."""
    from tpu_flash_torch.ops.flash import paged_prefill_attention
    from tpu_flash_torch.ops.quant import quantize_pages

    pages_per_seq = hist // page_size
    num_pages = batch * pages_per_seq + 1
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (num_kv_heads, num_pages, page_size, head_dim)
    k_pages = _randn(g, shape, torch.float32, device)
    v_pages = _randn(g, shape, torch.float32, device)
    if kv_quant:
        k_pages = quantize_pages(k_pages, kv_quant)
        v_pages = quantize_pages(v_pages, kv_quant)
    else:
        k_pages, v_pages = k_pages.to(fp_dtype), v_pages.to(fp_dtype)
    tables = torch.arange(
        batch * pages_per_seq, dtype=torch.int32, device=device
    ).reshape(batch, pages_per_seq)
    q = _randn(g, (batch, num_q_heads, chunk, head_dim), fp_dtype, device)
    ck = _randn(g, (batch, num_kv_heads, chunk, head_dim), fp_dtype, device)
    cv = _randn(g, (batch, num_kv_heads, chunk, head_dim), fp_dtype, device)
    offs = torch.full((batch,), hist, dtype=torch.int32, device=device)

    def step():
        return paged_prefill_attention(
            q, ck, cv, k_pages, v_pages, offs, tables, hist_cap=hist,
            window=window,
        )

    with torch.no_grad():
        secs = time_per_call(step, device=device, inner=max(4, iters // 2))
    attended = min(window, hist) if window else hist
    kv_bytes = kv_cache_bytes(batch * num_kv_heads * attended, head_dim,
                              kv_quant, fp_dtype)
    return secs, kv_bytes / secs / 1e9


def bench_train_step(
    batch: int = 1,
    num_q_heads: int = 32,
    num_kv_heads: int = 32,
    seq: int = 2048,
    head_dim: int = 128,
    dtype=torch.bfloat16,
    causal: bool = True,
    iters: int = 8,
    device="cuda",
    seed: int = 0,
) -> BenchResult:
    """Attention training throughput: the port's ``flash_attention``
    forward and its autograd backward (the backward kernels' dQ, dK, dV)
    of a scalar loss. Useful FLOPs = 3.5x the forward's (forward 2
    matmuls; backward 5: score recompute, dP, dS K, dS^T Q, P^T dO),
    causal halves both."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = _randn(g, (batch, num_q_heads, seq, head_dim), dtype, device)
    k = _randn(g, (batch, num_kv_heads, seq, head_dim), dtype, device)
    v = _randn(g, (batch, num_kv_heads, seq, head_dim), dtype, device)
    for t in (q, k, v):
        t.requires_grad_(True)

    def step():
        with torch.enable_grad():
            loss = flash_attention(q, k, v, causal=causal).float().sum()
            return torch.autograd.grad(loss, (q, k, v))

    seconds = time_per_call(step, device=device, inner=iters)
    causal_frac = 0.5 if causal else 1.0
    fwd_flops = 4 * batch * num_q_heads * seq * seq * head_dim * causal_frac
    flops = 3.5 * fwd_flops
    info = device_info(device)
    roofline = info.peak_bf16_tflops if dtype == torch.bfloat16 else 0.0
    bytes_moved = (2 * (q.numel() + k.numel() + v.numel())
                   * q.element_size() * 2)
    return BenchResult(
        name=f"flash_train b{batch} h{num_q_heads} s{seq} d{head_dim} "
        f"{str(dtype).removeprefix('torch.')}{' causal' if causal else ''}",
        seconds=seconds,
        tflops=flops / seconds / 1e12,
        roofline_tflops=roofline,
        hbm_gbps=bytes_moved / seconds / 1e9,
    )


# -- engine-level benches (configs 6, 10 and 12) ------------------------------


def _engine_model(num_layers, hidden, num_q_heads, num_kv_heads, head_dim,
                  device, seed: int = 0, name: str = "bench-engine"):
    """The engine benches' model (vocab 8192, intermediate 2 x hidden,
    bf16) and its seeded random weights on ``device``."""
    from tpu_flash_torch.models import FlashTransformer, ModelConfig

    cfg = ModelConfig(
        name=name,
        vocab_size=8192,
        hidden_size=hidden,
        num_layers=num_layers,
        num_q_heads=num_q_heads,
        num_kv_heads=num_kv_heads,
        head_dim=head_dim,
        intermediate_size=2 * hidden,
        dtype="bfloat16",
    )
    model = FlashTransformer(cfg, device=device)
    return model, model.init(torch.Generator(device=device).manual_seed(seed))


def _bench_engine(
    num_layers, hidden, num_q_heads, num_kv_heads, head_dim, batch, ctx,
    page_size, kv_dtype, recent_window=None, device="cuda",
    **engine_kwargs
):
    """Shared engine construction for the engine-level benches.
    ``recent_window`` overrides the CacheConfig default (0 disables the
    exact recent ring). ``page_size=None`` leaves the whole cache layout to
    the engine's auto policy (``utils/tuning.py``)."""
    from tpu_flash_torch.core.config import CacheConfig, EngineConfig
    from tpu_flash_torch.engine import InferenceEngine

    model, params = _engine_model(num_layers, hidden, num_q_heads,
                                  num_kv_heads, head_dim, device)
    ring_kw = (
        {} if recent_window is None else {"recent_window": recent_window}
    )
    if page_size is None:  # the auto layout
        cache = CacheConfig(kv_dtype=kv_dtype, **ring_kw)
    else:
        pages_per_seq = -(-ctx // page_size)
        cache = CacheConfig(
            page_size=page_size,
            num_pages=batch * pages_per_seq + 8,
            max_pages_per_seq=pages_per_seq,
            kv_dtype=kv_dtype,
            **ring_kw,
        )
    ecfg = EngineConfig(
        max_batch_size=batch,
        max_seq_len=ctx,
        prefill_chunk=512,
        cache=cache,
        **engine_kwargs,
    )
    return InferenceEngine(model, params, ecfg)


def bench_engine_tokens_per_s(
    num_layers: int = 4,
    hidden: int = 1024,
    num_q_heads: int = 8,
    num_kv_heads: int = 8,
    head_dim: int = 128,
    batch: int = 8,
    prompt_len: int = 512,
    new_tokens: int = 64,
    kv_dtype: str = "int8",
    page_size: int = 128,
    staggered: bool = False,
    fused_mixed_step="auto",
    lora_rank: int = 0,
    lora_count: int = 2,
    max_decode_burst: int = 8,
    device="cuda",
):
    """End-to-end continuous-batching engine throughput (the whole serving
    stack: scheduler, chunked prefill, paged decode, sampling, watchdogs)
    on the host's wall clock. Returns (decode_tokens_per_s, total_wall_s,
    metrics_summary, prefix_stats). Layer count is reduced: scale
    judgments should use per-layer rates.

    ``staggered`` submits arrivals in waves so prefill and decode overlap
    (the regime where ``fused_mixed_step`` merges each step's prefill and
    decode into one dispatch). A warm-up round builds and loads the
    kernels and grows the allocator's caches; the second round is timed.
    ``lora_rank`` > 0 tags the requests in turn with ``lora_count``
    seeded adapters of that rank over every layer and projection (the
    worst case: every projection pays the per-row low-rank products)."""
    import numpy as np

    if lora_rank and lora_count < 1:
        raise ValueError("lora_rank > 0 needs lora_count >= 1 adapters")
    engine = _bench_engine(
        num_layers, hidden, num_q_heads, num_kv_heads, head_dim, batch,
        prompt_len + new_tokens, page_size, kv_dtype, device=device,
        fused_mixed_step=fused_mixed_step,
        max_decode_burst=max_decode_burst,
    )
    vocab = engine.model.config.vocab_size
    host_rng = np.random.default_rng(1)
    lora_names = []
    if lora_rank:
        from tpu_flash_torch.engine.lora import seeded_adapter

        for i in range(lora_count):
            lora_names.append(f"bench-lora-{i}")
            engine.register_lora(lora_names[-1], seeded_adapter(
                engine.model.config, lora_rank, 0.01, host_rng))
    n_submitted = [0]

    def submit_one():
        lora = (lora_names[n_submitted[0] % len(lora_names)]
                if lora_names else None)
        n_submitted[0] += 1
        engine.submit(host_rng.integers(0, vocab, prompt_len).tolist(),
                      max_new_tokens=new_tokens, lora=lora)

    def run_round():
        if not staggered:
            for _ in range(batch):
                submit_one()
            engine.run()
            return
        # Waves: half up front (at least one), the rest arriving while
        # earlier requests decode, so every wave makes mixed prefill and
        # decode steps. Leftovers are submitted if the engine idles early,
        # so the rate's denominator covers all the work.
        first = max(1, batch // 2)
        for _ in range(first):
            submit_one()
        left = batch - first
        while engine.scheduler.has_work() or left:
            if not engine.scheduler.has_work():
                submit_one()
                left -= 1
                continue
            engine.step()
            if left:
                submit_one()
                left -= 1

    run_round()  # warm-up: kernel builds, allocator growth
    engine.metrics = type(engine.metrics)()
    _sync(device)
    t0 = time.perf_counter()
    run_round()
    _sync(device)
    wall = time.perf_counter() - t0
    m = engine.metrics.summary()
    stats = engine.prefix_stats()
    engine.close()
    return batch * new_tokens / wall, wall, m, stats


def bench_engine_device_decode(
    num_layers: int = 4,
    hidden: int = 1024,
    num_q_heads: int = 8,
    num_kv_heads: int = 8,
    head_dim: int = 128,
    batch: int = 8,
    prompt_len: int = 512,
    kv_dtype: str = "int8",
    page_size: int = 128,
    burst: int = 8,
    inner: int = 8,
    max_ctx: int = 1024,
    recent_window=None,
    device="cuda",
):
    """Serving decode throughput on the kernels' time: the engine's own
    burst (``_decode_multi_impl``: every layer's RMSNorm, QKV, cache
    append, paged attention and MLP, then sampling) run ``inner`` times
    under ``utils/profiling.timed``, the kernel time summed over the
    window (on the CPU: the time of PyTorch's ops themselves).

    A real engine and a real prefill make the caches and page tables live
    at full batch occupancy. The engine's lengths and last tokens are
    saved after it and restored before every burst, so each burst
    re-appends the same tokens at the same page offsets and ring slots: a
    steady-state workload that cannot overflow the page pool.

    Returns (decode_tokens_per_s, seconds_per_token, seconds_per_step,
    wall_seconds_per_step, idle_share): the first three on the summed
    kernel time, host excluded; then the host's wall clock per step over
    the traced window and the share of it the device spent idle."""
    import numpy as np

    from tpu_flash_torch.utils.profiling import timed

    engine = _bench_engine(
        num_layers, hidden, num_q_heads, num_kv_heads, head_dim, batch,
        max_ctx, page_size, kv_dtype, recent_window=recent_window,
        device=device,
    )
    vocab = engine.model.config.vocab_size
    host_rng = np.random.default_rng(1)
    for _ in range(batch):
        engine.submit(
            host_rng.integers(0, vocab, prompt_len).tolist(),
            max_new_tokens=max_ctx - prompt_len - 1,
        )
    # Step until every request has cleared prefill (generated >= 1), so
    # the bursts see live caches at full batch occupancy.
    for _ in range(64):
        if engine.scheduler.active and not engine.scheduler.waiting and all(
            r.generated >= 1 for r in engine.scheduler.active.values()
        ):
            break
        engine.step()
    active = torch.from_numpy(engine.active.copy()).to(engine.device)
    lengths, last_tokens = engine.lengths, engine.last_tokens

    def run_bursts(n):
        for _ in range(n):
            engine.lengths, engine.last_tokens = lengths, last_tokens
            engine._decode_multi_impl(burst, active)

    with torch.inference_mode():
        run_bursts(1)  # warm-up: this burst's kernels and caches
        window = timed(lambda: run_bursts(inner), device)
    engine.close()
    steps = inner * burst
    n_active = int(active.sum())
    sec_per_step = max(window.busy / steps, 1e-12)
    return (n_active / sec_per_step, sec_per_step / max(n_active, 1),
            sec_per_step, window.wall / steps, window.idle_share())


def bench_engine_speculative(
    num_layers: int = 4,
    hidden: int = 1024,
    num_q_heads: int = 8,
    num_kv_heads: int = 8,
    head_dim: int = 128,
    batch: int = 4,
    prompt_len: int = 48,
    new_tokens: int = 96,
    kv_dtype: str = "bfloat16",
    spec_k: int = 8,
    mode: str = "self-draft",  # "self-draft" | "prompt-lookup" | "off"
    model_and_params=None,  # e.g. a trained checkpoint (config 12)
    prompts=None,  # token lists; default: random in [0, 8192)
    device="cuda",
):
    """Serving-level speculative decoding. Returns a dict: wall tokens/s,
    engine steps, decode tokens per step, the acceptance rate and the
    outputs.

    Modes:
      * "self-draft": the draft model is the target model, so drafts
        match the target's greedy stream wherever the draft's 64-token
        sliding window sees enough context: the verify machinery near its
        acceptance ceiling (prompt_len stays under the draft window);
      * "prompt-lookup": bigram prompt-lookup drafting on random prompts,
        the low-acceptance regime (speculation's overhead);
      * "off": speculation_k = 0 (plain burst decode, same prompts and
        shapes)."""
    import numpy as np

    from tpu_flash_torch.core.config import CacheConfig, EngineConfig
    from tpu_flash_torch.engine import InferenceEngine

    if model_and_params is not None:
        model, params = model_and_params
    else:
        model, params = _engine_model(num_layers, hidden, num_q_heads,
                                      num_kv_heads, head_dim, device,
                                      name="bench-spec")
    if prompts is not None:
        prompt_len = max(len(p) for p in prompts)
        batch = len(prompts)
    ctx = prompt_len + new_tokens + spec_k + 2
    page_size = 128
    pages_per_seq = -(-ctx // page_size)
    ecfg = EngineConfig(
        max_batch_size=batch,
        max_seq_len=ctx,
        prefill_chunk=64,
        cache=CacheConfig(
            page_size=page_size,
            num_pages=batch * pages_per_seq + 8,
            max_pages_per_seq=pages_per_seq,
            kv_dtype=kv_dtype,
        ),
    )
    draft = (model, params) if mode == "self-draft" else None
    engine = InferenceEngine(model, params, ecfg, draft=draft)
    engine.speculation_k = 0 if mode == "off" else spec_k

    if prompts is None:
        host_rng = np.random.default_rng(7)
        prompts = [
            host_rng.integers(0, model.config.vocab_size, prompt_len)
            .tolist() for _ in range(batch)
        ]

    def run_round():
        ids = [engine.submit(list(p), max_new_tokens=new_tokens)
               for p in prompts]
        engine.run()
        return {i: engine.outputs[i] for i in ids}

    run_round()  # warm-up: every route's kernels (prefill, verify, burst)
    engine.metrics = type(engine.metrics)()
    engine._spec_proposed = 0
    engine._spec_accepted = 0
    _sync(device)
    t0 = time.perf_counter()
    outs = run_round()
    _sync(device)
    wall = time.perf_counter() - t0
    engine.close()
    total = sum(len(v) for v in outs.values())
    m = engine.metrics.summary()
    stats = engine.speculation_stats()
    return {
        "mode": mode,
        "tokens_per_s": total / wall,
        "wall_s": wall,
        "steps": m["steps"],
        "decode_tokens_per_step": (
            m["decode_tokens"] / m["steps"] if m["steps"] else 0.0
        ),
        "acceptance_rate": stats["acceptance_rate"],
        "proposed": stats["proposed"],
        "outputs": outs,
    }
