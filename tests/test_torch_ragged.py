"""The port's ragged prefill (its plain version, on CPU) against the JAX
package: ``flash_attention_ragged`` with its Pallas kernel in interpret
mode, given the port's kv tile through ``block_sizes`` so both walk the
same tiles, and the jnp oracle -- per row, causal attention at its own
offset over [live history | chunk].

Bars: against the JAX kernel, summation order only (one bf16 ulp of an
output at most: 2e-2 at these magnitudes; 2e-5 in f32); against the
oracle in f32, 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.core.config import BlockSizes
from tpu_flash.core.reference import reference_gqa_attention
from tpu_flash.ops.flash import flash_attention_ragged as j_ragged
from tpu_flash_torch.ops.flash import flash_attention_ragged

TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2),
       "float32": dict(atol=2e-5, rtol=2e-5)}
B, HQ, HKV, D = 3, 4, 2, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors: the suite
    runs several test workers on a few cores, where each worker's default
    torch thread pool slows such ops tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, q_len, hist_cap, offsets, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HQ, q_len, D), dtype=np.float32)
    k = rng.standard_normal((B, HKV, hist_cap + q_len, D), dtype=np.float32)
    v = rng.standard_normal((B, HKV, hist_cap + q_len, D), dtype=np.float32)
    return q, k, v, np.asarray(offsets, np.int32)


def _options(kw):
    kw = dict(kw)
    out = {}
    if kw.pop("sinks", False):
        out["sinks"] = np.linspace(-1.0, 2.0, HQ).astype(np.float32)
    if kw.pop("alibi", False):
        out["alibi"] = np.linspace(0.5, 0.05, HQ).astype(np.float32)
    return kw, out


def _port(q, k, v, offs, hist_cap, dtype, arrays, **kw):
    tdt = getattr(torch, dtype)
    return flash_attention_ragged(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), torch.from_numpy(offs),
        hist_cap=hist_cap,
        **{n: torch.from_numpy(a) for n, a in arrays.items()}, **kw,
    ).float().numpy()


@pytest.mark.parametrize(
    "dtype,hist_cap,offsets,kw",
    [
        ("bfloat16", 40, (0, 17, 40), dict()),
        ("bfloat16", 48, (5, 48, 30),
         dict(window=13, softcap=5.0, sinks=True, alibi=True)),
        ("float32", 24, (24, 3, 11), dict()),
    ],
    ids=["bf16-mixed-offsets", "window-softcap-sinks-alibi", "f32"],
)
def test_ragged_matches_jax_kernel(dtype, hist_cap, offsets, kw):
    """kv tile 16 over [history | 16-row chunk]: hist_cap 40 ends inside a
    tile, so history and chunk columns share one."""
    q, k, v, offs = _inputs(0, 16, hist_cap, offsets, dtype)
    kw, arrays = _options(kw)
    jdt = getattr(jnp, dtype)
    want = j_ragged(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(offs), hist_cap=hist_cap, interpret=True,
        block_sizes=BlockSizes(block_q=8, block_kv_major=16, block_kv=16),
        **{n: jnp.asarray(a) for n, a in arrays.items()}, **kw,
    )
    got = _port(q, k, v, offs, hist_cap, dtype, arrays, block_kv=16, **kw)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **TOL[dtype])


def _oracle(q, k, v, offs, hist_cap, arrays, **kw):
    rows = []
    for b, off in enumerate(offs.tolist()):
        # [live history | chunk | zeros]: one shape for every row (eager
        # JAX compiles each op once); causal at q_offset = off never
        # reaches the zeros.
        pad = np.zeros_like(k[b:b + 1, :, off:hist_cap])
        kr = np.concatenate([k[b:b + 1, :, :off], k[b:b + 1, :, hist_cap:],
                             pad], axis=2)
        vr = np.concatenate([v[b:b + 1, :, :off], v[b:b + 1, :, hist_cap:],
                             pad], axis=2)
        rows.append(reference_gqa_attention(
            jnp.asarray(q[b:b + 1]), jnp.asarray(kr), jnp.asarray(vr),
            causal=True, q_offset=off,
            **{n: jnp.asarray(a) for n, a in arrays.items()}, **kw,
        ))
    return np.asarray(jnp.concatenate(rows, axis=0))


@pytest.mark.parametrize(
    "case", ["garbage-history", "decode-rows", "window-alibi", "default-tile"]
)
def test_ragged_matches_oracle(case):
    """f32 against the jnp oracle. garbage-history: NaN in every history
    column at or past a row's offset stays out of every sum. decode-rows:
    one-token chunks (fused decode rows) at per-row offsets. default-tile:
    the port's own kv tile over a 200-column buffer."""
    q_len, hist_cap, offsets, kw = 16, 40, (0, 29, 40), {}
    if case == "decode-rows":
        q_len, offsets = 1, (7, 40, 1)
    elif case == "window-alibi":
        kw = dict(window=9, alibi=True)
    elif case == "default-tile":
        hist_cap, offsets = 184, (100, 184, 0)
    q, k, v, offs = _inputs(1, q_len, hist_cap, offsets, "float32")
    kw, arrays = _options(kw)
    want = _oracle(q, k, v, offs, hist_cap, arrays, **kw)
    if case == "garbage-history":
        for b, off in enumerate(offsets):
            k[b, :, off:hist_cap] = np.nan
            v[b, :, off:hist_cap] = np.nan
    tile = {} if case == "default-tile" else dict(block_kv=16)
    got = _port(q, k, v, offs, hist_cap, "float32", arrays, **tile, **kw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL["float32"])
