"""The port's attention-weights debug surface (K12), its plain version on
CPU, against the JAX package's ``attention_weights`` (its Pallas kernel
in interpret mode) and against the port's exact oracle.

Both sides scale q in its own dtype, sum the dot in f32 and normalise by
their own forward's lse, whose f32 sums run in different orders: P
agrees within 4e-6 (a few f32 ulps of values <= 1), the output within
the flash forward's bars (2e-5 in f32, one bf16 ulp at these magnitudes
in bf16). Against the oracle (f32 inputs) P agrees within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.ops.flash.debug import attention_weights as j_weights
from tpu_flash_torch.core.reference import reference_attention
from tpu_flash_torch.ops.flash import attention_weights, weights_plain

B, HQ, HKV, D = 1, 4, 2, 64
P_TOL = 4e-6
O_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors: the suite
    runs several test workers on a few cores, where each worker's default
    torch thread pool slows such ops tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, q_len=128, kv_len=128, d=D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, HQ, q_len, d), dtype=np.float32),
            rng.standard_normal((B, HKV, kv_len, d), dtype=np.float32),
            rng.standard_normal((B, HKV, kv_len, d), dtype=np.float32))


def _options(kw):
    kw = dict(kw)
    arrays = {}
    if kw.pop("sinks", False):
        arrays["sinks"] = np.linspace(-1.0, 2.0, HQ).astype(np.float32)
    if kw.pop("alibi", False):
        arrays["alibi"] = np.linspace(0.5, 0.05, HQ).astype(np.float32)
    return kw, arrays


CASES = {  # name: (dtype, options, q_len, stored kv)
    "f32-causal": ("float32", dict(causal=True), 128, 128),
    "f32-noncausal": ("float32", dict(causal=False), 128, 128),
    "bf16-causal-gqa-scale": ("bfloat16", dict(causal=True, sm_scale=0.3),
                              128, 128),
    "f32-window-softcap": ("float32", dict(causal=True, window=40,
                                           softcap=5.0), 128, 128),
    "bf16-alibi": ("bfloat16", dict(causal=True, alibi=True), 128, 128),
    "f32-sinks": ("float32", dict(causal=True, sinks=True), 128, 128),
    "bf16-offset-kv-tail": ("bfloat16", dict(causal=True, q_offset=64,
                                             kv_len=180), 128, 256),
    # Gemma-2's head width (the kernel's d 256 instance): a sliding layer.
    "f32-window-softcap-d256": ("float32", dict(causal=True, window=40,
                                                softcap=50.0), 128, 128),
}
WIDTHS = {"f32-window-softcap-d256": 256}  # d 64 unless named here


@pytest.mark.parametrize("case", list(CASES))
def test_weights_match_jax(case):
    dtype, kw, q_len, skv = CASES[case]
    q, k, v = _inputs(0, q_len, skv, WIDTHS.get(case, D))
    kw, arrays = _options(kw)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jo, jp = j_weights(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        interpret=True, **kw,
        **{n: jnp.asarray(a) for n, a in arrays.items()})
    to, tp = attention_weights(
        torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td), **kw,
        **{n: torch.from_numpy(a) for n, a in arrays.items()})
    assert tp.dtype == torch.float32
    assert tuple(tp.shape) == np.asarray(jp).shape
    assert np.abs(tp.numpy() - np.asarray(jp)).max() <= P_TOL
    assert np.abs(to.float().numpy()
                  - np.asarray(jo, np.float32)).max() <= O_TOL[dtype]
    sums = tp.sum(-1)
    if "sinks" in arrays:
        assert float(sums.max()) < 1.0  # the sink takes the rest
    else:
        assert torch.allclose(sums, torch.ones_like(sums), atol=1e-5)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True,
                                                        sinks=True,
                                                        alibi=True)],
                         ids=["causal", "sinks-alibi"])
def test_weights_match_oracle(kw):
    """P against the oracle's weights (kv heads repeated for GQA)."""
    q, k, v = _inputs(1)
    kw, arrays = _options(kw)
    t = {n: torch.from_numpy(a) for n, a in arrays.items()}
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    _, w = attention_weights(qt, kt, vt, **kw, **t)
    rep = HQ // HKV
    _, want = reference_attention(
        qt, kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1),
        return_weights=True, **kw, **t)
    assert (w - want).abs().max() <= 1e-5


def test_weights_plain_zero_for_rows_that_see_nothing():
    """An lse of -inf (a row that saw no key) gives P = 0, not NaN."""
    q, k, _ = (torch.from_numpy(x) for x in _inputs(2, 16, 16))
    lse = torch.zeros(B, HQ, 16)
    lse[:, :, 3] = -torch.inf
    w = weights_plain(q, k, lse, causal=False, sm_scale=0.125)
    assert torch.isfinite(w).all()
    assert float(w[:, :, 3].abs().max()) == 0.0
