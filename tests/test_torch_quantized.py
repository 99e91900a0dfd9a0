"""The port's quantized-input attention (K10) and int8 row quantizer (K11),
their plain versions on CPU, against the JAX package.

``flash_attention_quantized`` runs its Pallas kernel in interpret mode
with an explicit ``BlockSizes`` whose ``block_kv`` is the port's 128, so
both walk the same online-softmax steps; inputs are made with numpy from
a seed and quantized by JAX, and the same bytes go to both.

Bars (f32 outputs):
  * tiled routes, 2^-9 of max |v| (dequantized). Scores are exact on both
    sides (int32 dots; e4m3 products sum exactly in the port, in f32 in
    JAX, an f32 ulp apart at most) and every later step rounds alike, but
    XLA's and PyTorch's exp and tanh differ by an ulp now and then, which
    can flip the bf16 rounding of one p * v_scale element: that moves its
    term by 2^-8, and a P element below its row's max holds at most half
    the row's mass, so one output by at most 2^-9 of max |v|;
  * fp8 native and the int8 staircase, 1e-3 of max |ref|: there such an
    ulp can flip an e4m3 level (2^-4 of a term) or an int8 level of P
    (1/127 of the row's largest term) -- rare, and small unless the row
    sees few keys;
  * bf16 outputs, 2 bf16 ulps of max |ref| (an output rounding flips).
Each case's control (its options dropped, or the other route or tier)
must land outside its bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.core.config import BlockSizes
from tpu_flash.ops.flash import quantized as jq
from tpu_flash.ops.quant.quantize import quantize as j_quantize
from tpu_flash.ops.quant.quantize import quantize_pallas as j_quantize_pallas
from tpu_flash_torch.ops.flash import quantized as tq
from tpu_flash_torch.ops.quant import quantize_pallas

B, HQ, HKV, S, D = 1, 4, 2, 256, 128
BS = BlockSizes(block_q=128, block_kv_major=256, block_kv=128)
LEVEL_TOL = 1e-3


def _bar(kind, want, ti):
    """A case's bar (module docstring): "tiled" from max |v|, "level"
    from max |ref|."""
    if kind == "tiled":
        v = tq.dequantize_attention_inputs(ti)[2]
        return 2.0 ** -9 * float(v.abs().max())
    return LEVEL_TOL * float(np.abs(want).max())


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors: the suite
    runs several test workers on a few cores, where each worker's default
    torch thread pool slows such ops tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(seed, hq=HQ, hkv=HKV, s=S, skv=S, d=D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, hq, s, d), dtype=np.float32),
            rng.standard_normal((B, hkv, skv, d), dtype=np.float32),
            rng.standard_normal((B, hkv, skv, d), dtype=np.float32))


def _to_torch(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _bytes(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.float8_e4m3fn:
        t = t.view(torch.uint8)
    return np.ascontiguousarray(t.numpy()).view(np.uint8)


def _both(q, k, v, dtype_name):
    ji = jq.quantize_attention_inputs(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), dtype_name)
    ti = tq.QuantizedAttentionInputs(*[_to_torch(x) for x in ji[:6]],
                                     dtype_name)
    return ji, ti


@pytest.mark.parametrize("dtype_name", ["int8", "fp8"])
def test_quantize_attention_inputs_byte_identical(dtype_name):
    q, k, v = _qkv(0)
    q[0, 1, 3] = 0.0  # an all-zero row takes scale 1
    ji = jq.quantize_attention_inputs(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), dtype_name)
    ti = tq.quantize_attention_inputs(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), dtype_name)
    assert ti.dtype_name == ji.dtype_name
    for j, t in zip(ji[:6], ti[:6]):
        assert tuple(t.shape) == np.asarray(j).shape
        assert np.array_equal(_bytes(t), _bytes(_to_torch(j)))
    qd, kd, vd = tq.dequantize_attention_inputs(ti)
    for j, t in zip(jq.dequantize_attention_inputs(ji), (qd, kd, vd)):
        assert np.array_equal(np.asarray(j), t.numpy())


def _arrays(opts, hq=HQ):
    opts = dict(opts)
    arrays = {}
    if opts.pop("sinks", False):
        arrays["sinks"] = np.linspace(-1.0, 2.0, hq).astype(np.float32)
    if opts.pop("alibi", False):
        arrays["alibi"] = np.linspace(0.5, 0.05, hq).astype(np.float32)
    return opts, arrays


CASES = {  # name: (dtype, options, bar kind, control options)
    "int8-causal": ("int8", dict(causal=True), "tiled",
                    dict(causal=False)),
    "int8-noncausal": ("int8", dict(causal=False), "tiled",
                       dict(causal=True)),
    "int8-noncausal-kv-tail": ("int8", dict(causal=False, kv_len=200),
                               "tiled", dict(causal=False)),
    "int8-causal-kv-tail": ("int8", dict(causal=True, kv_len=200),
                            "tiled", dict(causal=True)),
    "int8-window-softcap": ("int8", dict(causal=True, window=50,
                                         softcap=5.0), "tiled",
                            dict(causal=True)),
    "int8-sinks-alibi": ("int8", dict(causal=True, sinks=True, alibi=True),
                         "tiled", dict(causal=True)),
    "fp8-software-causal": ("fp8", dict(causal=True, fp8_native=False),
                            "tiled", dict(causal=True, fp8_native=True)),
    "fp8-software-noncausal": ("fp8", dict(causal=False, fp8_native=False),
                               "tiled", dict(causal=True,
                                               fp8_native=False)),
    "fp8-native-causal": ("fp8", dict(causal=True, fp8_native=True),
                          "level", dict(causal=True, fp8_native=False)),
    "fp8-native-all-options": ("fp8", dict(causal=True, fp8_native=True,
                                           window=70, softcap=5.0,
                                           sinks=True, alibi=True),
                               "level", dict(causal=True,
                                               fp8_native=True)),
}
# The kernel's other head widths (d 128 elsewhere): int8 causal, and fp8
# native with every option.
WIDTHS = {}
for _d in (64, 256):
    CASES[f"int8-causal-d{_d}"] = CASES["int8-causal"]
    CASES[f"fp8-native-all-options-d{_d}"] = CASES["fp8-native-all-options"]
    WIDTHS.update({f"int8-causal-d{_d}": _d,
                   f"fp8-native-all-options-d{_d}": _d})


@pytest.mark.parametrize("case", list(CASES))
def test_quantized_plain_matches_jax_kernel(case):
    """GQA (4 q / 2 kv heads), 256 tokens, f32 out, d 128 unless the case
    names its width; the JAX kernel's rectangular grid (the triangular one
    has its own case)."""
    dtype_name, opts, kind, control = CASES[case]
    q, k, v = _qkv(1, d=WIDTHS.get(case, D))
    ji, ti = _both(q, k, v, dtype_name)
    opts, arrays = _arrays(opts)
    want = np.asarray(jq.flash_attention_quantized(
        ji, block_sizes=BS, out_dtype=jnp.float32, interpret=True,
        **opts, **{n: jnp.asarray(a) for n, a in arrays.items()}))

    def port(options):
        options, arrs = _arrays(options)
        return tq.flash_attention_quantized(
            ti, out_dtype=torch.float32, **options,
            **{n: torch.from_numpy(a) for n, a in arrs.items()}).numpy()

    bar = _bar(kind, want, ti)
    assert np.abs(port(CASES[case][1]) - want).max() <= bar
    assert np.abs(port(control) - want).max() > bar


def test_quantized_triangular_bf16_out_matches_jax_kernel():
    """The JAX kernel's triangular grid (window, softcap) with bf16 out,
    against the port's (one loop serves both grids)."""
    q, k, v = _qkv(2)
    ji, ti = _both(q, k, v, "int8")
    tri = BlockSizes(block_q=128, block_kv_major=128, block_kv=128,
                     triangular=True)
    opts = dict(causal=True, window=90, softcap=5.0)
    want = np.asarray(jq.flash_attention_quantized(
        ji, block_sizes=tri, interpret=True, **opts).astype(jnp.float32))
    got = tq.flash_attention_quantized(ti, **opts)
    assert got.dtype == torch.bfloat16
    top = np.abs(want).max()
    bar = 2 * 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.abs(got.float().numpy() - want).max() <= bar


def test_quantized_onepass_staircase_matches_jax(monkeypatch):
    """The opt-in int8 staircase at q_len 1024 (two stairs: the second
    merges a 512-column prefix), sinks and ALiBi on; JAX's gate is taken
    on both sides, and the tiled route is far off."""
    taken = []
    real = jq._forward_onepass_quant
    monkeypatch.setattr(jq, "_forward_onepass_quant",
                        lambda *a, **kw: taken.append(1) or real(*a, **kw))
    q, k, v = _qkv(3, hq=2, hkv=1, s=1024, skv=1024)
    ji, ti = _both(q, k, v, "int8")
    opts, arrays = _arrays(dict(causal=True, sinks=True, alibi=True), hq=2)
    bs = BlockSizes(block_q=512, block_kv_major=512, block_kv=512,
                    onepass=True, onepass_diag=512)
    want = np.asarray(jq.flash_attention_quantized(
        ji, block_sizes=bs, out_dtype=jnp.float32, interpret=True, **opts,
        **{n: jnp.asarray(a) for n, a in arrays.items()}))
    assert taken == [1]
    assert tq.onepass_route(True, "int8", True, None, 1024, 1024, 1024)
    tarr = {n: torch.from_numpy(a) for n, a in arrays.items()}
    got = tq.flash_attention_quantized(
        ti, onepass=True, out_dtype=torch.float32, **opts, **tarr).numpy()
    bar = _bar("level", want, ti)
    assert np.abs(got - want).max() <= bar
    tiled = tq.flash_attention_quantized(
        ti, out_dtype=torch.float32, **opts, **tarr).numpy()
    assert np.abs(tiled - want).max() > bar


@pytest.mark.parametrize(
    "onepass,dtype_name,causal,window,q_len,kv_len,taken",
    [
        (True, "int8", True, None, 1024, 1024, True),
        (True, "int8", True, None, 2048, 2048, True),
        (False, "int8", True, None, 1024, 1024, False),
        (True, "fp8", True, None, 1024, 1024, False),
        (True, "int8", False, None, 1024, 1024, False),
        (True, "int8", True, 100, 1024, 1024, False),
        (True, "int8", True, None, 512, 512, False),
        (True, "int8", True, None, 4096, 4096, False),
        (True, "int8", True, None, 1024, 1000, False),
    ],
)
def test_onepass_gate_is_jax_gate(onepass, dtype_name, causal, window,
                                  q_len, kv_len, taken):
    """The staircase serves exactly the calls JAX's gate admits
    (``tpu_flash/ops/flash/quantized.py:592-604``) with the JAX
    ``BlockSizes(onepass=True, onepass_diag=512)``; stored kv = q_len."""
    assert tq.onepass_route(onepass, dtype_name, causal, window, kv_len,
                            q_len, q_len) is taken


def test_quantized_validation_errors_as_jax():
    """JAX's errors for an unaligned length, a window without causal,
    ALiBi without causal, a kv_len out of range, an unknown dtype."""
    q, k, v = _qkv(4, s=100, skv=128)
    ji, ti = _both(q, k, v, "int8")
    with pytest.raises(ValueError, match="q_len"):
        jq.flash_attention_quantized(ji, block_sizes=BS, interpret=True)
    with pytest.raises(ValueError, match="q_len"):
        tq.flash_attention_quantized(ti)
    q, k, v = _qkv(4, s=128, skv=128)
    ji, ti = _both(q, k, v, "int8")
    for kw, match in ((dict(causal=False, window=32), "causal"),
                      (dict(causal=False, alibi=np.ones(HQ, np.float32)),
                       "causal"),
                      (dict(kv_len=200), "kv_len"),
                      (dict(causal=True, softcap=-1.0), "softcap")):
        with pytest.raises(ValueError, match=match):
            jq.flash_attention_quantized(
                ji, block_sizes=BS, interpret=True,
                **{n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
                   for n, a in kw.items()})
        with pytest.raises(ValueError, match=match):
            tq.flash_attention_quantized(
                ti, **{n: torch.from_numpy(a) if isinstance(a, np.ndarray)
                       else a for n, a in kw.items()})
    for quantize_inputs, arr in ((jq.quantize_attention_inputs, jnp.asarray),
                                 (tq.quantize_attention_inputs,
                                  torch.from_numpy)):
        with pytest.raises(ValueError, match="quant dtype"):
            quantize_inputs(arr(q), arr(k), arr(v), "int2")


def test_fp8_native_defaults_off_on_cpu():
    """fp8_native=None resolves to the software tier on the CPU (the
    card multiplies e4m3 natively and defaults to it)."""
    q, k, v = _qkv(5, s=128, skv=128)
    _, ti = _both(q, k, v, "fp8")
    default = tq.flash_attention_quantized(ti, causal=True)
    soft = tq.flash_attention_quantized(ti, causal=True, fp8_native=False)
    native = tq.flash_attention_quantized(ti, causal=True, fp8_native=True)
    assert torch.equal(default, soft)
    assert not torch.equal(default, native)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_pallas_byte_identical_to_jax_eager(dtype):
    """K11's plain version is JAX's eager int8 ``quantize``, byte for
    byte (a zero row included)."""
    rng = np.random.default_rng(6)
    x = 3.0 * rng.standard_normal((2, 4, 64, 128), dtype=np.float32)
    x[1, 2, 5] = 0.0
    want = j_quantize(jnp.asarray(x, getattr(jnp, dtype)), "int8")
    got = quantize_pallas(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype_name == "int8" and got.values.dtype == torch.int8
    assert np.array_equal(np.asarray(want.values), got.values.numpy())
    assert np.array_equal(np.asarray(want.scales), got.scales.numpy())


def test_quantize_pallas_against_jax_pallas_kernel():
    """Against JAX's Pallas kernel (interpret mode, under jit): its
    ``absmax / 127`` becomes a multiply by the reciprocal, so a scale may
    sit one ulp off the IEEE quotient and a value one int8 level off."""
    rng = np.random.default_rng(7)
    x = 3.0 * rng.standard_normal((2, 2, 64, 128), dtype=np.float32)
    want = j_quantize_pallas(jnp.asarray(x), interpret=True)
    got = quantize_pallas(torch.from_numpy(x))
    ws, gs = np.asarray(want.scales), got.scales.numpy()
    assert ws.shape == gs.shape == (2, 2, 64, 1)
    assert np.all(np.abs(ws - gs) <= np.spacing(gs))
    diff = np.abs(np.asarray(want.values, np.int32)
                  - got.values.numpy().astype(np.int32))
    assert diff.max() <= 1 and diff.mean() < 1e-2


def test_quantize_pallas_block_rows_contract():
    """JAX's divisibility error: the flattened row count must be a
    multiple of min(block_rows, rows)."""
    x = np.ones((3, 128, 128), np.float32)
    with pytest.raises(ValueError, match=r"rows \(384\) must divide"):
        j_quantize_pallas(jnp.asarray(x), interpret=True)
    with pytest.raises(ValueError, match=r"rows \(384\) must divide"):
        quantize_pallas(torch.from_numpy(x))
    assert quantize_pallas(torch.from_numpy(x), block_rows=128).values.shape \
        == (3, 128, 128)
