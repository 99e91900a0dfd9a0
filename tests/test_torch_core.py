"""The port's core layer against the JAX package: the attention oracles,
the softmax merge algebra, the ring-tail oracle, int8 quantization, and
the port's import hygiene.

Inputs are made with numpy from a seed and handed to both packages. The
oracles compute in f32 on both sides, so they agree to f32 rounding
(2e-5, the JAX package's own f32 parity tolerance); int8 payloads and
scales must be byte-identical (both round half to even in f32).
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.core import reference as jref
from tpu_flash.core import softmax as jsm
from tpu_flash.engine.cache import _quantize_rows as j_quantize_rows
from tpu_flash.ops.decode import tail as jtail
from tpu_flash.ops.quant.quantize import dequantize as j_dequantize
from tpu_flash.ops.quant.quantize import quantize as j_quantize
from tpu_flash_torch.core import reference as tref
from tpu_flash_torch.core import softmax as tsm
from tpu_flash_torch.engine.cache import _quantize_rows as t_quantize_rows
from tpu_flash_torch.ops.decode import tail as ttail
from tpu_flash_torch.ops.quant import dequantize as t_dequantize
from tpu_flash_torch.ops.quant import quantize as t_quantize

F32_TOL = dict(atol=2e-5, rtol=2e-5)
REPO = pathlib.Path(__file__).resolve().parents[1]


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize(
    "opts",
    [
        dict(),
        dict(causal=True),
        dict(causal=True, q_offset=5, window=4),
        dict(causal=True, softcap=3.0, sinks=True),
        dict(causal=True, alibi=True, sm_scale=0.3),
    ],
    ids=["plain", "causal", "offset-window", "softcap-sinks", "alibi"],
)
def test_reference_attention_matches_jax(opts):
    rng = np.random.default_rng(0)
    b, h, sq, skv, d = 2, 3, 7, 12, 16
    q, k, v = _rand(rng, b, h, sq, d), _rand(rng, b, h, skv, d), _rand(
        rng, b, h, skv, d
    )
    opts = dict(opts)
    sinks = _rand(rng, h) if opts.pop("sinks", False) else None
    alibi = (np.abs(_rand(rng, h)) * 0.2 if opts.pop("alibi", False)
             else None)

    def as_(x, conv):
        return None if x is None else conv(x)

    j = jref.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        sinks=as_(sinks, jnp.asarray), alibi=as_(alibi, jnp.asarray), **opts,
    )
    t = tref.reference_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        sinks=as_(sinks, torch.from_numpy),
        alibi=as_(alibi, torch.from_numpy), **opts,
    )
    np.testing.assert_allclose(_np(t), np.asarray(j), **F32_TOL)


def test_gqa_decode_gather_and_slopes_match_jax():
    rng = np.random.default_rng(1)
    b, hq, hkv, s, d = 2, 4, 2, 9, 8
    q, k, v = _rand(rng, b, hq, s, d), _rand(rng, b, hkv, s, d), _rand(
        rng, b, hkv, s, d
    )
    j = jref.reference_gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True
    )
    t = tref.reference_gqa_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True,
    )
    np.testing.assert_allclose(_np(t), np.asarray(j), **F32_TOL)

    qd = _rand(rng, b, hq, d)
    lengths = np.array([9, 4], np.int32)
    jd = jref.reference_decode_attention(
        jnp.asarray(qd), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths), window=3, softcap=2.0,
    )
    td = tref.reference_decode_attention(
        torch.from_numpy(qd), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), window=3, softcap=2.0,
    )
    np.testing.assert_allclose(_np(td), np.asarray(jd), **F32_TOL)

    pages = _rand(rng, hkv, 6, 4, d)
    table = np.array([[3, 0], [5, 1]], np.int32)
    np.testing.assert_array_equal(
        _np(tref.gather_pages_to_dense(torch.from_numpy(pages),
                                       torch.from_numpy(table))),
        np.asarray(jref.gather_pages_to_dense(jnp.asarray(pages),
                                              jnp.asarray(table))),
    )
    for n in (8, 12):
        np.testing.assert_array_equal(
            _np(tref.alibi_slopes(n)), np.asarray(jref.alibi_slopes(n))
        )


def test_softmax_merge_algebra_matches_jax():
    rng = np.random.default_rng(2)
    s1, s2 = _rand(rng, 2, 3, 5, 6), _rand(rng, 2, 3, 5, 4)
    v1, v2 = _rand(rng, 2, 3, 6, 8), _rand(rng, 2, 3, 4, 8)
    sinks = _rand(rng, 3)
    ja = jsm.state_from_block(jnp.asarray(s1), jnp.asarray(v1))
    jb = jsm.state_from_block(jnp.asarray(s2), jnp.asarray(v2))
    ta = tsm.state_from_block(torch.from_numpy(s1), torch.from_numpy(v1))
    tb = tsm.state_from_block(torch.from_numpy(s2), torch.from_numpy(v2))
    jm = jsm.merge_softmax_states(ja, jb)
    tm = tsm.merge_softmax_states(ta, tb)
    for jx, tx in zip(jm, tm):
        np.testing.assert_allclose(_np(tx), np.asarray(jx), **F32_TOL)
    np.testing.assert_allclose(
        _np(tsm.finalize(tm)), np.asarray(jsm.finalize(jm)), **F32_TOL
    )
    np.testing.assert_allclose(
        _np(tsm.finalize_with_sinks(tm, torch.from_numpy(sinks))),
        np.asarray(jsm.finalize_with_sinks(jm, jnp.asarray(sinks))),
        **F32_TOL,
    )
    # The identity element merges to the other side unchanged.
    e = tsm.empty_state((2, 3, 5), 8)
    for x, y in zip(tsm.merge_softmax_states(e, ta), ta):
        np.testing.assert_array_equal(_np(x), _np(y))


def test_recent_tail_and_merge_match_jax():
    rng = np.random.default_rng(3)
    b, hq, hkv, w, d = 3, 4, 2, 8, 16
    q = _rand(rng, b, hq, d)
    kr = _rand(rng, b, hkv, w, d)
    vr = _rand(rng, b, hkv, w, d)
    lengths = np.array([5, 13, 8], np.int32)
    quant_len = np.maximum(lengths - w, 0).astype(np.int32)
    alibi = np.abs(_rand(rng, hq)) * 0.1
    jo, jm, jl = jtail.recent_tail_state(
        jnp.asarray(q), jnp.asarray(kr, jnp.bfloat16),
        jnp.asarray(vr, jnp.bfloat16), jnp.asarray(lengths),
        jnp.asarray(quant_len), sm_scale=0.25, softcap=4.0,
        alibi=jnp.asarray(alibi),
    )
    to, tm, tl = ttail.recent_tail_state(
        torch.from_numpy(q), torch.from_numpy(kr).bfloat16(),
        torch.from_numpy(vr).bfloat16(), torch.from_numpy(lengths),
        torch.from_numpy(quant_len), sm_scale=0.25, softcap=4.0,
        alibi=torch.from_numpy(alibi),
    )
    for jx, tx in ((jo, to), (jm, tm), (jl, tl)):
        np.testing.assert_allclose(_np(tx), np.asarray(jx), **F32_TOL)
    o2 = _rand(rng, b, hq, d)
    m2, l2 = _rand(rng, b, hq), np.abs(_rand(rng, b, hq)) + 0.5
    sinks = _rand(rng, hq)
    valid = np.array([True, False, True])
    jmerged = jtail.merge_attention_states(
        jo, jm, jl, jnp.asarray(o2), jnp.asarray(m2), jnp.asarray(l2),
        part1_valid=jnp.asarray(valid), sinks=jnp.asarray(sinks),
    )
    tmerged = ttail.merge_attention_states(
        to, tm, tl, torch.from_numpy(o2), torch.from_numpy(m2),
        torch.from_numpy(l2), part1_valid=torch.from_numpy(valid),
        sinks=torch.from_numpy(sinks),
    )
    np.testing.assert_allclose(_np(tmerged), np.asarray(jmerged), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_quantization_byte_identical(dtype):
    rng = np.random.default_rng(4)
    x = _rand(rng, 5, 3, 32) * 3.0
    x[0, 0] = 0.0  # an all-zero row takes scale 1
    x[1, 1, :4] = [0.5, -0.5, 1.5, 2.5]  # ties at .5 after scaling
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, tq = j_quantize(jx, "int8"), t_quantize(tx, "int8")
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(
        t_dequantize(tq).numpy(), np.asarray(j_dequantize(jq))
    )
    jv, js = j_quantize_rows(jx, "int8")
    tv, ts = t_quantize_rows(tx, "int8")
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    with pytest.raises(ValueError, match="unsupported"):
        t_quantize(tx, "int3")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "tpu_flash_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tpu_flash"), (path, mod)
