"""The port's quality gate (``tpu_flash_torch/bench/quality.py``), its
engine's ``prefix_stats()`` and its draft-model proposals against the JAX
package on CPU: ``_rates`` on fixed token lists; ``generate_greedy`` on
the bf16 and int8 tiers on checkpoints/tiny-byte-llama, token for token,
with the prefix cache's counts after the same shared-prefix requests; the
draft model's proposals (the f32-loaded checkpoint drafting for itself)
against JAX ``_propose_drafts``.

Two JAX engine runs (one a tier, shared through a module fixture) and
one JAX draft compile.
"""

import os

import numpy as np
import pytest
import torch

from tpu_flash.bench import quality as j_quality
from tpu_flash.checkpoint.convert import load_hf_dir as j_load_hf_dir
from tpu_flash.core.config import CacheConfig as JCacheConfig
from tpu_flash.core.config import EngineConfig as JEngineConfig
from tpu_flash.engine import runner as j_runner
from tpu_flash_torch import engine as t_engine
from tpu_flash_torch.bench import quality
from tpu_flash_torch.checkpoint import load_hf_dir
from tpu_flash_torch.core.config import CacheConfig, EngineConfig

CKPT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "checkpoints", "tiny-byte-llama")
# bf16: two requests sharing a 32-byte prefix: the second is admitted
# after the first's first chunk has indexed that page, so the prefix
# cache hits (the engine matches whole prefill chunks) and its second
# chunk attends the shared page (paged prefill). int8: two prompts of one
# chunk each (the JAX engine's paged-prefill compile is a third of a
# run's time).
PREFIX = list(b"def attention(q, k, v):\n    s = ")
PROMPTS = {"bfloat16": [PREFIX + list(b"q @"), PREFIX + list(b"k.T")],
           "int8": [list(b"import numpy as np\n"), list(b"x = [i * 2")]}
HITS = {"bfloat16": 32.0, "int8": 0.0}
GEOMETRY = dict(page_size=32, max_seq_len=64, prefill_chunk=32,
                max_batch_size=2)
NEW_TOKENS = 4
TIERS = tuple(PROMPTS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors: the suite
    runs several test workers on a few cores, where each worker's default
    torch thread pool slows such ops tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _recording(base, seen):
    """A subclass of the engine class ``base`` that appends each instance
    to ``seen``."""
    class Recording(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)
    return Recording


def _greedy(module, attr, gen, model, params, kv_dtype):
    """``gen``'s tokens for the tier's PROMPTS at GEOMETRY, with the
    prefix stats of the engine it built (the engine class patched on
    ``module``)."""
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, attr, _recording(getattr(module, attr), seen))
        out = gen(model, params, PROMPTS[kv_dtype], NEW_TOKENS, kv_dtype,
                  **GEOMETRY)
    return out, seen[0].prefix_stats()


@pytest.fixture(scope="module")
def jax_greedy():
    """The JAX engine's greedy tokens and prefix stats on each tier."""
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    jm, jp = j_load_hf_dir(CKPT, dtype="bfloat16")
    return {dt: _greedy(j_runner, "InferenceEngine",
                        j_quality.generate_greedy, jm, jp, dt)
            for dt in TIERS}


@pytest.mark.parametrize("ref,got", [
    ([1, 2, 3, 4], [1, 2, 3, 4]),
    ([1, 2, 3, 4], [1, 2, 9, 4]),
    ([1, 2, 3, 4], [9, 2, 3, 4]),
    ([1, 2, 3], [1, 2, 3, 4, 5]),
    ([5, 6, 7, 8, 9], [5, 6]),
    ([], []),
    ([], [1]),
])
def test_rates_equal_jax(ref, got):
    assert quality._rates(ref, got) == j_quality._rates(ref, got)


@pytest.mark.parametrize("kv_dtype", TIERS)
def test_generate_greedy_and_prefix_stats_equal_jax(jax_greedy, kv_dtype):
    """The port's generate_greedy gives the JAX engine's tokens on the
    trained checkpoint, and its engine's prefix_stats() the JAX engine's
    counts (on bf16 the second request hits the shared page)."""
    tm, tp = load_hf_dir(CKPT, dtype="bfloat16", device="cpu")
    got, stats = _greedy(t_engine, "InferenceEngine",
                         quality.generate_greedy, tm, tp, kv_dtype)
    want, jstats = jax_greedy[kv_dtype]
    assert got == want
    assert all(len(o) == NEW_TOKENS for o in got)
    assert stats == jstats
    assert stats["enabled"] == 1.0
    assert stats["hits_tokens"] == HITS[kv_dtype]


def test_quant_quality_report_scores_tiers():
    """quant_quality_report on the trained checkpoint: one row a tier,
    rates from _rates against the bf16 engine, generate_greedy refusing a
    device other than the model's."""
    tm, tp = load_hf_dir(CKPT, dtype="bfloat16", device="cpu")
    report = quality.quant_quality_report(
        tm, tp, PROMPTS["bfloat16"], max_new_tokens=NEW_TOKENS,
        kv_dtypes=("bfloat16", "int8"), **GEOMETRY)
    assert report["bfloat16"] == {"prefix_match": 1.0,
                                  "positionwise_match": 1.0,
                                  "n_tokens": 2.0 * NEW_TOKENS}
    assert 0.0 <= report["int8"]["prefix_match"] <= 1.0
    with pytest.raises(ValueError, match="model's device"):
        quality.generate_greedy(tm, tp, PROMPTS["int8"], 1, device="meta")


def test_draft_model_proposals_equal_jax():
    """The f32-loaded checkpoint drafting for itself: the port's
    _propose_drafts (three contexts, padded to four rows; one shorter
    than the 64-token window, one longer) gives JAX _propose_drafts'
    tokens."""
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    contexts = [list(b"import numpy as np\nimport torch\n"),
                list(b"def f(x):\n    return"),
                list(b"for i in range(10):\n    print(i)\n" * 3)]
    k = 5
    jm, jp = j_load_hf_dir(CKPT, dtype="float32")
    cache = dict(page_size=32, num_pages=10, max_pages_per_seq=4)
    jeng = j_runner.InferenceEngine(
        jm, jp, JEngineConfig(max_batch_size=4, max_seq_len=128,
                              cache=JCacheConfig(**cache)),
        interpret=True, draft=(jm, jp))
    want = jeng._propose_drafts(contexts, k)
    jeng.close()
    tm, tp = load_hf_dir(CKPT, dtype="float32", device="cpu")
    eng = t_engine.InferenceEngine(
        tm, tp, EngineConfig(max_batch_size=4, max_seq_len=128,
                             cache=CacheConfig(**cache)), draft=(tm, tp))
    assert eng.draft_window == 64
    with torch.no_grad():
        got = eng._propose_drafts(contexts, k)
    eng.close()
    assert got == want
    assert [len(d) for d in got] == [k] * len(contexts)
    assert np.unique(np.asarray(got)).size > 1
