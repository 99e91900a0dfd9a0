"""Draft-model speculation and ``prefix_stats()`` in the port's engine on
CPU, torch only (``tests/test_torch_quality.py`` holds the proposals and
the counts against JAX): with the target itself or a differently seeded
model as the draft, the greedy stream equals the engine's without
speculation, as ``tests/test_speculative.py`` holds the JAX engine's.
"""

import pytest
import torch

from tpu_flash_torch.core.config import CacheConfig, EngineConfig
from tpu_flash_torch.engine import InferenceEngine
from tpu_flash_torch.models import TINY_TEST, FlashTransformer

PROMPT = [3, 14, 15, 9, 2, 6, 11]
CACHE = dict(page_size=8, num_pages=64, max_pages_per_seq=16)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors: the suite
    runs several test workers on a few cores, where each worker's default
    torch thread pool slows such ops tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model_and_params():
    model = FlashTransformer(TINY_TEST, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _engine(model, params, spec_k, draft=None, **config):
    config = {"max_batch_size": 2, "max_seq_len": 256, "prefill_chunk": 64,
              **config}
    eng = InferenceEngine(model, params, EngineConfig(
        cache=CacheConfig(**CACHE), **config), draft=draft)
    eng.speculation_k = spec_k
    return eng


@pytest.fixture(scope="module")
def expected(model_and_params):
    """The greedy stream without speculation, 16 tokens."""
    eng = _engine(*model_and_params, spec_k=0)
    rid = eng.submit(PROMPT, 16)
    return eng.run()[rid]


def test_self_draft_speculation_is_exact(model_and_params, expected):
    """The target as its own draft: the stream is the non-speculative
    one, and the draft model's greedy proposals are mostly accepted."""
    model, params = model_and_params
    spec = _engine(model, params, spec_k=4, draft=(model, params))
    spec.max_decode_burst = 1
    rid = spec.submit(PROMPT, 16)
    assert spec.run()[rid] == expected
    stats = spec.speculation_stats()
    assert stats["proposed"] > 0
    assert stats["acceptance_rate"] >= 0.5, stats
    assert spec.metrics.route_counts()["speculative"] > 0


def test_weak_draft_model_still_exact(model_and_params, expected):
    """A differently seeded draft disagrees often; rejection keeps the
    stream exact whatever the acceptance."""
    model, params = model_and_params
    weak = FlashTransformer(TINY_TEST, device="cpu")
    weak_params = weak.init(torch.Generator().manual_seed(99))
    spec = _engine(model, params, spec_k=4, draft=(weak, weak_params))
    rid = spec.submit(PROMPT, 12)
    assert spec.run()[rid] == expected[:12]
    assert spec.speculation_stats()["proposed"] > 0


def test_draft_batch_pads_rows_and_clips_the_window(model_and_params):
    """Three contexts go to the draft model as one batch of four rows
    (the power-of-two bucket), each its last draft_window tokens
    left-aligned; a pad row drafts too, and only real rows come back."""
    model, params = model_and_params
    eng = _engine(model, params, spec_k=4, draft=(model, params))
    eng.draft_window = 6
    calls = []
    impl = eng._draft_impl

    def spy(k, windows, lengths):
        calls.append((k, windows.clone(), lengths.clone()))
        return impl(k, windows, lengths)

    eng._draft_impl = spy
    contexts = [list(range(1, 11)), [5, 6], [7, 8, 9]]
    with torch.no_grad():
        drafts = eng._propose_drafts(contexts, 3)
    (k, windows, lengths), = calls
    assert k == 3 and windows.shape == (4, 6)
    assert lengths.tolist() == [6, 2, 3, 1]
    assert windows[0].tolist() == list(range(5, 11))
    assert windows[1].tolist() == [5, 6, 0, 0, 0, 0]
    assert len(drafts) == 3 and all(len(d) == 3 for d in drafts)
    # Each draft is the model's greedy continuation of its window.
    with torch.no_grad():
        buf = torch.tensor([[7, 8, 9]])
        for tok in drafts[2]:
            nxt = int(model.forward(params, buf)[0, -1].argmax())
            assert nxt == tok
            buf = torch.cat([buf, torch.tensor([[nxt]])], dim=1)


def test_prompt_lookup_without_a_draft_model(model_and_params):
    model, params = model_and_params
    eng = _engine(model, params, spec_k=4)
    assert eng.draft_model is None
    assert eng._propose_drafts([[1, 2, 3, 1, 2], [4]], 2) == [[3, 1], []]


def test_prefix_stats(model_and_params):
    """prefix_stats() reads the prefix index: a second request sharing
    the first's full pages hits them; with the cache off it reports
    only that."""
    model, params = model_and_params
    eng = _engine(model, params, spec_k=0, max_batch_size=1,
                  prefill_chunk=8)
    assert eng.prefix_stats() == {"enabled": 1.0, "hit_rate": 0.0,
                                  "hits_tokens": 0.0, "misses_tokens": 0.0,
                                  "indexed_pages": 0.0}
    shared = list(range(40, 56))  # two full pages of 8
    eng.submit(shared + [1, 2, 3], 2)
    eng.submit(shared + [4, 5], 2)
    eng.run()
    stats = eng.prefix_stats()
    assert stats["hits_tokens"] == 16.0
    assert stats["misses_tokens"] == 19.0 + 2.0
    assert stats["hit_rate"] == 16.0 / 37.0
    assert stats["indexed_pages"] >= 2.0
    off = _engine(model, params, spec_k=0, prefix_cache=False)
    assert off.prefix_stats() == {"enabled": 0.0}
