"""The port's engine at its defaults -- paged chunk prefill, the ragged
mixed-stage dispatch, fused mixed steps and prompt-lookup speculative
decoding -- against the JAX engine at its defaults, and against the
cache-free greedy loop.

One scenario reaches every route: a 96-byte repetitive code prompt is
submitted and the engine steps once (a same-stage prefill group); then a
short prompt arrives, so the next step carries chunks at two stages (the
ragged dispatch), the one after a final chunk beside a decoding slot (a
fused step), and decode with both requests in takes speculative steps.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tpu_flash.checkpoint.convert import load_hf_dir as j_load_hf_dir
from tpu_flash.core.config import CacheConfig as JCacheConfig
from tpu_flash.core.config import EngineConfig as JEngineConfig
from tpu_flash.engine.runner import InferenceEngine as JEngine
from tpu_flash_torch.checkpoint import load_hf_dir
from tpu_flash_torch.core.config import CacheConfig, EngineConfig
from tpu_flash_torch.engine import InferenceEngine, SamplingParams
from tpu_flash_torch.models import TINY_TEST, FlashTransformer

CKPT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "checkpoints", "tiny-byte-llama")
CACHE = dict(page_size=32, num_pages=12, max_pages_per_seq=4,
             kv_dtype="int8", recent_window=32)
ENGINE = dict(max_batch_size=2, max_seq_len=128, prefill_chunk=32)
PROMPT_A = list(b"for i in range(10):\n    print(i)\nfor i in range(10):\n"
                b"    print(i)\nfor i in range(10):\n    print(")
PROMPT_B = list(b"import numpy as np\n")
# New tokens per request: both speculative steps verify 9-row drafts and
# both requests end in one 8-step burst, so the JAX engine compiles each
# of its dispatch shapes once (its interpret-mode compiles are most of
# this module's time).
NEW_TOKENS = (11, 13)
JAX_ROUTES = (("_run_prefill_group", "prefill_group"),
              ("_run_prefill_ragged", "prefill_ragged"),
              ("_run_decode", "decode"), ("_run_speculative", "speculative"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny CPU tensors: the suite
    runs several test workers on a few cores, where each worker's default
    torch thread pool slows such ops tens of times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _serve_scenario(eng, prompts, new_tokens, sampling=None):
    """Submit the first prompt, step once, submit the second, run;
    ``new_tokens`` per prompt. Returns (outputs, logprobs)."""
    extra = {} if sampling is None else dict(sampling=sampling)
    ids = [eng.submit(prompts[0], new_tokens[0], **extra)]
    eng.step()
    ids.append(eng.submit(prompts[1], new_tokens[1], **extra))
    eng.run()
    return [eng.outputs[i] for i in ids], [eng.logprobs[i] for i in ids]


def _log_jax_dispatches(eng):
    """The JAX engine's dispatches by route, named as the port's
    ``EngineMetrics.dispatches`` names them (the JAX engine keeps no such
    log): a ragged dispatch with decode rows is "fused", and a decode call
    that verifies drafts is "speculative"."""
    log = []
    for name, route in JAX_ROUTES:
        fn = getattr(eng, name)

        def traced(*args, _fn=fn, _route=route, **kw):
            if _route == "speculative":
                log[-1] = _route  # called from the decode call just logged
            elif _route == "prefill_ragged" and (
                    kw.get("decode_slots") or args[1:2] and args[1]):
                log.append("fused")
            else:
                log.append(_route)
            return _fn(*args, **kw)

        setattr(eng, name, traced)
    return log


@pytest.fixture(scope="module")
def jax_default_run():
    """The JAX engine at its defaults (paged prefill, fused steps,
    speculation_k 8) on the trained checkpoint, int8 cache + 32-token
    ring, once for the module."""
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    jm, jp = j_load_hf_dir(CKPT, dtype="bfloat16")
    eng = JEngine(jm, jp, JEngineConfig(cache=JCacheConfig(**CACHE),
                                        **ENGINE), interpret=True)
    routes = _log_jax_dispatches(eng)
    out, logps = _serve_scenario(eng, [PROMPT_A, PROMPT_B], NEW_TOKENS)
    stats = eng.speculation_stats()
    eng.close()
    return (out, logps, routes), stats


@pytest.mark.parametrize("paged_prefill", ["auto", False],
                         ids=["defaults", "paged_prefill-False"])
def test_default_routing_matches_jax(jax_default_run, paged_prefill):
    """The port at its defaults gives the JAX engine's tokens, route
    sequence and speculation counts, with log-probs within 0.05 (bf16
    logits, summation order); with paged_prefill=False (the ragged kernel
    and the gathered verify) the same tokens and routes."""
    (jout, jlogps, jroutes), jstats = jax_default_run
    assert {"prefill_group", "prefill_ragged", "fused",
            "speculative"} <= set(jroutes)
    assert jstats["proposed"] > 0
    model, params = load_hf_dir(CKPT, dtype="bfloat16", device="cpu")
    eng = InferenceEngine(model, params, EngineConfig(
        cache=CacheConfig(**CACHE), paged_prefill=paged_prefill, **ENGINE))
    assert eng.speculation_k == 8
    out, logps = _serve_scenario(eng, [PROMPT_A, PROMPT_B], NEW_TOKENS)
    assert out == jout, [bytes(o) for o in out + jout]
    m = eng.metrics
    assert m.dispatches == jroutes
    assert set(m.route_seconds) == set(m.dispatches)
    # Every prompt token is counted once, by the route that prefilled it.
    assert sum(m.route_tokens[r] for r in (
        "prefill_group", "prefill_ragged", "fused"
    )) == m.prefill_tokens == len(PROMPT_A) + len(PROMPT_B)
    assert eng.speculation_stats() == jstats
    if paged_prefill == "auto":
        np.testing.assert_allclose(np.concatenate(logps),
                                   np.concatenate(jlogps), atol=0.05)
    eng.close()


def _tiny(variant):
    cfg = dataclasses.replace(TINY_TEST, **variant)
    model = FlashTransformer(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    if cfg.attn_sinks:
        for i, layer in enumerate(params["layers"]):
            layer["sinks"] = torch.linspace(-1.0, 1.0, cfg.num_q_heads) * i
    return model, params


def _greedy_loop(model, params, prompt, n):
    seq = list(prompt)
    for _ in range(n):
        logits = model.forward(params, torch.tensor([seq]))
        seq.append(int(logits[0, -1].argmax()))
    return seq[len(prompt):]


def _tiny_prompts(model, params):
    """A 19-token prompt with its last token and its first greedy token
    planted at some early position i, i + 1 (the first where the first
    greedy token stays put once planted), so prompt lookup drafts from
    i + 2 on; a 5-token prompt."""
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, 19).tolist()
    for i in range(2, 12):
        a = list(base)
        for _ in range(4):
            a[i:i + 2] = [a[-1], _greedy_loop(model, params, a, 1)[0]]
        if a[i + 1] == _greedy_loop(model, params, a, 1)[0]:
            return [a, rng.integers(0, 256, 5).tolist()]
    raise AssertionError("no planting position keeps the first token")


def _tiny_engine(model, params, **kw):
    return InferenceEngine(model, params, EngineConfig(
        max_batch_size=2, max_seq_len=48, prefill_chunk=8,
        max_decode_burst=3,
        cache=CacheConfig(page_size=4, num_pages=25, max_pages_per_seq=12,
                          kv_dtype="float32", recent_window=0), **kw))


@pytest.mark.parametrize("paged_prefill", ["auto", False],
                         ids=["paged", "gathered"])
@pytest.mark.parametrize(
    "variant",
    [dict(), dict(sliding_window=6, attn_softcap=8.0, attn_sinks=True),
     dict(attn_alibi=True)],
    ids=["plain", "window-softcap-sinks", "alibi"],
)
def test_routes_match_cache_free_greedy_loop(variant, paged_prefill):
    """On an f32 model every route -- paged (or gathered) chunk prefill,
    the ragged dispatch, a fused step, speculative verify -- gives the
    tokens of re-running the whole sequence through the model at every
    step, with no cache at all."""
    model, params = _tiny(variant)
    prompts = _tiny_prompts(model, params)
    eng = _tiny_engine(model, params, paged_prefill=paged_prefill)
    out, _ = _serve_scenario(eng, prompts, (7, 7))
    routes = eng.metrics.dispatches
    assert {"prefill_group", "prefill_ragged", "fused",
            "speculative"} <= set(routes), routes
    assert eng.speculation_stats()["proposed"] > 0
    for got, prompt in zip(out, prompts):
        assert got == _greedy_loop(model, params, prompt, 7)


def _spec_logits(seed, b, k, vocab):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, k + 1, vocab)).astype(np.float32) * 3
    top = logits.argmax(-1)
    # Drafts that follow the argmax for a seeded number of positions, then
    # miss it; per-row real lengths 0..k.
    draft = rng.integers(0, vocab, (b, k))
    for r in range(b):
        n = rng.integers(0, k + 1)
        draft[r, :n] = top[r, :n]
    draft_len = rng.integers(0, k + 1, b)
    return logits, draft, draft_len


@pytest.mark.parametrize("mixed", [False, True], ids=["all-greedy", "mixed"])
def test_speculative_sample_greedy_rows_match_jax(mixed):
    """Greedy rows give JAX's tokens and counts on the same logits and
    drafts (padded to a common k by draft_len), whether the batch is all
    greedy (the argmax shortcut) or shares the call with sampled rows."""
    import jax
    import jax.numpy as jnp

    from tpu_flash.engine.sampling import speculative_sample as j_spec
    from tpu_flash_torch.engine.sampling import speculative_sample

    b, k, vocab = 6, 5, 40
    logits, draft, draft_len = _spec_logits(4, b, k, vocab)
    odd = np.arange(b) % 2 == 1
    temps = np.where(odd & mixed, 0.9, 0.0).astype(np.float32)
    tok, n = speculative_sample(
        torch.from_numpy(logits), torch.from_numpy(draft),
        torch.Generator().manual_seed(0), torch.from_numpy(temps),
        torch.zeros(b, dtype=torch.int64), torch.ones(b),
        torch.from_numpy(draft_len),
    )
    jt, jn = jax.jit(jax.vmap(
        lambda lg, d, key, dl: j_spec(lg, d, key, jnp.float32(0.0),
                                      jnp.int32(0), jnp.float32(1.0), dl)
    ))(jnp.asarray(logits), jnp.asarray(draft, jnp.int32),
       jax.random.split(jax.random.PRNGKey(0), b),
       jnp.asarray(draft_len, jnp.int32))
    jt, jn = np.asarray(jt), np.asarray(jn)
    for r in np.flatnonzero(temps <= 0):
        assert int(n[r]) == jn[r]
        assert tok[r, :jn[r]].tolist() == jt[r, :jn[r]].tolist()


def test_speculative_sample_never_emits_a_zero_probability_draft():
    """A draft token that top_k filters out (probability 0) is rejected at
    once in every row, and the correction never re-emits it."""
    from tpu_flash_torch.engine.sampling import speculative_sample

    b, vocab = 512, 8
    logits = torch.tensor([[3.0, 2.0, 1.0, 0.0, -1.0, -2.0, -3.0, -4.0]] * 3)
    draft = torch.tensor([[7, 0]] * b)
    tok, n = speculative_sample(
        logits.expand(b, 3, vocab), draft, torch.Generator().manual_seed(1),
        torch.full((b,), 1.0), torch.full((b,), 4), torch.ones(b),
    )
    assert bool((n == 1).all())
    assert bool((tok[:, 0] != 7).all()) and bool((tok[:, 0] < 4).all())


def test_speculative_sample_first_token_follows_filtered_softmax():
    """With a fixed low-probability draft, the first emitted token over
    4096 draws follows the filtered (temperature 0.7, top_k 4) softmax:
    each frequency within 0.03 of its probability (its standard error
    here is at most 0.008, so the bar is ~4 of them)."""
    from tpu_flash_torch.engine.sampling import (
        filtered_logits,
        speculative_sample,
    )

    b, vocab = 4096, 6
    row = torch.tensor([1.0, 0.5, 0.0, -0.2, -1.0, 2.0])
    logits = row.expand(b, 2, vocab).contiguous()
    params = (torch.full((b,), 0.7), torch.full((b,), 4), torch.ones(b))
    tok, _ = speculative_sample(logits, torch.full((b, 1), 2),
                                torch.Generator().manual_seed(2), *params)
    target = torch.softmax(filtered_logits(
        row[None], *(p[:1] for p in params)), dim=-1)[0]
    freq = torch.bincount(tok[:, 0], minlength=vocab).float() / b
    np.testing.assert_allclose(freq.numpy(), target.numpy(), atol=0.03)


def test_find_draft_matches_jax():
    """Prompt lookup proposes JAX's drafts on seeded contexts over a small
    vocabulary (so bigrams repeat), for several k."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        ctx = rng.integers(0, 6, rng.integers(0, 40)).tolist()
        k = int(rng.integers(0, 10))
        assert (InferenceEngine._find_draft(ctx, k)
                == JEngine._find_draft(ctx, k))


def test_top_k_1_speculation_equals_plain_decoding():
    """Sampling at temperature 0.8 with top_k 1 is deterministic, so the
    speculative engine must give the stream of the engine without
    speculation -- the greedy stream."""
    model, params = _tiny(dict())
    prompts = _tiny_prompts(model, params)
    top1 = SamplingParams(temperature=0.8, top_k=1)
    streams = []
    for k in (8, 0):
        eng = _tiny_engine(model, params)
        eng.speculation_k = k
        out, _ = _serve_scenario(eng, prompts, (7, 7), sampling=top1)
        assert ("speculative" in eng.metrics.dispatches) == (k > 0)
        streams.append(out)
    assert streams[0] == streams[1]
    assert streams[0] == [_greedy_loop(model, params, p, 7) for p in prompts]
