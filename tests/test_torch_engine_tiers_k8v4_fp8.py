"""The port's engine serving the trained checkpoint from k8v4 and fp8
caches, greedy token for token against the JAX engine: the cases of
``test_torch_engine_tiers.py`` (its layout, prompts, margin rule and
helpers) on the other two new tiers. fp8 history is read from the pages
on the paged route; k8v4 always gathers, as in JAX.
"""

import pytest

from test_torch_engine_tiers import (  # noqa: F401 (fixtures)
    check_tier,
    jax_tokens,
    one_torch_thread,
    trained,
)


@pytest.fixture(scope="module", params=["k8v4", "fp8"])
def tier(request, trained):  # noqa: F811
    return request.param, jax_tokens(trained, request.param)


@pytest.mark.parametrize("paged", [False, True], ids=["gathered", "paged"])
def test_tier_greedy_tokens_match_jax(trained, tier, paged):  # noqa: F811
    kv_dtype, want = tier
    eng = check_tier(trained, want, kv_dtype, paged_prefill=paged)
    assert eng._paged_enabled() == (paged and kv_dtype == "fp8")
