"""The order-exact prefill tile (``csrc/prefill_tile.cuh``, shared by the
``paged_prefill`` (K5) and ``ragged_prefill`` (K6) CUDA kernels), read
from its source on the CPU: torch only, no JAX and no card.

A block of the tile holds a window of f32 scores and stages K/V steps in
a ring, and forms P = exp(S - m) only after a TPU block's whole running
max, so the rules here are what a change of its geometry must keep: each
instance fits the card's shared memory (two blocks an SM at d 128), the
TPU kernels' block widths are whole numbers of the tile's steps, and the
wrappers size the tile's rows and score scratch as the source reads
them.
"""

import re

import pytest
import torch

from tpu_flash_torch.core.config import (
    PREFILL_HIST_TOKENS,
    EngineConfig,
    TileSizes,
)
from tpu_flash_torch.ops import build
from tpu_flash_torch.ops.flash import paged_prefill as pp

HEADER = build.CSRC_DIR / "prefill_tile.cuh"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch intra-op thread while this module runs (the suite runs
    several workers on a few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _constants():
    """The header's integer constants (``constexpr int NAME = N;``)."""
    src = HEADER.read_text()
    return {m[1]: int(m[2])
            for m in re.finditer(r"constexpr int (\w+) = (\d+);", src)}


def _smem(c, d, qb, rows):
    """Geo<d, TQ, rows>::SMEM, evaluated from the header's own expression
    for a q dtype of ``qb`` bytes at the header's default step."""
    src = HEADER.read_text()
    expr = " ".join(
        re.search(r"static constexpr int SMEM =\s*([^;]*);", src)[1].split())
    names = dict(c, D=d, QB=qb, R=rows,
                 SW=c["WINDOW_D256"] if d > 128 else c["WINDOW"],
                 BK=c["STEP_F32"] if qb == 4 else c["STEP"])
    return int(eval(expr.replace("/", "//"), {"__builtins__": {}}, names))


def _instances(c):
    """(head width, q dtype bytes, rows) of every instance a call can
    take: both kernels at ROWS, K5's bf16 calls also at ROWS_VERIFY."""
    out = [(d, qb, c["ROWS"]) for d in (128, 256) for qb in (2, 4)]
    return out + [(d, 2, c["ROWS_VERIFY"]) for d in (128, 256)]


def test_tile_fits_the_card_two_blocks_an_sm_at_d128():
    c = _constants()
    for d, qb, rows in _instances(c):
        smem = _smem(c, d, qb, rows)
        assert smem <= c["SMEM_BLOCK"], (d, qb, rows, smem)
        if d == 128:  # 1 KB of an SM's 228 is reserved for each block
            assert 2 * (smem + 1024) <= c["SMEM_SM"], (d, qb, rows, smem)
    # The bf16 chunk instance at d 128: 103,424 bytes, two blocks.
    assert _smem(c, 128, 2, c["ROWS"]) == 103424


def test_wrappers_take_the_tile_geometry():
    c = _constants()
    assert pp.TILE_ROWS == pp.KERNEL_MAX_Q_PER_KV == c["ROWS"]
    assert pp.TILE_ROWS_VERIFY == c["ROWS_VERIFY"]
    assert pp.TILE_WINDOW == {128: c["WINDOW"], 256: c["WINDOW_D256"]}
    assert c["MAX_WINDOWS"] * c["WINDOW_D256"] >= PREFILL_HIST_TOKENS


def _main_path_widths():
    """Every TPU block width the main path's calls give the kernels:
    paged prefill's history blocks and chunk blocks (TileSizes.
    prefill_blocks) at page sizes 32, 128 and 512, for Llama's 4 and
    Gemma-2's 2 q heads a kv head, chunks of the engine's power-of-two
    buckets (9 rows for a verify), history bounds in whole chunks up to
    max_seq_len; and the ragged kernel's kv tile."""
    eng = EngineConfig()
    tiles = TileSizes()
    widths = {("ragged_block_kv", tiles.ragged_block_kv)}
    buckets = [8 << i for i in range(7)] + [9]
    for ps in (32, 128, 512):
        for hist in range(eng.prefill_chunk, eng.max_seq_len + 1,
                          eng.prefill_chunk):
            for g in (4, 2):
                for q_len in buckets:
                    bq, ppb = tiles.prefill_blocks(g, q_len, ps, hist // ps)
                    widths.add((f"history ps {ps}", ppb * ps))
                    widths.add((f"chunk g {g}", bq))
    return sorted(widths)


@pytest.mark.parametrize("step_name", ["STEP", "STEP_F32"])
def test_tpu_blocks_are_whole_numbers_of_tile_steps(step_name):
    """A block's P is formed after its whole max: the tile walks each
    TPU block from its first column in windows and steps, so a step
    never holds columns of two blocks. Every width the main path gives
    is a whole number of steps, or fits in one step."""
    c = _constants()
    step = c[step_name]
    assert c["WINDOW"] % step == 0 and c["WINDOW_D256"] % step == 0
    for name, width in _main_path_widths():
        assert width % step == 0 or width < step, (name, width, step)


def test_scratch_is_sized_for_blocks_wider_than_a_window():
    """tile_scratch: none where every block fits one window; otherwise a
    slot of window scores of the widest block for each thread block the
    card runs at once (no more slots than the grid has blocks), behind
    the slots' flag words, zeroed and padded to 16 bytes."""
    q = torch.zeros(2, 32, 512, 128)
    assert pp.tile_scratch(q, 8, pp.TILE_ROWS, 128, 264) == (None, 0)
    # 512 positions / 16 a block (64 rows / 4 heads), 8 kv heads, b 2:
    # 512 blocks, 264 of them at once; 8 windows of 64 rows x 128 columns.
    s, slots = pp.tile_scratch(q, 8, pp.TILE_ROWS, 1024, 264)
    assert s.dtype == torch.float32 and slots == 264
    assert s.numel() == 264 + 264 * 8 * 64 * 128
    assert not s[:264].any()
    s, slots = pp.tile_scratch(q, 8, pp.TILE_ROWS, 1024, 130)
    assert slots == 130 and s.numel() == 132 + 130 * 8 * 64 * 128
    assert not s[:132].any()
    q256 = torch.zeros(1, 16, 9, 256)
    s, slots = pp.tile_scratch(q256, 8, pp.TILE_ROWS_VERIFY, 128, 264)
    assert slots == 2 * 8  # 9 positions / 8 a block: 2, x 8 kv heads
    assert s.numel() == 16 + 16 * 2 * 16 * 64


def test_short_bf16_calls_take_the_verify_rows():
    """tile_rows: a bf16 call whose 64-row grid leaves SMs idle (the
    speculative verify: b 8 x 9 rows, 8 kv heads = 64 blocks on 132)
    takes 16-row blocks; a chunk, an f32 call or a group wider than 16
    heads keeps 64."""
    verify = torch.zeros(8, 32, 9, 128, dtype=torch.bfloat16)
    chunk = torch.zeros(4, 32, 512, 128, dtype=torch.bfloat16)
    assert pp.tile_rows(verify, 8, sms=132) == pp.TILE_ROWS_VERIFY
    assert pp.tile_rows(chunk, 8, sms=132) == pp.TILE_ROWS
    assert pp.tile_rows(verify.float(), 8, sms=132) == pp.TILE_ROWS
    wide = torch.zeros(1, 32, 9, 128, dtype=torch.bfloat16)
    assert pp.tile_rows(wide, 1, sms=132) == pp.TILE_ROWS
