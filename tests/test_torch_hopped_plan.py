"""Kernel H1's launch plan (`kernels.hopped_dft.launch_plan`), on the CPU.

The kernel (`csrc/hopped_dft.cu`) gives each block a tile of M start rows
and sweeps the tile's rows in walks c, c + R, c + 2R, ... (c < min(R, M),
rows below M + R), up to 8 sweep rows at once, walk u's m-th row as sweep
row u walk_len + m. The enumeration below restates that layout from the
plan's numbers and holds it, at the JAX test's shapes, the main path's
(a), (d), (e) and windows 262144 and 2^22, to:
- every start row in exactly one tile;
- every boundary row a window reads (its start row q0 and q0 + R) in
  exactly one sweep row of q0's tile, q0 + R the row right after q0's;
- shared memory within the card's 227 KB a block and not growing with R;
- the card filled at (a), (d) and (e) as the H100 readings chose (PERF.md
  section 6): at (a) and (d) one launch and one wave of at most one block an
  SM on at least 90% of the 132 SMs (one block a SM beat the 165 and 176
  blocks of a 132-block floor: 0.0121 against 0.0181 ms at (a)); at (e)
  two launches and at least 132 blocks, two an SM.
"""

import numpy as np
import pytest

from wavespec_tpu_torch.kernels import hopped_dft as kh

SHAPES = [
    (1024, 16, 64, 105), (512, 8, 98, 100), (1024, 48, 21, 80), (1024, 64, 32, 105),
    (8192, 64, 9, 300), (16384, 128, 5, 220),                        # the JAX test's
    (4096, 64, 512, 456), (4096, 16, 4096, 230), (4096, 16, 16384, 230),   # (a), (d), (e)
    *[(262144, hop, nwin, 262144 // 9 + 1) for hop in (16, 48, 64, 128, 200) for nwin in (8, 300)],
    *[(1 << 22, hop, 8, (1 << 22) // 9 + 1) for hop in (16, 48, 64, 128, 200)],
]
MAIN_PATH = {"(a)": (4096, 64, 512, 456), "(d)": (4096, 16, 4096, 230),
             "(e)": (4096, 16, 16384, 230)}


def sweep_rows(r_rows: int, tile: int, walk_len: int) -> dict:
    """Tile row -> (sweep, sweep row) as the kernel lays the sweeps out;
    asserts that no tile row is swept twice."""
    walks = min(r_rows, tile)
    per_sweep = kh.SWEEP // walk_len
    where = {}
    for sw in range(-(-walks // per_sweep)):
        for v in range(kh.SWEEP):
            u, m = divmod(v, walk_len)
            c = sw * per_sweep + u
            i = c + m * r_rows
            if u < per_sweep and c < walks and i < tile + r_rows:
                assert i not in where, f"tile row {i} swept twice"
                where[i] = (sw, v)
    return where


@pytest.mark.parametrize("window, hop, nwin, k_bins", SHAPES)
def test_plan_covers_every_window_once(window, hop, nwin, k_bins):
    lp = kh.launch_plan(window, hop, nwin, k_bins)
    r_rows = window // kh.LANES
    m = lp.tile_rows
    assert m % kh.GROUP == 0 and kh.GROUP <= m <= kh.MAX_TILE
    assert lp.walk_len == (m + r_rows - 1) // r_rows + 1 <= kh.SWEEP
    # every start row in exactly one tile
    q_starts = (nwin - 1) * hop // kh.LANES + 1
    assert lp.tiles == -(-q_starts // m) and (lp.tiles - 1) * m < q_starts <= lp.tiles * m
    assert lp.bin_tiles * kh.BINS >= k_bins > (lp.bin_tiles - 1) * kh.BINS
    assert lp.blocks == lp.tiles * lp.bin_tiles
    # each window's two boundary rows: swept once, in q0's tile, one after the other
    where = sweep_rows(r_rows, m, lp.walk_len)
    q0 = np.arange(nwin, dtype=np.int64) * hop // kh.LANES
    for i in np.unique(q0 % m):
        sw, v = where[int(i)]
        assert where[int(i) + r_rows] == (sw, v + 1)
    # the swept rows are exactly the tile's start rows and their boundary rows
    assert set(where) == set(range(m)) | set(range(r_rows, r_rows + m))
    # shared memory: within the card's, and a function of the tile alone
    snap = kh.snaps(hop, lp.two_pass)
    assert lp.smem_bytes == kh.tile_smem(m, lp.two_pass, snap) <= kh.SMEM_LIMIT


def test_shared_memory_does_not_grow_with_r():
    sizes = {(m, two, snap): kh.tile_smem(m, two, snap)
             for m in range(kh.GROUP, kh.MAX_TILE + 1, kh.GROUP)
             for two in (False, True) for snap in (False, True)}
    assert max(sizes.values()) <= kh.SMEM_LIMIT
    for window in (1024, 4096, 262144, 1 << 22):
        for hop in (16, 64, 200):
            lp = kh.launch_plan(window, hop, 300, 1000)
            assert lp.smem_bytes == sizes[lp.tile_rows, lp.two_pass, kh.snaps(hop, lp.two_pass)]


@pytest.mark.parametrize("label", MAIN_PATH)
def test_main_path_fills_the_card(label):
    lp = kh.launch_plan(*MAIN_PATH[label])
    if label == "(e)":
        assert lp.two_pass and lp.blocks >= kh.SMS
        assert 2 * (lp.smem_bytes + 1024) <= 233472   # two blocks an SM (228 KB an SM)
    else:
        assert not lp.two_pass and 0.9 * kh.SMS <= lp.blocks <= kh.SMS


def test_plan_scales_with_the_batch():
    one = kh.launch_plan(4096, 64, 512, 456)
    four = kh.launch_plan(4096, 64, 512, 456, batch=4)
    assert four.tile_rows >= one.tile_rows and four.blocks >= kh.SMS
    assert four.blocks == 4 * four.tiles * four.bin_tiles
