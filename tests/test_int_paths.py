"""Exactness of the integer device paths against numpy references.

These paths are exact only because their arithmetic is integer (or, for
the rANS division, because an f32 estimate is corrected to the exact
quotient).  The same checks run on the card at 8 MB-block shapes in
`chip_smoke.py --only ints`; here they run at small shapes on the CPU.
"""
import numpy as np
import pytest

import chip_smoke as S
from dsrc_tpu.ops import rans as R
from dsrc_tpu.parallel import uniform_pipeline as UP


@pytest.mark.parametrize("read_len", [100, 101, 150, 251])
def test_pack_dna_matches_numpy(read_len):
    """2-bit pack + exception bitmap + unpack, with padding rows past
    num_rec, for read lengths that are and are not multiples of 4 and of
    32 (the bitmap word width)."""
    num_rec = 301
    seq = S.random_seq(512, read_len, num_rec, seed=read_len)
    S.check_pack_dna(seq, num_rec)


def test_div_u32_exact_on_edge_operands():
    """Every f in [1, 2^14) with x at the edges of the encoder's range
    (0, 1, f - 1, f, f + 1, (f << 18) - 1, ...) plus random x."""
    x, f = S.div_operands(16, seed=3)
    assert x.size == 16 * (R.M - 1)
    S.check_div(R._div_u32, x, f)


def test_hist_update_both_branches_match_bincount():
    """One-hot matmul branch (<= 512*512 bins) and scatter branch, with a
    masked tail and scattered inactive ids."""
    rng = np.random.default_rng(1)
    n = 30000
    live = (np.arange(n) < n - 1234) & (rng.random(n) < 0.9)
    for nbins in (1 << 12, 1 << 18, 1 << 20):
        ids = rng.integers(0, nbins, n).astype(np.int32)
        S.check_hist_update(ids, live, nbins)


@pytest.mark.parametrize("nsym,cols", [(UP.QUAL_A, 37), (UP.VAL_A, 5)])
def test_pos_hist_matches_bincount_with_masked_tail(nsym, cols):
    rng = np.random.default_rng(nsym)
    mat = rng.integers(0, nsym, (768, cols)).astype(np.int32)
    S.check_pos_hist(mat, 700, nsym)
