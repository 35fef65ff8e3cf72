"""Round-trip of the gather-free uniform-record fast path."""
import numpy as np
import pytest

import jax.numpy as jnp

from dsrc_tpu.parallel import uniform_pipeline as UP
from dsrc_tpu.utils.synth import make_fastq_fast


def _prep(n_rec, read_len, seed=0):
    data = make_fastq_fast(n_rec, read_len, seed=seed, fixed_width=True)
    spec = UP.detect_spec(data[:4096])
    assert spec is not None
    rec = spec.rec_bytes
    r = len(data) // rec
    rpad = -(-r // UP.GROUP) * UP.GROUP
    mat = np.zeros((rpad, rec), np.uint8)
    mat[:r] = np.frombuffer(data, np.uint8).reshape(r, rec)
    return spec, jnp.asarray(mat), r, rpad


@pytest.mark.parametrize("n_rec,read_len", [(200, 80), (333, 101)])
def test_uniform_roundtrip(n_rec, read_len):
    spec, mat, r, rpad = _prep(n_rec, read_len, seed=n_rec)
    assert bool(UP.check_uniform(mat, spec, jnp.int32(r)))
    comp = UP.compress_uniform(mat, jnp.int32(r), spec, rpad)
    out = UP.decompress_uniform(comp, spec, rpad)
    assert bool(UP.mats_equal(out, mat, jnp.int32(r)))
    assert int(comp["comp_bytes"]) < r * spec.rec_bytes


def test_uniform_roundtrip_binned_quality():
    """NovaSeq-style 4-level binned quality (RTA3 bins) through the
    uniform fast path — the dominant modern-Illumina layout."""
    data = make_fastq_fast(300, 90, seed=5, fixed_width=True,
                           quality_levels=(2, 12, 23, 37))
    spec = UP.detect_spec(data[:4096])
    rec = spec.rec_bytes
    r = len(data) // rec
    rpad = -(-r // UP.GROUP) * UP.GROUP
    mat = np.zeros((rpad, rec), np.uint8)
    mat[:r] = np.frombuffer(data, np.uint8).reshape(r, rec)
    matj = jnp.asarray(mat)
    assert bool(UP.check_uniform(matj, spec, jnp.int32(r)))
    comp = UP.compress_uniform(matj, jnp.int32(r), spec, rpad)
    out = UP.decompress_uniform(comp, spec, rpad)
    assert bool(UP.mats_equal(out, matj, jnp.int32(r)))
    # 4-symbol quality must compress far below 8 bits/value: whole-record
    # budget well under half the raw size
    assert int(comp["comp_bytes"]) < r * rec // 2


def test_uniform_detect_rejects_nonuniform():
    assert UP.detect_spec(b"@r1\nACGT\n+\nIII\n") is None      # qual len
    assert UP.detect_spec(b"@r1\nACGT\n+x\nIIII\n") is None    # plus text
    assert UP.detect_spec(b"not fastq at all") is None


def test_uniform_check_rejects_bad_block():
    spec, mat, r, rpad = _prep(50, 60)
    bad = np.asarray(mat).copy()
    bad[10, 0] = ord("X")
    assert not bool(UP.check_uniform(jnp.asarray(bad), spec, jnp.int32(r)))


def test_lookup_rows_exact_vs_gather():
    """The bulk packed (cum << 15 | freq) lookup of the encoder's main path
    (_lookup_packed) must reproduce table gathers EXACTLY on every backend.
    History: round 2 ran this as a one-hot matmul, whose default-precision
    bf16 multiply rounds table values >= 256 (8 mantissa bits) — every
    encoded (freq, cum) was corrupted on the accelerator while the CPU
    passed.  The all-integer select chain is exact by construction; this
    pins it against regressions back to float matmuls."""
    from dsrc_tpu.ops.rans import cum_from_freqs, quantize_counts

    rng = np.random.default_rng(7)
    r, p, a = 512, 37, 64
    mat = jnp.asarray(rng.integers(0, a, (r, p)).astype(np.int32))
    counts = jnp.asarray(rng.integers(0, 5000, (p, a)).astype(np.int32))
    table = quantize_counts(counts)                 # rows sum to M = 2^14
    cumfull = cum_from_freqs(table)                 # [P, A+1]
    pk = np.asarray(UP._lookup_packed(mat, table, cumfull, a))
    tab_np, cum_np = np.asarray(table), np.asarray(cumfull)
    mat_np = np.asarray(mat)
    cols = np.arange(p)[None, :]
    np.testing.assert_array_equal(pk & 0x7FFF, tab_np[cols, mat_np])
    np.testing.assert_array_equal(pk >> 15, cum_np[cols, mat_np])
