"""Vectorized record transforms — the reference's RecordsProcessor
(RecordsProcessor.cpp:135-427) re-designed as bulk tensor ops.

Forward (before encoding): DNA chars -> dense indices, quality -> offset-free
values, ambiguity folding (a base with index > 3 and quality < 7 is deleted
from the DNA stream and encoded *into* its quality byte — same reversible
trick as RecordsProcessor.cpp:230-243), optional lossy Illumina 8-bin quality
quantization with N<->bin-0 folding (RecordsProcessor.cpp:318-427), plus the
stats used for per-block scheme selection (Stats.h).  Backward inverts
exactly.  Everything operates on contiguous per-block streams with record-id
vectors for segment reductions; no per-byte loops.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Dense DNA alphabet; first four symbols are ACGT-equivalent classes so the
# 2-bit packer applies when only they occur.  Mirrors the symbol classes of
# the reference's 19-char table (RecordsProcessor.cpp:187-206); exact order is
# our own (A,C,G,T first for conventional 2-bit packing).
DNA_CHARS = b"ACGTNRWSKMDVHBYXU.-"
DNA_NSYM = len(DNA_CHARS)  # 19
COLOR_CHARS = b"0123."      # SOLiD color-space digits (+ unknown)
INVALID_SYM = 31

# Lossy Illumina 8-bin quality quantization (RecordsProcessor.cpp:318-342):
LOSSY_BOUNDS = (2, 10, 20, 25, 30, 35, 40)       # bin = #bounds <= q
LOSSY_REPS = (0, 6, 15, 22, 27, 33, 37, 40)      # representative per bin

FOLD_BASE = 128   # folded-base marker region in the quality stream
HASH_QUAL = 2     # quality value of '#' at offset 33 (truncation symbol)


def _remap(data: jnp.ndarray, chars: bytes) -> jnp.ndarray:
    """Map bytes to dense symbol indices via a compare/select chain (A <= 19
    fused selects instead of a constant-table gather)."""
    out = jnp.full(data.shape, INVALID_SYM, jnp.int32)
    for i, ch in enumerate(chars):
        out = jnp.where(data == ch, i, out)
    return out


def _unmap(syms: jnp.ndarray, chars: bytes) -> jnp.ndarray:
    out = jnp.zeros(syms.shape, jnp.int32)
    for i, ch in enumerate(chars):
        out = jnp.where(syms == i, ch, out)
    return out.astype(jnp.uint8)


def dna_remap(data: jnp.ndarray) -> jnp.ndarray:
    return _remap(data, DNA_CHARS)


def dna_unmap(syms: jnp.ndarray) -> jnp.ndarray:
    return _unmap(syms, DNA_CHARS)


def color_remap(data: jnp.ndarray) -> jnp.ndarray:
    return _remap(data, COLOR_CHARS)


def color_unmap(syms: jnp.ndarray) -> jnp.ndarray:
    return _unmap(syms, COLOR_CHARS)


def compact(values: jnp.ndarray, keep: jnp.ndarray):
    """Stream compaction: values[keep] left-packed, zero-padded.

    Returns (packed [n], count).  Vectorized as cumsum + scatter.
    """
    n = values.shape[0]
    pos = jnp.cumsum(keep.astype(jnp.int32)) - keep.astype(jnp.int32)
    pos = jnp.where(keep, pos, n)
    out = jnp.zeros((n,), values.dtype).at[pos].set(values, mode="drop")
    return out, jnp.sum(keep.astype(jnp.int32))


def expand_positions(keep: jnp.ndarray) -> jnp.ndarray:
    """For each position, index into the compacted stream (valid where keep)."""
    return jnp.cumsum(keep.astype(jnp.int32)) - keep.astype(jnp.int32)


# --------------------------------------------------------------------------
# Lossless forward / backward (ambiguity folding)
# --------------------------------------------------------------------------

def forward_lossless(seq_sym: jnp.ndarray, qual: jnp.ndarray,
                     active: jnp.ndarray):
    """seq_sym: [S] dense DNA indices; qual: [S] offset-free values;
    active: [S] bool (stream positions within the block's total).

    Returns (dna [S] left-packed indices, dna_total, qual_out [S]).
    qual_out carries folded bases in [FOLD_BASE, 256) exactly as the
    reference's q + 128 + ((idx-2)<<3) - 16 encoding.
    """
    fold = (seq_sym > 3) & (qual < 7) & active
    qual_out = jnp.where(fold, qual + FOLD_BASE + ((seq_sym - 2) << 3) - 16,
                         qual)
    keep = active & ~fold
    dna, dna_total = compact(seq_sym, keep)
    return dna, dna_total, qual_out, fold


def backward_lossless(dna: jnp.ndarray, qual_enc: jnp.ndarray,
                      active: jnp.ndarray):
    """Invert forward_lossless.  Returns (seq_sym [S], qual [S])."""
    fold = (qual_enc >= FOLD_BASE) & active
    idx_folded = ((qual_enc - FOLD_BASE + 16) >> 3) + 2
    qual = jnp.where(fold,
                     qual_enc - FOLD_BASE - ((idx_folded - 2) << 3) + 16,
                     qual_enc)
    keep = active & ~fold
    src = expand_positions(keep)
    seq_sym = jnp.where(fold, idx_folded,
                        jnp.take(dna, src, mode="clip"))
    seq_sym = jnp.where(active, seq_sym, 0)
    return seq_sym, qual


# --------------------------------------------------------------------------
# Lossy forward / backward (Illumina binning + N<->bin-0 folding)
# --------------------------------------------------------------------------

def quality_bin(qual: jnp.ndarray) -> jnp.ndarray:
    b = jnp.zeros(qual.shape, jnp.int32)
    for t in LOSSY_BOUNDS:
        b = b + (qual >= t).astype(jnp.int32)
    return b


def quality_unbin(bins: jnp.ndarray) -> jnp.ndarray:
    out = jnp.zeros(bins.shape, jnp.int32)
    for i, rep in enumerate(LOSSY_REPS):
        out = jnp.where(bins == i, rep, out)
    return out


def forward_lossy(seq_sym: jnp.ndarray, qual: jnp.ndarray,
                  active: jnp.ndarray):
    """Lossy path: quality -> 8 bins; ambiguous bases force bin 0 and leave
    the DNA stream; any bin-0 position decodes as N (information loss by
    design — reference RecordsProcessor.cpp:364-427 semantics).
    """
    bins = quality_bin(qual)
    bins = jnp.where((seq_sym > 3) & active, 0, bins)
    keep = active & (bins != 0)
    dna, dna_total = compact(seq_sym, keep)
    return dna, dna_total, bins


def backward_lossy(dna: jnp.ndarray, bins: jnp.ndarray,
                   active: jnp.ndarray):
    keep = active & (bins != 0)
    src = expand_positions(keep)
    seq_sym = jnp.where(keep, jnp.take(dna, src, mode="clip"), 4)  # N
    seq_sym = jnp.where(active, seq_sym, 0)
    qual = jnp.where(active, quality_unbin(bins), 0)
    return seq_sym, qual


# --------------------------------------------------------------------------
# Stats for scheme selection (reference Stats.h, QualityModelerProxy.h:113-122)
# --------------------------------------------------------------------------

def segment_max(values: jnp.ndarray, seg_ids: jnp.ndarray, num_seg: int):
    return jnp.zeros((num_seg,), values.dtype).at[seg_ids].max(
        values, mode="drop")


def segment_sum(values: jnp.ndarray, seg_ids: jnp.ndarray, num_seg: int):
    return jnp.zeros((num_seg,), values.dtype).at[seg_ids].add(
        values, mode="drop")


def truncated_lengths(qual: jnp.ndarray, rec_of: jnp.ndarray,
                      pos_in_rec: jnp.ndarray, active: jnp.ndarray,
                      num_rec: int) -> jnp.ndarray:
    """Per-record position after the last non-'#' quality symbol
    (reference RecordsProcessor.cpp:245-263: truncatedLen)."""
    is_real = (qual != HASH_QUAL) & active
    return segment_max(jnp.where(is_real, pos_in_rec + 1, 0), rec_of, num_rec)


def run_count(stream: jnp.ndarray, rec_of: jnp.ndarray,
              active: jnp.ndarray) -> jnp.ndarray:
    """Number of runs (RLE length) in a per-record-segmented stream."""
    prev = jnp.concatenate([stream[:1] + 1, stream[:-1]])
    prev_rec = jnp.concatenate([rec_of[:1] + 1, rec_of[:-1]])
    new_run = ((stream != prev) | (rec_of != prev_rec)) & active
    return new_run.astype(jnp.int32).sum()


def histogram(values: jnp.ndarray, nsym: int, active: jnp.ndarray):
    v = jnp.where(active, values, nsym)
    return jnp.zeros((nsym,), jnp.int32).at[v].add(1, mode="drop")
