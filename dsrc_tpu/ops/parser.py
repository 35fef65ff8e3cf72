"""Vectorized FASTQ parsing on device.

Vectorized counterpart of the reference's byte-scanning parser
(FastqParser.cpp:140-164, FastqParser.h:93-135): instead of walking bytes one
at a time, a block's byte tensor is parsed with mask/cumsum/scatter ops —
newline detection, line tables, record field tables and stream gathers are all
bulk vector operations.

A block handed to `parse_block` must contain only whole 4-line records
(guaranteed by the host chunker, io/chunker.py) and end with a newline
(the chunker appends one to a final unterminated record).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

NEWLINE = 10
CR = 13


class ParsedBlock(NamedTuple):
    """Per-record field table (all [max_records], padded past num_records)."""
    num_records: jnp.ndarray    # scalar int32
    valid: jnp.ndarray          # scalar bool: structure checks passed
    title_start: jnp.ndarray    # int32, position of '@' + 1 (title text)
    title_len: jnp.ndarray
    seq_start: jnp.ndarray
    seq_len: jnp.ndarray
    plus_len: jnp.ndarray       # length of '+' line minus 1 (repetition text)
    qual_start: jnp.ndarray
    qual_len: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("max_records",))
def parse_block(data: jnp.ndarray, nbytes: jnp.ndarray,
                max_records: int) -> ParsedBlock:
    """Parse a record-aligned FASTQ block into a record field table.

    data: uint8 [cap] (bytes past nbytes must be zero); nbytes: scalar.
    """
    cap = data.shape[0]
    max_lines = 4 * max_records
    idx = jnp.arange(cap, dtype=jnp.int32)
    in_range = idx < nbytes
    nl = (data == NEWLINE) & in_range

    # line id of each newline (0-based), then line start/end tables
    nl_cum = jnp.cumsum(nl.astype(jnp.int32))          # inclusive
    num_lines = nl_cum[-1] if cap else jnp.int32(0)
    line_id = jnp.where(nl, nl_cum - 1, max_lines)     # park non-newlines
    # ends[k] = byte position of k-th newline
    ends = jnp.full((max_lines + 1,), 0, jnp.int32).at[line_id].set(
        idx, mode="drop")
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), ends[:-1] + 1])
    # strip trailing CR from line content
    prev_is_cr = jnp.take(data, jnp.maximum(ends - 1, 0), mode="clip") == CR
    content_ends = jnp.where(prev_is_cr & (ends > starts), ends - 1, ends)
    line_len = content_ends - starts

    num_records = num_lines // 4
    r = jnp.arange(max_records, dtype=jnp.int32)
    rec_mask = r < num_records

    def line(k):
        return starts[4 * r + k], line_len[4 * r + k]

    t_start, t_len = line(0)
    s_start, s_len = line(1)
    p_start, p_len = line(2)
    q_start, q_len = line(3)

    first_t = jnp.take(data, t_start, mode="clip")
    first_p = jnp.take(data, p_start, mode="clip")
    ok = (jnp.where(rec_mask, (first_t == ord("@")) & (first_p == ord("+")) &
                    (t_len >= 1) & (s_len >= 1) & (q_len >= 1), True).all()
          & (num_lines % 4 == 0) & (num_records <= max_records))

    z = jnp.int32(0)
    return ParsedBlock(
        num_records=num_records,
        valid=ok,
        title_start=jnp.where(rec_mask, t_start + 1, z),
        title_len=jnp.where(rec_mask, t_len - 1, z),
        seq_start=jnp.where(rec_mask, s_start, z),
        seq_len=jnp.where(rec_mask, s_len, z),
        plus_len=jnp.where(rec_mask, p_len - 1, z),
        qual_start=jnp.where(rec_mask, q_start, z),
        qual_len=jnp.where(rec_mask, q_len, z),
    )


@functools.partial(jax.jit, static_argnames=("total_cap",))
def gather_stream(data: jnp.ndarray, starts: jnp.ndarray, lens: jnp.ndarray,
                  total_cap: int):
    """Concatenate per-record byte ranges into one contiguous stream.

    Returns (stream uint8 [total_cap] zero-padded, total int32,
    offsets int32 [R] — start of each record's range in the stream).
    """
    cum = jnp.cumsum(lens)
    offsets = cum - lens
    total = cum[-1] if lens.shape[0] else jnp.int32(0)
    j = jnp.arange(total_cap, dtype=jnp.int32)
    rec_of = jnp.searchsorted(cum, j, side="right").astype(jnp.int32)
    src = jnp.take(starts, rec_of, mode="clip") + \
        (j - jnp.take(offsets, rec_of, mode="clip"))
    out = jnp.where(j < total, jnp.take(data, src, mode="clip"), 0)
    return out.astype(jnp.uint8), total, offsets


@functools.partial(jax.jit, static_argnames=("cap",))
def scatter_stream(stream: jnp.ndarray, offsets: jnp.ndarray,
                   lens: jnp.ndarray, dst_starts: jnp.ndarray, cap: int):
    """Inverse of gather_stream: place per-record ranges at dst positions.

    Returns uint8 [cap] with stream[offsets[r]:offsets[r]+lens[r]] written at
    dst_starts[r]; other bytes zero.  Used when laying out decompressed FASTQ
    text (reference: BlockCompressor::ReadTags text layout, .cpp:503-573).
    """
    total_cap = stream.shape[0]
    cum = jnp.cumsum(lens)
    j = jnp.arange(total_cap, dtype=jnp.int32)
    rec_of = jnp.searchsorted(cum, j, side="right").astype(jnp.int32)
    in_rec = j < (cum[-1] if lens.shape[0] else 0)
    dst = jnp.take(dst_starts, rec_of, mode="clip") + \
        (j - jnp.take(cum - lens, rec_of, mode="clip"))
    dst = jnp.where(in_rec, dst, cap)
    out = jnp.zeros((cap,), jnp.uint8)
    return out.at[dst].set(stream, mode="drop")


def analyze_block(data: jnp.ndarray, parsed: ParsedBlock):
    """Dataset-type detection from the first block.

    Reference: FastqParser::Analyze (FastqParser.cpp:27-138) — quality offset
    by min/max scan, color-space by 2nd sequence char in '0123.', plus-line
    repetition by non-empty '+' lines.  Returns dict of scalars.
    """
    r = jnp.arange(parsed.title_start.shape[0], dtype=jnp.int32)
    rec_mask = r < parsed.num_records

    # quality min/max over all quality bytes
    cap = data.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    # build a mask of quality bytes via interval diff trick
    qmask = jnp.zeros((cap + 1,), jnp.int32)
    qstarts = jnp.where(rec_mask, parsed.qual_start, cap)
    qends = jnp.where(rec_mask, parsed.qual_start + parsed.qual_len, cap)
    qmask = qmask.at[qstarts].add(1, mode="drop")
    qmask = qmask.at[qends].add(-1, mode="drop")
    qmask = jnp.cumsum(qmask[:-1]) > 0
    qvals = data.astype(jnp.int32)
    qmin = jnp.where(qmask, qvals, 255).min()
    qmax = jnp.where(qmask, qvals, 0).max()
    # reference offset rules (FastqParser.cpp:111-135)
    offset = jnp.where(
        (qmax <= 74) & (qmin >= 33), 33,
        jnp.where((qmax <= 105) & (qmin >= 64), 64,
                  jnp.where(qmin >= 59, 59, 33))).astype(jnp.int32)

    second = jnp.take(data, parsed.seq_start + 1, mode="clip")
    is_cs_char = ((second >= ord("0")) & (second <= ord("3"))) | \
        (second == ord("."))
    color_space = jnp.where(rec_mask, is_cs_char & (parsed.seq_len >= 2),
                            True).all() & (parsed.num_records > 0)
    plus_rep = jnp.where(rec_mask, parsed.plus_len > 0, True).all() \
        & (parsed.num_records > 0)
    plus_none = jnp.where(rec_mask, parsed.plus_len == 0, True).all()
    return dict(quality_offset=offset, color_space=color_space,
                plus_repetition=plus_rep, plus_consistent=plus_rep | plus_none,
                qmin=qmin, qmax=qmax)
