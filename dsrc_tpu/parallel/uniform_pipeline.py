"""Gather-free fast path for uniform-record FASTQ blocks (fixed-width
Illumina layout: every record has identical title length and read length).

Motivation: the generic pipeline spends its work on per-symbol table
gathers and scatters, which cost far more than fused elementwise chains.
When records are uniform:

  * parse/gather/layout become RESHAPES of [R, rec_bytes] — no searchsorted,
    no scatter;
  * positional coding becomes SHARED-ROW coding: lanes = record groups, the
    wavefront step t maps to (record-in-group g = t // P, position p = t % P)
    identically for every lane, so each step's model row tables[p] is ONE
    dynamic slice broadcast to all lanes — zero per-lane table gathers.
    Encode resolves (freq, cum) in bulk outside the scan (one packed
    integer select chain, _lookup_packed); decode locates symbols with a
    two-level coarse/fine search on the shared row; renorm words move
    through per-lane 2-tile sliding windows (ops/rans.py) so the payload
    is touched once per super-chunk, not per chunk;
  * DNA is 2-bit packed (reference DnaModelerBasicB2 equivalent) with a
    compacted exception list for non-ACGT bases, so N's don't break packing;
  * quality values use a dense alphabet of 64 (offset-subtracted), titles 128
    (printable ASCII).

Blocks that violate uniformity (variable 454 reads, color space, plus
repetition, exotic bytes) fall back to the generic device pipeline — this
module's `check_uniform` is a single fused device predicate.

This positional shared-row model is also the reference's own model family:
per-position quality Huffman trees (QualityPositionModeler.cpp:107-186) and
per-position title char histograms (TagModeler.cpp:159-459), re-expressed as
static-table rANS (the [P, A] quantized tables are transmitted, ~1% of the
stream — cheaper than band adaptation here because each position is visited
only GROUP times per lane).  Titles additionally go through a vertical
match-delta transform (title_delta) that captures the column coherence the
reference's tokenizer exploits field-wise.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import ctx as C
from ..ops.rans import (
    ENC_UNROLL, M, PROB_BITS, RANS_L, SUPER, TILE, TILE_BITS, UNROLL,
    _MASK, _U16, cum_from_freqs, pair_at, payload_window, quantize_counts,
    rans_encode_from_freqs, window_pairs,
)


QUAL_A = 64
TITLE_A = 128


class UniformSpec(NamedTuple):
    rec_bytes: int
    title_len: int   # without '@'
    read_len: int

    @property
    def layout_ok(self) -> bool:
        # @<title>\n<seq>\n+\n<qual>\n
        return self.rec_bytes == (1 + self.title_len + 1 + self.read_len
                                  + 1 + 2 + self.read_len + 1)


def detect_spec(head: bytes) -> Optional[UniformSpec]:
    """Infer the uniform record layout from the first record (host)."""
    try:
        e1 = head.index(b"\n")
        e2 = head.index(b"\n", e1 + 1)
        e3 = head.index(b"\n", e2 + 1)
        e4 = head.index(b"\n", e3 + 1)
    except ValueError:
        return None
    if head[:1] != b"@" or head[e2 + 1:e3] != b"+":
        return None
    spec = UniformSpec(rec_bytes=e4 + 1, title_len=e1 - 1,
                       read_len=e2 - e1 - 1)
    return spec if spec.layout_ok and e3 - e2 - 1 == 1 and \
        (e4 - e3 - 1) == spec.read_len else None


@functools.partial(jax.jit, static_argnames=("spec",))
def check_uniform(mat: jnp.ndarray, spec: UniformSpec, num_rec):
    """mat: [Rpad, rec_bytes] uint8 (rows >= num_rec are padding).  One
    fused predicate: every record matches the layout, all DNA in ACGTN,
    quality in [33, 97)."""
    s = spec
    t1 = 1 + s.title_len
    s0 = t1 + 1
    s1 = s0 + s.read_len
    p0, p1 = s1 + 1, s1 + 2
    q0 = p1 + 1
    q1 = q0 + s.read_len
    rmask = (jnp.arange(mat.shape[0], dtype=jnp.int32)
             < jnp.asarray(num_rec, jnp.int32))[:, None]

    def allr(cond):
        return jnp.where(rmask[:, : cond.shape[1]], cond, True).all()

    ok = allr(mat[:, :1] == ord("@"))
    ok &= allr(mat[:, t1:t1 + 1] == 10) & allr(mat[:, s1:s1 + 1] == 10)
    ok &= allr(mat[:, p0:p0 + 1] == ord("+")) & allr(mat[:, p1:p1 + 1] == 10)
    ok &= allr(mat[:, q1:q1 + 1] == 10)
    title = mat[:, 1:t1]
    ok &= allr((title >= 32) & (title < 32 + TITLE_A))
    seq = mat[:, s0:s1]
    ok &= allr((seq == ord("A")) | (seq == ord("C")) | (seq == ord("G"))
               | (seq == ord("T")) | (seq == ord("N")))
    qual = mat[:, q0:q1]
    ok &= allr((qual >= 33) & (qual < 33 + QUAL_A))
    return ok


# --------------------------------------------------------------------------
# Shared-row positional band-adaptive rANS (the core trick)
# --------------------------------------------------------------------------

def _group_lanes(mat: jnp.ndarray, g: int):
    """[R, P] -> lanes [T=G*P, L=R//G]: lanes[gp*P+p, l] = mat[l*G+gp, p]."""
    rr, p = mat.shape
    ll = rr // g
    return mat.reshape(ll, g, p).transpose(1, 2, 0).reshape(g * p, ll)


def _ungroup_lanes(lanes: jnp.ndarray, g: int, p: int):
    t, ll = lanes.shape
    return lanes.reshape(g, p, ll).transpose(2, 0, 1).reshape(ll * g, p)


def _lookup_packed(mat: jnp.ndarray, table: jnp.ndarray,
                   cumfull: jnp.ndarray, nsym: int):
    """Bulk packed (cum << 15 | freq) per symbol: one integer select chain
    over the alphabet on [Rpad, P].

    All-integer: a compare+select per alphabet symbol fuses into passes
    over [Rpad, P] with no large intermediates.  Packing both table values
    into one int32 (each < 2^15) halves the chain AND the number of lane
    transposes downstream.  A float one-hot matmul would be exact only at
    full f32 precision (bf16 or TF32 round table values >= 256 or 2^11);
    the select chain is exact by construction."""
    packed_tab = (cumfull[:, :nsym] << 15) | table        # [P, A]
    out = jnp.zeros_like(mat)
    for a in range(nsym):
        out = jnp.where(mat == a, packed_tab[:, a][None, :], out)
    return out


def _pos_hist(mat: jnp.ndarray, num_rec, nsym: int):
    """Per-position histograms [P, A] of mat [Rpad, P] via a nibble-
    factorized batched matmul: with a = 8*h + l,
    hist[p, a] = sum_r Hi[r,p,h] * Lo[r,p,l] — one [P]-batched
    [A/8, Rpad] @ [Rpad, 8] contraction instead of a [T, L, A] one-hot
    reduction.  Operands are int8 0/1 with int32 accumulation, so the
    counts are exact."""
    rpad, p = mat.shape
    hi_n = -(-nsym // 8)
    act = (jnp.arange(rpad, dtype=jnp.int32) < num_rec)[:, None]
    hi = ((mat >> 3)[:, :, None]
          == jnp.arange(hi_n, dtype=jnp.int32)) & act[:, :, None]
    lo = ((mat & 7)[:, :, None] == jnp.arange(8, dtype=jnp.int32))
    out = jax.lax.dot_general(
        hi.astype(jnp.int8), lo.astype(jnp.int8),
        dimension_numbers=(((0,), (0,)), ((1,), (1,))),
        preferred_element_type=jnp.int32)                 # [P, hi_n, 8]
    return out.reshape(p, hi_n * 8)[:, :nsym]


def qual_delta(mat: jnp.ndarray, nsym: int) -> jnp.ndarray:
    """Horizontal within-read delta: sym[:, i] = (q[:, i] - q[:, i-1])
    mod nsym (column 0 literal).  Real base callers emit AR-correlated
    quality, whose innovation entropy is ~0.3 b/sym below the marginal —
    the positional tables then model the DELTA distribution per cycle.
    Inverted OUTSIDE the decode scan by a row cumsum (qual_delta_inv)."""
    prev = jnp.concatenate([jnp.zeros_like(mat[:, :1]), mat[:, :-1]],
                           axis=1)
    return (mat - prev) % nsym


def qual_delta_inv(mat: jnp.ndarray, nsym: int) -> jnp.ndarray:
    return jnp.cumsum(mat, axis=1) % nsym


def _pos_entropy_bits(hist: jnp.ndarray) -> jnp.ndarray:
    """Total code length estimate (bits) of per-position histograms
    [P, A] — used only to CHOOSE a transform (the choice is transmitted,
    so float rounding cannot desync encoder and decoder)."""
    h = hist.astype(jnp.float32)
    tot = h.sum(axis=1, keepdims=True)
    p = h / jnp.maximum(tot, 1.0)
    return -jnp.sum(jnp.where(h > 0, h * jnp.log2(jnp.maximum(p, 1e-12)),
                              0.0))


def encode_positional(mat: jnp.ndarray, num_rec, nsym: int, group: int):
    """mat: [Rpad, P] int32 symbols (rows >= num_rec are padding).

    Returns (payload [L, Wp] i32 pairs, nwords [L], states [L],
    table [P, A] quantized freqs — TRANSMITTED, like the reference's
    per-position Huffman trees, QualityPositionModeler.cpp:107-186).

    Static tables beat band adaptation here: each position is visited only
    `group` times per lane, so adaptive bands would code the whole first
    record-slot (1/group of the block) against empty statistics; the table
    costs P*A*14 bits (~1% of the stream) and the single reverse scan stays
    gather-free (shared-row one-hot lookups).
    """
    rpad, p = mat.shape
    ll = rpad // group
    t_steps = group * p
    g_idx = jnp.arange(t_steps, dtype=jnp.int32) // p     # [T]
    rec_idx = (jnp.arange(ll, dtype=jnp.int32) * group)[None, :] \
        + g_idx[:, None]
    active = rec_idx < num_rec

    # full-population statistics: sampling every 4th record was tried (4x
    # less histogram work) but cost 2.5% compression ratio on the bench
    # corpus — the sharpened quantizer amplifies sampling noise on spiky
    # title-delta columns
    hist = _pos_hist(mat, num_rec, nsym)
    table = quantize_counts(hist)                         # [P, A]

    # bulk packed (cum << 15 | freq) lookup as ONE fused select chain on
    # [Rpad, P], then ONE lane transpose of the packed array: no table
    # lookup is left inside the sequential loop, and packing halves both
    # the chain and the transpose traffic
    cumfull = cum_from_freqs(table)                       # [P, A+1]
    pk = _lookup_packed(
        jnp.where((jnp.arange(rpad, dtype=jnp.int32)
                   < num_rec)[:, None], mat, 0), table, cumfull, nsym)
    pl = _group_lanes(pk, group)                          # [T, L]
    payload, bcnt, x = rans_encode_from_freqs(
        pl & 0x7FFF, pl >> 15, active)
    return payload, bcnt, x, table


def decode_positional(payload: jnp.ndarray, states: jnp.ndarray,
                      nwords: jnp.ndarray, table: jnp.ndarray, num_rec,
                      p: int, rpad: int, nsym: int, group: int,
                      left: bool = False, delta: bool = False):
    """Mirror of encode_positional.  Returns mat [Rpad, P] int32.

    table: the transmitted [P, A] quantized freqs.  Payload is the paired
    layout; renorm pairs are prefetched per chunk and consumed from
    registers."""
    ll = rpad // group
    t_steps = group * p
    lane_base = jnp.arange(ll, dtype=jnp.int32) * group
    npf = UNROLL // 2 + 1
    cumfull = cum_from_freqs(table)
    nt = -(-payload.shape[1] // TILE) + 1    # +1 guard tile (zeros)

    x = states
    wptr = jnp.zeros((ll,), jnp.int32) if left \
        else (2 * payload.shape[1] - nwords).astype(jnp.int32)

    hi_n = nsym // 8
    hm = jnp.arange(hi_n, dtype=jnp.int32)
    k8 = jnp.arange(8, dtype=jnp.int32)

    def substep(x, o, pairs, phase, t):
        act = (t < t_steps) & ((lane_base + t // p) < num_rec)
        row = jax.lax.dynamic_slice(
            cumfull, (t % p, 0), (1, nsym + 1))[0]        # [A+1] shared
        slot = (x & _MASK).astype(jnp.int32)
        # two-level symbol search on the SHARED row: sym = 8*hi + lo.
        # A coarse compare over the A/8 tile boundaries picks hi, one
        # select chain extracts the 8-entry sub-row + its upper boundary,
        # a fine compare picks lo, and two one-hot MACs read (cum, next).
        # Intermediates stay L-MAJOR [L, k].
        row8 = row[::8]                                   # [A/8 + 1]
        ge_h = (slot[:, None] >= row8[None, 1:hi_n]).astype(jnp.int32)
        hi = ge_h.sum(axis=1)                             # [L]
        oh_h = (hi[:, None] == hm[None, :]).astype(jnp.int32)  # [L, H]
        rowmat = row[:nsym].reshape(hi_n, 8)
        fine = jnp.zeros((slot.shape[0], 8), jnp.int32)
        for m in range(hi_n):
            fine = fine + oh_h[:, m:m + 1] * rowmat[m][None, :]
        row9 = (oh_h * row8[None, 1:hi_n + 1]).sum(axis=1)  # row[8hi+8]
        ge_l = (slot[:, None] >= fine[:, 1:]).astype(jnp.int32)  # [L, 7]
        lo = ge_l.sum(axis=1)
        sym = (hi << 3) + lo
        oh_l = (lo[:, None] == k8[None, :]).astype(jnp.int32)
        cu = (oh_l * fine).sum(axis=1)
        fine9 = jnp.concatenate([fine[:, 1:], row9[:, None]], axis=1)
        f = (oh_l * fine9).sum(axis=1) - cu
        fu = jnp.where(act, f, 1).astype(jnp.uint32)
        xn = fu * (x >> np.uint32(PROB_BITS)) + slot.astype(jnp.uint32) \
            - cu.astype(jnp.uint32)
        need = act & (xn < RANS_L)
        lp = (phase + o) >> 1
        half = (phase + o) & 1
        pair = pair_at(pairs, lp)
        w = (jnp.where(half == 1, pair >> 16, pair) & 0xFFFF) \
            .astype(jnp.uint32)
        xn = jnp.where(need, (xn << np.uint32(16)) | w, xn)
        x = jnp.where(act, xn, x)
        o = o + need.astype(jnp.int32)
        return x, o, sym

    chunks = (-(-t_steps // UNROLL))
    sups = -(-chunks // SUPER)

    def sup_step(state, ts0):
        x, wptr = state
        bt = (wptr >> 1) >> TILE_BITS
        win = payload_window(payload, bt, nt)
        base = bt << (TILE_BITS + 1)          # window start in u16 words
        syms = []
        for ci in range(SUPER):
            pairs = window_pairs(win, (wptr - base) >> 1, npf)
            phase = wptr & 1
            o = jnp.zeros((ll,), jnp.int32)
            for ui in range(UNROLL):
                x, o, sym = substep(x, o, pairs, phase,
                                    ts0 + ci * UNROLL + ui)
                syms.append(sym)
            wptr = wptr + o
        return (x, wptr), jnp.stack(syms)

    (x, wptr), syms = jax.lax.scan(
        sup_step, (x, wptr),
        jnp.arange(sups, dtype=jnp.int32) * (SUPER * UNROLL))
    out = syms.reshape(sups * SUPER * UNROLL, ll)[:t_steps]
    if delta:
        # vertical byte-delta inversion OUTSIDE the sequential scan: the
        # scan decodes raw deltas; char[g, p] = (sum_{g'<=g} delta) mod A
        # within each lane group — one modular cumsum over the G axis
        # replaces the old per-substep prevbuf dynamic_update_slice chain
        # (title decode was the slowest stream because of it)
        out = out.reshape(group, p, ll)
        out = jnp.cumsum(out, axis=0) % nsym
        out = out.reshape(group * p, ll)
    return _ungroup_lanes(out, group, p)


def invert_title_delta(mat: jnp.ndarray, group: int,
                       nsym: int = TITLE_A) -> jnp.ndarray:
    """Inverse of title_delta on the full [Rpad, P] matrix: a modular
    cumsum within each `group` of consecutive records.  Runs OUTSIDE the
    sequential decode scan, so the rANS coding group is free to differ
    from the delta group."""
    r, p = mat.shape
    m = mat.reshape(r // group, group, p)
    return (jnp.cumsum(m, axis=1) % nsym).reshape(r, p)


def title_delta(mat: jnp.ndarray, group: int,
                nsym: int = TITLE_A) -> jnp.ndarray:
    """Vertical byte-delta for fixed-format titles: symbol = (char -
    prev_record_char) mod nsym within a lane group; the group's first
    record is coded literally (prev = 0).  Equal columns give delta 0 (the
    old match flag) while incrementing decimal counters give near-constant
    deltas per column — both the reference tokenizer's ham_mask and its
    numeric delta schemes (TagModeler.cpp:461-551) in one branch-free
    transform (measured 0.78 vs 1.01 bits/sym for match-flags on the
    Illumina bench titles).  nsym must be a power of two."""
    rpad = mat.shape[0]
    prev = jnp.concatenate([jnp.zeros_like(mat[:1]), mat[:-1]], axis=0)
    first = ((jnp.arange(rpad, dtype=jnp.int32) % group) == 0)[:, None]
    prev = jnp.where(first, 0, prev)
    return (mat - prev) & (nsym - 1)


# --------------------------------------------------------------------------
# DNA: 2-bit pack + exception list (gather-free)
# --------------------------------------------------------------------------

def _exc_words(p: int) -> int:
    return -(-p // 32)


def pack_dna(seq: jnp.ndarray, num_rec, read_len: int):
    """seq: [Rpad, P] uint8 ACGTN.  Returns (packed 2-bit bytes,
    exc_bits [Rpad, ceil(P/32)] uint32 bitmap of non-ACGT positions,
    exc_count).

    Integer shifts and ORs only, so the result is exact on every backend
    (a float matmul form would depend on the backend's f32 precision).
    Exceptions stay a DENSE bitmap on device: compacting them to index
    lists would be a [Rpad*P]-element scatter; position lists are produced
    on the host during serialization instead
    (models/block.serialize_uniform_block), where flatnonzero is free."""
    rpad, p = seq.shape
    code = jnp.zeros(seq.shape, jnp.int32)
    code = jnp.where(seq == ord("C"), 1, code)
    code = jnp.where(seq == ord("G"), 2, code)
    code = jnp.where(seq == ord("T"), 3, code)
    is_exc = ~((seq == ord("A")) | (seq == ord("C")) | (seq == ord("G"))
               | (seq == ord("T")))
    rec_idx = jnp.arange(rpad, dtype=jnp.int32)[:, None]
    is_exc = is_exc & (rec_idx < num_rec)
    # row-major flat 2-bit pack, 4 symbols per byte, first symbol in the
    # low bits (a row of P % 4 == 0 symbols is a whole number of bytes)
    flat = code.reshape(-1)
    q = jnp.pad(flat, (0, (-flat.shape[0]) % 4)).reshape(-1, 4)
    packed = (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4)
              | (q[:, 3] << 6)).astype(jnp.uint8)
    wcnt = _exc_words(p)
    # exception bitmap: bit b of word w is column 32*w + b
    bits = jnp.pad(is_exc, ((0, 0), (0, wcnt * 32 - p))) \
        .astype(jnp.uint32).reshape(rpad, wcnt, 32) \
        << jnp.arange(32, dtype=jnp.uint32)
    exc_bits = jax.lax.reduce(bits, np.uint32(0), jax.lax.bitwise_or, (2,))
    exc_count = is_exc.astype(jnp.int32).sum()
    return packed, exc_bits, exc_count


def unpack_dna(packed: jnp.ndarray, exc_bits: jnp.ndarray, exc_count,
               rpad: int, p: int):
    if p % 4 == 0:
        # row-major unpack: repeat each packed byte over its 4 symbol slots
        # (broadcast+reshape, no gather)
        rows = packed[: rpad * p // 4].reshape(rpad, p // 4).astype(jnp.int32)
        rep = jnp.repeat(rows, 4, axis=1)
        shift_row = (2 * (jnp.arange(p, dtype=jnp.int32) % 4))[None, :]
        flat2 = (rep >> shift_row) & 3
    else:
        shifts = jnp.asarray([0, 2, 4, 6], jnp.int32)
        flat = ((packed.astype(jnp.int32)[:, None] >> shifts) & 3) \
            .reshape(-1)
        flat2 = flat[: rpad * p].reshape(rpad, p)
    seq = jnp.zeros_like(flat2)
    for i, ch in enumerate(b"ACGT"):
        seq = jnp.where(flat2 == i, ch, seq)
    wcnt = _exc_words(p)
    # bitmap expansion by repeat instead of a column gather
    repb = jnp.repeat(exc_bits, 32, axis=1)[:, :p]
    shift_b = (jnp.arange(p, dtype=jnp.uint32) % 32)[None, :]
    nmask = (repb >> shift_b) & 1
    seq = jnp.where(nmask == 1, ord("N"), seq)
    return seq.astype(jnp.uint8)


# --------------------------------------------------------------------------
# Whole-block uniform compress / decompress
# --------------------------------------------------------------------------

# records per lane, PER STREAM: the starting values for this card (they
# shape the bitstream but are transmitted per block in Wire, so retuning
# never breaks archives).  G=8 halves the ~5 B/lane state+word-count
# overhead vs G=4.  The title-delta literal fraction is 1/TITLE_GROUP,
# decoupled from the coding group (the delta inverts OUTSIDE the scan).
# rpad buckets (multiples of 256) are divisible by all groups.
TITLE_GROUP = 16       # delta group: literal fraction = 1/16
TITLE_CODE_GROUP = 8   # rANS lane group for the (delta-transformed) titles
QUAL_GROUP = 8
GROUP = 16    # legacy lane-geometry rounding used by tools/tests
# The title DELTA group and its rANS CODING group are decoupled: the
# vertical delta is applied before encoding and inverted by a modular
# cumsum on the full [rpad, P] matrix after decoding, so the scan length
# (t_steps = code_group * P) shrinks without paying the literal-fraction
# ratio cost of a smaller delta group.


class Wire(NamedTuple):
    """Per-block wire-format layout parameters.

    The module constants above are ENCODER tuning defaults only; every
    value that shapes the bitstream is transmitted in the block header and
    threaded through the decode kernels, so retuning the defaults never
    breaks existing archives (the reference's footer plays the same role,
    DsrcFile.cpp:133-170)."""
    title_a: int = TITLE_A
    qual_a: int = QUAL_A
    title_group: int = TITLE_GROUP            # title vertical-delta group
    title_code_group: int = TITLE_CODE_GROUP  # title rANS lane group
    qual_group: int = QUAL_GROUP              # quality rANS lane group
    val_group: int = 64   # rANS lane group of the semi mode-2 value planes
    # (few columns, so a big group costs few scan steps but divides the
    # ~5 B/lane state+count overhead by 8 vs the char-title group)

    def validate(self, rpad: int) -> None:
        for a in (self.title_a, self.qual_a):
            if not (8 <= a <= 512 and a % 8 == 0):
                raise ValueError(f"bad wire alphabet {a}")
        if self.title_a & (self.title_a - 1):
            raise ValueError("title alphabet must be a power of two")
        for g in (self.title_group, self.title_code_group, self.qual_group,
                  self.val_group):
            if not (1 <= g <= 256 and rpad % g == 0):
                raise ValueError(f"bad wire lane group {g} for rpad {rpad}")


WIRE_DEFAULT = Wire()


@functools.partial(jax.jit, static_argnames=("spec", "rpad", "wire"))
def compress_uniform(mat: jnp.ndarray, num_rec, spec: UniformSpec,
                     rpad: int, wire: Wire = WIRE_DEFAULT):
    """mat: [Rpad, rec_bytes] uint8 (rows past num_rec zero).  Single fused
    program; compressed tensors stay on device.  `wire` holds the layout
    parameters that are transmitted in the block header."""
    s, wr = spec, wire
    t1 = 1 + s.title_len
    s0 = t1 + 1
    s1 = s0 + s.read_len
    q0 = s1 + 3
    title = mat[:, 1:t1].astype(jnp.int32) - 32
    seq = mat[:, s0:s1]
    qual = mat[:, q0:q0 + s.read_len].astype(jnp.int32) - 33
    tsyms = title_delta(jnp.clip(title, 0, wr.title_a - 1),
                        wr.title_group, wr.title_a)
    tp, tn, ts, ttab = encode_positional(tsyms, num_rec, wr.title_a,
                                         wr.title_code_group)
    qenc, qual_mode = _choose_qual_syms(qual, num_rec, wr)
    qp, qn, qs, qtab = encode_positional(qenc, num_rec, wr.qual_a,
                                         wr.qual_group)
    packed, exc_bits, exc_count = pack_dna(seq, num_rec, s.read_len)
    dna_bytes = (num_rec * s.read_len) // 4 + 1 + 4 * exc_count
    table_bytes = (s.title_len * wr.title_a
                   + s.read_len * wr.qual_a) * PROB_BITS // 8
    comp_bytes = (2 * (tn.sum() + qn.sum())
                  + 5 * (rpad // wr.title_code_group + rpad // wr.qual_group)
                  + dna_bytes + table_bytes + 16)
    return dict(num_rec=num_rec, qual_mode=qual_mode,
                title=(tp, tn, ts, ttab), qual=(qp, qn, qs, qtab),
                dna=(packed, exc_bits, exc_count),
                comp_bytes=comp_bytes)


def _choose_qual_syms(qual: jnp.ndarray, num_rec, wr: Wire):
    """Per-block choice between direct and horizontal-delta quality
    symbols by estimated positional code length; the winning mode is
    transmitted (qual_mode byte), so the float estimate only PICKS."""
    qsym = jnp.clip(qual, 0, wr.qual_a - 1)
    qd = qual_delta(qsym, wr.qual_a)
    bits_direct = _pos_entropy_bits(_pos_hist(qsym, num_rec, wr.qual_a))
    bits_delta = _pos_entropy_bits(_pos_hist(qd, num_rec, wr.qual_a))
    use_delta = bits_delta < bits_direct
    return (jnp.where(use_delta, qd, qsym),
            use_delta.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("spec", "rpad", "left", "wire"))
def decompress_uniform(comp, spec: UniformSpec, rpad: int,
                       left: bool = False, wire: Wire = WIRE_DEFAULT):
    s, wr = spec, wire
    num_rec = comp["num_rec"]
    tp, tn, ts, ttab = comp["title"]
    tdel = decode_positional(tp, ts, tn, ttab, num_rec, s.title_len, rpad,
                             wr.title_a, wr.title_code_group, left=left)
    title = invert_title_delta(tdel, wr.title_group, wr.title_a) + 32
    qp, qn, qs, qtab = comp["qual"]
    qdec = decode_positional(qp, qs, qn, qtab, num_rec, s.read_len, rpad,
                             wr.qual_a, wr.qual_group, left=left)
    qual = jnp.where(comp["qual_mode"] > 0,
                     qual_delta_inv(qdec, wr.qual_a), qdec) + 33
    packed, exc_bits, exc_count = comp["dna"]
    seq = unpack_dna(packed, exc_bits, exc_count, rpad, s.read_len)
    # reassemble [Rpad, rec_bytes]
    rr = rpad
    parts = [
        jnp.full((rr, 1), ord("@"), jnp.uint8),
        title.astype(jnp.uint8),
        jnp.full((rr, 1), 10, jnp.uint8),
        seq,
        jnp.full((rr, 1), 10, jnp.uint8),
        jnp.full((rr, 1), ord("+"), jnp.uint8),
        jnp.full((rr, 1), 10, jnp.uint8),
        qual.astype(jnp.uint8),
        jnp.full((rr, 1), 10, jnp.uint8),
    ]
    mat = jnp.concatenate(parts, axis=1)
    rmask = (jnp.arange(rr, dtype=jnp.int32) < num_rec)[:, None]
    return jnp.where(rmask, mat, 0)


@functools.partial(jax.jit, static_argnames=())
def mats_equal(a: jnp.ndarray, b: jnp.ndarray, num_rec):
    rmask = (jnp.arange(a.shape[0], dtype=jnp.int32) < num_rec)[:, None]
    return jnp.all(jnp.where(rmask, a == b, True))


# --------------------------------------------------------------------------
# Semi-uniform blocks: fixed read length, VARIABLE titles — the layout of
# essentially every real Illumina run (coordinates vary in digit count, so
# records are not fixed-size and the fully-uniform reshape path never
# applies).  The host gathers seq/qual into [Rpad, P] matrices from the
# parsed record offsets; quality and DNA then ride the same positional
# kernels as the uniform path, and titles go through the tag coder.
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("read_len", "rpad", "wire"))
def compress_semi(qual_m: jnp.ndarray, seq_m: jnp.ndarray, num_rec,
                  read_len: int, rpad: int, wire: Wire = WIRE_DEFAULT):
    """qual_m/seq_m: [rpad, read_len] uint8 (rows past num_rec zero)."""
    wr = wire
    qenc, qual_mode = _choose_qual_syms(
        qual_m.astype(jnp.int32) - 33, num_rec, wr)
    qp, qn, qs, qtab = encode_positional(qenc, num_rec, wr.qual_a,
                                         wr.qual_group)
    packed, exc_bits, exc_count = pack_dna(seq_m, num_rec, read_len)
    return dict(qual_mode=qual_mode, qual=(qp, qn, qs, qtab),
                dna=(packed, exc_bits, exc_count))


@functools.partial(jax.jit, static_argnames=("read_len", "rpad", "left",
                                             "wire"))
def decompress_semi(comp, read_len: int, rpad: int, left: bool = False,
                    wire: Wire = WIRE_DEFAULT):
    wr = wire
    num_rec = comp["num_rec"]
    qp, qn, qs, qtab = comp["qual"]
    qdec = decode_positional(qp, qs, qn, qtab, num_rec, read_len, rpad,
                             wr.qual_a, wr.qual_group, left=left)
    qual = jnp.where(comp["qual_mode"] > 0,
                     qual_delta_inv(qdec, wr.qual_a), qdec) + 33
    packed, exc_bits, exc_count = comp["dna"]
    seq = unpack_dna(packed, exc_bits, exc_count, rpad, read_len)
    rmask = (jnp.arange(rpad, dtype=jnp.int32) < num_rec)[:, None]
    return (jnp.where(rmask, qual, 0).astype(jnp.uint8),
            jnp.where(rmask, seq, 0).astype(jnp.uint8))


# --------------------------------------------------------------------------
# Device-resident semi blocks (title mode 2): titles tokenized ONCE on the
# host (models/tag.analyze_value_fields) into constant fields + an
# [rpad, F] int32 numeric VALUE matrix; the device codes the values with a
# vertical group-delta -> zigzag -> 4 byte-planes -> positional rANS chain
# inside the same fused program as quality/DNA.  Incrementing counters and
# near-constant coordinates become all-zero high planes and near-constant
# low planes — the reference TagModeler's numeric delta schemes
# (TagModeler.cpp:461-551) at device speed.
# --------------------------------------------------------------------------

VAL_A = 256     # byte-plane alphabet


def _value_planes(vmat: jnp.ndarray, v0: jnp.ndarray,
                  pcs: Tuple[int, ...]) -> jnp.ndarray:
    """[rpad, F] int32 values -> [rpad, sum(pcs)] byte-plane symbols.

    Full-column vertical delta (record r vs r-1; record 0 vs the
    TRANSMITTED base v0, so no literal rows inflate the planes), zigzag,
    then pcs[f] little-endian byte planes per field — the per-field plane
    count is measured on the host and transmitted, so a +1 counter costs
    ONE near-constant plane, not four."""
    prev = jnp.concatenate([v0[None, :].astype(jnp.int32), vmat[:-1]],
                           axis=0)
    d = vmat - prev
    z = (d << 1) ^ (d >> 31)                       # zigzag, fits int32
    cols = [(z[:, f] >> (8 * b)) & 255
            for f, pc in enumerate(pcs) for b in range(pc)]
    return jnp.stack(cols, axis=1)


def _planes_to_values(planes: jnp.ndarray, v0: jnp.ndarray,
                      pcs: Tuple[int, ...]) -> jnp.ndarray:
    """Inverse of _value_planes: [rpad, sum(pcs)] -> [rpad, F] int32."""
    off = 0
    zs = []
    for pc in pcs:
        z = planes[:, off]
        for b in range(1, pc):
            z = z | (planes[:, off + b] << (8 * b))
        zs.append(z)
        off += pc
    z = jnp.stack(zs, axis=1)
    d = (z >> 1) ^ -(z & 1)                        # un-zigzag
    return jnp.cumsum(d, axis=0) + v0[None, :].astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("pcs", "read_len", "rpad",
                                             "wire"))
def compress_semi_tok(vmat: jnp.ndarray, v0: jnp.ndarray,
                      qual_m: jnp.ndarray, seq_m: jnp.ndarray, num_rec,
                      pcs: Tuple[int, ...], read_len: int,
                      rpad: int, wire: Wire = WIRE_DEFAULT):
    """vmat: [rpad, F] int32 numeric field values (rows past num_rec 0);
    v0: [F] int32 transmitted base values; qual_m/seq_m: [rpad, read_len]
    uint8."""
    wr = wire
    out = {}
    ncols = sum(pcs)
    if ncols:
        planes = _value_planes(vmat, v0, pcs)
        tp, tn, ts, ttab = encode_positional(planes, num_rec, VAL_A,
                                             wr.val_group)
        out["title"] = (tp, tn, ts, ttab)
        tbytes = 2 * tn.sum() + 5 * (rpad // wr.val_group) \
            + ncols * VAL_A * PROB_BITS // 8
    else:
        tbytes = 0
    qenc, qual_mode = _choose_qual_syms(
        qual_m.astype(jnp.int32) - 33, num_rec, wr)
    qp, qn, qs, qtab = encode_positional(qenc, num_rec, wr.qual_a,
                                         wr.qual_group)
    packed, exc_bits, exc_count = pack_dna(seq_m, num_rec, read_len)
    dna_bytes = (num_rec * read_len) // 4 + 1 + 4 * exc_count
    out.update(num_rec=num_rec, qual_mode=qual_mode,
               qual=(qp, qn, qs, qtab),
               dna=(packed, exc_bits, exc_count),
               comp_bytes=(tbytes + 2 * qn.sum()
                           + 5 * (rpad // wr.qual_group) + dna_bytes
                           + read_len * wr.qual_a * PROB_BITS // 8 + 16))
    return out


@functools.partial(jax.jit, static_argnames=("pcs", "read_len", "rpad",
                                             "left", "wire"))
def decompress_semi_tok(comp, v0: jnp.ndarray, pcs: Tuple[int, ...],
                        read_len: int, rpad: int,
                        left: bool = False, wire: Wire = WIRE_DEFAULT):
    """Mirror of compress_semi_tok.  Returns (vmat [rpad, F] int32,
    qual_m, seq_m [rpad, read_len] uint8)."""
    wr = wire
    num_rec = comp["num_rec"]
    nf = len(pcs)
    if sum(pcs):
        tp, tn, ts, ttab = comp["title"]
        planes = decode_positional(tp, ts, tn, ttab, num_rec, sum(pcs),
                                   rpad, VAL_A, wr.val_group, left=left)
        vmat = _planes_to_values(planes, v0, pcs)
    else:
        vmat = jnp.zeros((rpad, max(nf, 1)), jnp.int32)[:, :nf]
    qp, qn, qs, qtab = comp["qual"]
    qdec = decode_positional(qp, qs, qn, qtab, num_rec, read_len, rpad,
                             wr.qual_a, wr.qual_group, left=left)
    qual = jnp.where(comp["qual_mode"] > 0,
                     qual_delta_inv(qdec, wr.qual_a), qdec) + 33
    packed, exc_bits, exc_count = comp["dna"]
    seq = unpack_dna(packed, exc_bits, exc_count, rpad, read_len)
    rmask = (jnp.arange(rpad, dtype=jnp.int32) < num_rec)[:, None]
    return (jnp.where(rmask, vmat, 0),
            jnp.where(rmask, qual, 0).astype(jnp.uint8),
            jnp.where(rmask, seq, 0).astype(jnp.uint8))


