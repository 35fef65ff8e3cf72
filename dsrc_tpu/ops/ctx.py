"""Epoch-adaptive context-model rANS — the vectorized replacement for the
reference's per-symbol adaptive order-k range coding (DnaModelerRCO.h:44-131,
QualityEncoder.h:77-330, SymbolCoderRC.h:23-92).

Why epochs (DESIGN.md §1): per-symbol model adaptation serializes decoding and
would need per-lane private [C, A] tables.  Instead the wavefront time axis is
split into E geometric *bands*; band e is coded with a static quantized table
built from the (ctx, sym) histogram of bands < e, which the decoder rebuilds
after decoding each band.  No tables are transmitted, adaptation happens at
band granularity, and within a band every position is independent → bulk
vector ops.  Bands double in size (1, 1, 2, 4, ...×base) so early adaptation
is fast while table rebuilds stay O(log T).

Context rule: each lane chunk starts with an empty context (carry = 0); the
carry update is `carry' = ((carry << sym_bits) | sym) & mask` — a pure
function of previously decoded symbols in the same lane, so encoder (bulk
shifts) and decoder (scan carry) always agree.  A positional context can be
mixed in via `pos_fn(t) -> extra ctx id` (used by quality modelers).
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .rans import (
    M, PROB_BITS, RANS_L, SUPER, TILE, TILE_BITS, UNROLL, _MASK, _U16,
    cum_from_freqs, lane_active, lane_lengths, lane_merge, lane_split,
    pair_at, payload_window, quantize_counts, rans_encode_from_freqs,
    symbol_from_slot, window_pairs,
)


def band_edges(t_steps: int, max_bands: int = 9,
               base: int = 16) -> Tuple[int, ...]:
    """Geometric band schedule: edges 0 < b, 2b, 4b, ... <= T (b = base)."""
    edges = [0]
    e = base
    while e < t_steps and len(edges) < max_bands:
        edges.append(e)
        e *= 2
    edges.append(t_steps)
    return tuple(edges)


def history_ctx_lanes(lanes: jnp.ndarray, order: int, sym_bits: int,
                      hash_mul: int = 0) -> jnp.ndarray:
    """[T, L] symbol lanes -> [T, L] context ids from the previous `order`
    symbols of the same lane (packed at sym_bits each, oldest highest).

    If hash_mul != 0, uses the multiplicative rolling hash
    `h' = (h * hash_mul + s + 1) & mask` instead of exact packing (for high
    orders where A^order would not fit); must then be mirrored by
    `history_carry_update`.
    """
    t_steps, l = lanes.shape
    mask = (1 << (order * sym_bits)) - 1
    if hash_mul:
        def step(h, s):
            hn = ((h * hash_mul + s + 1) & mask).astype(jnp.int32)
            return hn, h
        _, ctx = jax.lax.scan(step, jnp.zeros((l,), jnp.int32), lanes)
        return ctx
    ctx = jnp.zeros_like(lanes)
    for i in range(1, order + 1):
        prev = jnp.pad(lanes, ((i, 0), (0, 0)))[:t_steps]
        ctx = ctx | (prev << ((i - 1) * sym_bits))
    return ctx & mask


def history_carry_update(carry: jnp.ndarray, sym: jnp.ndarray, order: int,
                         sym_bits: int, hash_mul: int = 0) -> jnp.ndarray:
    """Decoder-side mirror of history_ctx_lanes (carry IS the ctx id)."""
    mask = (1 << (order * sym_bits)) - 1
    if hash_mul:
        return ((carry * hash_mul + sym + 1) & mask).astype(jnp.int32)
    return ((carry << sym_bits) | sym) & mask


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------

def encode_ctx_lanes(
    lanes: jnp.ndarray,        # [T, L] int32 symbols, decode order
    active: jnp.ndarray,       # [T, L] bool
    ctx: jnp.ndarray,          # [T, L] int32 context ids in [0, num_ctx)
    num_ctx: int,
    nsym: int,
    edges: Tuple[int, ...],
):
    """Band-adaptive encode.  Returns (payload [L, T], nwords [L], states [L]).

    The decoder reconstructs each band's table from its own decoded history,
    so nothing but the payload/states needs transmission.
    """
    t_steps, l = lanes.shape
    nbins = num_ctx * nsym
    hist = jnp.zeros((nbins,), jnp.int32)
    packed = jnp.zeros((t_steps, l), jnp.int32)
    sym_iota = jnp.arange(nsym, dtype=jnp.int32)
    for b in range(len(edges) - 1):
        t0, t1 = edges[b], edges[b + 1]
        table = quantize_counts(hist.reshape(num_ctx, nsym))   # [C, A]
        cumfull = cum_from_freqs(table)                        # [C, A+1]
        bc, bs, ba = ctx[t0:t1], lanes[t0:t1], active[t0:t1]
        # ONE row-take per symbol + a fused one-hot masked reduction over
        # the alphabet: (cum << 15 | freq) packed into the table entry
        # (both < 2^15), so one lookup yields both values.
        ptab = (cumfull[:, :nsym] << 15) | table
        rows = jnp.take(ptab, bc, axis=0, mode="clip")    # [tb, L, A]
        vals = jnp.where(bs[:, :, None] == sym_iota, rows, 0).sum(axis=2)
        packed = packed.at[t0:t1].set(vals)
        hist = hist + hist_update(bc * nsym + bs, ba, nbins)
    return rans_encode_from_freqs(packed & 0x7FFF, packed >> 15, active)


def hist_update(flat: jnp.ndarray, active: jnp.ndarray, nbins: int):
    """[*] flat bin ids -> [nbins] int32 counts of the active elements.
    int8 one-hot matmul when the id space splits into <= 512-wide halves,
    scatter-add beyond that."""
    if nbins <= 512 * 512:
        return _hist_mxu(jnp.where(active, flat, 0), active, nbins)
    out = jnp.zeros((nbins,), jnp.int32)
    return out.at[jnp.where(active, flat, nbins)].add(1, mode="drop")


def _hist_mxu(ids: jnp.ndarray, active: jnp.ndarray, nbins: int):
    """[*] flat bin ids (masked by active) -> [nbins] int32 counts as a
    one-hot outer product: split id = hi*W + lo, then
    hist2d[h, l] = sum_i oh_hi[i, h] * oh_lo[i, l] — one matmul contracting
    over all symbols replaces a scatter-add.  Exact: int8 0/1 one-hot
    operands with int32 accumulation."""
    w, wbits = 128, 7
    while -(-nbins // w) > w:                 # keep hi_n <= W (<= 512)
        w, wbits = w * 2, wbits + 1
    hi_n = -(-nbins // w)
    idf = ids.reshape(-1)
    oh_hi = ((idf[:, None] >> wbits) == jnp.arange(hi_n, dtype=jnp.int32)) \
        & active.reshape(-1)[:, None]
    oh_lo = (idf[:, None] & (w - 1)) == jnp.arange(w, dtype=jnp.int32)
    h2 = jax.lax.dot_general(
        oh_hi.astype(jnp.int8), oh_lo.astype(jnp.int8),
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)                 # [hi_n, W]
    return h2.reshape(hi_n * w)[:nbins]


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------

def decode_ctx_lanes(
    payload: jnp.ndarray,      # [L, W] int32 u16 words
    states: jnp.ndarray,       # [L] uint32
    lengths: jnp.ndarray,      # [L] int32
    t_steps: int,
    num_ctx: int,
    nsym: int,
    edges: Tuple[int, ...],
    carry_init: jnp.ndarray,             # [L] int32 context carries
    ctx_of: Callable,          # (carry [L], t) -> ctx ids [L]
    carry_update: Callable,    # (carry [L], sym [L], t) -> carry [L]
    nwords=None,               # right-aligned payload: start at W - nwords
):
    """Mirror of encode_ctx_lanes.  Returns syms [T, L] int32.

    The payload is the PAIRED layout (two u16 renorm words per i32); each
    chunk prefetches the pairs that can cover its <= UNROLL word reads
    from the per-lane payload window, so pairing halves the word fetches.
    """
    l = payload.shape[0]
    wmax = 2 * payload.shape[1]
    npf = UNROLL // 2 + 1          # pairs prefetched per chunk
    nt = -(-payload.shape[1] // TILE) + 1    # +1 guard tile (zeros)
    hist = jnp.zeros((num_ctx * nsym,), jnp.int32)
    x = states
    wptr = jnp.zeros((l,), jnp.int32) if nwords is None \
        else (wmax - nwords).astype(jnp.int32)
    carry = carry_init
    out = jnp.zeros((t_steps, l), jnp.int32)

    def substep(x, o, pairs, phase, carry, t, t1, cumfull):
        active = (t < t1) & (t < lengths)
        c_ids = ctx_of(carry, t)
        rows = jnp.take(cumfull, c_ids, axis=0, mode="clip")  # [L, A+1]
        slot = (x & _MASK).astype(jnp.int32)
        sym, f, cu = symbol_from_slot(slot, rows, nsym)
        fu = jnp.where(active, f, 1).astype(jnp.uint32)
        xn = fu * (x >> np.uint32(PROB_BITS)) + slot.astype(jnp.uint32) \
            - cu.astype(jnp.uint32)
        need = active & (xn < RANS_L)
        lp = (phase + o) >> 1
        half = (phase + o) & 1
        p = pair_at(pairs, lp)
        w = (jnp.where(half == 1, p >> 16, p) & 0xFFFF).astype(jnp.uint32)
        xn = jnp.where(need, (xn << np.uint32(16)) | w, xn)
        x = jnp.where(active, xn, x)
        o = o + need.astype(jnp.int32)
        new_carry = carry_update(carry, sym, t)
        carry = jnp.where(active, new_carry, carry)
        return x, o, carry, sym, c_ids

    for b in range(len(edges) - 1):
        t0, t1 = edges[b], edges[b + 1]
        table = quantize_counts(hist.reshape(num_ctx, nsym))
        cumfull = cum_from_freqs(table)                        # [C, A+1]
        chunks = -(-(t1 - t0) // UNROLL)
        sups = -(-chunks // SUPER)

        def sup_step(state, ts0, t1=t1, cumfull=cumfull):
            x, wptr, carry = state
            # refresh the per-lane 2-tile payload window once per
            # super-chunk (rans.payload_window); every word read inside
            # the super-chunk stays within it
            bt = (wptr >> 1) >> TILE_BITS
            win = payload_window(payload, bt, nt)
            base = bt << (TILE_BITS + 1)
            syms, ctxs = [], []
            for ci in range(SUPER):
                pairs = window_pairs(win, (wptr - base) >> 1, npf)
                phase = wptr & 1
                o = jnp.zeros((l,), jnp.int32)
                for ui in range(UNROLL):
                    x, o, carry, sym, c_ids = substep(
                        x, o, pairs, phase, carry,
                        ts0 + ci * UNROLL + ui, t1, cumfull)
                    syms.append(sym)
                    ctxs.append(c_ids)
                wptr = wptr + o
            return (x, wptr, carry), (jnp.stack(syms), jnp.stack(ctxs))

        (x, wptr, carry), (syms_b, ctx_b) = jax.lax.scan(
            sup_step, (x, wptr, carry),
            t0 + jnp.arange(sups, dtype=jnp.int32) * (SUPER * UNROLL))
        syms_b = syms_b.reshape(sups * SUPER * UNROLL, l)[: t1 - t0]
        ctx_b = ctx_b.reshape(sups * SUPER * UNROLL, l)[: t1 - t0]
        out = out.at[t0:t1].set(syms_b)
        ba = lane_active(t_steps, lengths)[t0:t1]
        hist = hist + hist_update(ctx_b * nsym + syms_b, ba, num_ctx * nsym)
    return out


# --------------------------------------------------------------------------
# Flat-stream convenience wrappers (order-k over a [n] symbol stream)
# --------------------------------------------------------------------------

def stream_cap(cap: int, n: int) -> int:
    """Power-of-two working length for a stream of n symbols inside a block
    of capacity cap.  Sizing lanes/steps to the STREAM (not the block)
    keeps per-lane overhead (state + word count) proportional to the data —
    a 16 KB tag stream must not pay for 2048 lanes sized to an 8 MB block.
    Both sides derive it from the transmitted n, so encoder/decoder agree.
    """
    if n <= 1:
        return min(cap, 4096)
    return min(cap, max(4096, 1 << int(n - 1).bit_length()))


def pick_num_lanes(n: int, target_per_lane: int = 512,
                   max_lanes: int = 2048) -> int:
    l = max(8, min(max_lanes, n // target_per_lane if n else 8))
    # round down to a power of two for clean layouts
    return 1 << (l.bit_length() - 1)


@functools.partial(jax.jit, static_argnames=(
    "order", "sym_bits", "nsym", "num_lanes", "hash_mul", "edges"))
def encode_orderk(syms: jnp.ndarray, n, order: int, sym_bits: int,
                  nsym: int, num_lanes: int, edges: Tuple[int, ...],
                  hash_mul: int = 0):
    """Order-k context coding of a flat [cap] stream (first n valid)."""
    lanes = lane_split(syms.astype(jnp.int32), num_lanes)
    t_steps = lanes.shape[0]
    per = t_steps  # chunk size per lane
    nn = jnp.asarray(n, jnp.int32)
    starts = jnp.minimum(jnp.arange(num_lanes, dtype=jnp.int32) * per, nn)
    lengths = jnp.minimum(starts + per, nn) - starts
    active = lane_active(t_steps, lengths)
    lanes = jnp.where(active, lanes, 0)
    ctx = history_ctx_lanes(lanes, order, sym_bits, hash_mul)
    num_ctx = 1 << (order * sym_bits)
    payload, nwords, states = encode_ctx_lanes(
        lanes, active, ctx, num_ctx, nsym, edges)
    return dict(payload=payload, nwords=nwords, states=states)


@functools.partial(jax.jit, static_argnames=(
    "order", "sym_bits", "nsym", "num_lanes", "hash_mul", "edges",
    "t_steps"))
def decode_orderk(payload, states, n, t_steps: int, order: int,
                  sym_bits: int, nsym: int, num_lanes: int,
                  edges: Tuple[int, ...], hash_mul: int = 0, nwords=None):
    per = t_steps
    nn = jnp.asarray(n, jnp.int32)
    starts = jnp.minimum(jnp.arange(num_lanes, dtype=jnp.int32) * per, nn)
    lengths = jnp.minimum(starts + per, nn) - starts
    num_ctx = 1 << (order * sym_bits)
    syms = decode_ctx_lanes(
        payload, states, lengths, t_steps, num_ctx, nsym, edges,
        jnp.zeros((num_lanes,), jnp.int32),
        ctx_of=lambda carry, t: carry,
        carry_update=lambda carry, sym, t: history_carry_update(
            carry, sym, order, sym_bits, hash_mul),
        nwords=nwords,
    )
    return lane_merge(syms, syms.shape[0] * num_lanes)


def decode_ctx_precomputed(payload, states, lengths, t_steps: int,
                           num_ctx: int, nsym: int,
                           edges: Tuple[int, ...],
                           ctx_lanes: jnp.ndarray, nwords=None):
    """Decode when the context of every position is known in advance
    (e.g. positional contexts derived from record lengths, or a previously
    decoded companion stream).  ctx_lanes: [T, L] int32."""
    return decode_ctx_lanes(
        payload, states, lengths, t_steps, num_ctx, nsym, edges,
        jnp.zeros((ctx_lanes.shape[1],), jnp.int32),
        ctx_of=lambda carry, t: jax.lax.dynamic_index_in_dim(
            ctx_lanes, t, 0, keepdims=False),
        carry_update=lambda carry, sym, t: carry,
        nwords=nwords,
    )
