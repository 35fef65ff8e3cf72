"""Batched rANS entropy engine — the vectorized replacement for the
reference's scalar adaptive range coder (RangeCoder.h:44-134,
SymbolCoderRC.h:23-92) and Huffman coder (huffman.cpp).

Design (DESIGN.md §1): a symbol stream is split into L contiguous lane-chunks,
each an independent 32-bit rANS stream; a `lax.scan` wavefront advances all
lanes one symbol per step using only vector ops.  Probabilities are quantized
to a power-of-two total (M = 2^14) so decoding needs no division; renormal-
ization moves at most one 16-bit word per symbol, so it is a branchless masked
op.  The encoder runs the wavefront in reverse (standard rANS) with per-symbol
(freq, cum) precomputed in bulk; the decoder runs forward.

Model variants built on the same core:
  * static order-0          (lane-uniform table)
  * adaptive EMA            (per-lane [A] counts, division-free updates)
  * epoch-adaptive order-k  (shared [C, A] tables rebuilt from context
                             histograms after each epoch; see ctx.py)
  * positional              (lanes = records; see quality modelers)

All functions are jit-compatible with static shapes.
"""
from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

PROB_BITS = 14
M = 1 << PROB_BITS                 # total of every quantized model
RANS_L = np.uint32(1 << 16)        # lower bound of the normalized interval
_MASK = np.uint32(M - 1)
_ENC_SHIFT = np.uint32(PROB_BITS + 4)  # x >= freq << 18 triggers emission
_U16 = np.uint32(0xFFFF)


# --------------------------------------------------------------------------
# Lane layout helpers
# --------------------------------------------------------------------------

def lane_lengths(n: int, num_lanes: int) -> np.ndarray:
    """Per-lane symbol counts for a contiguous-chunk split of n symbols."""
    t = -(-n // num_lanes) if n else 0
    starts = np.minimum(np.arange(num_lanes) * t, n)
    ends = np.minimum(starts + t, n)
    return (ends - starts).astype(np.int32)


def lane_split(arr: jnp.ndarray, num_lanes: int) -> jnp.ndarray:
    """[n] -> [T, L] contiguous chunks (lane j covers [j*T, (j+1)*T))."""
    n = arr.shape[0]
    t = -(-n // num_lanes) if n else 1
    pad = t * num_lanes - n
    arr = jnp.pad(arr, (0, pad))
    return arr.reshape(num_lanes, t).T


def lane_merge(lanes: jnp.ndarray, n: int) -> jnp.ndarray:
    """[T, L] -> [n], inverse of lane_split."""
    return lanes.T.reshape(-1)[:n]


def lane_active(t_steps: int, lengths) -> jnp.ndarray:
    """[T, L] active mask from per-lane lengths."""
    return jnp.arange(t_steps, dtype=jnp.int32)[:, None] < \
        jnp.asarray(lengths, jnp.int32)[None, :]


# --------------------------------------------------------------------------
# Probability quantization (shared by encoder and decoder — must be
# deterministic integer math so both sides build identical tables)
# --------------------------------------------------------------------------

def quantize_counts(counts: jnp.ndarray) -> jnp.ndarray:
    """Quantize [..., A] int32 counts to freqs summing to M, all >= 1.

    Laplace-smoothed (counts + 1) so unseen contexts get a near-uniform
    model — required by epoch-adaptive coding where future symbols may be
    unseen.  Deterministic: same result on any backend.
    """
    a = counts.shape[-1]
    # sharpen sparse estimates: observed counts outweigh the +1 Laplace
    # floor 8:1, so thin contexts don't pay a full uniform-mixing tax
    c = (counts.astype(jnp.int32) << 3) + 1
    # rescale so total < 2^16 (keeps c * (M - a) within int32): one direct
    # per-row shift, bit-length computed by compares (no floats — must be
    # bit-identical on every backend)
    tot = c.sum(-1, keepdims=True)
    shift = jnp.zeros_like(tot)
    for k in range(16, 31):  # tot is int32 (< 2^31)
        shift = shift + (tot >= (1 << k))
    c = jnp.maximum(c >> shift, 1)
    tot = c.sum(-1, keepdims=True)
    q = jnp.maximum(1, (c * (M - a)) // tot).astype(jnp.int32)
    deficit = M - q.sum(-1, keepdims=True)
    top = jnp.argmax(q, axis=-1)
    onehot = jax.nn.one_hot(top, a, dtype=jnp.int32)
    return q + onehot * deficit


def cum_from_freqs(freqs: jnp.ndarray) -> jnp.ndarray:
    """[..., A] freqs -> [..., A+1] cumulative (exclusive, cum[-1] = M)."""
    z = jnp.zeros(freqs.shape[:-1] + (1,), freqs.dtype)
    return jnp.concatenate([z, jnp.cumsum(freqs, axis=-1)], axis=-1)


# --------------------------------------------------------------------------
# Encoder core: reverse wavefront with precomputed (freq, cum)
# --------------------------------------------------------------------------

UNROLL = 8       # decode symbols per chunk (pair window = UNROLL//2+1);
# decode-side scheduling only (wire format unaffected)
ENC_UNROLL = 32  # encode symbols per scan step
TILE = 64        # payload tile, in u16 PAIRS (128 words = one 512 B row)
TILE_BITS = 6
# Decode chunks per window refresh: SUPER*UNROLL <= 64 words = 32 pairs
# consumed at most, so a 2-tile (128-pair) window always covers a whole
# super-chunk for any SUPER in 1..8.  SUPER is a decode-side CADENCE only
# (the wire format and encoder are unaffected), but it multiplies the
# unrolled scan-body size and hence XLA compile time, roughly linearly:
# on the H100 one SUPER=8 semi-block decode program took 100-124 s to
# compile and the -m1 context decoders (one unrolled body per band) did not
# finish within 12 minutes, so the default is 1.  DSRC_TPU_SUPER overrides
# it (a test decodes the same archive at 8 to pin cadence independence).
SUPER = min(8, max(1, int(__import__("os").environ.get(
    "DSRC_TPU_SUPER", "1"))))

# Payload access is WINDOWED: the hot loops never touch the full [L, Wp]
# payload per chunk (that dense pass would dominate decode time and
# device-memory traffic).  Instead a per-lane 2-tile register window slides
# monotonically: the decoder refreshes it once per super-chunk with one
# masked pass over the tiled payload; the encoder accumulates emissions
# into the window and emits one completed tile per chunk AT MOST through
# the scan's stacked outputs (so the big payload is never a scan carry).


def _div_u32(x, f):
    """Exact unsigned (x // f, x % f) via an f32 reciprocal + correction.
    Valid for q = x // f < 2^24 (the encoder keeps q < 2^18): the f32
    estimate is then off by at most 1, fixed branchlessly."""
    q = (x.astype(jnp.float32) * (1.0 / f.astype(jnp.float32))) \
        .astype(jnp.uint32)
    r = x - q * f                       # wraps (mod 2^32) if q overshot
    over = r >= np.uint32(1 << 31)      # q too big by 1
    q = jnp.where(over, q - np.uint32(1), q)
    r = jnp.where(over, r + f, r)
    under = r >= f                      # q too small by 1
    q = jnp.where(under, q + np.uint32(1), q)
    r = jnp.where(under, r - f, r)
    return q, r


def _enc_sym(x, f, c, a):
    """One rANS encode sub-step on [L] vectors."""
    do_emit = a & (x >= (f << _ENC_SHIFT))
    word = (x & _U16).astype(jnp.int32)
    x = jnp.where(do_emit, x >> np.uint32(16), x)
    q, r = _div_u32(x, f)
    xn = (q << np.uint32(PROB_BITS)) + c + r
    x = jnp.where(a, xn, x)
    return x, word, do_emit


def payload_window(payload, bt, nt: int):
    """Decode-side window refresh: win[l] = payload-tiles [bt[l], bt[l]+1]
    as one [L, 2*TILE] array, selected with dense masked sums (one pass
    over the tiled payload per super-chunk instead of per chunk).

    Layout note: the window stays L-MAJOR like the payload — a width-major
    form needs a [L, Wp] transpose per decode call (the encoder, which
    OWNS its window, does run width-major; see rans_encode_from_freqs)."""
    l = payload.shape[0]
    tl = jnp.pad(payload, ((0, 0), (0, nt * TILE - payload.shape[1]))) \
        .reshape(l, nt, TILE)
    win = jnp.zeros((l, 2 * TILE), payload.dtype)
    for m in range(nt):
        upper = tl[:, m + 1] if m + 1 < nt else jnp.zeros_like(tl[:, m])
        win = win + jnp.where((bt == m)[:, None],
                              jnp.concatenate([tl[:, m], upper], axis=1), 0)
    return win


def window_pairs(win, lp, npair: int):
    """pairs[m, l] = win[l, lp[l] + m] for m < npair (lp in [0, 2*TILE)):
    npair dense masked sums over the [L, 2*TILE] window, stacked
    WIDTH-MAJOR [npair, L] so the per-substep fetch (pair_at) runs on [L]
    vectors instead of lane-tile-padded [L, npair] ops."""
    wi = jnp.arange(2 * TILE, dtype=jnp.int32)
    m_idx = wi[None, :] - lp[:, None]                     # [L, 2*TILE]
    return jnp.stack(
        [jnp.sum(jnp.where(m_idx == m, win, 0), axis=1)
         for m in range(npair)], 0)                       # [npair, L]


def pair_at(pairs, lp):
    """pairs [npair, L], lp [L] -> pairs[lp[l], l] via an [L]-op select
    chain (the per-substep word fetch)."""
    p = jnp.where(lp == 0, pairs[0], 0)
    for k in range(1, pairs.shape[0]):
        p = jnp.where(lp == k, pairs[k], p)
    return p


def rans_encode_from_freqs(
    freq: jnp.ndarray,      # [T, L] int32 (1..M-1), decode order
    cum: jnp.ndarray,       # [T, L] int32
    active: jnp.ndarray,    # [T, L] bool
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (payload [L, Wp] i32 of u16 PAIRS, nwords [L] int32 in u16
    words, states [L] u32).

    The reverse wavefront processes ENC_UNROLL symbols per scan step and
    writes renorm words into a WIDTH-MAJOR per-lane 2-tile register window
    [2*TILE, L] (lanes on the minor dim; the single transpose back to the
    external [L, Wp] layout happens once at the end of this function); when a
    lane's write head leaves a tile (it only moves down), that finished
    tile is flushed into the carried [nt, TILE, L] payload with one masked
    pass (a stacked-ys variant that avoided the payload carry entirely
    measured slower).  Each chunk's emissions span <= 17 pairs, so they
    accumulate directly into a 32-pair block anchored at a 16-pair
    boundary (one [32, L] masked add per substep) and the block lands in
    the window with four static-slice adds.  The result transposes back
    to the external [L, Wp] layout once at the end.  Word layout: in the
    virtual u16 index space [0, 2*Wp), row j's words occupy
    [2*Wp - nwords[j], 2*Wp) in DECODE order; u16 index ws lives in pair
    ws >> 1, half ws & 1 (low half read first — matches a little-endian
    u16 view of the i32 array, so host serialization is a reinterpret).
    Wp is a multiple of TILE.
    """
    t_steps, l = freq.shape
    u = ENC_UNROLL
    tp = -(-t_steps // u) * u
    wp = -(-(tp + u) // (2 * TILE)) * TILE   # pair capacity, tile-aligned
    wmax = 2 * wp                            # u16 capacity
    nt = wp // TILE
    pad = ((0, tp - t_steps), (0, 0))
    f32 = jnp.pad(jnp.where(active, freq, 1), pad, constant_values=1) \
        .astype(jnp.uint32).reshape(-1, u, l)
    c32 = jnp.pad(cum, pad).astype(jnp.uint32).reshape(-1, u, l)
    act = jnp.pad(active, pad).reshape(-1, u, l)
    ti = jnp.arange(nt, dtype=jnp.int32)
    qi32 = jnp.arange(32, dtype=jnp.int32)

    def step(carry, inp):
        x, b, win, wt, payload = carry        # win [2T, L], payload [nt, T, L]
        f, c, a = inp
        # Emission j of this chunk occupies u16 slot ws0 - j.  The chunk's
        # span [lbase-16, lbase] (pairs, window-local; invariant
        # base>>6 == wt puts lbase in [TILE, 2*TILE)) fits a 32-pair block
        # anchored at the 16-pair boundary sb*16 <= lbase-16, so emissions
        # accumulate straight into the block — no per-substep compaction.
        ws0 = wmax - 1 - b                    # [L] u16 slot of emission 0
        sb = ((((ws0 >> 1) - ((wt - 1) << TILE_BITS)) - 16) >> 4)  # [3,7)
        qbase = ((wt - 1) << TILE_BITS) + (sb << 4)  # blk pair origin
        blk = jnp.zeros((32, l), jnp.int32)
        le = jnp.zeros((l,), jnp.int32)
        for k in range(u - 1, -1, -1):
            x, w, e = _enc_sym(x, f[k], c[k], a[k])
            ws = ws0 - le                     # this emission's u16 slot
            val = jnp.where((ws & 1) == 1, w << 16, w)
            val = jnp.where(e, val, 0)
            q = (ws >> 1) - qbase
            blk = blk + jnp.where(q[None, :] == qi32[:, None],
                                  val[None, :], 0)
            le = le + e.astype(jnp.int32)
        for s in range(3, 7):                 # 4 static-slice adds
            win = win.at[(s << 4):(s << 4) + 32].add(
                jnp.where((sb == s)[None, :], blk, 0))
        b = b + le
        # head left tile wt (<= u/2 pairs per chunk -> at most one tile):
        # flush the finished upper tile into the carried payload with one
        # masked pass, slide the window down one tile
        crossed = (((wmax - 1 - b) >> 1) >> TILE_BITS) < wt
        flush = jnp.where(crossed[None, :], win[TILE:], 0)
        win = jnp.where(
            crossed[None, :],
            jnp.concatenate([jnp.zeros((TILE, l), jnp.int32),
                             win[:TILE]], axis=0), win)
        payload = payload + jnp.where(
            (wt[None, :] == ti[:, None])[:, None, :], flush[None, :, :], 0)
        return (x, b, win, wt - crossed.astype(jnp.int32), payload), None

    x0 = jnp.full((l,), RANS_L, jnp.uint32)
    win0 = jnp.zeros((2 * TILE, l), jnp.int32)
    wt0 = jnp.full((l,), nt - 1, jnp.int32)
    p0 = jnp.zeros((nt, TILE, l), jnp.int32)
    (states, nwords, win, wt, payload), _ = jax.lax.scan(
        step, (x0, jnp.zeros((l,), jnp.int32), win0, wt0, p0),
        (f32, c32, act), reverse=True)
    # final flush: the window still holds tiles wt (upper) and wt-1 (lower)
    payload = payload + jnp.where(
        (wt[None, :] == ti[:, None])[:, None, :], win[None, TILE:, :], 0)
    payload = payload + jnp.where(
        ((wt - 1)[None, :] == ti[:, None])[:, None, :],
        win[None, :TILE, :], 0)
    # one transpose back to the external [L, Wp] layout
    return payload.reshape(nt * TILE, l).T, nwords, states


# --------------------------------------------------------------------------
# Decoder core: forward wavefront with a pluggable symbol model
# --------------------------------------------------------------------------

def rans_decode(
    payload: jnp.ndarray,    # [L, Wp] int32 pairs
    states: jnp.ndarray,     # [L] uint32
    lengths: jnp.ndarray,    # [L] int32
    t_steps: int,
    model_fn: Callable,      # (carry, slot_i32 [L], t, active) ->
                             #   (sym [L] i32, freq [L] i32, cum [L] i32, carry)
    model_carry,
    nwords=None,             # right-aligned payload: start at 2*Wp - nwords
):
    """Returns (syms [T, L] int32, final_states [L] u32, model_carry).
    payload is the paired layout from rans_encode_from_freqs.

    Super-chunked wavefront: one scan step decodes SUPER*UNROLL symbols.
    The per-lane word pointer moves at most 32 pairs per super-chunk, so
    one 2-tile (128-pair) window refreshed at the top of the step covers
    every read inside it — the full payload is touched once per
    super-chunk instead of once per chunk (8x less payload traffic, which
    dominated decode time)."""
    l = payload.shape[0]
    npf = UNROLL // 2 + 1
    nt = -(-payload.shape[1] // TILE) + 1    # +1 guard tile (zeros)
    wptr0 = jnp.zeros((l,), jnp.int32) if nwords is None \
        else (2 * payload.shape[1] - nwords).astype(jnp.int32)
    chunks = max(1, -(-t_steps // UNROLL))
    sups = -(-chunks // SUPER)

    def sup_step(carry, ts0):
        x, wptr, mc = carry
        bt = (wptr >> 1) >> TILE_BITS
        win = payload_window(payload, bt, nt)
        base = bt << (TILE_BITS + 1)          # window start in u16 words
        syms = []
        for ci in range(SUPER):
            pairs = window_pairs(win, (wptr - base) >> 1, npf)
            phase = wptr & 1
            o = jnp.zeros((l,), jnp.int32)
            for ui in range(UNROLL):
                t = ts0 + ci * UNROLL + ui
                active = t < lengths
                slot = (x & _MASK).astype(jnp.int32)
                sym, f, c, mc = model_fn(mc, slot, t, active)
                fu = jnp.where(active, f, 1).astype(jnp.uint32)
                xn = fu * (x >> np.uint32(PROB_BITS)) \
                    + slot.astype(jnp.uint32) - c.astype(jnp.uint32)
                need = active & (xn < RANS_L)
                lp = (phase + o) >> 1
                half = (phase + o) & 1
                p = pair_at(pairs, lp)
                w = (jnp.where(half == 1, p >> 16, p) & 0xFFFF) \
                    .astype(jnp.uint32)
                xn = jnp.where(need, (xn << np.uint32(16)) | w, xn)
                x = jnp.where(active, xn, x)
                o = o + need.astype(jnp.int32)
                syms.append(sym)
            wptr = wptr + o
        return (x, wptr, mc), jnp.stack(syms)

    (x, _, mc), syms = jax.lax.scan(
        sup_step, (states, wptr0, model_carry),
        jnp.arange(sups, dtype=jnp.int32) * (SUPER * UNROLL))
    return syms.reshape(sups * SUPER * UNROLL, l)[:t_steps], x, mc


def symbol_from_slot(slot: jnp.ndarray, cumfull: jnp.ndarray, nsym: int):
    """Locate symbol for each lane given [..., A+1] cumulative table.

    cumfull may be [A+1] (uniform) or [L, A+1] (per-lane).  Returns
    (sym, freq, cum) as int32 [L].

    For A >= 16 (multiple of 8) a two-level search runs: a coarse compare
    over the A/8 sub-row boundaries picks hi, one select chain extracts
    the 8-entry sub-row, a fine compare picks lo — ~A + 3*(A/8) + 30
    [L]-ops instead of ~4*A for the flat compare + one-hot MACs.
    """
    if cumfull.ndim == 1:
        cumfull = cumfull[None, :]
    l = slot.shape[0]
    if nsym >= 16 and nsym % 8 == 0:
        hi_n = nsym // 8
        row8 = cumfull[:, ::8]                            # [., H+1]
        ge_h = (slot[:, None] >= row8[:, 1:hi_n]).astype(jnp.int32)
        hi = ge_h.sum(1)                                  # [L]
        oh_h = (hi[:, None]
                == jnp.arange(hi_n, dtype=jnp.int32)[None, :]) \
            .astype(jnp.int32)                            # [L, H]
        rowmat = jnp.broadcast_to(
            cumfull[:, :nsym], (l, nsym)).reshape(l, hi_n, 8)
        fine = jnp.zeros((l, 8), jnp.int32)
        for m in range(hi_n):
            fine = fine + oh_h[:, m:m + 1] * rowmat[:, m, :]
        row9 = (oh_h * jnp.broadcast_to(row8[:, 1:hi_n + 1],
                                        (l, hi_n))).sum(1)
        ge_l = (slot[:, None] >= fine[:, 1:]).astype(jnp.int32)
        lo = ge_l.sum(1)
        sym = (hi << 3) + lo
        oh_l = (lo[:, None]
                == jnp.arange(8, dtype=jnp.int32)[None, :]).astype(jnp.int32)
        cum_lo = (oh_l * fine).sum(1)
        fine9 = jnp.concatenate([fine[:, 1:], row9[:, None]], axis=1)
        return sym, (oh_l * fine9).sum(1) - cum_lo, cum_lo
    ge = (slot[:, None] >= cumfull[:, 1:nsym]).astype(jnp.int32)  # [L, A-1]
    sym = ge.sum(1)
    onehot = jax.nn.one_hot(sym, nsym, dtype=jnp.int32)           # [L, A]
    cum_lo = (onehot * cumfull[:, :nsym]).sum(1)
    cum_hi = (onehot * cumfull[:, 1:nsym + 1]).sum(1)
    return sym, cum_hi - cum_lo, cum_lo


# --------------------------------------------------------------------------
# Static order-0 codec
# --------------------------------------------------------------------------

def encode_order0(syms: jnp.ndarray, nsym: int, num_lanes: int):
    """Static order-0 coding of [n] symbols with a single shared table.

    Returns dict of device arrays + the quantized freqs (to transmit).
    """
    n = syms.shape[0]
    counts = jnp.zeros((nsym,), jnp.int32).at[syms].add(1, mode="drop")
    freqs = quantize_counts(counts)
    cumfull = cum_from_freqs(freqs)
    lanes = lane_split(syms.astype(jnp.int32), num_lanes)
    t_steps = lanes.shape[0]
    lengths = jnp.asarray(lane_lengths(n, num_lanes))
    active = lane_active(t_steps, lengths)
    f = freqs[lanes]
    c = cumfull[:-1][lanes]
    payload, nwords, states = rans_encode_from_freqs(f, c, active)
    return dict(payload=payload, nwords=nwords, states=states, freqs=freqs)


def decode_order0(payload, states, freqs, n: int, nsym: int, num_lanes: int,
                  nwords=None):
    cumfull = cum_from_freqs(freqs)
    lengths = jnp.asarray(lane_lengths(n, num_lanes))
    t_steps = -(-n // num_lanes) if n else 1

    def model(carry, slot, t, active):
        sym, f, c = symbol_from_slot(slot, cumfull, nsym)
        return sym, f, c, carry

    syms, _, _ = rans_decode(payload, states, lengths, t_steps, model, (),
                             nwords=nwords)
    return lane_merge(syms, n)


# --------------------------------------------------------------------------
# Adaptive EMA codec (division-free, constant-total integer model)
# --------------------------------------------------------------------------

EMA_RATE = 5  # adaptation rate: counts lose 1/2^r mass to the seen symbol


def ema_init(num_lanes: int, nsym: int) -> jnp.ndarray:
    base = M // nsym
    rem = M - base * nsym
    row = base + (jnp.arange(nsym) < rem).astype(jnp.int32)
    return jnp.broadcast_to(row, (num_lanes, nsym)).astype(jnp.int32)


def ema_update(counts: jnp.ndarray, sym: jnp.ndarray, active) -> jnp.ndarray:
    """counts [L, A] -> updated; total stays exactly M, entries stay >= 1."""
    dec = counts >> EMA_RATE
    newc = counts - dec
    deficit = dec.sum(1)
    onehot = jax.nn.one_hot(sym, counts.shape[1], dtype=jnp.int32)
    newc = newc + onehot * deficit[:, None]
    return jnp.where(active[:, None], newc, counts)


def encode_adaptive(syms: jnp.ndarray, nsym: int, num_lanes: int):
    """Adaptive-EMA order-0 coding; no tables are transmitted."""
    n = syms.shape[0]
    lanes = lane_split(syms.astype(jnp.int32), num_lanes)
    t_steps = lanes.shape[0]
    lengths = jnp.asarray(lane_lengths(n, num_lanes))
    active = lane_active(t_steps, lengths)

    def model_pass(counts, inp):
        s, a = inp
        cumf = cum_from_freqs(counts)
        onehot = jax.nn.one_hot(s, nsym, dtype=jnp.int32)
        f = (onehot * counts).sum(1)
        c = (onehot * cumf[:, :nsym]).sum(1)
        counts = ema_update(counts, s, a)
        return counts, (f, c)

    _, (f, c) = jax.lax.scan(model_pass, ema_init(num_lanes, nsym),
                             (lanes, active))
    payload, nwords, states = rans_encode_from_freqs(f, c, active)
    return dict(payload=payload, nwords=nwords, states=states)


def decode_adaptive(payload, states, n: int, nsym: int, num_lanes: int,
                    nwords=None):
    lengths = jnp.asarray(lane_lengths(n, num_lanes))
    t_steps = -(-n // num_lanes) if n else 1

    def model(counts, slot, t, active):
        cumf = cum_from_freqs(counts)
        sym, f, c = symbol_from_slot(slot, cumf, nsym)
        counts = ema_update(counts, sym, active)
        return sym, f, c, counts

    syms, _, _ = rans_decode(payload, states, lengths, t_steps, model,
                             ema_init(num_lanes, nsym), nwords=nwords)
    return lane_merge(syms, n)
