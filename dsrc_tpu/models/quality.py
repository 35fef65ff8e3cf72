"""Quality stream codec — per-block scheme selection over the device kernels.

Capability map vs the reference (QualityModelerProxy.h:113-292,
QualityPositionModeler.cpp, QualityRLEModeler.cpp, QualityEncoder.h):

  scheme CONST : one distinct value — store it (degenerate fast path,
                 QualityRLEModeler.cpp:360-372 equivalent)
  scheme POS   : positional coding — every symbol's context is its read
                 position (capped); replaces the per-position Huffman trees
                 (QualityPositionModeler.cpp:107-186) with band-adaptive rANS
                 (no trees/tables transmitted)
  scheme TRUNC : positional over the '#'-truncated prefix; trailing run
                 reconstructed from per-record truncated lengths
                 (QualityPositionModeler.cpp:240-335 equivalent)
  scheme RLE   : run-length (sym, len<=254) with run-sym conditioned on the
                 previous run's sym and len conditioned on sym
                 (QualityRLEModeler.cpp:142-311 equivalent)
  scheme CTX   : order-k context coding with positional mixing and a dense
                 ("translational") symbol remap — replaces the adaptive
                 order models (QualityEncoder.h:77-330); contexts are a
                 structured pack of COARSENED previous in-record symbols
                 (nearest lag finest; sampling-budgeted, _coarse_bits)
                 plus a 16-bucket relative-position id (the reference's
                 pctx = j*K/len, QualityEncoder.h:244)

Scheme choice for order 0 follows the reference's ratio rules
(QualityModelerProxy.h:113-122); order >= 1 always uses CTX.

Quality values here are post-transform ints in [0, 256): offset-subtracted,
with folded ambiguity codes >= 128 (lossless) or 8-bin values (lossy).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import ctx as C
from ..ops.rans import lane_active, lane_merge, lane_split
from ..ops.streams import (deserialize_rans, pack_ints, serialize_rans,
                           unpack_ints)
from ..ops.transform import compact, expand_positions
from ..utils.bitio import BitReader, BitWriter

QS_EMPTY = 0
QS_CONST = 1
QS_POS = 2
QS_TRUNC = 3
QS_RLE = 4
QS_CTX = 5

POS_CTX_CAP = 256      # positional context ids are min(pos, cap-1)
POS_BUCKETS = 16       # relative-position buckets for CTX scheme
MAX_RUN = 254          # reference's run-length cap (QualityRLEModeler)
A_BUCKETS = (2, 4, 8, 16, 32, 64, 128, 256)


def _a_pad(distinct: int) -> int:
    for a in A_BUCKETS:
        if distinct <= a:
            return a
    return 256


def _qbits(a_pad: int) -> int:
    return max(1, (a_pad - 1).bit_length())


def _pow2ceil(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length()) if n > 1 else 1


def _coarse_bits(order: int, qbits: int, n_hint: int):
    """Per-lag context bits for the CTX scheme: nearest lag finest (the
    previous quality value carries most of the AR correlation real base
    callers produce), older lags coarsened by right-shifting.

    Total history bits bounded by BOTH the sampling budget (total bins <=
    n/8, else the per-band Laplace smoothing dominates — measured 4.26
    vs 4.09 b/sym AGAINST position-only on AR(1) quality with the old
    1M-bin hashed contexts) and the one-hot matmul histogram limit
    (bins <= 2^18, ops/ctx.hist_update).  Deterministic from the transmitted stream
    length, so encoder and decoder agree."""
    budget = max(0, int(n_hint).bit_length() - 1 - 3 - 4 - qbits)
    hb = min(order * qbits, 18 - 4 - qbits, budget)
    lags = []
    want = (qbits, 3, 2, 2)             # finest first
    for k in range(min(order, 4)):
        c = min(want[k], hb - sum(lags))
        if c <= 0:
            break
        lags.append(c)
    return tuple(lags)


def _pos_params(a_pad: int, n_hint: int):
    """Positional-context coarsening: shift positions right until the table
    (ctx × a_pad) is adequately sampled."""
    shift = 0
    while shift < 8 and (POS_CTX_CAP >> shift) * a_pad > max(n_hint // 4,
                                                             1024):
        shift += 1
    return shift, POS_CTX_CAP >> shift


# --------------------------------------------------------------------------
# Stream layout from record lengths (shared by encoder and decoder)
# --------------------------------------------------------------------------

def stream_layout(lengths: jnp.ndarray, cap: int):
    """lengths [R] -> (rec_of [cap], pos_of [cap]) for the concatenated
    stream; positions past the total get clipped values (mask separately)."""
    cum = jnp.cumsum(lengths)
    starts = cum - lengths
    idx = jnp.arange(cap, dtype=jnp.int32)
    rec_of = jnp.searchsorted(cum, idx, side="right").astype(jnp.int32)
    rec_c = jnp.minimum(rec_of, lengths.shape[0] - 1)
    pos_of = idx - jnp.take(starts, rec_c, mode="clip")
    return rec_c, pos_of


# --------------------------------------------------------------------------
# Stats (device) for scheme selection
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cap", "rcap"))
def quality_stats(qvals: jnp.ndarray, n, lengths: jnp.ndarray, num_rec,
                  hash_val, cap: int, rcap: int):
    active = jnp.arange(cap, dtype=jnp.int32) < n
    v = jnp.where(active, qvals, 256)
    hist = jnp.zeros((257,), jnp.int32).at[v].add(1, mode="drop")[:256]
    rec_of, pos_of = stream_layout(lengths, cap)
    rmask = jnp.arange(rcap, dtype=jnp.int32) < num_rec
    # truncated length per record: 1 + last position != hash_val
    is_real = (qvals != hash_val) & active
    tl = jnp.zeros((rcap,), jnp.int32).at[rec_of].max(
        jnp.where(is_real, pos_of + 1, 0), mode="drop")
    tl = jnp.where(rmask, tl, 0)
    # run count (record-segmented)
    prev = jnp.concatenate([qvals[:1] + 1, qvals[:-1]])
    new_run = ((qvals != prev) | (pos_of == 0)) & active
    n_runs = new_run.astype(jnp.int32).sum()
    return hist, n_runs, tl


# --------------------------------------------------------------------------
# Generic precomputed-context codec (POS / TRUNC / RLE substreams)
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=(
    "num_ctx", "nsym", "num_lanes", "edges"))
def _encode_ctxarr(dense: jnp.ndarray, n, ctx: jnp.ndarray,
                   num_ctx: int, nsym: int, num_lanes: int,
                   edges: Tuple[int, ...]):
    lanes = lane_split(dense.astype(jnp.int32), num_lanes)
    ctxl = lane_split(ctx.astype(jnp.int32), num_lanes)
    t_steps = lanes.shape[0]
    lengths = _lane_lengths(n, num_lanes, t_steps)
    active = lane_active(t_steps, lengths)
    payload, nwords, states = C.encode_ctx_lanes(
        jnp.where(active, lanes, 0), active, jnp.where(active, ctxl, 0),
        num_ctx, nsym, edges)
    return dict(payload=payload, nwords=nwords, states=states)


@functools.partial(jax.jit, static_argnames=(
    "num_ctx", "nsym", "num_lanes", "edges", "t_steps"))
def _decode_ctxarr(payload, states, n, ctx: jnp.ndarray, t_steps: int,
                   num_ctx: int, nsym: int, num_lanes: int,
                   edges: Tuple[int, ...]):
    lengths = _lane_lengths(n, num_lanes, t_steps)
    ctxl = lane_split(ctx.astype(jnp.int32), num_lanes)
    active = lane_active(t_steps, lengths)
    syms = C.decode_ctx_precomputed(
        payload, states, lengths, t_steps, num_ctx, nsym, edges,
        jnp.where(active, ctxl, 0))
    return lane_merge(syms, t_steps * num_lanes)


def _lane_lengths(n, num_lanes: int, t_steps: int):
    nn = jnp.asarray(n, jnp.int32)
    starts = jnp.minimum(
        jnp.arange(num_lanes, dtype=jnp.int32) * t_steps, nn)
    return jnp.minimum(starts + t_steps, nn) - starts


# --------------------------------------------------------------------------
# CTX scheme: rolling in-record hash + relative-position bucket
# --------------------------------------------------------------------------

def _ctx_params(order: int, a_pad: int, n_hint: int):
    qbits = _qbits(a_pad)
    lags = _coarse_bits(order, qbits, n_hint)
    hb = sum(lags)
    num_ctx = (1 << hb) * POS_BUCKETS
    return qbits, hb, lags, num_ctx


def _coarse_ctx(carry, qbits: int, lags) -> "jnp.ndarray":
    """Exact-history carry (recent syms packed at qbits each, newest in
    the low bits) -> structured coarse context id."""
    ctx = jnp.zeros_like(carry)
    qmask = (1 << qbits) - 1
    for k, c in enumerate(lags):
        s = (carry >> (k * qbits)) & qmask
        ctx = (ctx << c) | (s >> (qbits - c))
    return ctx


def _rle_sym_order(a_pad: int, nr_hint: int) -> int:
    return 1 if nr_hint >= 4 * a_pad * a_pad else 0


def _bucket(pos, rlen):
    return jnp.minimum(POS_BUCKETS - 1,
                       (pos * POS_BUCKETS) // jnp.maximum(rlen, 1))


@functools.partial(jax.jit, static_argnames=(
    "cap", "order", "a_pad", "num_lanes", "edges", "n_hint"))
def _encode_ctxq(dense: jnp.ndarray, n, lengths: jnp.ndarray,
                 cap: int, order: int, a_pad: int, num_lanes: int,
                 edges: Tuple[int, ...], n_hint: int):
    qbits, hb, lags, num_ctx = _ctx_params(order, a_pad, n_hint)
    hmask = (1 << (len(lags) * qbits)) - 1 if lags else 0
    rec_of, pos_of = stream_layout(lengths, cap)
    rlen = jnp.take(lengths, rec_of, mode="clip")
    bucket = _bucket(pos_of, rlen)
    lanes = lane_split(dense.astype(jnp.int32), num_lanes)
    t_steps = lanes.shape[0]
    llen = _lane_lengths(n, num_lanes, t_steps)
    active = lane_active(t_steps, llen)
    lanes = jnp.where(active, lanes, 0)
    reset = lane_split((pos_of == 0).astype(jnp.int32), num_lanes)
    buckl = lane_split(bucket, num_lanes)

    def step(h, inp):
        s, rs = inp
        h_eff = jnp.where(rs > 0, 0, h)
        h2 = ((h_eff << qbits) | s) & hmask
        return h2, h_eff

    _, hist = jax.lax.scan(
        step, jnp.zeros((num_lanes,), jnp.int32), (lanes, reset))
    ctx = _coarse_ctx(hist, qbits, lags) | (buckl << hb)
    payload, nwords, states = C.encode_ctx_lanes(
        lanes, active, jnp.where(active, ctx, 0), num_ctx, a_pad, edges)
    return dict(payload=payload, nwords=nwords, states=states)


@functools.partial(jax.jit, static_argnames=(
    "cap", "order", "a_pad", "num_lanes", "edges", "t_steps", "n_hint"))
def _decode_ctxq(payload, states, n, lengths: jnp.ndarray, cap: int,
                 t_steps: int, order: int, a_pad: int, num_lanes: int,
                 edges: Tuple[int, ...], n_hint: int):
    qbits, hb, lags, num_ctx = _ctx_params(order, a_pad, n_hint)
    hmask = (1 << (len(lags) * qbits)) - 1 if lags else 0
    rec_of, pos_of = stream_layout(lengths, cap)
    rlen = jnp.take(lengths, rec_of, mode="clip")
    bucket_arr = _bucket(pos_of, rlen)
    reset_arr = (pos_of == 0).astype(jnp.int32)
    buckl = lane_split(bucket_arr, num_lanes)
    resetl = lane_split(reset_arr, num_lanes)
    llen = _lane_lengths(n, num_lanes, t_steps)

    def ctx_of(carry, t):
        rs = jax.lax.dynamic_index_in_dim(resetl, t, 0, keepdims=False)
        bk = jax.lax.dynamic_index_in_dim(buckl, t, 0, keepdims=False)
        h_eff = jnp.where(rs > 0, 0, carry)
        return _coarse_ctx(h_eff, qbits, lags) | (bk << hb)

    def carry_update(carry, sym, t):
        rs = jax.lax.dynamic_index_in_dim(resetl, t, 0, keepdims=False)
        h_eff = jnp.where(rs > 0, 0, carry)
        return ((h_eff << qbits) | sym) & hmask

    syms = C.decode_ctx_lanes(
        payload, states, llen, t_steps, num_ctx, a_pad, edges,
        jnp.zeros((num_lanes,), jnp.int32), ctx_of, carry_update)
    return lane_merge(syms, t_steps * num_lanes)


# --------------------------------------------------------------------------
# RLE scheme helpers (device): runs with the MAX_RUN cap, and expansion
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cap",))
def _make_runs(qvals: jnp.ndarray, n, lengths: jnp.ndarray, cap: int):
    """Record-segmented runs capped at MAX_RUN.

    Returns (run_syms [cap], run_len_syms [cap] in [0, MAX_RUN), n_runs)."""
    active = jnp.arange(cap, dtype=jnp.int32) < n
    _, pos_of = stream_layout(lengths, cap)
    prev = jnp.concatenate([qvals[:1] + 1, qvals[:-1]])
    new_raw = ((qvals != prev) | (pos_of == 0)) & active
    # position within the raw run, to split runs longer than MAX_RUN
    raw_id = jnp.cumsum(new_raw.astype(jnp.int32)) - 1
    run_start = jnp.where(new_raw, jnp.arange(cap, dtype=jnp.int32), 0)
    starts = jnp.zeros((cap,), jnp.int32).at[raw_id].max(
        run_start, mode="drop")
    in_run = jnp.arange(cap, dtype=jnp.int32) - jnp.take(
        starts, raw_id, mode="clip")
    new_run = (new_raw | ((in_run % MAX_RUN) == 0)) & active
    rid = jnp.cumsum(new_run.astype(jnp.int32)) - 1
    n_runs = new_run.astype(jnp.int32).sum()
    run_syms = jnp.zeros((cap,), jnp.int32).at[
        jnp.where(new_run, rid, cap)].set(qvals, mode="drop")
    # run length = count of elements with this rid
    rlen = jnp.zeros((cap,), jnp.int32).at[
        jnp.where(active, rid, cap)].add(1, mode="drop")
    run_len_syms = jnp.maximum(rlen - 1, 0)
    return run_syms, run_len_syms, n_runs


@functools.partial(jax.jit, static_argnames=("cap",))
def _expand_runs(run_syms: jnp.ndarray, run_lens: jnp.ndarray, n_runs,
                 cap: int):
    """Inverse of _make_runs: ([cap] syms, [cap] len-1 syms) -> [cap] stream."""
    rmask = jnp.arange(cap, dtype=jnp.int32) < n_runs
    lens = jnp.where(rmask, run_lens + 1, 0)
    cum = jnp.cumsum(lens)
    idx = jnp.arange(cap, dtype=jnp.int32)
    rid = jnp.searchsorted(cum, idx, side="right").astype(jnp.int32)
    out = jnp.take(run_syms, rid, mode="clip")
    total = cum[-1] if cap else jnp.int32(0)
    return jnp.where(idx < total, out, 0), total


# --------------------------------------------------------------------------
# Truncation helpers
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cap",))
def _truncate_stream(qvals: jnp.ndarray, n, lengths: jnp.ndarray,
                     trunc: jnp.ndarray, cap: int):
    active = jnp.arange(cap, dtype=jnp.int32) < n
    rec_of, pos_of = stream_layout(lengths, cap)
    keep = active & (pos_of < jnp.take(trunc, rec_of, mode="clip"))
    packed, total = compact(qvals, keep)
    return packed, total


@functools.partial(jax.jit, static_argnames=("cap",))
def _untruncate_stream(tstream: jnp.ndarray, lengths: jnp.ndarray,
                       trunc: jnp.ndarray, n, hash_val, cap: int):
    active = jnp.arange(cap, dtype=jnp.int32) < n
    rec_of, pos_of = stream_layout(lengths, cap)
    keep = active & (pos_of < jnp.take(trunc, rec_of, mode="clip"))
    src = expand_positions(keep)
    out = jnp.where(keep, jnp.take(tstream, src, mode="clip"), hash_val)
    return jnp.where(active, out, 0)


# --------------------------------------------------------------------------
# Top-level quality section codec (host orchestration, device kernels)
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cap", "shift"))
def _pos_ctx(lengths: jnp.ndarray, cap: int, shift: int = 0):
    _, pos_of = stream_layout(lengths, cap)
    return jnp.minimum(pos_of, POS_CTX_CAP - 1) >> shift


@functools.partial(jax.jit, static_argnames=("cap",))
def _remap_dense(qvals: jnp.ndarray, lut: jnp.ndarray, cap: int):
    return jnp.take(lut, jnp.clip(qvals, 0, 255))


def _geom(cap: int, n: int):
    """Stream-sized lane geometry: (nc, num_lanes, edges)."""
    nc = C.stream_cap(cap, n)
    num_lanes = C.pick_num_lanes(nc)
    return nc, num_lanes, C.band_edges(nc // num_lanes)


def encode_quality(w: BitWriter, qvals: jnp.ndarray, n: int,
                   lengths: jnp.ndarray, num_rec: int, order: int,
                   hash_val: int) -> None:
    """qvals: [cap] post-transform values in [0,256), zero past n.
    lengths: [rcap] per-record quality lengths.  hash_val: the value of '#'
    after offset subtraction (-1 when truncation does not apply)."""
    cap = qvals.shape[0]
    rcap = lengths.shape[0]
    if n == 0:
        w.put_byte(QS_EMPTY)
        return
    hist, n_runs, trunc = quality_stats(
        qvals, n, lengths, num_rec, hash_val, cap, rcap)
    hist = np.asarray(hist)
    present = np.flatnonzero(hist)
    if len(present) == 1:
        w.put_byte(QS_CONST)
        w.put_varint(n)
        w.put_byte(int(present[0]))
        return
    a_pad = _a_pad(len(present))
    lut = np.zeros(256, np.int32)
    lut[present] = np.arange(len(present))
    dense = _remap_dense(qvals, jnp.asarray(lut), cap)

    if order >= 1:
        scheme = QS_CTX
    else:
        th_total = int(np.asarray(trunc).sum())
        nr = int(n_runs)
        # reference ratio rules (QualityModelerProxy.h:113-122); rleLength is
        # ~2 bytes per run (sym, len)
        if nr and th_total / max(2 * nr, 1) > 1.25:
            scheme = QS_RLE
        elif th_total and n / th_total > 1.10 and 0 <= hash_val < 256:
            scheme = QS_TRUNC
        else:
            scheme = QS_POS
    w.put_byte(scheme)
    w.put_bytes(np.packbits(hist > 0).tobytes())  # 32-byte presence bitmap

    if scheme == QS_POS:
        nc, num_lanes, edges = _geom(cap, n)
        shift, pctx = _pos_params(a_pad, _pow2ceil(n))
        ctx = _pos_ctx(lengths, cap, shift)
        enc = _encode_ctxarr(dense[:nc], n, ctx[:nc], pctx, a_pad,
                             num_lanes, edges)
        serialize_rans(w, n, enc["payload"], enc["nwords"], enc["states"])
    elif scheme == QS_TRUNC:
        pack_ints(w, np.asarray(trunc)[:num_rec])
        tstream, t_total = _truncate_stream(dense, n, lengths, trunc, cap)
        t_total = int(t_total)
        nc, num_lanes, edges = _geom(cap, t_total)
        shift, pctx = _pos_params(a_pad, _pow2ceil(t_total))
        ctx = _pos_ctx(trunc, cap, shift)
        enc = _encode_ctxarr(tstream[:nc], t_total, ctx[:nc], pctx, a_pad,
                             num_lanes, edges)
        serialize_rans(w, t_total, enc["payload"], enc["nwords"],
                       enc["states"])
    elif scheme == QS_RLE:
        run_syms, run_lens, nr = _make_runs(dense, n, lengths, cap)
        nr = int(nr)
        nc, num_lanes, edges = _geom(cap, nr)
        qb = _qbits(a_pad)
        sym_order = _rle_sym_order(a_pad, _pow2ceil(nr))
        enc_s = C.encode_orderk(run_syms[:nc], nr, sym_order, qb, a_pad,
                                num_lanes, edges)
        serialize_rans(w, nr, enc_s["payload"], enc_s["nwords"],
                       enc_s["states"])
        enc_l = _encode_ctxarr(run_lens[:nc], nr, run_syms[:nc], a_pad,
                               MAX_RUN + 1, num_lanes, edges)
        serialize_rans(w, nr, enc_l["payload"], enc_l["nwords"],
                       enc_l["states"])
    else:  # QS_CTX
        nc, num_lanes, edges = _geom(cap, n)
        enc = _encode_ctxq(dense[:nc], n, lengths, nc, order, a_pad,
                           num_lanes, edges, _pow2ceil(n))
        serialize_rans(w, n, enc["payload"], enc["nwords"], enc["states"])


def decode_quality(r: BitReader, cap: int, lengths: jnp.ndarray,
                   num_rec: int, order: int, hash_val: int
                   ) -> Tuple[jnp.ndarray, int]:
    """Returns ([cap] values in [0,256) zero past n, n)."""
    scheme = r.get_byte()
    if scheme == QS_EMPTY:
        return jnp.zeros((cap,), jnp.int32), 0
    if scheme == QS_CONST:
        n = r.get_varint()
        val = r.get_byte()
        mask = jnp.arange(cap, dtype=jnp.int32) < n
        return jnp.where(mask, val, 0), n
    bitmap = np.frombuffer(r.get_bytes(32), np.uint8)
    present = np.flatnonzero(np.unpackbits(bitmap))
    a_pad = _a_pad(len(present))
    inv = np.zeros(a_pad, np.int32)
    inv[: len(present)] = present
    inv_j = jnp.asarray(inv)

    if scheme == QS_POS:
        n, payload, states, _ = deserialize_rans(r)
        nc, num_lanes, edges = _geom(cap, n)
        t_steps = nc // num_lanes
        payload = _fit_payload(payload, num_lanes)
        shift, pctx = _pos_params(a_pad, _pow2ceil(n))
        ctx = _pos_ctx(lengths, cap, shift)
        dense = _decode_ctxarr(jnp.asarray(payload), jnp.asarray(states), n,
                               ctx[:nc], t_steps, pctx, a_pad,
                               num_lanes, edges)[:nc]
        dense = jnp.pad(dense, (0, cap - nc))
    elif scheme == QS_TRUNC:
        trunc_np = unpack_ints(r)
        rcap = lengths.shape[0]
        trunc = jnp.asarray(
            np.pad(trunc_np, (0, rcap - len(trunc_np))).astype(np.int32))
        t_total, payload, states, _ = deserialize_rans(r)
        nc, num_lanes, edges = _geom(cap, t_total)
        t_steps = nc // num_lanes
        payload = _fit_payload(payload, num_lanes)
        shift, pctx = _pos_params(a_pad, _pow2ceil(t_total))
        ctx = _pos_ctx(trunc, cap, shift)
        tdense = _decode_ctxarr(jnp.asarray(payload), jnp.asarray(states),
                                t_total, ctx[:nc], t_steps, pctx, a_pad,
                                num_lanes, edges)[:nc]
        tdense = jnp.pad(tdense, (0, cap - nc))
        lut = np.zeros(256, np.int32)
        lut[present] = np.arange(len(present))
        hash_dense = int(lut[hash_val]) if 0 <= hash_val < 256 else 0
        n = int(np.asarray(jnp.sum(
            jnp.where(jnp.arange(lengths.shape[0]) < num_rec, lengths, 0))))
        dense = _untruncate_stream(tdense, lengths, trunc, n,
                                   hash_dense, cap)
    elif scheme == QS_RLE:
        qb = _qbits(a_pad)
        nr, payload_s, states_s, _ = deserialize_rans(r)
        nc, num_lanes, edges = _geom(cap, nr)
        t_steps = nc // num_lanes
        payload_s = _fit_payload(payload_s, num_lanes)
        sym_order = _rle_sym_order(a_pad, _pow2ceil(nr))
        run_syms = C.decode_orderk(
            jnp.asarray(payload_s), jnp.asarray(states_s), nr, t_steps,
            sym_order, qb, a_pad, num_lanes, edges)[:nc]
        rmask = jnp.arange(nc, dtype=jnp.int32) < nr
        run_syms = jnp.where(rmask, run_syms, 0)
        nr2, payload_l, states_l, _ = deserialize_rans(r)
        payload_l = _fit_payload(payload_l, num_lanes)
        run_lens = _decode_ctxarr(
            jnp.asarray(payload_l), jnp.asarray(states_l), nr2, run_syms,
            t_steps, a_pad, MAX_RUN + 1, num_lanes, edges)[:nc]
        run_lens = jnp.where(rmask, run_lens, 0)
        dense, n = _expand_runs(jnp.pad(run_syms, (0, cap - nc)),
                                jnp.pad(run_lens, (0, cap - nc)), nr, cap)
        n = int(n)
    else:  # QS_CTX
        n, payload, states, _ = deserialize_rans(r)
        nc, num_lanes, edges = _geom(cap, n)
        t_steps = nc // num_lanes
        payload = _fit_payload(payload, num_lanes)
        dense = _decode_ctxq(jnp.asarray(payload), jnp.asarray(states), n,
                             lengths, nc, t_steps, order, a_pad,
                             num_lanes, edges, _pow2ceil(n))[:nc]
        dense = jnp.pad(dense, (0, cap - nc))
    mask = jnp.arange(cap, dtype=jnp.int32) < n
    vals = jnp.take(inv_j, jnp.clip(dense, 0, a_pad - 1))
    return jnp.where(mask, vals, 0), int(n)


def _fit_payload(payload: np.ndarray, num_lanes: int) -> np.ndarray:
    if payload.shape[0] < num_lanes:
        payload = np.pad(payload,
                         ((0, num_lanes - payload.shape[0]), (0, 0)))
    return payload
