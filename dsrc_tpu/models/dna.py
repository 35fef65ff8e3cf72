"""DNA stream codec — per-block scheme selection over the device kernels.

Capability map vs the reference (DnaModelerProxy.h:50-72, DnaModelerBasicB2.h,
DnaModelerHuffman.cpp, DnaModelerRCO.h):

  scheme PACK2  : <=4 distinct symbols, order 0 — raw 2-bit packing
                  (DnaModelerBasicB2.h:34-60 equivalent, pure reshape)
  scheme CTX4   : <=4 distinct symbols, order 1..9 — epoch-adaptive order-k
                  rANS, 2-bit contexts (DnaModelerRCO 4-sym equivalent)
  scheme CTX8   : <=8 distinct symbols, order>=1 — dense remap + order
                  min(k,5), 3-bit contexts (reference caps its 8-sym path at
                  order 7 for the same table-size reason, DnaModelerProxy.h:220)
  scheme A19    : >8 distinct — static-table order-0 rANS over the full
                  19-symbol alphabet (replaces the order-0 Huffman fallback,
                  DnaModelerHuffman.cpp:41-113; the 34-byte quantized table
                  replaces the stored tree and fractional-bit coding beats
                  integer code lengths — tests/test_huffman_decision.py)
  scheme RAW    : symbols outside the alphabet — verbatim bytes (robustness
                  fallback; reference would fail its ASSERT here)

Streams are serialized with ops/streams.py; the scheme id is 1 byte, as in
the reference proxy.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import ctx as C
from ..ops import packbits
from ..ops.streams import deserialize_rans, serialize_rans
from ..ops.transform import DNA_NSYM, INVALID_SYM, histogram
from ..utils.bitio import BitReader, BitWriter
from ..utils.npbits import np_pack_fixed, np_unpack_fixed

SCHEME_EMPTY = 0
SCHEME_PACK2 = 1
SCHEME_CTX4 = 2
SCHEME_CTX8 = 3
SCHEME_A19 = 4
SCHEME_RAW = 5
SCHEME_CTX4P = 6   # base-PAIR symbols (A=16), ctx = previous pairs
SCHEME_CTX8P = 7   # dense<=8 base-pair symbols (A=64)
# Pair coding halves both the sequential wavefront steps and the
# per-symbol table lookups, and conditioning P(pair | previous pairs)
# carries the same information as per-base coding at twice the context
# reach for the pair's second base.

# matches the reference's 8-symbol cap (2^21 contexts, DnaModelerProxy.h:220);
# _order8_eff's sampling budget still lowers the effective order on small
# streams, where epoch-static tables would be under-sampled
MAX_ORDER8 = 7


@functools.partial(jax.jit, static_argnames=("nsym", "num_lanes", "cap"))
def _a19_encode(syms, n, nsym: int, num_lanes: int, cap: int):
    """Masked static-table order-0 rANS over [cap] syms (first n valid)."""
    from ..ops.rans import (cum_from_freqs, lane_active, lane_split,
                            quantize_counts, rans_encode_from_freqs)
    t = cap // num_lanes
    active_flat = jnp.arange(cap, dtype=jnp.int32) < n
    s = jnp.where(active_flat, syms, nsym)        # padding -> dropped
    counts = jnp.zeros((nsym,), jnp.int32).at[s].add(1, mode="drop")
    freqs = quantize_counts(counts)
    cumfull = cum_from_freqs(freqs)
    lanes = lane_split(jnp.where(active_flat, syms, 0).astype(jnp.int32),
                       num_lanes)
    lengths = jnp.clip(n - jnp.arange(num_lanes, dtype=jnp.int32) * t, 0, t)
    active = lane_active(t, lengths)
    payload, nwords, states = rans_encode_from_freqs(
        freqs[lanes], cumfull[:-1][lanes], active)
    return payload, nwords, states, freqs


@functools.partial(jax.jit, static_argnames=("nsym", "num_lanes", "cap"))
def _a19_decode(payload, states, freqs, n, nsym: int, num_lanes: int,
                cap: int):
    from ..ops.rans import (cum_from_freqs, lane_merge, rans_decode,
                            symbol_from_slot)
    t = cap // num_lanes
    cumfull = cum_from_freqs(freqs)
    lengths = jnp.clip(n - jnp.arange(num_lanes, dtype=jnp.int32) * t, 0, t)

    def model(carry, slot, tt, active):
        sym, f, c = symbol_from_slot(slot, cumfull, nsym)
        return sym, f, c, carry

    syms, _, _ = rans_decode(payload, states, lengths, t, model, ())
    return lane_merge(syms, cap)


def _order4_eff(order: int, n: int) -> int:
    """Scale the 4-symbol context order by stream size so tables stay
    adequately sampled (4^k × 4 entries <= n/4); deterministic from the
    transmitted n, so encoder and decoder agree."""
    budget = max(0, (max(1, n // 4).bit_length() - 1 - 2)) // 2
    return max(0, min(order, 9, budget))


def _order8_eff(order: int, n: int) -> int:
    # bins <= n/8: the quality-ctx lesson (round 5) — sparser tables lose
    # ratio to Laplace smoothing AND fall off the one-hot matmul
    # histogram path (2^18-bin limit) onto scatter-adds
    budget = max(1, (max(1, n // 8).bit_length() - 1 - 3)) // 3
    return max(1, min(max(order, 1), MAX_ORDER8, budget))


def _order4p_eff(order: int, npairs: int) -> int:
    """Pair-context order (in PAIRS) for A=16 pair symbols, capped at 2
    (4 bases): the A=16 tables are 4x sparser than per-base CTX4 at equal
    context reach, and 6-base pair contexts measured +0.15 b/sym on iid
    DNA (Laplace tax) vs +0.02 at 4 bases."""
    budget = 1
    while 16 ** (budget + 2) <= max(1, npairs // 6) and budget < 2:
        budget += 1
    return max(1, min(order // 2, budget))


def _order8p_eff(order: int, npairs: int) -> int:
    budget = 1
    while 64 ** (budget + 2) <= max(1, npairs // 6) and budget < 3:
        budget += 1
    return max(1, min(order // 2, budget))


@functools.partial(jax.jit, static_argnames=("cap", "a"))
def _to_pairs(syms: jnp.ndarray, n, cap: int, a: int) -> jnp.ndarray:
    """[cap] base symbols -> [cap//2] pair symbols hi*a + lo (bases past
    n are zeroed, so an odd tail pairs with pad 0 — the decoder drops it
    via the transmitted base count)."""
    s = jnp.where(jnp.arange(cap, dtype=jnp.int32) < n, syms, 0) \
        .astype(jnp.int32)
    return s[0::2] * a + s[1::2]


@functools.partial(jax.jit, static_argnames=("cap", "a"))
def _from_pairs(pairs: jnp.ndarray, cap: int, a: int) -> jnp.ndarray:
    """Inverse of _to_pairs: [cap//2] -> [cap] interleaved bases."""
    hi = pairs // a
    lo = pairs % a
    return jnp.stack([hi, lo], axis=1).reshape(-1)


@functools.partial(jax.jit, static_argnames=("cap",))
def dna_stats(syms: jnp.ndarray, n, cap: int):
    """Histogram over the 20 symbol classes (19 + invalid)."""
    active = jnp.arange(cap, dtype=jnp.int32) < n
    s = jnp.where(syms == INVALID_SYM, DNA_NSYM, syms)
    return histogram(s, DNA_NSYM + 1, active)


def encode_dna(w: BitWriter, syms: jnp.ndarray, n: int, order: int,
               hist: np.ndarray) -> None:
    """syms: [cap] dense DNA indices (padded with zeros past n)."""
    cap = syms.shape[0]
    if n == 0:
        w.put_byte(SCHEME_EMPTY)
        return
    if hist[DNA_NSYM] > 0:
        # invalid symbols present: verbatim fallback
        w.put_byte(SCHEME_RAW)
        w.put_varint(n)
        w.put_bytes(np.asarray(syms[:n], np.uint8).tobytes())
        return
    nz = np.flatnonzero(hist[:DNA_NSYM])
    max_sym = int(nz[-1]) if len(nz) else 0
    nc = C.stream_cap(cap, n)
    num_lanes = C.pick_num_lanes(nc)
    edges = C.band_edges(nc // num_lanes)
    if max_sym < 4 and order == 0:
        w.put_byte(SCHEME_PACK2)
        w.put_varint(n)
        ncap = -(-n // 4) * 4
        packed = np.asarray(packbits.pack2(syms[:_pad4(cap)]))
        w.put_bytes(packed[: ncap // 4].tobytes())
        return
    npairs = (n + 1) // 2
    use_pairs = order >= 4 and n >= (1 << 16)
    if max_sym < 4 and use_pairs:
        w.put_byte(SCHEME_CTX4P)
        w.put_varint(n)
        pairs = _to_pairs(syms, jnp.int32(n), cap, 4)
        ncp = C.stream_cap(cap // 2, npairs)
        lanes_p = C.pick_num_lanes(ncp)
        edges_p = C.band_edges(ncp // lanes_p)
        enc = C.encode_orderk(pairs[:ncp], npairs,
                              _order4p_eff(order, npairs), 4, 16,
                              lanes_p, edges_p)
        serialize_rans(w, npairs, enc["payload"], enc["nwords"],
                       enc["states"])
        return
    if max_sym < 4:
        w.put_byte(SCHEME_CTX4)
        enc = C.encode_orderk(syms[:nc], n, _order4_eff(order, n), 2, 4,
                              num_lanes, edges)
    elif len(nz) <= 8 and use_pairs:
        w.put_byte(SCHEME_CTX8P)
        bitmap = int(sum(1 << int(i) for i in nz))
        w.put_bits(bitmap, 19)
        w.put_varint(n)
        lut = np.zeros(DNA_NSYM, np.int32)
        lut[nz] = np.arange(len(nz))
        dense = jnp.take(jnp.asarray(lut), jnp.minimum(syms, DNA_NSYM - 1))
        pairs = _to_pairs(dense, jnp.int32(n), cap, 8)
        ncp = C.stream_cap(cap // 2, npairs)
        lanes_p = C.pick_num_lanes(ncp)
        edges_p = C.band_edges(ncp // lanes_p)
        enc = C.encode_orderk(pairs[:ncp], npairs,
                              _order8p_eff(order, npairs), 6, 64,
                              lanes_p, edges_p)
        serialize_rans(w, npairs, enc["payload"], enc["nwords"],
                       enc["states"])
        return
    elif len(nz) <= 8:
        w.put_byte(SCHEME_CTX8)
        bitmap = int(sum(1 << int(i) for i in nz))
        w.put_bits(bitmap, 19)
        lut = np.zeros(DNA_NSYM, np.int32)
        lut[nz] = np.arange(len(nz))
        dense = jnp.take(jnp.asarray(lut), jnp.minimum(syms, DNA_NSYM - 1))
        enc = C.encode_orderk(dense[:nc], n, _order8_eff(order, n), 3, 8,
                              num_lanes, edges)
    else:
        # >8 distinct symbols: static-table order-0 rANS.  The quantized
        # [19] table costs 34 bytes — far below the reference's stored
        # Huffman tree (huffman.cpp:177-221) — and fractional-bit coding
        # beats integer Huffman code lengths on skewed alphabets
        # (tests/test_huffman_decision.py measures this).
        w.put_byte(SCHEME_A19)
        a19_lanes = C.pick_num_lanes(nc, target_per_lane=2048)
        payload, nwords, states, freqs = _a19_encode(
            syms[:nc].astype(jnp.int32), jnp.int32(n), DNA_NSYM,
            a19_lanes, nc)
        w.put_bytes(np_pack_fixed(
            np.asarray(freqs).astype(np.uint64), 14))
        serialize_rans(w, n, payload, nwords, states)
        return
    serialize_rans(w, n, enc["payload"], enc["nwords"], enc["states"])


def _pad4(cap: int) -> int:
    return cap - cap % 4


def decode_dna(r: BitReader, cap: int, order: int) -> Tuple[jnp.ndarray, int]:
    """Returns ([cap] dense DNA indices zero-padded, n)."""
    scheme = r.get_byte()
    if scheme == SCHEME_EMPTY:
        return jnp.zeros((cap,), jnp.int32), 0
    if scheme == SCHEME_RAW:
        n = r.get_varint()
        raw = np.frombuffer(r.get_bytes(n), np.uint8).astype(np.int32)
        return jnp.asarray(np.pad(raw, (0, cap - n))), n
    if scheme == SCHEME_PACK2:
        n = r.get_varint()
        nbytes = -(-n // 4)
        packed = np.frombuffer(r.get_bytes(nbytes), np.uint8)
        packed = np.pad(packed, (0, _pad4(cap) // 4 - nbytes))
        syms = packbits.unpack2(jnp.asarray(packed))
        syms = jnp.pad(syms, (0, cap - syms.shape[0]))
        mask = jnp.arange(cap, dtype=jnp.int32) < n
        return jnp.where(mask, syms, 0), n
    if scheme in (SCHEME_CTX8, SCHEME_CTX8P):
        bitmap = r.get_bits(19)
        nz = np.flatnonzero([(bitmap >> i) & 1 for i in range(19)])
    if scheme in (SCHEME_CTX4P, SCHEME_CTX8P):
        n = r.get_varint()
        npairs, payload, states, _ = deserialize_rans(r)
        if npairs != (n + 1) // 2:
            raise ValueError("dna pair stream length mismatch")
        ncp = C.stream_cap(cap // 2, npairs)
        lanes_p = C.pick_num_lanes(ncp)
        edges_p = C.band_edges(ncp // lanes_p)
        t_steps = ncp // lanes_p
        payload = _pad_payload(payload, lanes_p)
        if scheme == SCHEME_CTX4P:
            pairs = C.decode_orderk(
                jnp.asarray(payload), jnp.asarray(states), npairs, t_steps,
                _order4p_eff(order, npairs), 4, 16, lanes_p, edges_p)
            dec = _from_pairs(pairs[:ncp], 2 * ncp, 4)
        else:
            dense = C.decode_orderk(
                jnp.asarray(payload), jnp.asarray(states), npairs, t_steps,
                _order8p_eff(order, npairs), 6, 64, lanes_p, edges_p)
            dp = _from_pairs(dense[:ncp], 2 * ncp, 8)
            inv = np.zeros(8, np.int32)
            inv[: len(nz)] = nz
            dec = jnp.take(jnp.asarray(inv), jnp.minimum(dp, 7))
        dec = jnp.pad(dec[: min(2 * ncp, cap)],
                      (0, max(0, cap - 2 * ncp)))
        mask = jnp.arange(cap, dtype=jnp.int32) < n
        return jnp.where(mask, dec, 0), n
    freqs = None
    if scheme == SCHEME_A19:
        raw = r.get_bytes((DNA_NSYM * 14 + 7) // 8)
        freqs = np_unpack_fixed(np.frombuffer(raw, np.uint8),
                                DNA_NSYM, 14).astype(np.int32)
    n, payload, states, _ = deserialize_rans(r)
    nc = C.stream_cap(cap, n)
    if scheme == SCHEME_A19:
        num_lanes = C.pick_num_lanes(nc, target_per_lane=2048)
        payload = _pad_payload(payload, num_lanes)
        dec = _a19_decode(jnp.asarray(payload), jnp.asarray(states),
                          jnp.asarray(freqs), jnp.int32(n), DNA_NSYM,
                          num_lanes, nc)
        dec = jnp.pad(dec[:nc], (0, cap - nc))
        mask = jnp.arange(cap, dtype=jnp.int32) < n
        return jnp.where(mask, dec, 0), n
    num_lanes = C.pick_num_lanes(nc)
    edges = C.band_edges(nc // num_lanes)
    t_steps = nc // num_lanes
    payload = _pad_payload(payload, num_lanes)
    if scheme == SCHEME_CTX4:
        dec = C.decode_orderk(jnp.asarray(payload), jnp.asarray(states), n,
                              t_steps, _order4_eff(order, n), 2, 4,
                              num_lanes, edges)
    elif scheme == SCHEME_CTX8:
        dense = C.decode_orderk(jnp.asarray(payload), jnp.asarray(states), n,
                                t_steps, _order8_eff(order, n), 3, 8,
                                num_lanes, edges)
        inv = np.zeros(8, np.int32)
        inv[: len(nz)] = nz
        dec = jnp.take(jnp.asarray(inv), jnp.minimum(dense, 7))
    else:
        raise ValueError(f"bad DNA scheme {scheme}")
    dec = jnp.pad(dec[:nc], (0, cap - nc))
    mask = jnp.arange(cap, dtype=jnp.int32) < n
    return jnp.where(mask, dec, 0), n


def _pad_payload(payload: np.ndarray, num_lanes: int) -> np.ndarray:
    if payload.shape[0] < num_lanes:
        payload = np.pad(payload,
                         ((0, num_lanes - payload.shape[0]), (0, 0)))
    return payload
