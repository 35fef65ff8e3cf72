"""Block compressor — orchestrates parse → transform → per-stream codecs for
one record-aligned FASTQ block, mirroring the reference BlockCompressor
(BlockCompressor.cpp:208-297) with a device-first layout:

  compress:  parse_block (vector ops) → stream gathers → records transform
             (fold/lossy, all [n] tensor ops) → tag/length/quality/DNA
             sections coded by the rANS kernels → one byte blob
  decompress: exact mirror; FASTQ text is re-laid-out with vectorized
             scatters (reference: BlockCompressor::ReadTags text layout,
             BlockCompressor.cpp:503-573)

Block bitstream layout (ours, information-equivalent to the reference's
meta/tag/quality/dna sections, BlockCompressor.cpp:223-259):

  meta:    varint num_records; flags byte; pack_ints(quality lengths);
           [color-space: primer byte vector]; [crc32 x3 when enabled]
  tag:     models/tag.py section
  quality: models/quality.py section
  dna:     models/dna.py section

All device kernels are jit-compiled against one static `BlockShape`, so every
block of a file reuses the same executables (the last short block is padded).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CompressionSettings, DatasetType, DsrcException
from ..ops import parser as P
from ..ops import transform as T
from ..ops.streams import pack_ints, serialize_rans, unpack_ints
from ..utils.npbits import np_pack_fixed, np_unpack_fixed
from ..utils.bitio import BitReader, BitWriter
from ..utils.crc32 import crc32
from . import dna as DNA
from . import quality as Q
from . import tag as TAG

FLAG_CRC = 1
FLAG_COLOR_SPACE = 2
FLAG_PLUS_REP = 4

BLOCK_GENERIC = 0   # per-stream scheme-selected sections (full capability)
BLOCK_UNIFORM = 1   # gather-free uniform-record fast path (fixed layout)
BLOCK_SEMI = 2      # fixed read length, variable titles (real Illumina):
                    # qual/DNA on the uniform positional kernels; titles
                    # device-coded as tokenized field VALUES (mode 2) or
                    # host tag-coded (mode 0) for free-text grammars

HASH_CHAR = ord("#")   # truncation symbol (reference RecordsProcessor.h:76)


def _rpad_bucket(num_rec: int) -> int:
    """Record-count bucket for the uniform fast path: multiple of 256 so a
    file's blocks share jit shapes (encoder and decoder derive it from the
    same transmitted num_rec)."""
    return max(4, -(-num_rec // 256) * 256)


@dataclasses.dataclass(frozen=True)
class BlockShape:
    """Static capacities shared by all jitted kernels for one file."""
    cap: int           # max block text bytes (padded)
    rcap: int          # max records per block

    @staticmethod
    def for_block_size(block_bytes: int) -> "BlockShape":
        cap = -(-block_bytes // 16384) * 16384 + 16384
        rcap = max(1024, cap // 16)
        return BlockShape(cap=cap, rcap=rcap)


@dataclasses.dataclass
class StreamsInfo:
    """Per-stream raw/compressed byte accounting (reference Common.h:82-105)."""
    raw: dict = dataclasses.field(
        default_factory=lambda: dict(meta=0, tag=0, dna=0, quality=0))
    comp: dict = dataclasses.field(
        default_factory=lambda: dict(meta=0, tag=0, dna=0, quality=0))

    def add(self, other: "StreamsInfo") -> None:
        for k in self.raw:
            self.raw[k] += other.raw[k]
            self.comp[k] += other.comp[k]


# --------------------------------------------------------------------------
# Device kernels (jit, static shapes)
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cap", "rcap"))
def _gather_all(data, nbytes, title_start, title_len, seq_start, seq_len,
                qual_start, qual_len, cap: int, rcap: int):
    titles, t_total, _ = P.gather_stream(data, title_start, title_len, cap)
    seqs, s_total, _ = P.gather_stream(data, seq_start, seq_len, cap)
    quals, q_total, _ = P.gather_stream(data, qual_start, qual_len, cap)
    return titles, t_total, seqs, s_total, quals, q_total


@functools.partial(jax.jit, static_argnames=("cap", "lossy"))
def _forward_transform(seqs, quals, s_total, offset, cap: int, lossy: bool):
    """Byte streams -> (dna dense syms, dna_total, qual values [0,256))."""
    active = jnp.arange(cap, dtype=jnp.int32) < s_total
    seq_sym = T.dna_remap(seqs)
    qv = jnp.where(active, quals.astype(jnp.int32) - offset, 0)
    qv = jnp.clip(qv, 0, 255)
    if lossy:
        dna, dna_total, bins = T.forward_lossy(seq_sym, qv, active)
        return dna, dna_total, bins, seq_sym
    dna, dna_total, qual_out, _ = T.forward_lossless(seq_sym, qv, active)
    return dna, dna_total, qual_out, seq_sym


@functools.partial(jax.jit, static_argnames=("cap", "lossy"))
def _backward_transform(dna, qual_vals, n, offset, cap: int, lossy: bool):
    """Inverse: (dna syms, coded qual values) -> (seq bytes, qual bytes)."""
    active = jnp.arange(cap, dtype=jnp.int32) < n
    if lossy:
        seq_sym, qv = T.backward_lossy(dna, qual_vals, active)
    else:
        seq_sym, qv = T.backward_lossless(dna, qual_vals, active)
    seq = T.dna_unmap(jnp.where(active, seq_sym, 0))
    qual = jnp.where(active, qv + offset, 0).astype(jnp.uint8)
    return seq, qual


@functools.partial(jax.jit, static_argnames=("cap", "lossy"))
def _forward_transform_cs(seqs, quals, s_total, offset, primer_valid,
                          cap: int, lossy: bool):
    """Color-space: seqs are the digit streams (primer already stripped)."""
    active = jnp.arange(cap, dtype=jnp.int32) < s_total
    col = T.color_remap(seqs)
    qv = jnp.where(active, quals.astype(jnp.int32) - offset, 0)
    qv = jnp.clip(qv, 0, 255)
    if lossy:
        bins = T.quality_bin(qv)
        bins = jnp.where((col > 3) & active, 0, bins)
        return col, s_total, bins, col
    return col, s_total, qv, col


@functools.partial(jax.jit, static_argnames=("cap", "lossy"))
def _backward_transform_cs(col, qual_vals, n, offset, cap: int, lossy: bool):
    active = jnp.arange(cap, dtype=jnp.int32) < n
    if lossy:
        qv = T.quality_unbin(qual_vals)
        col_s = jnp.where((qual_vals == 0) & active, 4, col)  # '.'
    else:
        qv = qual_vals
        col_s = col
    seq = T.color_unmap(jnp.where(active, col_s, 0))
    qual = jnp.where(active, qv + offset, 0).astype(jnp.uint8)
    return seq, qual


# --------------------------------------------------------------------------
# Uniform-block staging / (de)serialization — shared by the single-chip
# BlockCodec and the multi-chip mesh pipeline (parallel/mesh.py)
# --------------------------------------------------------------------------

def stage_uniform_block(block: np.ndarray, cap: int = 0):
    """Text block -> (mat [rpad, rec_bytes] device, num_rec, spec, rpad), or
    None when the block is not a fixed-layout uniform block.

    cap (the codec's block capacity in bytes) pins one FILE-WIDE lane
    bucket: every block — including the short tail — then reuses the same
    jit executables instead of compiling a second set.  rpad is TRANSMITTED
    in the block header, so the decoder follows whatever bucket the encoder
    chose."""
    from ..parallel import uniform_pipeline as UP
    spec = UP.detect_spec(bytes(block[:4096]))
    if spec is None or len(block) % spec.rec_bytes:
        return None
    num_rec = len(block) // spec.rec_bytes
    rpad = _rpad_bucket(max(num_rec, cap // spec.rec_bytes))
    mat = np.zeros((rpad, spec.rec_bytes), np.uint8)
    mat[:num_rec] = np.asarray(block).reshape(num_rec, spec.rec_bytes)
    matj = jnp.asarray(mat)
    if not bool(UP.check_uniform(matj, spec, jnp.int32(num_rec))):
        return None
    return matj, num_rec, spec, rpad


@functools.partial(jax.jit, static_argnums=(1,))
def _pad_cols(x, width: int):
    """Zero-pad columns up to `width` on device (H2D stays compact)."""
    return jnp.pad(x, ((0, 0), (0, width - x.shape[1])))


def _uniform_wp(p: int, group: int) -> int:
    """Canonical pair capacity of a positional stream with P positions
    (must mirror rans_encode_from_freqs' tile-aligned width)."""
    from ..ops.rans import ENC_UNROLL, TILE
    t_steps = group * p
    tp = -(-t_steps // ENC_UNROLL) * ENC_UNROLL
    return -(-(tp + ENC_UNROLL) // (2 * TILE)) * TILE


def _put_pos_stream(w: BitWriter, n_syms: int, tup) -> None:
    """One positional rANS stream + its transmitted PROB_BITS-wide table."""
    from ..ops.rans import PROB_BITS
    payload, nwords, states, tab = tup
    serialize_rans(w, n_syms, payload, nwords, states)
    w.put_bytes(np_pack_fixed(
        np.asarray(tab).ravel().astype(np.uint64), PROB_BITS))


def _put_dna(w: BitWriter, packed, exc_bits, num_rec: int,
             read_len: int) -> None:
    """2-bit packed DNA + exception-position list."""
    ndna = (num_rec * read_len + 3) // 4
    w.put_varint(ndna)
    w.put_bytes(np.asarray(packed)[:ndna].tobytes())
    # host-side bitmap -> SORTED flat positions, gap-coded: varint count,
    # varint first position, pack_ints of the gaps.  Real N's cluster
    # (instrument bad cycles put one N per read at the same column ->
    # near-constant gaps of read_len), so gaps pack in ~half the bits of
    # absolute r*read_len+p indices.
    bits = np.asarray(exc_bits)
    rr, wc = bits.shape
    expand = (bits[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    expand = expand.reshape(rr, wc * 32)[:, :read_len]
    rpos, cpos = np.nonzero(expand)
    flat = (rpos * read_len + cpos).astype(np.int64)
    w.put_varint(len(flat))
    if len(flat):
        w.put_varint(int(flat[0]))
        pack_ints(w, np.diff(flat))


def _put_wire(w: BitWriter, wire) -> None:
    """Wire-format layout parameters (uniform/semi block headers): the
    decoder reads these instead of trusting its own module constants, so
    encoder retuning never breaks old archives (reference analogue: the
    self-describing footer, DsrcFile.cpp:133-170)."""
    from ..ops.rans import PROB_BITS
    w.put_byte(PROB_BITS)
    for v in wire:
        w.put_varint(v)


def _get_wire(r: BitReader, rpad: int):
    from ..parallel.uniform_pipeline import Wire
    from ..ops.rans import PROB_BITS
    pb = r.get_byte()
    if pb != PROB_BITS:
        raise DsrcException(
            f"archive coded with PROB_BITS={pb}; this build decodes "
            f"PROB_BITS={PROB_BITS} only")
    wire = Wire(*(r.get_varint() for _ in range(len(Wire._fields))))
    try:
        wire.validate(rpad)
    except ValueError as e:
        raise DsrcException(f"bad block wire parameters: {e}")
    return wire


def serialize_uniform_block(comp, spec, num_rec: int, rpad: int,
                            wire=None):
    """Device compress_uniform output -> (blob, StreamsInfo)."""
    from ..parallel.uniform_pipeline import WIRE_DEFAULT
    wire = wire or WIRE_DEFAULT
    packed, exc_bits, exc_count = comp["dna"]
    w = BitWriter()
    w.put_byte(BLOCK_UNIFORM)
    w.put_varint(num_rec)
    w.put_varint(rpad)
    w.put_varint(spec.title_len)
    w.put_varint(spec.read_len)
    _put_wire(w, wire)
    w.put_byte(int(comp["qual_mode"]))   # 0 direct / 1 horizontal delta
    meta_end = w.byte_position
    _put_pos_stream(w, num_rec * spec.title_len, comp["title"])
    t_end = w.byte_position
    _put_pos_stream(w, num_rec * spec.read_len, comp["qual"])
    q_end = w.byte_position
    _put_dna(w, packed, exc_bits, num_rec, spec.read_len)
    blob = w.getvalue()
    info = StreamsInfo()
    info.raw.update(tag=num_rec * spec.title_len,
                    dna=num_rec * spec.read_len,
                    quality=num_rec * spec.read_len)
    info.comp.update(meta=meta_end, tag=t_end - meta_end,
                     quality=q_end - t_end, dna=len(blob) - q_end)
    return blob, info


def _get_pos_stream(r: BitReader, expect_n: int, p: int, tab_cols: int,
                    ll: int, group: int, compact: bool):
    from ..ops.rans import PROB_BITS
    from ..ops.streams import deserialize_rans
    n, payload, states, nwords = deserialize_rans(r)
    if n != expect_n:
        raise DsrcException("uniform block stream length mismatch")
    wp = _uniform_wp(p, group)
    if payload.shape[1] > wp:
        raise DsrcException("uniform block payload too wide")
    wtarget = min(wp, -(-payload.shape[1] // 64) * 64) if compact else wp
    payload = np.pad(payload,
                     ((0, ll - payload.shape[0]),
                      (0, max(0, wtarget - payload.shape[1]))))
    states = np.pad(states, (0, ll - len(states)))
    nwords = np.pad(nwords, (0, ll - len(nwords)))
    nvals = p * tab_cols
    raw = r.get_bytes((nvals * PROB_BITS + 7) // 8)
    tab = np_unpack_fixed(np.frombuffer(raw, np.uint8), nvals, PROB_BITS) \
        .astype(np.int32).reshape(p, tab_cols)
    return (payload, nwords.astype(np.int32), states, tab)


def _get_dna(r: BitReader, rpad: int, read_len: int):
    ndna = r.get_varint()
    packed_np = np.frombuffer(r.get_bytes(ndna), np.uint8)
    dcap = rpad * read_len // 4 + 1
    packed = np.pad(packed_np, (0, dcap - ndna))
    n_exc = r.get_varint()
    if n_exc:
        first = r.get_varint()
        gaps = unpack_ints(r).astype(np.int64)
        if len(gaps) != n_exc - 1 or (gaps < 0).any():
            raise DsrcException("dna exception gaps malformed")
        exc_np = first + np.concatenate([[0], np.cumsum(gaps)])
        if exc_np[-1] >= rpad * read_len:
            raise DsrcException("dna exception position out of range")
    else:
        exc_np = np.zeros(0, np.int64)
    wcnt = -(-read_len // 32)
    exc_bits = np.zeros((rpad, wcnt), np.uint32)
    if len(exc_np):
        rpos, cpos = exc_np // read_len, exc_np % read_len
        np.bitwise_or.at(exc_bits, (rpos, cpos // 32),
                         np.uint32(1) << (cpos % 32).astype(np.uint32))
    return (packed, exc_bits, np.int32(len(exc_np)))


def read_uniform_block(r: BitReader, compact: bool = False):
    """Blob reader (after the scheme byte) -> (comp pytree of NUMPY arrays in
    the canonical [rpad]-bucket shapes, spec, num_rec, rpad, wire).
    Canonical shapes make blocks stackable for the sharded multi-chip
    decode; `wire` holds the transmitted layout parameters the decode
    kernels must use.

    compact=True keeps payload widths at a small 64-pair bucket instead of
    the canonical capacity: payloads are LEFT-aligned, so the consumer can
    zero-pad columns on device — the host->device transfer then moves only
    compressed bytes, not the canonical padding."""
    from ..parallel import uniform_pipeline as UP
    num_rec = r.get_varint()
    rpad = r.get_varint()
    title_len = r.get_varint()
    read_len = r.get_varint()
    spec = UP.UniformSpec(
        rec_bytes=1 + title_len + 1 + read_len + 3 + read_len + 1,
        title_len=title_len, read_len=read_len)
    if (rpad < max(1, num_rec) or rpad % 256
            or rpad * max(1, spec.rec_bytes) > (1 << 31)):
        raise DsrcException("uniform block: bad transmitted lane bucket")
    wire = _get_wire(r, rpad)
    qual_mode = r.get_byte()
    title = _get_pos_stream(
        r, num_rec * title_len, title_len, wire.title_a,
        rpad // wire.title_code_group, wire.title_code_group, compact)
    qual = _get_pos_stream(r, num_rec * read_len, read_len, wire.qual_a,
                           rpad // wire.qual_group, wire.qual_group, compact)
    comp = dict(num_rec=np.int32(num_rec), qual_mode=np.int32(qual_mode),
                title=title, qual=qual,
                dna=_get_dna(r, rpad, read_len))
    return comp, spec, num_rec, rpad, wire


# --------------------------------------------------------------------------
# Semi-block staging / (de)serialization — shared by the single-chip
# BlockCodec and the multi-chip mesh pipeline (parallel/mesh.py)
# --------------------------------------------------------------------------

def stage_semi_raw(block: np.ndarray, rpad_hint: int = 0):
    """Host staging for the semi fast path: probe read_len, one native
    scan into matrices.  Returns (read_len, num_rec, qm, sm, tstream, tl)
    or None when the block is not semi-layout."""
    from ..utils import native
    b = np.asarray(block, np.uint8)
    head = bytes(b[:16896])
    try:
        e0 = head.index(b"\n")
        e1 = head.index(b"\n", e0 + 1)
    except ValueError:
        return None
    read_len = e1 - e0 - 1
    if not (0 < read_len <= 8192):
        return None
    nmax = len(b) // (2 * read_len + 6) + 1
    rpad_alloc = max(_rpad_bucket(nmax) + 256, rpad_hint)
    staged = native.stage_semi(b, read_len, rpad_alloc)
    if staged is None:
        return None
    qm_a, sm_a, tstream, tl, num_rec = staged
    return read_len, num_rec, qm_a, sm_a, tstream, tl


def semi_tok_planes(vmat: np.ndarray, num_rec: int,
                    pcs_hint: Optional[dict] = None):
    """(v0 [F] int32, pcs tuple): transmitted base values + per-field
    byte-plane counts from the actual zigzag deltas (record 0 deltas
    against v0, so blocks deep into a file don't inflate the planes).
    pcs_hint (grow-only, mutated) keeps one executable set per file."""
    nf = vmat.shape[1]
    v0 = (vmat[0] if num_rec else np.zeros(nf, np.int32)) \
        .astype(np.int32)
    d = np.diff(vmat.astype(np.int64), axis=0,
                prepend=v0[None, :].astype(np.int64))
    z = np.where(d < 0, -2 * d - 1, 2 * d)
    hint = pcs_hint if pcs_hint is not None else {}
    pcs = tuple(
        max(max(1, (int(z[:, f].max()).bit_length() + 7) // 8),
            hint.get(f, 1)) for f in range(nf))
    for f, pc in enumerate(pcs):
        hint[f] = pc
    return v0, pcs


def serialize_semi_tok_block(comp, num_rec: int, rpad: int, read_len: int,
                             pcs, v0, tok_meta, raw_tag_len: int,
                             wire=None):
    """Device compress_semi_tok output -> (blob, StreamsInfo)."""
    from ..parallel.uniform_pipeline import WIRE_DEFAULT
    wire = wire or WIRE_DEFAULT
    k, seps, fields = tok_meta
    w = BitWriter()
    w.put_byte(BLOCK_SEMI)
    w.put_varint(num_rec)
    w.put_varint(rpad)
    w.put_varint(read_len)
    _put_wire(w, wire)
    w.put_byte(int(comp["qual_mode"]))
    w.put_byte(2)
    w.put_varint(k)
    w.put_bytes(seps)
    fi = 0
    for sch, arg in fields:
        w.put_byte(sch)
        if sch == TAG.TOKF_CONST:
            w.put_varint(len(arg))
            w.put_bytes(arg)
        else:
            if sch == TAG.TOKF_NUM_PAD:
                w.put_byte(arg)
            w.put_byte(pcs[fi])
            w.put_varint(int(v0[fi]))
            fi += 1
    meta_end = w.byte_position
    if sum(pcs):
        _put_pos_stream(w, num_rec * sum(pcs), comp["title"])
    t_end = w.byte_position
    _put_pos_stream(w, num_rec * read_len, comp["qual"])
    q_end = w.byte_position
    packed, exc_bits, _ = comp["dna"]
    _put_dna(w, packed, exc_bits, num_rec, read_len)
    blob = w.getvalue()
    info = StreamsInfo()
    info.raw.update(tag=raw_tag_len, dna=num_rec * read_len,
                    quality=num_rec * read_len)
    info.comp.update(meta=meta_end, tag=t_end - meta_end,
                     quality=q_end - t_end, dna=len(blob) - q_end)
    return blob, info


def parse_semi_block(r: BitReader, tag_cap: int) -> dict:
    """Blob reader (after the scheme byte) -> dict describing the semi
    block: num_rec/rpad/read_len/wire/mode plus qual/dna numpy stream
    tuples in compact widths; mode 2 adds title/pcs/v0/tok_meta, mode 0
    decodes the host tag section in place (titles_np/title_len_np)."""
    from ..parallel import uniform_pipeline as UP
    num_rec = r.get_varint()
    rpad = r.get_varint()
    read_len = r.get_varint()
    if rpad < max(1, num_rec) or rpad % 256 or rpad > (1 << 26):
        raise DsrcException("semi block: bad transmitted lane bucket")
    wire = _get_wire(r, rpad)
    qual_mode = r.get_byte()
    title_mode = r.get_byte()
    if title_mode not in (0, 2):
        raise DsrcException(f"semi block: unknown title mode {title_mode}")
    out = dict(num_rec=num_rec, rpad=rpad, read_len=read_len, wire=wire,
               mode=title_mode, qual_mode=qual_mode)
    if title_mode == 2:
        k = r.get_varint()
        if not 0 < k <= TAG.MAX_FIELDS:
            raise DsrcException("semi block: bad title field count")
        seps = r.get_bytes(k - 1)
        fields = []
        pcs: tuple = ()
        v0 = []
        for _ in range(k):
            sch = r.get_byte()
            if sch == TAG.TOKF_CONST:
                fields.append((sch, r.get_bytes(r.get_varint())))
                continue
            if sch == TAG.TOKF_NUM_PAD:
                fields.append((sch, r.get_byte()))
            elif sch == TAG.TOKF_NUM:
                fields.append((sch, None))
            else:
                raise DsrcException("semi block: bad title field scheme")
            pc = r.get_byte()
            if not 1 <= pc <= 4:
                raise DsrcException("semi block: bad plane count")
            pcs = pcs + (pc,)
            v0.append(r.get_varint())
        out.update(tok_meta=(k, seps, fields), pcs=pcs,
                   v0=np.asarray(v0, np.int32))
        if sum(pcs):
            out["title"] = _get_pos_stream(
                r, num_rec * sum(pcs), sum(pcs), UP.VAL_A,
                rpad // wire.val_group, wire.val_group, compact=True)
    else:
        titles_np, title_len_np = TAG.decode_tags(r, num_rec, tag_cap)
        out.update(titles_np=titles_np, title_len_np=title_len_np)
    out["qual"] = _get_pos_stream(
        r, num_rec * read_len, read_len, wire.qual_a,
        rpad // wire.qual_group, wire.qual_group, compact=True)
    out["dna"] = _get_dna(r, rpad, read_len)
    return out


def semi_tok_comp_device(d: dict):
    """parse_semi_block mode-2 dict -> canonical-width DEVICE comp pytree
    for decompress_semi_tok (payload columns restored on device)."""
    wire, pcs = d["wire"], d["pcs"]
    comp = dict(num_rec=np.int32(d["num_rec"]),
                qual_mode=np.int32(d["qual_mode"]), qual=d["qual"],
                dna=d["dna"])
    if sum(pcs):
        comp["title"] = d["title"]
    comp = jax.tree_util.tree_map(jnp.asarray, comp)
    keys = ((("title", sum(pcs), wire.val_group),) if sum(pcs) else ()) + \
        (("qual", d["read_len"], wire.qual_group),)
    for key, p, g in keys:
        payload, nwords, states, tab = comp[key]
        comp[key] = (_pad_cols(payload, _uniform_wp(p, g)),
                     nwords, states, tab)
    return comp


def decode_semi_tok_device(d: dict):
    """Single-chip device decode of a parsed mode-2 semi block."""
    from ..parallel import uniform_pipeline as UP
    comp = semi_tok_comp_device(d)
    return UP.decompress_semi_tok(
        comp, jnp.asarray(d["v0"]), d["pcs"], d["read_len"], d["rpad"],
        left=True, wire=d["wire"])


# --------------------------------------------------------------------------
# Block codec
# --------------------------------------------------------------------------

class BlockCodec:
    """Stateless per-block compress/decompress bound to one BlockShape.

    Thread-safe: all model state is per-call (like the reference's
    per-worker BlockCompressor, DsrcWorker.cpp:37) and jit tracing in this
    jax version is safe from concurrent threads (stress-verified), so
    workers in parallel/pipeline.py genuinely overlap host-side codec work.
    The whole-file drivers still warm block 0 synchronously so the common
    kernels compile once before the pool starts.
    """

    def __init__(self, shape: BlockShape, settings: CompressionSettings,
                 dataset: DatasetType):
        if dataset.quality_offset == 0:
            raise DsrcException("dataset quality offset must be resolved")
        self.shape = shape
        self.settings = settings
        self.dataset = dataset
        # Lane-bucket hints for the semi path: keep every block of a
        # file on ONE set of jit executables (rpad and the mode-2 plane
        # counts are transmitted per block, so the decoder follows).
        # The FIRST semi block — always compressed synchronously before
        # worker threads start (api.py) — seeds them; they are then
        # FROZEN so compressed bytes never depend on worker scheduling
        # (a block that outgrows the frozen hints simply uses its own
        # larger bucket and pays one extra compile).
        self._rpad_hint = 0
        self._pcs_hint: dict = {}   # semi mode-2 per-field plane counts
        self._hints_frozen = False

    # -------------------------------------------------- compress
    def compress(self, block: np.ndarray) -> Tuple[bytes, StreamsInfo]:
        sh, st, ds = self.shape, self.settings, self.dataset
        nbytes = len(block)
        if nbytes > sh.cap:
            raise DsrcException("block larger than codec capacity")
        if self._uniform_eligible():
            out = self._compress_uniform(block)
            if out is None:
                out = self._compress_semi(block)
            if out is not None:
                return out
        return self._compress_generic(block)

    def _uniform_eligible(self) -> bool:
        st, ds = self.settings, self.dataset
        return (st.dna_order == 0 and st.quality_order == 0
                and not st.lossy_quality and not st.calculate_crc32
                and not st.tag_fields_filtered
                and not ds.color_space and not ds.plus_repetition)

    def _compress_uniform(self, block: np.ndarray):
        """Gather-free fast path for fixed-layout blocks; None = not
        applicable (falls back to the generic section codec)."""
        from ..parallel import uniform_pipeline as UP
        staged = stage_uniform_block(block, self.shape.cap)
        if staged is None:
            return None
        matj, num_rec, spec, rpad = staged
        comp = UP.compress_uniform(matj, jnp.int32(num_rec), spec, rpad)
        return serialize_uniform_block(comp, spec, num_rec, rpad)

    def _semi_rpad(self, num_rec: int) -> int:
        """File-wide semi lane bucket: seeded (with one bucket of
        headroom) by the FIRST semi block — always compressed
        synchronously — then frozen, so compressed bytes never depend on
        worker scheduling.  A later block that outgrows the seed uses its
        own larger bucket (deterministic: a pure function of that block)."""
        rpad = max(_rpad_bucket(num_rec), self._rpad_hint)
        if self._rpad_hint == 0:
            rpad += 256
            self._rpad_hint = rpad
        return rpad

    def _semi_pcs_hint(self) -> dict:
        """Plane-count hint dict: mutable for the first (synchronous)
        semi block, a private copy afterwards — same determinism rule as
        _semi_rpad."""
        if self._hints_frozen:
            return dict(self._pcs_hint)
        self._hints_frozen = True
        return self._pcs_hint

    def seed_semi_hints(self, block: np.ndarray) -> None:
        """Seed the frozen semi lane/plane hints from a given block
        WITHOUT compressing it.  The multi-host driver calls this with
        block 0 on every process, so all processes produce the exact
        bytes a single-process run would (whose hints block 0 seeds by
        being compressed first)."""
        staged = stage_semi_raw(block, self._rpad_hint)
        if staged is None:
            return
        read_len, num_rec, _qm, _sm, tstream, tl = staged
        self._semi_rpad(num_rec)
        tok = TAG.analyze_value_fields(np.asarray(tstream, np.uint8),
                                       np.asarray(tl))
        if tok is not None and tok[0].shape[1] <= 16:
            semi_tok_planes(tok[0], num_rec, self._semi_pcs_hint())

    def stage_semi_tok_for_mesh(self, block: np.ndarray):
        """Host-side staging of one block for the sharded semi codec
        (parallel/mesh.MeshSemiCodec).  Returns (staged dict, read_len,
        rpad, pcs) or None when the block is not mode-2 semi.  Shares the
        grow-only rpad/pcs hints with the single-chip path so fallback
        blocks land on the same executables."""
        staged = stage_semi_raw(block, self._rpad_hint)
        if staged is None:
            return None
        read_len, num_rec, qm_a, sm_a, tstream, tl = staged
        tok = TAG.analyze_value_fields(np.asarray(tstream, np.uint8),
                                       np.asarray(tl))
        if tok is None or tok[0].shape[1] > 16:
            return None
        rpad = self._semi_rpad(num_rec)
        vmat, tok_meta = tok
        v0, pcs = semi_tok_planes(vmat, num_rec, self._semi_pcs_hint())
        vpad = np.zeros((rpad, vmat.shape[1]), np.int32)
        vpad[:num_rec] = vmat
        return (dict(vmat=vpad, v0=v0, qm=qm_a[:rpad], sm=sm_a[:rpad],
                     num_rec=num_rec, tok_meta=tok_meta,
                     tag_len=len(tstream)),
                read_len, rpad, pcs)

    def _compress_semi(self, block: np.ndarray):
        """Fixed read-length, variable-title fast path — the layout of real
        Illumina runs (titles vary in digit count, reads do not), which the
        fully-uniform reshape path can never match.  The host stages
        seq/qual into [rpad, P] matrices in one native pass
        (utils/native.stage_semi) and tokenizes the titles; quality/DNA
        and (for const/numeric title grammars, mode 2) the title field
        values ride the fused positional kernels; other titles go through
        the host tag coder (mode 0).  None = structure does not fit
        (falls back to the generic codec)."""
        from ..parallel import uniform_pipeline as UP
        staged = stage_semi_raw(block, self._rpad_hint)
        if staged is None:
            return None
        read_len, num_rec, qm_a, sm_a, tstream, tl = staged
        rpad = self._semi_rpad(num_rec)

        # Title mode selection: mode 2 (host tokenization -> device
        # value-delta coding, measured smaller than the host tag coder on
        # Illumina-style titles) when every field is constant or numeric;
        # mode 0 (host tag coder) otherwise.
        tl_np = np.asarray(tl)
        ts_np = np.asarray(tstream, np.uint8)
        tok = TAG.analyze_value_fields(ts_np, tl_np)
        if tok is not None and tok[0].shape[1] > 16:
            tok = None                      # > 16 numeric fields: tag coder
        if tok is not None:
            vmat, tok_meta = tok
            v0, pcs = semi_tok_planes(vmat, num_rec,
                                      self._semi_pcs_hint())
            nf = vmat.shape[1]
            vpad = np.zeros((rpad, nf), np.int32)
            vpad[:num_rec] = vmat
            comp = UP.compress_semi_tok(
                jnp.asarray(vpad), jnp.asarray(v0),
                jnp.asarray(qm_a[:rpad]), jnp.asarray(sm_a[:rpad]),
                jnp.int32(num_rec), pcs, read_len, rpad)
            return serialize_semi_tok_block(
                comp, num_rec, rpad, read_len, pcs, v0, tok_meta,
                len(tstream))

        comp = UP.compress_semi(jnp.asarray(qm_a[:rpad]),
                                jnp.asarray(sm_a[:rpad]),
                                jnp.int32(num_rec), read_len, rpad)
        w = BitWriter()
        w.put_byte(BLOCK_SEMI)
        w.put_varint(num_rec)
        w.put_varint(rpad)
        w.put_varint(read_len)
        _put_wire(w, UP.WIRE_DEFAULT)
        w.put_byte(int(comp["qual_mode"]))
        w.put_byte(0)
        meta_end = w.byte_position
        TAG.encode_tags(w, tstream, tl,
                        self.settings.tag_preserve_mask, self.shape.cap)
        t_end = w.byte_position
        _put_pos_stream(w, num_rec * read_len, comp["qual"])
        q_end = w.byte_position
        packed, exc_bits, _ = comp["dna"]
        _put_dna(w, packed, exc_bits, num_rec, read_len)
        blob = w.getvalue()
        info = StreamsInfo()
        info.raw.update(tag=len(tstream), dna=num_rec * read_len,
                        quality=num_rec * read_len)
        info.comp.update(meta=meta_end, tag=t_end - meta_end,
                         quality=q_end - t_end, dna=len(blob) - q_end)
        return blob, info

    def _decompress_semi(self, r: BitReader) -> np.ndarray:
        from ..parallel import uniform_pipeline as UP
        d = parse_semi_block(r, self.shape.cap)
        num_rec, rpad, read_len, wire = (d["num_rec"], d["rpad"],
                                         d["read_len"], d["wire"])
        if d["mode"] == 2:
            vmat, qual_m, seq_m = decode_semi_tok_device(d)
            titles_np, title_len_np = TAG.render_value_titles(
                np.asarray(vmat), d["tok_meta"], num_rec)
        else:
            titles_np, title_len_np = d["titles_np"], d["title_len_np"]
            comp = jax.tree_util.tree_map(jnp.asarray, dict(
                num_rec=np.int32(num_rec),
                qual_mode=np.int32(d["qual_mode"]),
                qual=d["qual"], dna=d["dna"]))
            payload, nwords, states, tab = comp["qual"]
            comp["qual"] = (
                _pad_cols(payload, _uniform_wp(read_len, wire.qual_group)),
                nwords, states, tab)
            qual_m, seq_m = UP.decompress_semi(comp, read_len, rpad,
                                               left=True, wire=wire)
        qual_len_np = np.full(num_rec, read_len, np.int64)
        seq_np = np.asarray(seq_m)[:num_rec].reshape(-1)
        qual_np = np.asarray(qual_m)[:num_rec].reshape(-1)
        return self._layout(num_rec, titles_np, title_len_np, qual_len_np,
                            seq_np, qual_np, None, self.dataset)

    def _compress_generic(self, block: np.ndarray
                          ) -> Tuple[bytes, StreamsInfo]:
        sh, st, ds = self.shape, self.settings, self.dataset
        nbytes = len(block)
        data = jnp.asarray(np.pad(np.asarray(block, np.uint8),
                                  (0, sh.cap - nbytes)))
        parsed = P.parse_block(data, jnp.int32(nbytes), sh.rcap)
        if not bool(parsed.valid):
            raise DsrcException("Error parsing FASTQ block (bad structure)")
        num_rec = int(parsed.num_records)
        seq_len = parsed.seq_len
        qual_len = parsed.qual_len
        seq_len_np = np.asarray(seq_len)[:num_rec]
        qual_len_np = np.asarray(qual_len)[:num_rec]
        if ds.color_space:
            if not (seq_len_np == qual_len_np + 1).all():
                raise DsrcException("color-space length mismatch")
            seq_start = parsed.seq_start + 1
            seq_len = jnp.maximum(seq_len - 1, 0)
            seq_len = jnp.where(jnp.arange(sh.rcap) < num_rec, seq_len, 0)
        else:
            if not (seq_len_np == qual_len_np).all():
                raise DsrcException("sequence/quality length mismatch")
            seq_start = parsed.seq_start
        titles, t_total, seqs, s_total, quals, q_total = _gather_all(
            data, jnp.int32(nbytes), parsed.title_start, parsed.title_len,
            seq_start, seq_len, parsed.qual_start, qual_len,
            sh.cap, sh.rcap)
        s_total_i = int(s_total)
        q_total_i = int(q_total)

        # Per-block quality offset: the dataset offset comes from the FIRST
        # block (analyze_first_block); a later block with a quality byte
        # below it would clip in the q - offset transform and round-trip
        # WRONG silently (the reference wraps on uchar and stays
        # reversible, RecordsProcessor.cpp:223-293).  Instead the block
        # falls back to offset 33 and TRANSMITS its offset in the meta
        # section, keeping every block exactly reversible.
        offset = ds.quality_offset
        if q_total_i:
            qmin = int(jnp.min(jnp.where(
                jnp.arange(sh.cap, dtype=jnp.int32) < q_total,
                quals, jnp.uint8(255))))
            qmax = int(jnp.max(jnp.where(
                jnp.arange(sh.cap, dtype=jnp.int32) < q_total,
                quals, jnp.uint8(0))))
            if qmin < offset:
                offset = 33
            if qmin < offset or qmax - offset >= T.FOLD_BASE:
                raise DsrcException(
                    f"quality bytes span [{qmin}, {qmax}] — outside the "
                    f"reversible range for any FASTQ offset")
        if ds.color_space:
            primers = np.asarray(jnp.take(
                data, parsed.seq_start, mode="clip"))[:num_rec]
            dna, dna_total, qvals, _ = _forward_transform_cs(
                seqs, quals, s_total, offset, True, sh.cap, st.lossy_quality)
        else:
            primers = None
            dna, dna_total, qvals, _ = _forward_transform(
                seqs, quals, s_total, offset, sh.cap, st.lossy_quality)

        w = BitWriter()
        w.put_byte(BLOCK_GENERIC)
        info = StreamsInfo()
        # ---- meta section
        flags = 0
        if st.calculate_crc32:
            flags |= FLAG_CRC
        if ds.color_space:
            flags |= FLAG_COLOR_SPACE
        if ds.plus_repetition:
            flags |= FLAG_PLUS_REP
        w.put_varint(num_rec)
        w.put_byte(flags)
        w.put_byte(offset)         # per-block quality offset (see above)
        pack_ints(w, qual_len_np)
        if ds.color_space:
            pack_ints(w, primers.astype(np.int64))
        if st.calculate_crc32:
            title_len_np = np.asarray(parsed.title_len)[:num_rec]
            t_np = np.asarray(titles)[: int(t_total)]
            s_np = np.asarray(seqs)[:s_total_i]
            q_np = np.asarray(quals)[:q_total_i]
            w.put_uint32(crc32(t_np))
            w.put_uint32(crc32(s_np))
            w.put_uint32(crc32(q_np))
        meta_end = w.byte_position
        # ---- tag section
        title_len_np = np.asarray(parsed.title_len)[:num_rec]
        TAG.encode_tags(w, np.asarray(titles), title_len_np,
                        st.tag_preserve_mask, sh.cap)
        tag_end = w.byte_position
        # ---- quality section
        hash_val = (HASH_CHAR - offset) if (
            not st.lossy_quality and 0 <= HASH_CHAR - offset < 256) else -1
        qlen_dev = qual_len
        Q.encode_quality(w, qvals, q_total_i, qlen_dev,
                         num_rec, st.quality_order, hash_val)
        qual_end = w.byte_position
        # ---- dna section
        hist = np.asarray(DNA.dna_stats(
            dna, jnp.int32(int(dna_total)), sh.cap))
        DNA.encode_dna(w, dna, int(dna_total), st.dna_order, hist)
        dna_end = w.byte_position

        blob = w.getvalue()
        info.raw.update(meta=0, tag=int(t_total), dna=s_total_i,
                        quality=q_total_i)
        info.comp.update(meta=meta_end, tag=tag_end - meta_end,
                         quality=qual_end - tag_end, dna=dna_end - qual_end)
        return blob, info

    # -------------------------------------------------- decompress
    def decompress(self, blob: bytes) -> np.ndarray:
        sh, st, ds = self.shape, self.settings, self.dataset
        r = BitReader(blob)
        scheme = r.get_byte()
        if scheme == BLOCK_UNIFORM:
            return self._decompress_uniform(r)
        if scheme == BLOCK_SEMI:
            return self._decompress_semi(r)
        if scheme != BLOCK_GENERIC:
            raise DsrcException(f"bad block scheme {scheme}")
        num_rec = r.get_varint()
        flags = r.get_byte()
        offset = r.get_byte()      # per-block quality offset (transmitted)
        qual_len_np = unpack_ints(r).astype(np.int64)
        primers = None
        if flags & FLAG_COLOR_SPACE:
            primers = unpack_ints(r).astype(np.uint8)
        crcs = None
        if flags & FLAG_CRC:
            crcs = (r.get_uint32(), r.get_uint32(), r.get_uint32())
        # tag
        titles_np, title_len_np = TAG.decode_tags(r, num_rec, sh.cap)
        hash_val = (HASH_CHAR - offset) if (
            not st.lossy_quality and 0 <= HASH_CHAR - offset < 256) else -1
        qlen_pad = jnp.asarray(np.pad(
            qual_len_np, (0, sh.rcap - num_rec)).astype(np.int32))
        qvals, q_total = Q.decode_quality(
            r, sh.cap, qlen_pad, num_rec, st.quality_order, hash_val)
        # dna
        dna, dna_total = DNA.decode_dna(r, sh.cap, st.dna_order)
        # inverse transform
        if ds.color_space:
            seq, qual = _backward_transform_cs(
                dna, qvals, jnp.int32(q_total), offset, sh.cap,
                st.lossy_quality)
        else:
            seq, qual = _backward_transform(
                dna, qvals, jnp.int32(q_total), offset, sh.cap,
                st.lossy_quality)
        seq_np = np.asarray(seq)[:q_total]
        qual_np = np.asarray(qual)[:q_total]
        text = self._layout(num_rec, titles_np, title_len_np, qual_len_np,
                            seq_np, qual_np, primers, ds)
        if crcs is not None:
            got = _stream_crcs_from_text(text, ds)
            if got != crcs:
                raise DsrcException(
                    "CRC32 mismatch on block self-verification "
                    f"(stored {crcs}, decoded {got})")
        return text

    def _decompress_uniform(self, r: BitReader) -> np.ndarray:
        from ..parallel import uniform_pipeline as UP
        comp_np, spec, num_rec, rpad, wire = read_uniform_block(
            r, compact=True)
        comp = jax.tree_util.tree_map(jnp.asarray, comp_np)
        # left-aligned payloads: restore canonical width on DEVICE so the
        # compressed bytes (not the canonical padding) cross the host link
        for key, p, g in (("title", spec.title_len, wire.title_code_group),
                          ("qual", spec.read_len, wire.qual_group)):
            payload, nwords, states, tab = comp[key]
            wp = _uniform_wp(p, g)
            comp[key] = (_pad_cols(payload, wp), nwords, states, tab)
        mat = UP.decompress_uniform(comp, spec, rpad, left=True, wire=wire)
        return np.asarray(mat)[:num_rec].reshape(-1)

    @staticmethod
    def _layout(num_rec, titles_np, title_len_np, qual_len_np, seq_np,
                qual_np, primers, ds: DatasetType) -> np.ndarray:
        """Rebuild FASTQ text — one native pass (utils/native.layout_records,
        reference text layout BlockCompressor.cpp:503-573) with a
        vectorized-scatter numpy fallback."""
        from ..utils import native
        return native.layout_records(
            num_rec, np.asarray(titles_np), title_len_np,
            np.asarray(seq_np), np.asarray(qual_np), qual_len_np,
            primers, ds.color_space, ds.plus_repetition)

    # -------------------------------------------------- verification
    def verify_checksum(self, blob: bytes) -> bool:
        """Decode-after-encode self check (reference BlockCompressor::
        VerifyChecksum, BlockCompressor.cpp:576-594): re-decode the block;
        decompress() compares the decoded streams' CRC32s against the ones
        stored in the meta section and raises on mismatch."""
        try:
            self.decompress(blob)
            return True
        except DsrcException:
            return False


def _stream_crcs_from_text(text: np.ndarray, ds: DatasetType):
    """CRC32 of the tag/sequence/quality streams of decoded FASTQ text
    (vectorized masks; streams match what compress() hashed)."""
    nl_mask = text == 10
    line_id = np.cumsum(nl_mask) - nl_mask
    lmod = line_id % 4
    is_start = np.concatenate([[True], nl_mask[:-1]])
    t_mask = (lmod == 0) & ~nl_mask & ~is_start          # skip '@'
    s_mask = (lmod == 1) & ~nl_mask
    if ds.color_space:
        s_mask &= ~is_start                              # skip primer base
    q_mask = (lmod == 3) & ~nl_mask
    return (crc32(text[t_mask]), crc32(text[s_mask]), crc32(text[q_mask]))
