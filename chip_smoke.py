"""End-to-end check of dsrc_tpu on a GPU.

    python chip_smoke.py [--seed N] [--only PHASE,...]   # one card
    python chip_smoke.py --four [--seed N]               # four cards

One card: drives the main path (DsrcModule.compress/decompress and the
CLI) file -> archive -> file at real block sizes and checks every result
byte for byte:

  build    the native host library from source, and whether it loaded
  semi     ~256 MB NovaSeq-style Illumina, 2x150-like reads, -m0
           (8 MB blocks, the SEMI block class), through DsrcModule and CLI
  uniform  ~64 MB fixed-width records, -m0 (the UNIFORM class)
  high     ~128 MB 42-level HiSeq-style quality, -m1 (64 MB blocks, the
           GENERIC class and the order-k context coders)
  golden   decode the archives in tests/data (made on the CPU) and
           re-encode their inputs on the card
  ints     the integer paths (2-bit DNA pack, rANS division, histograms)
           at 8 MB-block shapes against numpy, the XLA wavefront time on
           one block's quality stream, and how XLA lowered the int8 dots

Four cards (--four): the mesh codec of one process over four cards, then
`compress_distributed` over four processes with one card each; each
archive must equal the single-device archive of the same input.

Every finding line starts with the card's name and power limit.  The last
line is one JSON object, {"ok": true, "device": {...}}, printed only when
every phase passed.  Without a GPU the script exits non-zero at once.
All data is generated from --seed; it lives in .smoke/ (git-ignored).
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

from dsrc_tpu.utils.gpu import card_names

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
MiB = 1 << 20
PHASES = ("build", "semi", "uniform", "high", "golden", "ints")


# --------------------------------------------------------------------------
# Output
# --------------------------------------------------------------------------

class Say:
    """Prints finding lines prefixed with the card's name and power."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, msg: str) -> None:
        print(f"[{self.card}] {msg}", flush=True)


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()[:16]


# --------------------------------------------------------------------------
# Data, generated from the seed
# --------------------------------------------------------------------------

def make_data(kind: str, mb: float, seed: int) -> bytes:
    """FASTQ of about `mb` MiB from utils/synth.py, one generator call (one
    run: coordinates stay sorted across the whole file, as in a tile-sorted
    run)."""
    from dsrc_tpu.utils import synth

    if kind == "fixed":
        rec = len(synth.make_fastq_fast(1, 150, fixed_width=True))
        return synth.make_fastq_fast(max(1, int(mb * MiB) // rec), 150,
                                     seed=seed, fixed_width=True)
    platform, read_len = {"novaseq": ("novaseq", 150),
                          "hiseq": ("hiseq", 100)}[kind]
    rec = len(synth.make_fastq_realistic(256, read_len, platform=platform,
                                         seed=seed)) / 256
    return synth.make_fastq_realistic(max(64, int(mb * MiB / rec)), read_len,
                                      platform=platform, seed=seed)


def data_file(kind: str, mb: float, seed: int) -> str:
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, f"{kind}_{mb:g}MiB_seed{seed}.fastq")
    if not os.path.exists(path):
        t0 = time.perf_counter()
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            f.write(make_data(kind, mb, seed))
        os.replace(tmp, path)
        print(f"data: {os.path.basename(path)} generated in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return path


# --------------------------------------------------------------------------
# Program recorder: first-call seconds and memory_analysis() per program
# --------------------------------------------------------------------------

class ProgramRecorder:
    """Wraps the jitted functions of the given modules while active.
    Records each distinct call signature once with its first-call wall
    time (trace + compile + run); `report` prints those, and lowers the
    first call of each (function, argument shapes) again (the persistent
    cache makes that cheap) to print its memory_analysis()."""

    def __init__(self, modules):
        self.modules = modules
        self.calls = collections.OrderedDict()
        self._lock = threading.Lock()
        self._saved = []

    def __enter__(self):
        for mod in self.modules:
            for name, fn in list(vars(mod).items()):
                if callable(fn) and hasattr(fn, "lower") \
                        and hasattr(fn, "eval_shape"):
                    self._saved.append((mod, name, fn))
                    setattr(mod, name, self._wrap(
                        f"{mod.__name__.split('.')[-1]}.{name}", fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved = []

    def _wrap(self, label, fn):
        import jax

        def abstract(x):
            if isinstance(x, jax.core.Tracer):
                raise TypeError
            if hasattr(x, "shape") and hasattr(x, "dtype"):
                return jax.ShapeDtypeStruct(np.shape(x), x.dtype)
            return x

        def call(*args, **kw):
            try:
                a_args, a_kw = jax.tree_util.tree_map(abstract, (args, kw))
                key = (label, repr(a_args), repr(sorted(a_kw.items())))
            except TypeError:                 # called inside a trace
                return fn(*args, **kw)
            with self._lock:
                first = key not in self.calls
                if first:
                    self.calls[key] = [label, fn, a_args, a_kw, None]
            if not first:
                return fn(*args, **kw)
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*args, **kw))
            self.calls[key][4] = time.perf_counter() - t0
            return out

        return call

    def report(self, say, tag: str) -> None:
        import jax
        seen = set()
        for label, fn, a_args, a_kw, first_s in self.calls.values():
            shapes = repr([(x.shape, x.dtype) for x in
                           jax.tree_util.tree_leaves((a_args, a_kw))
                           if isinstance(x, jax.ShapeDtypeStruct)])
            mem = ""
            if (label, shapes) not in seen:
                seen.add((label, shapes))
                try:
                    ma = fn.lower(*a_args, **a_kw).compile() \
                        .memory_analysis()
                    mem = (f"; args {ma.argument_size_in_bytes / MiB:.1f} "
                           f"MiB, out {ma.output_size_in_bytes / MiB:.1f} "
                           f"MiB, temp {ma.temp_size_in_bytes / MiB:.1f} "
                           f"MiB, code "
                           f"{ma.generated_code_size_in_bytes / MiB:.2f} MiB")
                except Exception as e:         # report, never hide
                    mem = f"; memory_analysis unavailable: {e!r}"
            say(f"{tag}: program {label}: first call {first_s:.2f} s "
                f"(trace+compile+run){mem}")


def peak_mib() -> float:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / MiB


def _program_modules():
    from dsrc_tpu import api
    from dsrc_tpu.models import block, dna, quality
    from dsrc_tpu.ops import ctx, packbits, parser, transform
    from dsrc_tpu.parallel import uniform_pipeline
    return [api, block, dna, quality, ctx, packbits, parser, transform,
            uniform_pipeline]


# --------------------------------------------------------------------------
# Phases 2-4: file -> archive -> file
# --------------------------------------------------------------------------

def block_classes(arch_path: str) -> list:
    """The class of every block of an archive, in order."""
    from dsrc_tpu.io.archive import ArchiveReader
    from dsrc_tpu.models.block import (BLOCK_GENERIC, BLOCK_SEMI,
                                       BLOCK_UNIFORM)
    names = {BLOCK_GENERIC: "GENERIC", BLOCK_SEMI: "SEMI",
             BLOCK_UNIFORM: "UNIFORM"}
    reader = ArchiveReader(arch_path)
    try:
        return [names.get(b[0], str(b[0])) for b in reader]
    finally:
        reader.close()


def roundtrip_phase(say, tag: str, fastq: str, flags: list,
                    expect_class: str, via_cli: bool) -> None:
    """Compress and decompress `fastq` twice through DsrcModule (cold,
    then warm) with the CLI `flags`, and, if asked, once through the CLI
    itself; every output must equal the input byte for byte and every
    archive the first one."""
    from dsrc_tpu import cli
    from dsrc_tpu.api import DsrcModule

    data = open(fastq, "rb").read()
    mb = len(data) / MiB
    _, params, _, _ = cli.parse_args(["c", *flags, "in", "out"])
    workers = params.num_workers or 2
    say(f"{tag}: input {mb:.1f} MiB, {' '.join(flags)} (-d"
        f"{params.dna_compression_level} -q"
        f"{params.quality_compression_level} -b"
        f"{params.fastq_block_size_mb}), {workers} codec worker threads")
    base = os.path.join(WORK, tag)
    times = {}
    archives = []
    with ProgramRecorder(_program_modules()) as rec:
        for run in ("cold", "warm"):
            arch, out = f"{base}.{run}.xfqz", f"{base}.{run}.fastq"
            mod = DsrcModule(params)
            t0 = time.perf_counter()
            mod.compress(fastq, arch)
            tc = time.perf_counter() - t0
            t0 = time.perf_counter()
            mod.decompress(arch, out)
            td = time.perf_counter() - t0
            times[run] = (tc, td)
            got = open(out, "rb").read()
            if got != data:
                raise AssertionError(
                    f"{tag}: {run} round trip differs from the input "
                    f"({len(got)} vs {len(data)} bytes)")
            archives.append(open(arch, "rb").read())
            os.remove(out)
    if archives[0] != archives[1]:
        raise AssertionError(f"{tag}: two compressions of one input gave "
                             f"different archives")
    arch_bytes = archives[0]
    classes = block_classes(f"{base}.cold.xfqz")
    # the short last block may take another class (a few records of one
    # length pass the UNIFORM check); every full block must not
    full = set(classes[:-1] or classes)
    (cc, cd), (wc, wd) = times["cold"], times["warm"]
    say(f"{tag}: byte-exact round trip through DsrcModule (cold and warm); "
        f"archive {len(arch_bytes)} B sha256 {_sha(arch_bytes)}; "
        f"ratio {len(data) / len(arch_bytes):.4f}; block classes "
        f"{dict(collections.Counter(classes))}, last {classes[-1]}")
    say(f"{tag}: cold compress {cc:.2f} s, cold decompress {cd:.2f} s "
        f"(compile/warm-up {cc + cd - wc - wd:.2f} s)")
    say(f"{tag}: warm compress {wc:.2f} s = {mb / wc:.1f} MiB/s, warm "
        f"decompress {wd:.2f} s = {mb / wd:.1f} MiB/s")
    if full != {expect_class}:
        raise AssertionError(f"{tag}: expected only {expect_class} blocks, "
                             f"got {collections.Counter(classes)}")
    if via_cli:
        arch, out = f"{base}.cli.xfqz", f"{base}.cli.fastq"
        t0 = time.perf_counter()
        rc_c = cli.main(["c", *flags, fastq, arch])
        tc = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc_d = cli.main(["d", arch, out])
        td = time.perf_counter() - t0
        if rc_c or rc_d:
            raise AssertionError(f"{tag}: CLI exit codes {rc_c}, {rc_d}")
        if open(out, "rb").read() != data:
            raise AssertionError(f"{tag}: CLI round trip differs")
        if open(arch, "rb").read() != arch_bytes:
            raise AssertionError(f"{tag}: CLI archive differs from the "
                                 f"DsrcModule archive")
        os.remove(out)
        say(f"{tag}: byte-exact round trip through the CLI (python -m "
            f"dsrc_tpu c {' '.join(flags)} / d), same archive; compress "
            f"{tc:.2f} s, decompress {td:.2f} s")
    for suffix in ("cold", "warm", "cli"):
        p = f"{base}.{suffix}.xfqz"
        if os.path.exists(p):
            os.remove(p)
    rec.report(say, tag)
    say(f"{tag}: peak device memory so far {peak_mib():.1f} MiB "
        f"(peak_bytes_in_use)")


# --------------------------------------------------------------------------
# Phase 5: golden archives
# --------------------------------------------------------------------------

GOLDEN = [
    ("golden_uniform", dict()),
    ("golden_semi", dict()),
    ("golden_generic", dict(dna_compression_level=2,
                            quality_compression_level=2)),
    ("golden_lossy", dict(lossy_quality=True, quality_compression_level=1)),
]


def golden_phase(say) -> None:
    """Decode every CPU-made golden archive on the card, re-encode its
    input on the card, and say whether the archive bytes match.  The
    fixtures run in parallel threads so that their compiles overlap."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(GOLDEN)) as pool:
        for f in [pool.submit(golden_fixture, say, name, kw)
                  for name, kw in GOLDEN]:
            f.result()


def golden_fixture(say, name: str, kw: dict) -> None:
    """One golden archive: decode, re-encode, decode again, compare."""
    from dsrc_tpu.api import DsrcModule
    from dsrc_tpu.config import InputParameters

    t0 = time.perf_counter()
    data_dir = os.path.join(ROOT, "tests", "data")
    expect = open(os.path.join(data_dir, name + ".fastq"), "rb").read()
    golden = open(os.path.join(data_dir, name + ".xfqz"), "rb").read()
    out = io.BytesIO()
    DsrcModule().decompress(io.BytesIO(golden), out)
    if out.getvalue() != expect:
        raise AssertionError(f"golden: {name} does not decode exactly")
    mod = DsrcModule(InputParameters(fastq_block_size_bytes=1 << 17,
                                     **kw))
    arch = io.BytesIO()
    mod.compress(io.BytesIO(expect), arch)
    arch.seek(0)
    back = io.BytesIO()
    mod.decompress(arch, back)
    if kw.get("lossy_quality"):
        # lossy re-binning keeps titles and bases
        lines, want = back.getvalue().split(b"\n"), expect.split(b"\n")
        exact = lines[0::4] == want[0::4] and lines[1::4] == want[1::4]
    else:
        exact = back.getvalue() == expect
    if not exact:
        raise AssertionError(f"golden: {name} re-encoded on the card "
                             f"does not decode exactly")
    same = arch.getvalue() == golden
    say(f"golden: {name}: CPU archive decoded exactly; re-encoded on "
        f"the card and decoded exactly; card archive "
        f"{'EQUALS' if same else 'DIFFERS FROM'} the CPU archive "
        f"({arch.getbuffer().nbytes} vs {len(golden)} B); "
        f"{time.perf_counter() - t0:.1f} s with compiles")


# --------------------------------------------------------------------------
# Phase 6: integer paths against numpy
# --------------------------------------------------------------------------

def np_pack_dna(seq: np.ndarray, num_rec: int):
    """numpy reference of uniform_pipeline.pack_dna."""
    rpad, p = seq.shape
    code = np.zeros(seq.shape, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        code[seq == ch] = i
    flat = np.pad(code.reshape(-1), (0, (-code.size) % 4)).reshape(-1, 4)
    packed = (flat[:, 0] | (flat[:, 1] << 2) | (flat[:, 2] << 4)
              | (flat[:, 3] << 6)).astype(np.uint8)
    exc = ~np.isin(seq, np.frombuffer(b"ACGT", np.uint8))
    exc[num_rec:] = False
    wcnt = -(-p // 32)
    bits = np.pad(exc, ((0, 0), (0, wcnt * 32 - p))).reshape(rpad, wcnt, 32)
    words = (bits.astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return packed, words, int(exc.sum())


def random_seq(rpad: int, p: int, num_rec: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGTN", np.uint8)[
        rng.choice(5, (rpad, p), p=[0.25, 0.24, 0.24, 0.25, 0.02])]
    seq = seq.copy()
    seq[num_rec:] = 0
    return seq


def check_pack_dna(seq: np.ndarray, num_rec: int) -> None:
    """Device pack_dna/unpack_dna against numpy, exactly."""
    import jax
    import jax.numpy as jnp
    from dsrc_tpu.parallel import uniform_pipeline as UP

    rpad, p = seq.shape
    pack = jax.jit(UP.pack_dna, static_argnums=2)
    packed, exc_bits, exc_count = pack(jnp.asarray(seq), num_rec, p)
    e_packed, e_bits, e_count = np_pack_dna(seq, num_rec)
    np.testing.assert_array_equal(np.asarray(packed), e_packed)
    np.testing.assert_array_equal(np.asarray(exc_bits), e_bits)
    assert int(exc_count) == e_count, (int(exc_count), e_count)
    unpack = jax.jit(UP.unpack_dna, static_argnums=(3, 4))
    back = np.asarray(unpack(packed, exc_bits, exc_count, rpad, p))
    np.testing.assert_array_equal(back[:num_rec], seq[:num_rec])


def div_operands(per_f: int, seed: int):
    """(x, f) uint32 over the encoder's whole operand range: every f in
    [1, 2^14), and x below the renorm bound f << 18 — its edges (0, 1,
    f - 1, f, f + 1, the bound - 1 and - 2, multiples of f +- 1) plus
    random values."""
    from dsrc_tpu.ops.rans import M
    rng = np.random.default_rng(seed)
    f = np.arange(1, M, dtype=np.uint64)
    top = f << np.uint64(18)
    edges = [np.zeros_like(f), np.ones_like(f), f - 1, f, f + 1,
             top - 1, top - 2, (top >> np.uint64(1)) - 1,
             top >> np.uint64(1), (top >> np.uint64(1)) + 1,
             np.full_like(f, 1 << 16), np.full_like(f, (1 << 16) - 1)]
    cols = [np.minimum(e, top - 1) for e in edges]
    for _ in range(max(0, per_f - len(cols))):
        cols.append((rng.random(f.shape) * top).astype(np.uint64)
                    .clip(0, top - 1))
    x = np.stack(cols, 1)
    return (x.astype(np.uint32).reshape(-1),
            np.broadcast_to(f[:, None], x.shape).astype(np.uint32)
            .reshape(-1))


def div_lax(x, f):
    """Division by XLA's own unsigned integer ops."""
    return x // f, x % f


def check_div(div, x: np.ndarray, f: np.ndarray) -> None:
    import jax
    q, r = jax.jit(div)(x, f)
    x64, f64 = x.astype(np.uint64), f.astype(np.uint64)
    np.testing.assert_array_equal(np.asarray(q).astype(np.uint64), x64 // f64)
    np.testing.assert_array_equal(np.asarray(r).astype(np.uint64), x64 % f64)


def check_pos_hist(mat: np.ndarray, num_rec: int, nsym: int) -> None:
    """_pos_hist against per-column np.bincount of the live rows."""
    import jax
    from dsrc_tpu.parallel import uniform_pipeline as UP
    got = np.asarray(jax.jit(UP._pos_hist, static_argnums=2)(
        mat, num_rec, nsym))
    want = np.stack([np.bincount(mat[:num_rec, j], minlength=nsym)[:nsym]
                     for j in range(mat.shape[1])])
    np.testing.assert_array_equal(got, want)


def check_hist_update(ids: np.ndarray, active: np.ndarray,
                      nbins: int) -> None:
    """ctx.hist_update (one-hot matmul branch up to 512*512 bins, scatter
    beyond) against np.bincount of the active ids."""
    import jax
    from dsrc_tpu.ops import ctx as C
    got = np.asarray(jax.jit(C.hist_update, static_argnums=2)(
        ids, active, nbins))
    want = np.bincount(ids[active], minlength=nbins)
    np.testing.assert_array_equal(got, want)


def lowering_summary(fn, *args) -> str:
    """Custom-call targets and fusion kinds of the compiled program."""
    import re
    text = fn.lower(*args).compile().as_text()
    targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"', text)))
    kinds = collections.Counter(re.findall(r"kind=(k\w+)", text))
    backend = sorted(set(re.findall(r'"kind":"(__\w+)"', text)))
    dots = len(re.findall(r"= s32\[[^\]]*\][^=]* dot\(", text))
    return (f"custom calls {targets or 'none'}; fusion kinds "
            f"{dict(kinds)}; fusion backend kinds {backend or 'none'}; "
            f"s32 dot ops left in fusions {dots}")


def _timed(fn, *args, reps: int = 5) -> float:
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def ints_phase(say, seed: int, block_mb: float = 8.0) -> None:
    import unittest.mock

    import jax
    import jax.numpy as jnp
    from dsrc_tpu.models.block import stage_semi_raw
    from dsrc_tpu.ops import ctx as C
    from dsrc_tpu.ops import rans as R
    from dsrc_tpu.parallel import uniform_pipeline as UP

    # one real 8 MB block of the semi path, staged as the codec stages it
    block = np.frombuffer(make_data("novaseq", block_mb, seed + 6), np.uint8)
    read_len, num_rec, qm, sm, _, _ = stage_semi_raw(block)
    rpad = -(-num_rec // 256) * 256 + 256
    qm, sm = qm[:rpad], sm[:rpad]
    say(f"ints: one {len(block) / MiB:.1f} MiB NovaSeq block: {num_rec} "
        f"records x {read_len}, rpad {rpad}")

    check_pack_dna(sm, num_rec)
    for p in (100, 101, 150, 251):
        n = int(block_mb * MiB) // (2 * p + 60)
        check_pack_dna(random_seq(-(-n // 256) * 256, p, n, seed + p), n)
    say("ints: pack_dna/unpack_dna equal numpy exactly (the real block, "
        "and random ACGTN 8 MB blocks at read lengths 100, 101, 150, 251)")

    x, f = div_operands(256, seed)
    check_div(R._div_u32, x, f)
    check_div(div_lax, x, f)
    say(f"ints: rANS division exact against np.floor_divide/np.mod on "
        f"{x.size} operands (every f in [1, 2^14), x below f << 18 with "
        f"the edges), both the program's _div_u32 and lax // and %")

    qsym = np.clip(qm.astype(np.int32) - 33, 0, UP.QUAL_A - 1)
    qsym[num_rec:] = 0
    check_pos_hist(qsym, num_rec, UP.QUAL_A)
    rng = np.random.default_rng(seed)
    check_pos_hist(rng.integers(0, 256, (rpad, 8)).astype(np.int32),
                   num_rec, UP.VAL_A)
    n_ids = num_rec * read_len
    live = np.arange(n_ids) < n_ids - n_ids // 7       # masked tail
    live &= rng.random(n_ids) < 0.9
    for nbins in (1 << 12, 1 << 18, 1 << 20):
        ids = rng.integers(0, nbins, n_ids).astype(np.int32)
        check_hist_update(ids, live, nbins)
    say(f"ints: _pos_hist (A=64 on the block's quality, A=256) and "
        f"hist_update on {n_ids} ids (one-hot matmul branch at 2^12 and "
        f"2^18 bins, scatter branch at 2^20) equal np.bincount exactly")

    say("ints: lowering of _pos_hist (int8 batched dot, non-leading batch "
        "dim): " + lowering_summary(
            jax.jit(UP._pos_hist, static_argnums=2), jnp.asarray(qsym),
            num_rec, UP.QUAL_A))
    say("ints: lowering of ctx._hist_mxu at 2^18 bins: " + lowering_summary(
        jax.jit(C._hist_mxu, static_argnums=2), jnp.asarray(ids),
        jnp.asarray(live), 1 << 18))

    # XLA wavefronts on the block's quality stream, and the two divisions
    group = UP.QUAL_GROUP
    qj = jnp.asarray(qsym)

    def enc_fn():
        return jax.jit(lambda m, n: UP.encode_positional(
            m, n, UP.QUAL_A, group))

    enc = enc_fn()
    t_enc = _timed(enc, qj, num_rec)
    payload, nwords, states, table = enc(qj, num_rec)
    dec = jax.jit(lambda pl, st, nw, tb, n: UP.decode_positional(
        pl, st, nw, tb, n, read_len, rpad, UP.QUAL_A, group))
    t_dec = _timed(dec, payload, states, nwords, table, num_rec)
    back = np.asarray(dec(payload, states, nwords, table, num_rec))
    np.testing.assert_array_equal(back[:num_rec], qsym[:num_rec])
    msym = num_rec * read_len / 1e6
    say(f"ints: XLA wavefront on one block's quality stream ({msym:.2f} "
        f"Msym, {rpad // group} lanes, UNROLL {R.UNROLL}, SUPER "
        f"{R.SUPER}): encode_positional {t_enc * 1e3:.2f} ms "
        f"({msym / t_enc:.1f} Msym/s), decode_positional "
        f"{t_dec * 1e3:.2f} ms ({msym / t_dec:.1f} Msym/s); decoded "
        f"exactly")
    with unittest.mock.patch.object(R, "_div_u32", div_lax):
        enc_lax = enc_fn()
        t_lax = _timed(enc_lax, qj, num_rec)
        out_lax = enc_lax(qj, num_rec)
    same = all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(out_lax, (payload, nwords, states, table)))
    if not same:
        raise AssertionError("ints: encode with lax division differs")
    say(f"ints: encode_positional with the program's _div_u32 "
        f"{t_enc * 1e3:.2f} ms, with lax // and % {t_lax * 1e3:.2f} ms; "
        f"identical output")
    say(f"ints: peak device memory so far {peak_mib():.1f} MiB")


# --------------------------------------------------------------------------
# Driver
# --------------------------------------------------------------------------

def build_phase(say) -> None:
    from dsrc_tpu.utils import native
    t0 = time.perf_counter()
    r = subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                       capture_output=True, text=True)
    say(f"build: make -C native exit {r.returncode} in "
        f"{time.perf_counter() - t0:.1f} s"
        + ("" if r.returncode == 0 else f": {r.stderr[-500:]}"))
    loaded = native.available()
    say(f"build: native host library loaded: {loaded}")
    if not loaded:
        raise AssertionError("build: native host library did not load; "
                             "the SEMI fast path needs it")


def run_phases(say, phases, seed: int) -> bool:
    ok = True
    for phase in phases:
        t0 = time.perf_counter()
        try:
            if phase == "build":
                build_phase(say)
            elif phase == "semi":
                roundtrip_phase(say, "semi", data_file("novaseq", 256, seed),
                                ["-m0"], "SEMI", via_cli=True)
            elif phase == "uniform":
                roundtrip_phase(say, "uniform",
                                data_file("fixed", 64, seed + 1), ["-m0"],
                                "UNIFORM", via_cli=False)
            elif phase == "high":
                roundtrip_phase(say, "high",
                                data_file("hiseq", 128, seed + 2), ["-m1"],
                                "GENERIC", via_cli=False)
            elif phase == "golden":
                golden_phase(say)
            elif phase == "ints":
                ints_phase(say, seed)
            say(f"{phase}: PASSED in {time.perf_counter() - t0:.1f} s")
        except Exception:
            ok = False
            for line in traceback.format_exc().splitlines():
                say(f"{phase}: {line}")
            say(f"{phase}: FAILED after {time.perf_counter() - t0:.1f} s")
    return ok


def require_gpus(where: str, count: int = 0) -> list:
    """JAX's devices when they are GPUs (exactly `count` of them, if
    given); otherwise says why on stderr and exits with code 2."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu" or (count and len(devs) != count):
        print(f"chip_smoke: {where} needs {count or 'a'} GPU"
              f"{'s' if count > 1 else ''}; JAX found {len(devs)} x "
              f"{devs[0].platform}", file=sys.stderr)
        sys.exit(2)
    return devs


def one_card(args) -> int:
    import jax
    devs = require_gpus("the one-card run")
    cards = card_names()
    for line in cards:
        print(line, flush=True)
    say = Say(cards[0] if cards else "card unknown")
    from dsrc_tpu.ops.rans import SUPER, UNROLL
    say(f"device: {devs[0].device_kind} x{len(devs)}, platform "
        f"{devs[0].platform}, jax {jax.__version__}, compile cache "
        f"{jax.config.jax_compilation_cache_dir}, decode UNROLL {UNROLL} x "
        f"SUPER {SUPER}")
    phases = args.only.split(",") if args.only else PHASES
    ok = run_phases(say, phases, args.seed)
    if not ok:
        say("FAILED")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


# --------------------------------------------------------------------------
# Four cards
# --------------------------------------------------------------------------

FOUR = 4
FOUR_INPUTS = (("semi", "novaseq", 256, 0, "MeshSemiCodec"),
               ("uniform", "fixed", 64, 1, "MeshUniformCodec"))
# seconds per stage: about 2.5x what each took on 4 H100s, compiles
# included (mesh process 238 s, distributed processes 76 s)
FOUR_TIMEOUT = {"mesh": 600, "dist": 200}


def four_path(tag: str, which: str) -> str:
    return os.path.join(WORK, f"four_{tag}.{which}.xfqz")


def _counting(used: collections.Counter, cls, name: str):
    """Patch `cls.name` to count its calls in `used`."""
    import unittest.mock
    orig = getattr(cls, name)

    def counted(self, *a, **k):
        used[f"{cls.__name__}.{name}"] += 1
        return orig(self, *a, **k)

    return unittest.mock.patch.object(cls, name, counted)


def four_child_mesh(args) -> int:
    """One process over the four cards: DsrcModule picks the mesh codec;
    each input must round-trip through it byte for byte, and its archive
    must equal the single-device archive (DsrcModule with the mesh turned
    off, on the first card)."""
    import contextlib
    import unittest.mock

    from dsrc_tpu.api import DsrcModule
    from dsrc_tpu.config import InputParameters
    from dsrc_tpu.parallel import mesh as MESH

    devs = require_gpus("the mesh process", FOUR)
    mesh = MESH.local_device_mesh()
    if mesh is None or mesh.devices.size != FOUR:
        raise AssertionError(f"mesh: no {FOUR}-device mesh over {devs}")
    say = Say(args.card)
    say(f"mesh: {len(devs)} x {devs[0].device_kind} ({devs[0].platform}) "
        f"in one process, mesh axis {mesh.axis_names} of "
        f"{mesh.devices.size}")
    for tag, kind, mb, off, codec in FOUR_INPUTS:
        fastq = data_file(kind, mb, args.seed + off)
        data = open(fastq, "rb").read()
        arch, single = four_path(tag, "mesh"), four_path(tag, "single")
        out = os.path.join(WORK, f"four_{tag}.mesh.fastq")
        t0 = time.perf_counter()
        with unittest.mock.patch.object(MESH, "local_device_mesh",
                                        lambda *a, **k: None):
            DsrcModule(InputParameters.preset(0)).compress(fastq, single)
        say(f"mesh: {tag}: single-device reference archive in "
            f"{time.perf_counter() - t0:.2f} s (compiles included)")
        used = collections.Counter()
        with contextlib.ExitStack() as stack:
            for cls in (MESH.MeshSemiCodec, MESH.MeshUniformCodec):
                for name in ("compress_blocks", "decompress_blocks"):
                    stack.enter_context(_counting(used, cls, name))
            mod = DsrcModule(InputParameters.preset(0))
            t0 = time.perf_counter()
            mod.compress(fastq, arch)
            tc = time.perf_counter() - t0
            t0 = time.perf_counter()
            mod.decompress(arch, out)
            td = time.perf_counter() - t0
        batches = (used[f"{codec}.compress_blocks"],
                   used[f"{codec}.decompress_blocks"])
        say(f"mesh: {tag}: {codec} ran {batches[0]} compress and "
            f"{batches[1]} decompress batches of {FOUR} blocks; all mesh "
            f"calls {dict(used)}")
        if not all(batches):
            raise AssertionError(f"mesh: {tag} did not go through {codec}")
        if open(out, "rb").read() != data:
            raise AssertionError(f"mesh: {tag} round trip differs")
        say(f"mesh: {tag}: compress {tc:.2f} s, decompress {td:.2f} s "
            f"(compiles included); byte-exact round trip")
        a, s = open(arch, "rb").read(), open(single, "rb").read()
        if a != s:
            raise AssertionError(f"mesh: {tag} archive ({len(a)} B) differs "
                                 f"from the single-device one ({len(s)} B)")
        os.remove(out)
        say(f"mesh: {tag}: archive {len(a)} B sha256 {_sha(a)} equals the "
            f"single-device archive; block classes "
            f"{dict(collections.Counter(block_classes(arch)))}")
    with open(os.path.join(WORK, "four_device.json"), "w") as f:
        json.dump({"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs)}, f)
    return 0


def require_dist(nproc: int) -> None:
    """After jax.distributed.initialize: `nproc` processes with one GPU
    each, or exit with code 2."""
    import jax
    devs = jax.devices()
    if (devs[0].platform != "gpu" or jax.process_count() != nproc
            or jax.local_device_count() != 1 or len(devs) != nproc):
        print(f"chip_smoke: compress_distributed needs {nproc} processes "
              f"with one GPU each; JAX found {jax.process_count()} "
              f"processes, {jax.local_device_count()} local and {len(devs)} "
              f"global {devs[0].platform} devices", file=sys.stderr)
        sys.exit(2)


def four_child_dist(args) -> int:
    """One of N processes of compress_distributed, one card each."""
    import jax
    jax.distributed.initialize(
        coordinator_address=f"localhost:{args.port}",
        num_processes=args.nproc, process_id=args.pid,
        local_device_ids=[args.pid])
    require_dist(args.nproc)
    from dsrc_tpu.api import DsrcModule
    from dsrc_tpu.config import InputParameters

    say = Say(args.card)
    for tag, kind, mb, off, _ in FOUR_INPUTS:
        fastq = data_file(kind, mb, args.seed + off)
        t0 = time.perf_counter()
        DsrcModule(InputParameters.preset(0)).compress(
            fastq, four_path(tag, "dist"), distributed=True)
        if args.pid == 0:
            say(f"dist: {tag}: compress_distributed over {jax.process_count()}"
                f" processes x {jax.local_device_count()} local "
                f"{jax.local_devices()[0].platform} device: "
                f"{time.perf_counter() - t0:.2f} s (compiles included)")
    jax.distributed.shutdown()
    return 0


def _run_children(cmds, env, timeout: int) -> list:
    procs = [subprocess.Popen(c, env=env) for c in cmds]
    try:
        deadline = time.time() + timeout
        return [p.wait(timeout=max(1, deadline - time.time()))
                for p in procs]
    except subprocess.TimeoutExpired:
        return [p.poll() if p.poll() is not None else "timeout"
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def four_cards(args) -> int:
    """Parent of the four-card run.  It never touches a card itself: the
    mesh process runs first and exits, then the four distributed
    processes start, so each card has one process at a time.  Children
    run with JAX_PLATFORMS=cuda, so JAX cannot fall back to the CPU."""
    cards = card_names()
    for line in cards:
        print(line, flush=True)
    card = cards[0] if cards else "card unknown"
    say = Say(card)
    if len(cards) < FOUR:
        say(f"four: needs {FOUR} cards, nvidia-smi lists {len(cards)}")
        return 2
    t0 = time.perf_counter()
    for _, kind, mb, off, _ in FOUR_INPUTS:
        data_file(kind, mb, args.seed + off)
    say(f"four: inputs generated in {time.perf_counter() - t0:.1f} s")
    me = [sys.executable, os.path.abspath(__file__), "--seed",
          str(args.seed), "--card", card]
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    device_file = os.path.join(WORK, "four_device.json")
    for path in [device_file] + [four_path(tag, which)
                                 for tag, *_ in FOUR_INPUTS
                                 for which in ("single", "mesh", "dist")]:
        if os.path.exists(path):
            os.remove(path)
    t0 = time.perf_counter()
    rc = _run_children([me + ["--child", "mesh"]], env,
                       FOUR_TIMEOUT["mesh"])[0]
    say(f"four: mesh process exited {rc} after "
        f"{time.perf_counter() - t0:.1f} s")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    rcs = _run_children(
        [me + ["--child", "dist", "--pid", str(i), "--nproc", str(FOUR),
               "--port", str(port)] for i in range(FOUR)],
        env, FOUR_TIMEOUT["dist"])
    say(f"four: distributed processes exited {rcs} after "
        f"{time.perf_counter() - t0:.1f} s")
    if rc != 0 or any(rcs):
        say("FAILED")
        return 1
    with open(device_file) as f:
        device = json.load(f)
    ok = device["platform"] == "gpu" and device["count"] == FOUR
    for tag, *_ in FOUR_INPUTS:
        single, mesh_a, dist = (open(four_path(tag, w), "rb").read()
                                for w in ("single", "mesh", "dist"))
        same = single == mesh_a == dist
        ok &= same
        say(f"four: {tag}: compress_distributed archive {len(dist)} B "
            f"sha256 {_sha(dist)}, mesh {len(mesh_a)} B sha256 "
            f"{_sha(mesh_a)}, single-device {len(single)} B sha256 "
            f"{_sha(single)}: {'all EQUAL' if same else 'they DIFFER'}")
    if not ok:
        say("FAILED")
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run the four-card paths and nothing else")
    ap.add_argument("--only", default="",
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--child", choices=("mesh", "dist"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--card", default="", help=argparse.SUPPRESS)
    ap.add_argument("--pid", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--nproc", type=int, default=FOUR,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child == "mesh":
        return four_child_mesh(args)
    if args.child == "dist":
        return four_child_dist(args)
    if args.four:
        return four_cards(args)
    return one_card(args)


if __name__ == "__main__":
    sys.exit(main())
