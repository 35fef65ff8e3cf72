"""Native host-runtime ops (native/host_ops.cpp) vs their numpy fallbacks.

Every native entry point must agree bit-for-bit with the pure-numpy
fallback so the package behaves identically with and without the built
library (the reference's host runtime is C++, DsrcWorker.cpp /
FastqParser.cpp; ours mirrors that split: the device owns compute, C++ owns the
host staging loops)."""
import numpy as np
import pytest

from dsrc_tpu.utils import native


def _with_fallback(fn, *args, **kwargs):
    """Run fn twice: native (if built) and forced-numpy; return both."""
    out_native = fn(*args, **kwargs)
    orig_load, orig_lib = native._load, native._LIB
    native._load = lambda: None
    try:
        out_np = fn(*args, **kwargs)
    finally:
        native._load, native._LIB = orig_load, orig_lib
    return out_native, out_np


def _fastq(num, read_len, seed=0, good=True):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(num):
        title = f"SRR0{seed}.{i} x={rng.integers(1, 10 ** 6)}".encode()
        seq = rng.choice(list(b"ACGTN"), read_len).astype(np.uint8).tobytes()
        qual = rng.integers(33, 97, read_len).astype(np.uint8).tobytes()
        recs.append(b"@" + title + b"\n" + seq + b"\n+\n" + qual + b"\n")
    return np.frombuffer(b"".join(recs), np.uint8)


def test_stage_semi_native_matches_numpy():
    blob = _fastq(40, 64, seed=1)
    a, b = _with_fallback(native.stage_semi, blob, 64, 256)
    assert a is not None and b is not None
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert np.array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("mutate", ["plus", "qual", "seq", "at", "truncate"])
def test_stage_semi_rejections_agree(mutate):
    blob = _fastq(8, 32, seed=2).copy()
    rec_len = None
    # locate record 1's lines to corrupt deterministically
    nl = np.flatnonzero(blob == 10)
    if mutate == "plus":
        blob[nl[1] + 1] = ord("x")          # '+' line
    elif mutate == "qual":
        blob[nl[2] + 1] = 200               # out-of-range quality
    elif mutate == "seq":
        blob[nl[0] + 1] = ord("z")          # non-ACGTN base
    elif mutate == "at":
        blob[0] = ord("%")                  # record start
    elif mutate == "truncate":
        blob = blob[:-1]                    # no trailing newline
    a, b = _with_fallback(native.stage_semi, blob, 32, 256)
    assert a is None and b is None


def test_layout_records_native_matches_numpy_and_inverts_stage():
    blob = _fastq(30, 48, seed=3)
    qm, sm, ts, tl, n = native.stage_semi(blob, 48, 256)
    ql = np.full(n, 48, np.int64)
    args = (n, ts, tl, sm[:n].reshape(-1), qm[:n].reshape(-1), ql,
            None, False, False)
    a, b = _with_fallback(native.layout_records, *args)
    assert np.array_equal(a, b)
    assert a.tobytes() == blob.tobytes()


def test_layout_records_color_space_and_plus_rep():
    rng = np.random.default_rng(4)
    n = 12
    tl = rng.integers(3, 20, n).astype(np.int64)
    ql = rng.integers(5, 30, n).astype(np.int64)
    titles = rng.integers(33, 127, int(tl.sum())).astype(np.uint8)
    seq = rng.integers(ord("0"), ord("3") + 1, int(ql.sum())).astype(np.uint8)
    qual = rng.integers(33, 97, int(ql.sum())).astype(np.uint8)
    primers = rng.choice(list(b"ACGT"), n).astype(np.uint8)
    for cs, pr in [(True, False), (False, True), (True, True)]:
        args = (n, titles, tl, seq, qual, ql, primers if cs else None,
                cs, pr)
        a, b = _with_fallback(native.layout_records, *args)
        assert np.array_equal(a, b)
        # structural spot-checks
        text = a.tobytes().split(b"\n")
        assert text[0][:1] == b"@"
        if cs:
            assert text[1][:1] in (b"A", b"C", b"G", b"T")
        if pr:
            assert text[2][1:] == text[0][1:]


def test_scan_records_agrees():
    blob = _fastq(17, 20, seed=5)
    a, b = _with_fallback(native.scan_records, blob, 0)
    assert a == b
    # mid-record cut: boundary must respect lines_before phase
    a2, b2 = _with_fallback(native.scan_records, blob[:150], 2)
    assert a2 == b2
