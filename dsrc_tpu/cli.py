"""CLI frontend — reference-compatible flag surface (main.cpp:98-308).

    python -m dsrc_tpu <c|d> [options] <input> <output>
    python -m dsrc_tpu c -s out.xfqz < in.fastq      (stdin FASTQ)
    python -m dsrc_tpu d -s in.xfqz > out.fastq      (stdout FASTQ)

Options (compression):
  -d<n>  DNA compression level 0..3 (order = 3n)        [0]
  -q<n>  quality compression level 0..2                  [0]
  -l     lossy quality (Illumina 8-bin)                  [off]
  -f<a,b,...>  keep only these 1-based title fields      [all]
  -b<n>  FASTQ block size, MB, 1..1024                   [8]
  -o<n>  quality offset 33..64, 0 = auto-detect          [auto]
  -c     per-block CRC32 self-verification               [off]
  -m<n>  preset: -m0 = -d0 -q0 -b8, -m1 = -d2 -q2 -b64,
         -m2 = -d3 -q2 -b256
  -t<n>  worker threads (pipeline depth), 0 = auto       [auto]
  -s     FASTQ side on stdin/stdout
  -v     verbose per-stream statistics

Options (decompression):
  -r<N:M>  extract only records [N, M) (0-based) via the block index
"""
from __future__ import annotations

import sys
from typing import List, Optional

from .config import DsrcException, FieldMask, InputParameters

USAGE = __doc__


def parse_args(argv: List[str]) -> tuple:
    """Returns (mode 'c'|'d', InputParameters, input_path, output_path)."""
    if not argv or argv[0] in ("-h", "--help", "help"):
        raise DsrcException(USAGE)
    mode = argv[0]
    if mode not in ("c", "d"):
        raise DsrcException(f"invalid mode {mode!r}; use 'c' or 'd'\n"
                            + USAGE)
    p = InputParameters()
    paths: List[str] = []
    for a in argv[1:]:
        if not a.startswith("-"):
            paths.append(a)
            continue
        key, val = a[1], a[2:]
        try:
            if key == "d":
                p.dna_compression_level = int(val)
            elif key == "q":
                p.quality_compression_level = int(val)
            elif key == "l":
                p.lossy_quality = True
            elif key == "f":
                fields = [int(x) for x in val.split(",") if x]
                p.tag_preserve_mask = FieldMask.only(*fields).mask
            elif key == "b":
                p.fastq_block_size_mb = int(val)
            elif key == "o":
                p.quality_offset = int(val)
            elif key == "c":
                p.calculate_crc32 = True
            elif key == "m":
                preset = InputParameters.preset(int(val))
                p.dna_compression_level = preset.dna_compression_level
                p.quality_compression_level = \
                    preset.quality_compression_level
                p.fastq_block_size_mb = preset.fastq_block_size_mb
            elif key == "t":
                p.num_workers = int(val)
            elif key == "r":
                a, _, b = val.partition(":")
                p.record_range = (int(a), int(b))
            elif key == "s":
                p.use_stdio = True
            elif key == "v":
                p.verbose = True
            else:
                raise DsrcException(f"unknown option -{key}\n" + USAGE)
        except ValueError:
            raise DsrcException(f"bad value for option -{key}: {val!r}")
    p.validate()
    want = 1 if p.use_stdio else 2
    if len(paths) != want:
        raise DsrcException(
            f"expected {want} path(s), got {len(paths)}\n" + USAGE)
    if p.use_stdio:
        if mode == "c":
            return mode, p, None, paths[0]       # stdin FASTQ -> archive
        return mode, p, paths[0], None           # archive -> stdout FASTQ
    return mode, p, paths[0], paths[1]


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        mode, params, inp, outp = parse_args(argv)
    except DsrcException as e:
        print(str(e), file=sys.stderr)
        return 1
    from .api import DsrcModule  # deferred: heavy codec import
    m = DsrcModule(params)
    try:
        if mode == "c":
            src = sys.stdin.buffer if inp is None else inp
            info = m.compress(src, outp)
            if params.verbose:
                for k in ("tag", "dna", "quality", "meta"):
                    print(f"{k:8s} raw {info.raw[k]:>14d}  "
                          f"compressed {info.comp[k]:>12d}", file=sys.stderr)
        elif params.record_range is not None:
            # record-range extraction through the block index: only the
            # blocks overlapping [N, M) are decompressed
            from .archive_api import DsrcArchive
            dst = sys.stdout.buffer if outp is None else open(outp, "wb")
            try:
                arch = DsrcArchive(params)
                arch.start_decompress(inp)
                a, b = params.record_range
                for rec in arch.read_records(a, min(b, arch.record_count)):
                    dst.write(rec.to_bytes())
                arch.finish_decompress()
            finally:
                if outp is not None:
                    dst.close()
        else:
            dst = sys.stdout.buffer if outp is None else outp
            m.decompress(inp, dst)
        if params.verbose and m.last_stage_times is not None:
            print("per-stage (seconds are summed across workers):",
                  file=sys.stderr)
            for line in m.last_stage_times.lines():
                print("  " + line, file=sys.stderr)
    except DsrcException as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0
