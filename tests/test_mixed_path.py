"""Mixed-path archives and decode-cadence independence.

Real files essentially always end in a partial block, so a -d0 -q0 archive
mixes BLOCK_UNIFORM blocks (full fixed-width blocks) with a BLOCK_GENERIC
tail; and the decode super-chunk cadence (DSRC_TPU_SUPER) must never
change results — it is an access pattern, not part of the format.
"""
import io
import os
import subprocess
import sys

import numpy as np

from dsrc_tpu.api import DsrcModule
from dsrc_tpu.config import InputParameters
from dsrc_tpu.models.block import BLOCK_GENERIC, BLOCK_UNIFORM
from dsrc_tpu.io.archive import ArchiveReader
from dsrc_tpu.utils.synth import make_fastq_fast


def _mixed_archive(tmp_path):
    """Fixed-width blocks followed by variable-length records: the chunker
    record-aligns blocks, so the fixed-width prefix takes the uniform fast
    path while the tail block must take the generic codec — one archive,
    both block schemes."""
    from dsrc_tpu.utils.synth import make_fastq
    rec_bytes = 258
    per_block = (1 << 20) // rec_bytes            # records per 1 MB block
    uniform = make_fastq_fast(per_block * 2, 100, seed=11, fixed_width=True)
    tail = make_fastq(40, 90, variable_length=True, seed=12)
    data = uniform + tail
    params = InputParameters(fastq_block_size_mb=1)
    mod = DsrcModule(params)
    arch = io.BytesIO()
    mod.compress(io.BytesIO(data), arch)
    return data, arch


def test_mixed_uniform_and_generic_blocks_roundtrip(tmp_path):
    data, arch = _mixed_archive(tmp_path)
    arch.seek(0)
    reader = ArchiveReader(arch)
    schemes = {blob[0] for blob in reader}
    assert schemes == {BLOCK_UNIFORM, BLOCK_GENERIC}, \
        f"expected a mixed-path archive, got schemes {schemes}"
    arch.seek(0)
    out = io.BytesIO()
    DsrcModule().decompress(arch, out)
    assert out.getvalue() == data


def test_decode_super_cadence_independent(tmp_path):
    """An archive written under one DSRC_TPU_SUPER decodes byte-identically
    under another (8 vs the default 1) — run in a subprocess because the
    cadence is fixed at import time."""
    data, arch = _mixed_archive(tmp_path)
    fq = tmp_path / "in.xfqz"
    fq.write_bytes(arch.getvalue())
    outp = tmp_path / "out.fastq"
    env = dict(os.environ, DSRC_TPU_SUPER="8", JAX_PLATFORMS="cpu")
    subprocess.run(
        [sys.executable, "-m", "dsrc_tpu", "d", str(fq), str(outp)],
        check=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert outp.read_bytes() == data


def test_semi_uniform_real_illumina_layout():
    """Variable-digit titles with fixed read length — the layout of real
    Illumina runs — must take the BLOCK_SEMI fast path and round-trip."""
    from dsrc_tpu.models.block import BLOCK_SEMI
    from dsrc_tpu.utils.synth import make_fastq
    data = make_fastq(3000, 100, seed=5)       # titles vary in width
    mod = DsrcModule(InputParameters(fastq_block_size_mb=1))
    arch = io.BytesIO()
    mod.compress(io.BytesIO(data), arch)
    arch.seek(0)
    schemes = {blob[0] for blob in ArchiveReader(arch)}
    assert BLOCK_SEMI in schemes, f"semi path not taken: schemes {schemes}"
    arch.seek(0)
    out = io.BytesIO()
    DsrcModule().decompress(arch, out)
    assert out.getvalue() == data


def test_semi_rejects_iupac_and_offset64():
    """IUPAC bases or 64-offset quality must fall back to the generic
    codec (and still round-trip)."""
    from dsrc_tpu.models.block import BLOCK_SEMI
    from dsrc_tpu.utils.synth import make_fastq
    for kwargs in (dict(iupac_prob=0.02), dict(quality_offset=64)):
        data = make_fastq(400, 60, seed=6, **kwargs)
        mod = DsrcModule(InputParameters(fastq_block_size_mb=1))
        arch = io.BytesIO()
        mod.compress(io.BytesIO(data), arch)
        arch.seek(0)
        schemes = {blob[0] for blob in ArchiveReader(arch)}
        assert BLOCK_SEMI not in schemes
        arch.seek(0)
        out = io.BytesIO()
        DsrcModule().decompress(arch, out)
        assert out.getvalue() == data
