"""dsrc_tpu — a FASTQ compression engine in JAX/XLA.

Brand-new JAX/XLA implementation with the capabilities of the reference
DSRC 2.02 (refresh-bio/DSRC): lossless and lossy FASTQ compression with DNA
modes 0-3, quality modes 0-2, tokenized read-ID compression,
Illumina/SOLiD/454 support, CRC32 self-verification, a block-indexed archive
container, CLI and library APIs.  See SURVEY.md for the reference analysis
and DESIGN.md for the architecture.
"""
__version__ = "0.1.0"

from .utils.jax_cache import use_compile_cache

# Persistent XLA compilation cache, the one place it is set: first-run
# compiles of the big block executables are written there and reused by
# every later process (CLI, library, bench, chip_smoke).  This imports jax
# (not the codec modules); see utils/jax_cache.py for where.
use_compile_cache()

from .config import (  # noqa: E402,F401
    AUTO_QUALITY_OFFSET,
    CompressionSettings,
    DatasetType,
    DsrcException,
    FieldMask,
    InputParameters,
)


def __getattr__(name):
    # Lazy exports that pull in the codec modules.
    if name in ("DsrcModule", "compress", "decompress"):
        from . import api
        return getattr(api, name)
    if name in ("DsrcArchive", "FastqFile", "FastqRecord"):
        from . import archive_api
        return getattr(archive_api, name)
    raise AttributeError(f"module 'dsrc_tpu' has no attribute {name!r}")
