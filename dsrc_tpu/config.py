"""Configuration for the FASTQ compression engine.

Mirrors the user-visible knobs of the reference (DSRC 2.02) — see
/root/reference/src/Common.h:115-193 (CompressionSettings, InputParameters) and
/root/reference/include/dsrc/Globals.h — re-expressed as Python dataclasses.
The archive footer persists ``CompressionSettings`` + ``DatasetType`` so that
decompression needs no flags (reference: DsrcFile.cpp:133-170).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


class DsrcException(Exception):
    """Engine error (reference: Globals.h:58)."""


# Quality-offset sentinel: auto-detect from the first chunk
# (reference: Common.h / FastqParser.cpp:111-135).
AUTO_QUALITY_OFFSET = 0

MIN_DNA_ORDER = 0
MAX_DNA_ORDER = 9          # reference: CompressionSettings::MaxDnaOrder (Common.h)
MIN_QUALITY_ORDER = 0
MAX_QUALITY_ORDER = 6      # reference: CompressionSettings::MaxQualityOrder
MAX_BLOCK_SIZE_MB = 1024   # reference: main.cpp:300
DEFAULT_BLOCK_SIZE_MB = 8


@dataclasses.dataclass(frozen=True)
class DatasetType:
    """Per-dataset properties detected from the first chunk.

    Reference: FastqDatasetType (Common.h:56-80).
    """
    quality_offset: int = AUTO_QUALITY_OFFSET  # 0 = auto; else 33/59/64
    plus_repetition: bool = False              # '+' line repeats the title
    color_space: bool = False                  # SOLiD color-space reads

    def replace(self, **kw) -> "DatasetType":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FieldMask:
    """Bitmask of 1-based title fields to preserve under lossy ID filtering.

    Reference: FieldMask (Configurable.h:23-43); mask bit i set = field i+1
    is *preserved*.  An all-ones mask (default) keeps every field.
    """
    mask: int = 0xFFFFFFFFFFFFFFFF

    def add_field(self, field_1based: int) -> "FieldMask":
        if not (1 <= field_1based <= 64):
            raise DsrcException(f"field index out of range: {field_1based}")
        return FieldMask(self.mask | (1 << (field_1based - 1)))

    @staticmethod
    def only(*fields_1based: int) -> "FieldMask":
        m = FieldMask(0)
        for f in fields_1based:
            m = m.add_field(f)
        return m

    def keeps(self, field_1based: int) -> bool:
        return bool(self.mask >> (field_1based - 1) & 1)


@dataclasses.dataclass(frozen=True)
class CompressionSettings:
    """Codec-level settings, persisted in the archive footer.

    Reference: CompressionSettings (Common.h:115-147).  The reference's
    level->order mapping (DsrcOperator.h:74-90) lives in
    :func:`from_input_parameters`.
    """
    dna_order: int = 0                 # 0 = pack/static, 1..9 = context order
    quality_order: int = 0             # 0 = position modelers, 1..6 = context
    lossy_quality: bool = False        # Illumina 8-bin quantization
    tag_preserve_mask: int = 0xFFFFFFFFFFFFFFFF
    calculate_crc32: bool = False

    def __post_init__(self):
        if not MIN_DNA_ORDER <= self.dna_order <= MAX_DNA_ORDER:
            raise DsrcException(f"invalid dna_order: {self.dna_order}")
        if not MIN_QUALITY_ORDER <= self.quality_order <= MAX_QUALITY_ORDER:
            raise DsrcException(f"invalid quality_order: {self.quality_order}")

    @property
    def tag_fields_filtered(self) -> bool:
        return self.tag_preserve_mask != 0xFFFFFFFFFFFFFFFF


@dataclasses.dataclass
class InputParameters:
    """User-facing parameters (CLI / library), reference Common.h:149-193.

    CLI levels: ``dna_compression_level`` 0..3 maps to dna_order = level*3;
    ``quality_compression_level`` 0..2 maps to quality_order = level*3 when
    lossy else level (reference: DsrcOperator.h:74-90).
    """
    dna_compression_level: int = 0        # -d0..3
    quality_compression_level: int = 0    # -q0..2
    lossy_quality: bool = False           # -l
    tag_preserve_mask: int = 0xFFFFFFFFFFFFFFFF  # -f
    calculate_crc32: bool = False         # -c
    fastq_block_size_mb: int = DEFAULT_BLOCK_SIZE_MB  # -b (MB)
    quality_offset: int = AUTO_QUALITY_OFFSET         # -o
    use_stdio: bool = False               # -s
    num_workers: int = 0                  # -t equivalent; 0 = auto
    verbose: bool = False                 # -v
    # exact block size override (testing / tuning); None = block_size_mb << 20
    fastq_block_size_bytes: Optional[int] = None
    # decompress-only record range [start, stop), CLI -rN:M; None = all
    record_range: Optional[tuple] = None

    def validate(self) -> None:
        if self.record_range is not None:
            a, b = self.record_range
            if not (0 <= a < b):
                raise DsrcException("record range must be 0 <= N < M")
        if not 0 <= self.dna_compression_level <= 3:
            raise DsrcException("DNA compression level must be 0..3")
        if not 0 <= self.quality_compression_level <= 2:
            raise DsrcException("Quality compression level must be 0..2")
        if not 1 <= self.fastq_block_size_mb <= MAX_BLOCK_SIZE_MB:
            raise DsrcException(
                f"FASTQ block size must be 1..{MAX_BLOCK_SIZE_MB} MB")
        if self.quality_offset != AUTO_QUALITY_OFFSET and not (
                33 <= self.quality_offset <= 64):
            raise DsrcException("Quality offset must be 33..64 (or auto)")
        if not 0 <= self.num_workers <= 64:
            raise DsrcException(
                "Thread number must be 0 (auto) .. 64")  # main.cpp:294

    def to_settings(self) -> CompressionSettings:
        self.validate()
        dna_order = self.dna_compression_level * 3
        if self.lossy_quality:
            quality_order = self.quality_compression_level * 3
        else:
            quality_order = self.quality_compression_level
        return CompressionSettings(
            dna_order=dna_order,
            quality_order=quality_order,
            lossy_quality=self.lossy_quality,
            tag_preserve_mask=self.tag_preserve_mask,
            calculate_crc32=self.calculate_crc32,
        )

    @staticmethod
    def preset(mode: int) -> "InputParameters":
        """Reference CLI presets -m0/-m1/-m2 (main.cpp:195-219)."""
        if mode == 0:
            return InputParameters(dna_compression_level=0,
                                   quality_compression_level=0,
                                   fastq_block_size_mb=8)
        if mode == 1:
            return InputParameters(dna_compression_level=2,
                                   quality_compression_level=2,
                                   fastq_block_size_mb=64)
        if mode == 2:
            return InputParameters(dna_compression_level=3,
                                   quality_compression_level=2,
                                   fastq_block_size_mb=256)
        raise DsrcException(f"invalid preset mode: {mode}")
