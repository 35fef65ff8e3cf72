"""Generate the golden-archive fixtures in tests/data.

Run ONLY alongside an archive VERSION bump: the whole point of the
fixtures is that existing archives keep decoding across encoder tuning
(tests/test_golden_archive.py)."""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from dsrc_tpu.api import DsrcModule                     # noqa: E402
from dsrc_tpu.config import InputParameters             # noqa: E402
from dsrc_tpu.utils.synth import (make_fastq, make_fastq_fast,  # noqa
                                  make_fastq_realistic)

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "data")


def main() -> None:
    os.makedirs(DATA, exist_ok=True)
    fixtures = {
        "golden_uniform": (make_fastq_fast(1500, 60, seed=50,
                                           fixed_width=True), dict()),
        "golden_semi": (make_fastq_realistic(1500, 60, seed=51), dict()),
        "golden_generic": (make_fastq(900, 70, seed=52,
                                      variable_length=True),
                           dict(dna_compression_level=2,
                                quality_compression_level=2)),
        "golden_lossy": (make_fastq_fast(1200, 60, seed=53,
                                         fixed_width=True),
                         dict(lossy_quality=True,
                              quality_compression_level=1)),
    }
    import io
    for name, (data, kw) in fixtures.items():
        mod = DsrcModule(InputParameters(fastq_block_size_bytes=1 << 17,
                                         **kw))
        arch_path = os.path.join(DATA, name + ".xfqz")
        arch = io.BytesIO()
        mod.compress(io.BytesIO(data), arch)
        if kw.get("lossy_quality"):
            # the golden .fastq stores what DECODE must produce
            arch.seek(0)
            out = io.BytesIO()
            mod.decompress(arch, out)
            data = out.getvalue()
        open(os.path.join(DATA, name + ".fastq"), "wb").write(data)
        open(arch_path, "wb").write(arch.getvalue())
        print(f"{name}: fastq {len(data)} B, archive "
              f"{arch.getbuffer().nbytes} B")


if __name__ == "__main__":
    main()
