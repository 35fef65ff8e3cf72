"""Checks that need the card.  They skip on a host without a GPU; on one
with a card run them with `python -m pytest tests/ -m gpu -p no:xdist`.
Each runs a chip_smoke.py phase in a child process on the card."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke(env, phases):
    r = subprocess.run([sys.executable, "chip_smoke.py", "--only", phases],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=1500)
    assert r.returncode == 0, r.stdout[-6000:] + r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
    return r.stdout


@pytest.mark.gpu
def test_golden_archives_decode_on_card(gpu):
    out = _smoke(gpu, "golden")
    assert out.count("CPU archive decoded exactly") == 4


@pytest.mark.gpu
def test_integer_paths_exact_on_card(gpu):
    out = _smoke(gpu, "build,ints")
    assert "pack_dna/unpack_dna equal numpy exactly" in out
    assert "rANS division exact" in out
