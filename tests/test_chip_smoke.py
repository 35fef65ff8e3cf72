"""chip_smoke.py: refuses to run without a GPU, and its round-trip phase
logic (DsrcModule cold/warm, the CLI, block classes, the program
recorder) works end to end at a tiny size on the CPU."""
import os
import subprocess
import sys

import pytest

import chip_smoke as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_mesh_child_refuses_without_four_gpus():
    # the CPU's virtual devices must not stand in for the four cards
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py", "--child", "mesh",
                        "--card", "none"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 2
    assert "mesh" not in r.stdout
    assert "needs 4 GPUs" in r.stderr


def test_dist_child_refuses_one_cpu_process():
    with pytest.raises(SystemExit) as e:
        S.require_dist(4)
    assert e.value.code == 2


def test_four_cards_needs_four_cards(monkeypatch, capsys):
    monkeypatch.setattr(S, "card_names", lambda: ["NVIDIA H100, 700 W"])
    assert S.main(["--four"]) == 2
    out = capsys.readouterr().out
    assert "needs 4 cards, nvidia-smi lists 1" in out
    assert '"ok": true' not in out


def test_counting_patch_counts_and_restores():
    class Codec:
        def compress_blocks(self, x):
            return x + 1

    used = S.collections.Counter()
    orig = Codec.compress_blocks
    with S._counting(used, Codec, "compress_blocks"):
        assert Codec().compress_blocks(1) == 2
        assert Codec().compress_blocks(2) == 3
    assert used == {"Codec.compress_blocks": 2}
    assert Codec.compress_blocks is orig


@pytest.mark.parametrize("kind,flags,expect", [
    ("novaseq", ["-d0", "-q0", "-b1"], "SEMI"),
    ("fixed", ["-d0", "-q0", "-b1"], "UNIFORM"),
])
def test_roundtrip_phase_small(monkeypatch, tmp_path, capsys, kind, flags,
                               expect):
    monkeypatch.setattr(S, "WORK", str(tmp_path))
    fastq = S.data_file(kind, 1.5, seed=4)
    S.roundtrip_phase(S.Say("cpu"), "t", fastq, flags, expect,
                      via_cli=(kind == "novaseq"))
    out = capsys.readouterr().out
    assert "byte-exact round trip through DsrcModule" in out
    assert f"'{expect}'" in out
    assert "program uniform_pipeline." in out
    assert ("through the CLI" in out) == (kind == "novaseq")


def test_roundtrip_phase_rejects_wrong_block_class(monkeypatch, tmp_path):
    monkeypatch.setattr(S, "WORK", str(tmp_path))
    fastq = S.data_file("fixed", 0.5, seed=5)
    with pytest.raises(AssertionError, match="expected only SEMI"):
        S.roundtrip_phase(S.Say("cpu"), "t", fastq, ["-d0", "-q0", "-b1"],
                          "SEMI", via_cli=False)
