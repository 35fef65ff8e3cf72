"""The host's GPUs as nvidia-smi names them, for reports that must say
which card (and at which power limit) a number was taken on."""
from __future__ import annotations

import subprocess


def card_names() -> list:
    """`name, power.limit` of every card, as nvidia-smi reports them; empty
    when nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [ln.strip() for ln in out.splitlines() if ln.strip()]
