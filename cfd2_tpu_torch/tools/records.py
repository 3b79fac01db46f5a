"""What the validation tools write beside each result: the card it ran on
and one JSON row appended to a record."""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

DATA = Path(__file__).resolve().parent.parent / "data"


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them for a
    CUDA device; ``"cpu"`` for the CPU."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = out.strip().splitlines()
    return lines[device.index or 0] if lines else ""


def append_row(path, row: dict):
    """Append ``row`` as one JSON line to ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(row) + "\n")
