"""The cards as ``nvidia-smi`` names them, power limit included."""

import subprocess


def lines() -> list:
    """One "name, power.limit" line a visible card, or [] without
    nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.strip().splitlines()]
