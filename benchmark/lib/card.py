"""The card line: name, power limit and clocks as nvidia-smi reads them."""

from __future__ import annotations

import subprocess

QUERY = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"


def read() -> dict:
    """{field: text} of the first card, or {} where nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={QUERY}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    first = out.strip().splitlines()[0] if out.strip() else ""
    return dict(zip(QUERY.split(","), (v.strip() for v in first.split(","))))
