"""Accelerator checks shared by the entry points that measure on the card
(chip_smoke.py, bench.py).

A measurement that finds no GPU fails; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = [
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
]


def require_gpu():
    """JAX's devices when its default backend is a GPU; raises otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU found: JAX's default backend is {devs[0].platform!r} "
            f"({devs[0].device_kind})")
    return devs


def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """(name, power limit) per card from the output of NVIDIA_SMI_QUERY,
    e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    cards = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip() or not limit.strip():
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    if not cards:
        raise ValueError("nvidia-smi listed no card")
    return cards


def query_cards() -> str:
    """The raw output of NVIDIA_SMI_QUERY (one line per card)."""
    return subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
