"""The accelerator a measurement runs on, and the refusal to run without one.

Measurement entry points (bench.py, chip_smoke.py) call :func:`require_gpu`
first: a number taken on XLA's CPU backend says nothing about the card,
so they exit instead of falling back.
"""

from __future__ import annotations

import subprocess
import sys


def require_gpu() -> None:
    """Exit with status 2 (and say why on stderr) unless JAX's default
    backend is a GPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(
            f"refusing to run: JAX found no GPU (default backend {backend!r})",
            file=sys.stderr,
        )
        raise SystemExit(2)


def card_info() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    reports them (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def device_summary() -> dict:
    """Platform, kind and count of JAX's devices."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}
