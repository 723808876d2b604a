"""HLO collective audit: turn "sharded as designed" into numbers.

Parses compiled (optimized) HLO text and reports every cross-device
collective with its output byte volume. Used by ``__graft_entry__
.dryrun_multichip`` to (a) ASSERT the replicated-atlas multi-view step
compiles with ZERO collectives (per-device cost is mesh-size-independent,
SURVEY §2.2) and (b) report the sharded-atlas step's collective op count
and byte volume at production shape.
"""

from __future__ import annotations

import re

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
    "collective-broadcast",
)

_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "c64": 8,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
# `%name = <shape(s)> <op>(` — shapes may be a tuple `(f32[..], f32[..])`
_OP_RE = re.compile(
    r"=\s*(\(?[^=]*?\)?)\s*(" + "|".join(_COLLECTIVES) + r")(-start)?\("
)


def _shape_bytes(shapes: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shapes):
        if dtype not in _DTYPE_BYTES:
            continue  # token/opaque
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_stats(hlo_text: str) -> dict:
    """{op: {"count": N, "bytes": B}} over all collectives in the module.

    ``bytes`` is the PER-DEVICE output byte volume (async ``-start`` ops
    counted once; ``-done`` twins skipped).
    """
    stats: dict = {}
    for line in hlo_text.splitlines():
        s = line.strip()
        if "-done(" in s or "-done." in s:
            continue
        m = _OP_RE.search(s)
        if not m:
            continue
        shapes, op = m.group(1), m.group(2)
        entry = stats.setdefault(op, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += _shape_bytes(shapes)
    return stats


def audit_compiled(compiled) -> dict:
    """collective_stats over a jax ``Compiled`` object's optimized HLO."""
    return collective_stats(compiled.as_text())


def link_bytes(stats: dict, n_devices: int) -> int:
    """Ring-algorithm interconnect traffic estimate per device, from output
    bytes:
    all-gather moves (n-1)/n x output; reduce-scatter's OUTPUT is 1/n of
    its input, so traffic = (n-1) x output; all-reduce = 2(n-1) x output
    (output == input)."""
    total = 0.0
    for op, v in stats.items():
        if op == "reduce-scatter":
            total += (n_devices - 1) * v["bytes"]
        elif op == "all-reduce":
            total += 2 * (n_devices - 1) * v["bytes"]
        else:  # all-gather, all-to-all, permutes: ~output-sized
            total += (n_devices - 1) / n_devices * v["bytes"]
    return int(total)


def format_stats(stats: dict, n_devices: int | None = None) -> str:
    if not stats:
        return "no collectives"
    body = ", ".join(
        f"{op} x{v['count']} ({v['bytes'] / 1e6:.2f} MB/device out)"
        for op, v in sorted(stats.items())
    )
    if n_devices:
        body += (f"; ~{link_bytes(stats, n_devices) / 1e6:.0f} MB over the "
                 "interconnect/device/frame")
    return body
