"""Timing harness: device time from profiler traces, host phase timers.

The reference has no instrumentation beyond println (SURVEY.md section 5);
the north-star metric here is microseconds/frame, so measurement is
first-class:

* :func:`device_time_ms` — device-side execution time of a call, read from
  a ``jax.profiler`` trace. On the GPU, XLA records every kernel and copy
  it runs on the device plane (``/device:GPU:N``, one line per stream);
  the busy time is the union of those intervals, so host dispatch and
  idle gaps do not count. It raises when the trace holds no device events
  (a CPU-only backend, a broken profiler); it never substitutes a wall
  clock.
* :class:`Timer` — accumulating host-side section timer.
"""

from __future__ import annotations

import glob
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import jax
import numpy as np


def device_events(xplane_path: str) -> list[tuple[str, float, float]]:
    """(name, start_ns, end_ns) of every event on the trace's device planes.

    Raises RuntimeError (listing what the trace does hold) when there are
    none."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    events, seen = [], []
    for plane in data.planes:
        seen.append(f"{plane.name}: {[ln.name for ln in plane.lines][:8]}")
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                if ev.duration_ns > 0:
                    events.append(
                        (ev.name, ev.start_ns, ev.start_ns + ev.duration_ns)
                    )
    if not events:
        raise RuntimeError(
            "no device events in the trace; planes: " + "; ".join(seen)
        )
    return events


def busy_ns(events) -> float:
    """Length of the union of the events' [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def kernel_totals_ms(events) -> dict[str, float]:
    """Summed device time (ms) per event name, largest first."""
    tot = defaultdict(float)
    for name, s, e in events:
        tot[name] += (e - s) / 1e6
    return dict(sorted(tot.items(), key=lambda kv: -kv[1]))


def trace_device_events(fn, *args, runs: int = 5):
    """Run ``fn(*args)`` once to compile and warm, then ``runs`` times
    under the profiler, each to completion. Returns the device events."""
    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory(prefix="bt_trace_") as d:
        with jax.profiler.trace(d):
            for _ in range(runs):
                jax.block_until_ready(fn(*args))
        files = sorted(glob.glob(d + "/**/*.xplane.pb", recursive=True))
        if not files:
            raise RuntimeError("the profiler wrote no trace")
        return device_events(files[-1])


def device_time_ms(fn, *args, runs: int = 5) -> float:
    """Mean device busy time (ms) of one ``fn(*args)`` call over ``runs``
    profiled calls: every kernel and copy the call puts on the device,
    overlaps counted once. Nothing else may use the device meanwhile."""
    return busy_ns(trace_device_events(fn, *args, runs=runs)) / runs / 1e6


@dataclass
class Timer:
    """Accumulating section timer for host-side frame phases."""

    sections: dict = field(default_factory=dict)

    def measure(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                timer.sections.setdefault(name, []).append(
                    time.perf_counter() - self.t0
                )

        return _Ctx()

    def summary(self) -> dict[str, float]:
        return {k: float(np.median(v) * 1e3) for k, v in self.sections.items()}
