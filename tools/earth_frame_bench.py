"""Earth flagship frame benchmark — the spherical counterpart of bench.py.

Streams the cube-sphere Earth of chip_smoke.py's earth phase (radius
6.371e6 m, geometry lods to 13 over 3 data lods, Taylor high-precision
path) at 60 km altitude under a 60-degree frustum camera and reports the
settled frame's device time from a profiler trace. ``--ops`` also prints
the frame's largest device kernels.

Prints one JSON object. Needs a GPU.

    python tools/earth_frame_bench.py [--altitude-km 60] [--ops]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--altitude-km", type=float, default=60.0)
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--headroom", type=float, default=1.3,
                    help="adaptive-ladder headroom over the last tile count "
                         "(static camera: tight is safe; flythroughs want 2.0)")
    ap.add_argument("--ops", action="store_true",
                    help="print the settled frame's top device kernels")
    args = ap.parse_args()

    from bevy_terrain_tpu.utils.device import card_info, require_gpu

    require_gpu()
    import chip_smoke
    from bevy_terrain_tpu.math.frustum import view_projection
    from bevy_terrain_tpu.utils.compile_cache import enable_compile_cache
    from bevy_terrain_tpu.utils.timing import (
        busy_ns, kernel_totals_ms, trace_device_events,
    )

    enable_compile_cache()
    s = chip_smoke.FULL
    terrain, radius = chip_smoke.earth_terrain(
        Path(tempfile.mkdtemp(prefix="earth_bench_")), s, seed=0
    )
    if args.adaptive:
        terrain.enable_adaptive_capacity(
            "cam", ladder=[1024, 2048, 4096], headroom=args.headroom
        )
    view = np.array([0.0, 0.0, radius + args.altitude_km * 1e3])
    vp = view_projection(view, view * 0.5, np.pi / 3, 16 / 9)

    def update():
        return terrain.update({"cam": view}, {"cam": vp})["cam"]

    for i in range(200):
        out = update()
        if i > 3 and chip_smoke.resident(terrain.atlas):
            break
        time.sleep(0.01)
    out = update()
    runs = 5
    events = trace_device_events(update, runs=runs)
    stats = {
        "benchmark": "earth_frame",
        "card": card_info(),
        "altitude_km": args.altitude_km,
        "lod_count": s["earth_lods"],
        "tiles": out.tile_count,
        "capacity": s["earth_capacity"],
        "overflow": out.overflow,
        "device_ms": busy_ns(events) / runs / 1e6,
    }
    if args.adaptive:
        stats["adaptive_capacity"] = terrain._adaptive["cam"]["capacity"]
    json.dump(stats, sys.stdout)
    print()
    if args.ops:
        for name, ms in list(kernel_totals_ms(events).items())[:30]:
            print(f"{ms / runs:9.4f} ms  {name[:100]}")
    assert out.overflow == 0 or args.adaptive
    assert out.tile_count > 100


if __name__ == "__main__":
    main()
