"""Deep-quadtree streaming flythrough benchmark (BASELINE.json configs[4]).

The swisstopo-style load of the reference: a deep quadtree (geometry lods
far beyond the data lods), a streaming atlas, and a camera flying from
high altitude down to near the surface across the terrain — the workload
that exercises the whole stack at once: per-frame C++ request scan,
async tile IO, residency, refinement + culling, and mesh generation,
under continuous atlas churn (reference big_space
deep-quadtree scenario; terrain_view.rs:49-63 defaults tree_size=8,
refinement_count=30, grid_size=16).

Prints one JSON object with streaming + frame statistics. Host timings
are wall-clock (they ARE host work); device time is profiler-traced on
the final settled frame (utils/timing.device_time_ms, GPU only). Runs on
whatever platform JAX picks — pass --cpu to pin the CPU (correctness and
host timings only).
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
    ap.add_argument("--cpu", action="store_true", help="pin the CPU backend")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--lod-count", type=int, default=12,
                    help="geometry quadtree depth (data lods stay at 5)")
    ap.add_argument("--adaptive", action="store_true",
                    help="enable the tile-capacity ladder "
                         "(Terrain.enable_adaptive_capacity; one compile "
                         "per rung on first use)")
    ap.add_argument("--device-time", action="store_true",
                    help="also profile the settled frame's device time "
                         "(GPU only)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from bevy_terrain_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import bevy_terrain_tpu as bt
    from bevy_terrain_tpu.models import streaming_flythrough_view
    from bevy_terrain_tpu.utils.synthetic import generate_planar_dataset

    DATA_LODS = 5
    SIZE = 40_000.0  # 40 km across, swisstopo-ish extent
    MAX_H = 2500.0

    root = tempfile.mkdtemp(prefix="flythrough_")
    att = bt.AttachmentConfig(
        name="height", texture_size=512, border_size=2, mip_level_count=4,
        format=bt.AttachmentFormat.R16,
    )
    t0 = time.perf_counter()
    generate_planar_dataset("terrains/fly", DATA_LODS, att, root=root)
    gen_s = time.perf_counter() - t0

    config = bt.TerrainConfig(
        lod_count=args.lod_count,
        model=bt.TerrainModel.planar(np.zeros(3), SIZE, 0.0, MAX_H),
        atlas_size=1024,
        path="terrains/fly",
        attachments=(att,),
        assets_root=root,
    )
    terrain = bt.Terrain(config)
    terrain.add_view("cam", streaming_flythrough_view(tile_capacity=8192),
                     queue_capacity=16384, culling=True)
    if args.adaptive:
        terrain.enable_adaptive_capacity("cam", ladder=[2048, 4096, 8192])

    # detached probe tree: times the per-frame host request scan without
    # touching the streaming terrain's residency (compute_requests mutates
    # tree state, so the live tree cannot be re-scanned out of band)
    from bevy_terrain_tpu.terrain_data.tile_tree import TileTree

    probe = TileTree(terrain.atlas, streaming_flythrough_view(tile_capacity=8192))

    # descend from 12 km altitude to 60 m while crossing half the terrain
    n = args.frames
    s = np.linspace(0.0, 1.0, n)
    path = np.stack([
        -0.35 * SIZE + 0.6 * SIZE * s,
        12_000.0 * (1.0 - s) ** 2 + 60.0,
        0.25 * SIZE - 0.4 * SIZE * s,
    ], axis=-1)

    # 60-degree forward-looking camera: near the ground a deep quadtree
    # emits far beyond tile_capacity without frustum culling — flying a
    # real culled camera IS the production workload
    from bevy_terrain_tpu.math.frustum import view_projection

    def vp(i):
        tgt = path[min(i + 1, n - 1)] + np.array([1.0, -0.2, 0.0])
        return view_projection(path[i], tgt, np.pi / 3, 16 / 9)

    host_ms, frame_ms, loads, overflows = [], [], [], []
    tiles = []
    _loaded_total = [0]

    def _count_loaded():
        # tiles whose attachment 0 finished loading this frame
        return sum(
            1 for s in terrain.atlas.state.tile_states.values()
            if s.loading_remaining == 0
        )
    t_start = time.perf_counter()
    for i in range(n):
        before = _loaded_total[0]
        f0 = time.perf_counter()
        out = terrain.update({"cam": path[i]}, {"cam": vp(i)})["cam"]
        f1 = time.perf_counter()
        # pure-host scan cost on the detached probe tree (no device work)
        h0 = time.perf_counter()
        probe.compute_requests(path[i])
        h1 = time.perf_counter()
        frame_ms.append((f1 - f0) * 1e3)
        host_ms.append((h1 - h0) * 1e3)
        _loaded_total[0] = _count_loaded()
        loads.append(max(0, _loaded_total[0] - before))
        overflows.append(int(np.asarray(out.overflow)))
        tiles.append(int(out.tile_count))
    wall_s = time.perf_counter() - t_start

    # settle the stream at the final (hardest) position
    for _ in range(200):
        terrain.update({"cam": path[-1]}, {"cam": vp(n - 1)})
        if not terrain.atlas.state.to_load and not any(
            a.loading for a in terrain.atlas.attachments
        ):
            break
        time.sleep(0.02)
    out = terrain.update({"cam": path[-1]}, {"cam": vp(n - 1)})["cam"]

    device_ms = None
    if args.device_time:
        from bevy_terrain_tpu.utils.timing import device_time_ms

        device_ms = device_time_ms(
            lambda: terrain.update({"cam": path[-1]}, {"cam": vp(n - 1)})
        )

    stats = {
        "benchmark": "deep_flythrough",
        "backend": jax.default_backend(),
        "frames": n,
        "lod_count": args.lod_count,
        "data_lods": DATA_LODS,
        "terrain_km": SIZE / 1e3,
        "dataset_gen_s": round(gen_s, 2),
        "flythrough_wall_s": round(wall_s, 2),
        "host_scan_ms_p50": round(float(np.percentile(host_ms, 50)), 3),
        "host_scan_ms_p95": round(float(np.percentile(host_ms, 95)), 3),
        # skip the first 5 frames: jit compile + cold IO dominate them
        "frame_wall_ms_p50": round(float(np.percentile(frame_ms[5:], 50)), 2),
        "frame_wall_ms_p95": round(float(np.percentile(frame_ms[5:], 95)), 2),
        "tiles_p50": int(np.percentile(tiles, 50)),
        "tiles_max": int(max(tiles)),
        "final_tile_count": int(out.tile_count),
        "tiles_loaded": int(sum(loads)),
        "loads_per_s": round(sum(loads) / wall_s, 1),
        "overflow_frames": int(sum(1 for o in overflows if o)),
        "resident_tiles": len(terrain.atlas.state.tile_states),
    }
    if args.adaptive:
        stats["adaptive"] = True
        stats["final_capacity"] = terrain._adaptive["cam"]["capacity"]
    if device_ms is not None:
        stats["settled_device_ms"] = round(device_ms, 3)
    json.dump(stats, sys.stdout)
    print()
    if not args.adaptive:  # ladder may transiently overflow after spikes
        assert stats["overflow_frames"] == 0, "tile_capacity overflowed"
    assert stats["tiles_loaded"] > 0


if __name__ == "__main__":
    main()
