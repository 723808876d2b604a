"""Mesh-generation stage of the planar headline frame, on the card.

Times three jitted steps on bench.py's frame (capacity 4096, 1024-slot
atlas, culled 60-degree camera) from profiler traces: refinement alone,
refinement + ``generate_mesh_grid`` (the per-tile patch path the frame
runs) and refinement + ``generate_mesh`` (the per-vertex gather path).
The mesh stage is each step's time less refinement's, printed beside the
stage's memory floor: live tiles' 16 KB quads read plus the capacity's
vertex buffers written, at the card's published bandwidth.

    python tools/mesh_stage_bench.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def main() -> None:
    import jax
    import jax.numpy as jnp

    from bevy_terrain_tpu.utils.device import card_info, require_gpu

    require_gpu()
    import bench
    from bevy_terrain_tpu.ops import meshgen, refinement
    from bevy_terrain_tpu.utils.compile_cache import enable_compile_cache
    from bevy_terrain_tpu.utils.timing import device_time_ms

    enable_compile_cache()
    frame, (blocks, u), cfg = bench.build_frame()
    slab = jax.random.randint(
        jax.random.key(0), (bench.ATLAS_SLOTS, bench.TEXTURE_SIZE,
                            bench.TEXTURE_SIZE, 1), 0, 65535, jnp.int32,
    ).astype(jnp.uint16)

    @jax.jit
    def refine_only(u):
        return refinement.refine_tiles(u, cfg)

    @jax.jit
    def per_vertex(slab, u):
        tiles = refinement.refine_tiles(u, cfg)
        return tiles, meshgen.generate_mesh(
            tiles, slab, u, cfg, 508 / 512, 2 / 512
        )

    tiles = refine_only(u)
    live = int(tiles.tile_count)
    t_refine = device_time_ms(refine_only, u)
    t_grid = device_time_ms(frame, blocks, u)
    t_vertex = device_time_ms(per_vertex, slab, u)
    G1 = cfg.grid_size + 1
    F = cfg.tile_capacity
    # positions + normals (3), uvs (2), heights (1): f32 per grid vertex
    out_bytes = F * G1 * G1 * (3 + 3 + 2 + 1) * 4
    in_bytes = live * 32 * 128 * 4
    floor_us = (out_bytes + in_bytes) / HBM_BYTES_PER_S * 1e6
    print(json.dumps({
        "card": card_info(),
        "live_tiles": live,
        "capacity": F,
        "refine_ms": t_refine,
        "frame_grid_ms": t_grid,
        "frame_per_vertex_ms": t_vertex,
        "mesh_grid_ms": t_grid - t_refine,
        "mesh_per_vertex_ms": t_vertex - t_refine,
        "floor_bytes": out_bytes + in_bytes,
        "floor_us": floor_us,
    }))


if __name__ == "__main__":
    main()
