"""Rasterizer timing on bench.py's 8k^2 scene, on the card.

Rows (profiler-traced device time):
  raster_only   rasterize_grid at the given resolution (binning + sort +
                scan + resolve) on the frame's mesh
  render_pixel  full render_view: skirts + raster + perspective-correct
                interpolation + per-pixel PBR
  render_debug  a debug view (vertex colors interpolated per pixel)

The camera is the frame's eye pitched 45 degrees down (see
chip_smoke.phase_raster: the forward view's horizon band overflows any
sensible per-bin candidate budget). The raster path is the CAPTURE path
(MIGRATING.md capability delta), not part of the per-vertex frame.

Usage: python tools/raster_bench.py [--size 1024]
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    import jax

    from bevy_terrain_tpu.utils.device import card_info, require_gpu

    require_gpu()
    size = 1024
    if "--size" in sys.argv:
        size = int(sys.argv[sys.argv.index("--size") + 1])
    import jax.numpy as jnp

    import bench
    from bevy_terrain_tpu.math import frustum
    from bevy_terrain_tpu.render.material import StandardMaterial
    from bevy_terrain_tpu.render.raster import rasterize_grid, render_view
    from bevy_terrain_tpu.utils.compile_cache import enable_compile_cache
    from bevy_terrain_tpu.utils.timing import device_time_ms

    enable_compile_cache()
    frame, (blocks, u1), cfg = bench.build_frame()
    tiles, mesh = jax.block_until_ready(frame(blocks, u1))
    print(f"{card_info()}\nscene: {int(tiles.tile_count)} tiles, "
          f"image {size}x{size}")
    view, _ = bench.bench_camera()
    vp = frustum.view_projection(
        view, view + np.array([700.0, -700.0, 210.0]), np.pi / 3, 1.0
    )
    vp32 = jnp.asarray(vp, jnp.float32)
    knobs = dict(bin_px=32, bin_cap=2048)
    raster = jax.jit(lambda pos, mask, m: rasterize_grid(
        pos, mask, m, size, size, **knobs))
    r = raster(mesh.positions, mesh.tile_mask, vp32)
    print(f"coverage {float(np.asarray(r.covered).mean()):.2f}, "
          f"bin_overflow {int(r.bin_overflow)}, near_culled {int(r.near_culled)}")
    ms = device_time_ms(raster, mesh.positions, mesh.tile_mask, vp32)
    print(f"raster_only      {ms * 1000:8.1f} us")

    material = StandardMaterial(metallic=0.05, perceptual_roughness=0.9)
    pixel = jax.jit(lambda mesh, tiles, u, m: render_view(
        mesh, tiles, u, cfg, m, size, size, material=material,
        shade_mode="pixel", **knobs)[0])
    ms = device_time_ms(pixel, mesh, tiles, u1, vp32)
    print(f"render_pixel     {ms * 1000:8.1f} us")
    dbg = jax.jit(lambda mesh, tiles, u, m: render_view(
        mesh, tiles, u, cfg, m, size, size, debug_view="geometry_lod",
        **knobs)[0])
    ms = device_time_ms(dbg, mesh, tiles, u1, vp32)
    print(f"render_debug     {ms * 1000:8.1f} us")


if __name__ == "__main__":
    main()
