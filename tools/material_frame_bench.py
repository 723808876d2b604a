"""Material frame stages on bench.py's 8k^2 planar scene, on the card.

One jit per row, each a superset of the previous: the mesh frame
(refinement -> generate_mesh_grid), + the packed Rgba8 albedo sampled at
the morphed vertex uvs (one patch gather serves four channels), + PBR
shading (StandardMaterial over the sampled albedo). A side row times the
4-tap anisotropic (SAMPLE_GRAD) albedo option. Device times come from
profiler traces.

Usage: python tools/material_frame_bench.py
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
    import jax.numpy as jnp

    import bench
    from bevy_terrain_tpu.ops import meshgen, refinement
    from bevy_terrain_tpu.ops.patch_sampling import (
        make_patch_plan, sample_attachment_vertices,
        sample_attachment_vertices_grad,
    )
    from bevy_terrain_tpu.render.material import (
        StandardMaterial, albedo_material, shade,
    )
    from bevy_terrain_tpu.utils.compile_cache import enable_compile_cache
    from bevy_terrain_tpu.utils.timing import device_time_ms

    enable_compile_cache()
    _, (blocks, u), cfg = bench.build_frame()
    plan = make_patch_plan(bench.TEXTURE_SIZE, bench.MIPS, bench.BORDER)
    rng = np.random.default_rng(7)
    packed = jnp.asarray(
        rng.integers(0, 2**32, blocks.shape, dtype=np.uint64)
        .astype(np.uint32).view(np.int32)
    )
    material = StandardMaterial(base_color=albedo_material(1))

    def mesh_of(block_array, u):
        tiles = refinement.refine_tiles(u, cfg)
        mesh, tiles = meshgen.generate_mesh_grid(
            tiles, block_array, u, cfg, plan, 65535.0)
        return tiles, mesh

    def rgba_of(tiles, mesh, ap, u):
        return sample_attachment_vertices(
            [ap], tiles, mesh.uvs, u, cfg, plan, 255.0,
            packed_channels=4, packed_bits=8)

    @jax.jit
    def mesh_only(b, u):
        return mesh_of(b, u)

    @jax.jit
    def with_albedo(b, ap, u):
        tiles, mesh = mesh_of(b, u)
        return tiles, rgba_of(tiles, mesh, ap, u)

    @jax.jit
    def with_grad(b, ap, u):
        tiles, mesh = mesh_of(b, u)
        return tiles, sample_attachment_vertices_grad(
            [ap], tiles, mesh.uvs, mesh, u, cfg, plan, 255.0, taps=4,
            packed_channels=4, packed_bits=8)

    @jax.jit
    def full(b, ap, u):
        tiles, mesh = mesh_of(b, u)
        return tiles, shade(mesh, tiles, u, cfg, material=material,
                            lighting=True,
                            attachment_samples={1: rgba_of(tiles, mesh, ap, u)})

    tiles, _ = jax.block_until_ready(mesh_only(blocks, u))
    t_mesh = device_time_ms(mesh_only, blocks, u)
    t_rgba = device_time_ms(with_albedo, blocks, packed, u)
    t_grad = device_time_ms(with_grad, blocks, packed, u)
    t_full = device_time_ms(full, blocks, packed, u)
    print(
        f"{card_info()}\n"
        f"mesh frame:           {t_mesh * 1e3:8.1f} us ({int(tiles.tile_count)} tiles)\n"
        f"+ packed RGBA sample: {t_rgba * 1e3:8.1f} us (+{(t_rgba - t_mesh) * 1e3:.1f})\n"
        f"  [4-tap grad RGBA:   {t_grad * 1e3:8.1f} us (+{(t_grad - t_mesh) * 1e3:.1f})]\n"
        f"+ PBR shade = full:   {t_full * 1e3:8.1f} us (+{(t_full - t_rgba) * 1e3:.1f})"
    )


if __name__ == "__main__":
    main()
