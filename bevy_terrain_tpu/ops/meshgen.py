"""CDLOD-morphed terrain mesh generation — vertex.wgsl twin.

The reference pulls vertices in the vertex shader from the compacted tile
list (one indirect draw, vertices_per_tile x tile_count threads;
the reference's src/shaders/render/vertex.wgsl:30-98). Here: one batched
computation over (tile_capacity, vertices_per_tile) lanes producing the
vertex buffers as dense tensors. Lanes beyond the live tile count are
masked to zero.

Outputs use the same degenerate-strip vertex ordering as the reference
(functions.wgsl:64-71) so morphed meshes are comparable buffer-for-buffer.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bevy_terrain_tpu.ops import coords, sampling
from bevy_terrain_tpu.ops.params import FrameUniforms, StaticTerrainConfig
from bevy_terrain_tpu.ops.refinement import RefinementOutput


class GridMeshOutput(NamedTuple):
    """Fast-path frame mesh: one (G+1)x(G+1) vertex grid per tile.

    The reference's degenerate-strip vertex pulling (functions.wgsl:64-71)
    exists to avoid index buffers in its draw call; a grid + shared index
    buffer is strictly better for a consumer of these tensors.
    Use :func:`grid_to_strip_order` for buffer-level comparison against the
    reference layout.
    """

    positions: jax.Array  # (F, G+1, G+1, 3) f32 world positions
    normals: jax.Array  # (F, G+1, G+1, 3) f32 geometric normals
    uvs: jax.Array  # (F, G+1, G+1, 2) f32 morphed tile-space uv
    heights: jax.Array  # (F, G+1, G+1) f32
    tile_mask: jax.Array  # (F,) bool


class MeshOutput(NamedTuple):
    positions: jax.Array  # (F, V, 3) f32 world positions
    normals: jax.Array  # (F, V, 3) f32 world normals (geometric, pre-height)
    uvs: jax.Array  # (F, V, 2) f32 morphed tile-space uv
    heights: jax.Array  # (F, V) f32 sampled terrain height
    tile_mask: jax.Array  # (F,) bool — lanes below tile_count


def vertex_grid_uv(cfg: StaticTerrainConfig):
    """Static per-vertex grid uv table (functions.wgsl:64-71)."""
    vid = jnp.arange(cfg.vertices_per_tile, dtype=jnp.int32)
    return coords.compute_tile_uv(vid, cfg)  # (V, 2)


def grid_to_strip_order(grid_values, cfg: StaticTerrainConfig):
    """Expand (F, G+1, G+1, ...) grid tensors to the reference's
    degenerate-strip vertex order (host-side comparison utility)."""
    import numpy as np

    uv = np.asarray(vertex_grid_uv(cfg))
    ix = np.round(uv[:, 0] * cfg.grid_size).astype(int)
    iy = np.round(uv[:, 1] * cfg.grid_size).astype(int)
    vals = np.asarray(grid_values)
    return vals[:, iy, ix]


def generate_mesh_grid(
    tiles: RefinementOutput,
    block_array,
    uniforms: FrameUniforms,
    cfg: StaticTerrainConfig,
    plan,
    max_value: float,
    assume_sorted: bool = False,
    fetch_fn=None,
    n_blocks: int | None = None,
) -> tuple[GridMeshOutput, RefinementOutput]:
    """Fast-path mesh generation on the (G+1)^2 grid layout.

    Same math as :func:`generate_mesh` (vertex.wgsl:30-98) but with heights
    from the gather-free patch pipeline (see ops/patch_sampling.py) and one
    lane per unique grid vertex.

    ``fetch_fn(block_array, ids) -> (F, 64, 64) f32`` overrides the XLA
    patch fetch — the hook for sharded-atlas fetches inside shard_map
    (parallel/sharded_atlas.py), where ``block_array`` is this device's
    shard and ids are global (pass the global ``n_blocks``).

    Returns (mesh, sorted_tiles): the tile list reordered by atlas quad id
    (the order the mesh rows are in — see patch_sampling.PatchBatch; a tile
    list is a set, so any deterministic order is valid). Callers must pair
    the mesh with the returned tiles, not the input.
    """
    from bevy_terrain_tpu.ops import patch_sampling as ps

    F = cfg.tile_capacity
    G = cfg.grid_size

    tiles, batch = ps.plan_patch_batch(
        tiles, uniforms, cfg, plan,
        n_blocks if n_blocks is not None else block_array.shape[0],
        assume_sorted=assume_sorted,
    )
    t_side = tiles.tile_side[:F]
    t_lod = jnp.maximum(tiles.tile_lod[:F], 0)
    t_xy = tiles.tile_xy[:F]

    # --- patch fetch + half-grid heights ---
    # blend toward the coarser data lod by crossfading the RESAMPLE WEIGHTS
    # with their 1-2-1-smoothed form at the tile-center ratio (see
    # halfgrid_resample) — no second fetch, no smoothing passes over the
    # half-grid in device memory. blend_per_vertex instead fetches the plain
    # half-grid and value-mixes two window interpolations below (the
    # reference's per-vertex crossfade; tighter cross-lod seams).
    per_vertex = cfg.blend and cfg.blend_per_vertex
    patch = (fetch_fn or ps.fetch_patches_xla)(block_array, batch.ids[:, None])
    h_mix = ps.halfgrid_resample(
        patch, batch.geom[:, 0:2], batch.geom[:, 2], cfg,
        ratio=batch.geom[:, 4] if (cfg.blend and not per_vertex) else None,
    ) / max_value
    h_mix = ps.permute_halfgrid(h_mix * batch.geom[:, 3][:, None, None])
    if per_vertex:
        h_coarse = ps.smooth_halfgrid_permuted(h_mix)

    # --- per-vertex geometry on the grid layout (vertex.wgsl:30-71),
    # computed on a flat (F, (G+1)^2) layout ---
    NV = (G + 1) * (G + 1)
    g = jnp.arange(G + 1, dtype=jnp.float32) / G
    guv = jnp.stack(jnp.meshgrid(g, g, indexing="xy"), axis=-1)  # (G+1, G+1, 2)
    tile_uv = jnp.broadcast_to(guv.reshape(1, NV, 2), (F, NV, 2))
    side = jnp.broadcast_to(t_side[:, None], (F, NV))
    lod_b = jnp.broadcast_to(t_lod[:, None], (F, NV))
    xy = jnp.broadcast_to(t_xy[:, None, :], (F, NV, 2))

    if cfg.spherical or cfg.high_precision:
        local = coords.compute_local_position(side, lod_b, xy, tile_uv, cfg.spherical)
        world = coords.position_local_to_world(local, uniforms.world_from_local)
        normal = coords.normal_local_to_world(
            local, uniforms.normal_matrix, cfg.spherical
        )
        view_distance = jnp.linalg.norm(
            world
            + uniforms.approximate_height * normal
            - uniforms.view_world_position,
            axis=-1,
        )
    else:
        # planar: componentwise distance avoids materializing the stacked
        # (F, NV, 3) world/normal chains (only the distance is consumed;
        # approximate_view_distance takes the same route for refinement
        # and the per-tile lookup)
        view_distance = coords.planar_view_distance(lod_b, xy, tile_uv, uniforms)
    if cfg.high_precision:
        relative = coords.compute_relative_position(
            side, lod_b, xy, tile_uv, uniforms.taylor, cfg.origin_lod,
            cfg.side_count,
        )
        hp_distance = jnp.linalg.norm(
            relative + uniforms.approximate_height * normal, axis=-1
        )
        high_precision = view_distance < uniforms.precision_threshold_distance
        view_distance = jnp.where(high_precision, hp_distance, view_distance)

    morphed_uv = coords.compute_morph(lod_b, tile_uv, view_distance, uniforms, cfg)

    morph_local = coords.compute_local_position(side, lod_b, xy, morphed_uv, cfg.spherical)
    morph_world = coords.position_local_to_world(morph_local, uniforms.world_from_local)
    morph_normal = coords.normal_local_to_world(
        morph_local, uniforms.normal_matrix, cfg.spherical
    )
    if cfg.high_precision:
        hp_relative = coords.compute_relative_position(
            side, lod_b, xy, morphed_uv, uniforms.taylor, cfg.origin_lod,
            cfg.side_count,
        )
        hp_world = uniforms.view_world_position + hp_relative
        morph_world = jnp.where(high_precision[..., None], hp_world, morph_world)
        morph_normal = jnp.where(high_precision[..., None], normal, morph_normal)

    # --- heights: interpolate the (already blend-crossfaded) half-grid
    # once at the morphed uv. The crossfade ratio varies by <= ~0.2 within
    # one tile (the blend zone is many tiles wide), so the per-tile-center
    # ratio used above quantizes the fade invisibly; blend_per_vertex
    # mixes fine and smoothed interpolations by the per-vertex ratio
    # instead (fragment.wgsl-style crossfade) ---
    morphed_grid = morphed_uv.reshape(F, G + 1, G + 1, 2)
    h_norm = ps.vertex_values_from_halfgrid(h_mix, morphed_grid, cfg).reshape(F, NV)
    if per_vertex:
        _, v_ratio = coords.compute_blend(view_distance, uniforms, cfg)
        h_coarse_v = ps.vertex_values_from_halfgrid(
            h_coarse, morphed_grid, cfg
        ).reshape(F, NV)
        h_norm = h_norm + (h_coarse_v - h_norm) * v_ratio
    height = uniforms.min_height + (uniforms.max_height - uniforms.min_height) * h_norm

    positions = morph_world + height[..., None] * morph_normal

    tile_mask = jnp.arange(F, dtype=jnp.int32) < tiles.tile_count
    mask = tile_mask[:, None]

    def grid(x, ch=None):
        shape = (F, G + 1, G + 1) + ((ch,) if ch else ())
        return x.reshape(shape)

    mesh = GridMeshOutput(
        positions=grid(jnp.where(mask[..., None], positions, 0.0), 3),
        normals=grid(jnp.where(mask[..., None], morph_normal, 0.0), 3),
        uvs=grid(jnp.where(mask[..., None], morphed_uv, 0.0), 2),
        heights=grid(jnp.where(mask, height, 0.0)),
        tile_mask=tile_mask,
    )
    return mesh, tiles


def generate_mesh(
    tiles: RefinementOutput,
    height_slab,
    uniforms: FrameUniforms,
    cfg: StaticTerrainConfig,
    attachment_scale: float,
    attachment_offset: float,
) -> MeshOutput:
    """Per-(tile, vertex) morphed world position + height (vertex.wgsl:30-98).

    ``height_slab`` is attachment 0's mip-0 slab (A, H, W, 1) uint16.
    """
    F = cfg.tile_capacity
    V = cfg.vertices_per_tile

    # refinement buffers carry Q lanes of append slack beyond tile_capacity
    side = tiles.tile_side[:F, None]  # (F, 1)
    lod = tiles.tile_lod[:F, None]
    xy = tiles.tile_xy[:F, None, :]  # (F, 1, 2)
    side = jnp.broadcast_to(side, (F, V))
    lod_b = jnp.broadcast_to(jnp.maximum(lod, 0), (F, V))
    xy = jnp.broadcast_to(xy, (F, V, 2))
    tile_uv = jnp.broadcast_to(vertex_grid_uv(cfg)[None], (F, V, 2))

    # --- approximate view distance (vertex.wgsl:34-38) ---
    local = coords.compute_local_position(side, lod_b, xy, tile_uv, cfg.spherical)
    world = coords.position_local_to_world(local, uniforms.world_from_local)
    normal = coords.normal_local_to_world(local, uniforms.normal_matrix, cfg.spherical)
    view_distance = jnp.linalg.norm(
        world + uniforms.approximate_height * normal - uniforms.view_world_position,
        axis=-1,
    )

    if cfg.high_precision:
        # vertex.wgsl:40-55: refine the distance with the Taylor relative
        # position below the precision threshold
        relative = coords.compute_relative_position(
            side, lod_b, xy, tile_uv, uniforms.taylor, cfg.origin_lod,
            cfg.side_count,
        )
        hp_distance = jnp.linalg.norm(
            relative + uniforms.approximate_height * normal, axis=-1
        )
        high_precision = view_distance < uniforms.precision_threshold_distance
        view_distance = jnp.where(high_precision, hp_distance, view_distance)

    # --- morph (vertex.wgsl:52-57, functions.wgsl:35-49) ---
    morphed_uv = coords.compute_morph(lod_b, tile_uv, view_distance, uniforms, cfg)

    morph_local = coords.compute_local_position(side, lod_b, xy, morphed_uv, cfg.spherical)
    morph_world = coords.position_local_to_world(morph_local, uniforms.world_from_local)
    morph_normal = coords.normal_local_to_world(
        morph_local, uniforms.normal_matrix, cfg.spherical
    )

    if cfg.high_precision:
        hp_relative = coords.compute_relative_position(
            side, lod_b, xy, morphed_uv, uniforms.taylor, cfg.origin_lod,
            cfg.side_count,
        )
        hp_world = uniforms.view_world_position + hp_relative
        morph_world = jnp.where(high_precision[..., None], hp_world, morph_world)
        morph_normal = jnp.where(high_precision[..., None], normal, morph_normal)

    # --- height sample with blend between two atlas lods (vertex.wgsl:85-98) ---
    blend_lod, blend_ratio = coords.compute_blend(view_distance, uniforms, cfg)

    a_idx, a_lod, a_xy, a_uv = coords.lookup_tile(
        uniforms.entries, side, lod_b, xy, morphed_uv, blend_lod, cfg, lod_offset=0
    )
    height = sampling.sample_height(
        height_slab, a_idx, a_uv, uniforms, attachment_scale, attachment_offset
    )
    if cfg.blend:
        a_idx2, a_lod2, a_xy2, a_uv2 = coords.lookup_tile(
            uniforms.entries, side, lod_b, xy, morphed_uv, blend_lod, cfg, lod_offset=1
        )
        height2 = sampling.sample_height(
            height_slab, a_idx2, a_uv2, uniforms, attachment_scale, attachment_offset
        )
        height = jnp.where(
            blend_ratio > 0.0, height + (height2 - height) * blend_ratio, height
        )

    positions = morph_world + height[..., None] * morph_normal

    tile_mask = jnp.arange(F, dtype=jnp.int32) < tiles.tile_count
    mask3 = tile_mask[:, None, None]
    return MeshOutput(
        positions=jnp.where(mask3, positions, 0.0),
        normals=jnp.where(mask3, morph_normal, 0.0),
        uvs=jnp.where(mask3, morphed_uv, 0.0),
        heights=jnp.where(tile_mask[:, None], height, 0.0),
        tile_mask=tile_mask,
    )
