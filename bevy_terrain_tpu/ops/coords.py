"""Shared device coordinate math — the functions.wgsl twin.

Every helper here mirrors a function in /root/reference/src/shaders/functions.wgsl
(cited per function) and operates on arbitrarily batched jnp arrays in f32 /
int32. Coordinates are carried unpacked as (side, lod, xy, uv) arrays:

* ``side`` int32 (...,)      cube face 0-5
* ``lod``  int32 (...,)      quadtree depth, 0 = coarsest
* ``xy``   int32 (..., 2)    tile index at that lod
* ``uv``   f32  (..., 2)     position within the tile, [0, 1]

Operation order matches the WGSL so that f32 results are bit-comparable
(SURVEY.md section 4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bevy_terrain_tpu.math.coordinate import C_SQR, SIDE_LOCAL_MATRICES
from bevy_terrain_tpu.ops.params import FrameUniforms, StaticTerrainConfig, TaylorParams

# module-level tables stay numpy (host) arrays: they embed as plain HLO
# literals, and importing this module allocates nothing on a device
_SIDE_MATS = np.asarray(SIDE_LOCAL_MATRICES, np.float32)  # (6, 3, 3)


def tile_count(lod):
    """f32 tiles-per-axis (functions.wgsl:156)."""
    return jnp.exp2(lod.astype(jnp.float32) if hasattr(lod, "astype") else float(lod))


def inverse_mix(a, b, value):
    """saturate((value - a) / (b - a)) (functions.wgsl:31-33)."""
    return jnp.clip((value - a) / (b - a), 0.0, 1.0)


def compute_local_position(side, lod, xy, uv, spherical: bool):
    """Coordinate -> unit local position (functions.wgsl:73-96).

    Returns (..., 3) f32. Uses the same f32 math as the shader: the absolute
    f32 error at deep lods is identical to the reference's GPU path; the
    Taylor relative path provides precision near the view.
    """
    uv01 = (xy.astype(jnp.float32) + uv) / tile_count(lod)[..., None]
    if not spherical:
        return jnp.stack(
            [uv01[..., 0] - 0.5, jnp.zeros_like(uv01[..., 0]), uv01[..., 1] - 0.5],
            axis=-1,
        )
    w = (uv01 - 0.5) / 0.5
    p = w / jnp.sqrt(1.0 + C_SQR - C_SQR * w * w)
    mats = take_side_rows(jnp.asarray(_SIDE_MATS), side)  # (..., 3, 3)
    homo = jnp.stack([p[..., 0], p[..., 1], jnp.ones_like(p[..., 0])], axis=-1)
    cube = jnp.sum(mats * homo[..., None, :], axis=-1)
    return cube / jnp.linalg.norm(cube, axis=-1, keepdims=True)


def take_side_rows(table, side, side_count: int = 6):
    """Row-select a tiny per-side table without a per-lane gather.

    A planar terrain has one side — broadcast row 0; a sphere has six —
    a branchless where-chain fuses into the surrounding elementwise code.
    """
    tail = tuple(table.shape[1:])
    if side_count == 1:
        return jnp.broadcast_to(table[0], jnp.shape(side) + tail)
    out = jnp.broadcast_to(table[0], jnp.shape(side) + tail)
    mask_shape = jnp.shape(side) + (1,) * len(tail)
    for k in range(1, side_count):
        out = jnp.where((side == k).reshape(mask_shape), table[k], out)
    return out


def _apply_mat3(m, v):
    """Elementwise 3x3 matrix-vector product for batched 3-vectors.

    Deliberately NOT a dot_general: a size-3 contraction gains nothing
    from a matrix unit, and elementwise f32 math is exact (a
    default-precision dot may run in TF32 on the GPU).
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack(
        [
            m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
            m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
            m[2, 0] * x + m[2, 1] * y + m[2, 2] * z,
        ],
        axis=-1,
    )


def position_local_to_world(local_position, world_from_local):
    """Affine transform (functions.wgsl:26-29). ``world_from_local`` is (3,4) f32."""
    return _apply_mat3(world_from_local, local_position) + world_from_local[:, 3]


def normal_local_to_world(local_position, normal_matrix, spherical: bool):
    """Surface normal (functions.wgsl:14-24): local normal is the local
    position for spheres, +Y for planes, mapped by the inverse-transpose."""
    if spherical:
        n = _apply_mat3(normal_matrix, local_position)
    else:
        # constant +Y normal: the transform reduces to the matrix column
        n = jnp.broadcast_to(normal_matrix[:, 1], local_position.shape)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


def coordinate_change_lod(lod, xy, uv, new_lod):
    """Re-anchor (xy, uv) at a different lod (functions.wgsl:164-188).

    ``new_lod`` broadcasts against ``lod``. Returns (new_lod, xy', uv').
    Branchless: both directions are computed and selected; diff == 0 keeps
    the inputs bit-identical (the WGSL early-returns).
    """
    lod = jnp.asarray(lod, jnp.int32)
    new_lod = jnp.broadcast_to(jnp.asarray(new_lod, jnp.int32), lod.shape)
    diff = new_lod - lod
    pos_shift = jnp.maximum(diff, 0)
    neg_shift = jnp.maximum(-diff, 0)
    delta_size = jnp.exp2(diff.astype(jnp.float32))[..., None]

    # lod increases: xy = xy * 2^d + floor(uv * 2^d); uv = frac(uv * 2^d)
    scaled_uv = uv * delta_size
    floor_uv = jnp.floor(scaled_uv)
    up_xy = (xy << pos_shift[..., None]) + floor_uv.astype(jnp.int32)
    up_uv = scaled_uv - floor_uv

    # lod decreases: xy' = xy >> d; uv = ((xy & (2^d - 1)) + uv) * 2^-d
    mask = (jnp.int32(1) << neg_shift[..., None]) - 1
    down_xy = xy >> neg_shift[..., None]
    down_uv = ((xy & mask).astype(jnp.float32) + uv) * delta_size

    same = (diff == 0)[..., None]
    up = (diff > 0)[..., None]
    out_xy = jnp.where(same, xy, jnp.where(up, up_xy, down_xy))
    out_uv = jnp.where(same, uv, jnp.where(up, up_uv, down_uv))
    return new_lod, out_xy, out_uv


def compute_relative_position(
    side, lod, xy, uv, taylor: TaylorParams, origin_lod: int, side_count: int = 6
):
    """Taylor-series view-relative position (functions.wgsl:98-115).

    Returns (..., 3) f32 positions relative to the view world position.
    """
    _, oxy, ouv = coordinate_change_lod(lod, xy, uv, origin_lod)
    origin_xy = take_side_rows(taylor.origin_xy, side, side_count)  # (..., 2)
    origin_uv = take_side_rows(taylor.origin_uv, side, side_count)
    origin_count = tile_count(jnp.int32(origin_lod))
    rel_st = ((oxy - origin_xy).astype(jnp.float32) + (ouv - origin_uv)) / origin_count
    s = rel_st[..., 0:1]
    t = rel_st[..., 1:2]
    row = lambda tbl: take_side_rows(tbl, side, side_count)
    return (
        row(taylor.c)
        + row(taylor.c_s) * s
        + row(taylor.c_t) * t
        + row(taylor.c_ss) * s * s
        + row(taylor.c_st) * s * t
        + row(taylor.c_tt) * t * t
    )


def approximate_view_distance(
    side,
    lod,
    xy,
    uv,
    uniforms: FrameUniforms,
    cfg: StaticTerrainConfig,
):
    """View distance of a coordinate at the approximate terrain height
    (functions.wgsl:117-131), with the HIGH_PRECISION Taylor fallback
    below ``precision_threshold_distance``."""
    if not cfg.spherical and not cfg.high_precision:
        # componentwise: the stacked (..., 3) world/normal chains otherwise
        # make XLA materialize three component buffers per call site
        return planar_view_distance(lod, xy, uv, uniforms)
    local = compute_local_position(side, lod, xy, uv, cfg.spherical)
    world = position_local_to_world(local, uniforms.world_from_local)
    normal = normal_local_to_world(local, uniforms.normal_matrix, cfg.spherical)
    sample = world + uniforms.approximate_height * normal
    view_distance = jnp.linalg.norm(sample - uniforms.view_world_position, axis=-1)

    if cfg.high_precision:
        relative = compute_relative_position(
            side, lod, xy, uv, uniforms.taylor, cfg.origin_lod, cfg.side_count
        )
        hp_distance = jnp.linalg.norm(
            relative + uniforms.approximate_height * normal, axis=-1
        )
        view_distance = jnp.where(
            view_distance < uniforms.precision_threshold_distance,
            hp_distance,
            view_distance,
        )
    return view_distance


def planar_view_distance(lod, xy, uv, uniforms: FrameUniforms):
    """View distance for planar terrains, componentwise.

    Same math as compute_local_position -> position_local_to_world ->
    norm, but never stacks the intermediate (..., 3) vectors — the stack
    boundaries otherwise make XLA materialize three component buffers per
    chain. The constant
    +Y normal folds into one precomputed base offset."""
    uv01 = (xy.astype(jnp.float32) + uv) / tile_count(lod)[..., None]
    lx = uv01[..., 0] - 0.5
    lz = uv01[..., 1] - 0.5
    m = uniforms.world_from_local  # (3, 4)
    n = uniforms.normal_matrix[:, 1]
    n = n / jnp.linalg.norm(n)
    base = (
        m[:, 3]
        + uniforms.approximate_height * n
        - uniforms.view_world_position
    )  # (3,)
    dx = m[0, 0] * lx + m[0, 2] * lz + base[0]
    dy = m[1, 0] * lx + m[1, 2] * lz + base[1]
    dz = m[2, 0] * lx + m[2, 2] * lz + base[2]
    return jnp.sqrt(dx * dx + dy * dy + dz * dz)


def compute_subdivision_coordinate(
    side, lod, xy, taylor: TaylorParams, origin_lod: int, side_count: int = 6
):
    """Closest point of a tile to the view, in uv space
    (functions.wgsl:133-154). Input coordinates have uv = 0; returns uv."""
    view_xy = take_side_rows(taylor.origin_xy, side, side_count)
    view_uv = take_side_rows(taylor.origin_uv, side, side_count)
    vlod, vxy, vuv = coordinate_change_lod(
        jnp.broadcast_to(jnp.int32(origin_lod), jnp.asarray(lod).shape),
        view_xy,
        view_uv,
        lod,
    )
    offset = vxy - xy
    uv = jnp.where(offset < 0, 0.0, jnp.where(offset > 0, 1.0, vuv))
    return uv


def compute_morph(lod, uv, view_distance, uniforms: FrameUniforms, cfg: StaticTerrainConfig):
    """CDLOD vertex morph toward the even-grid uv (functions.wgsl:35-49)."""
    if not cfg.morph:
        return uv
    grid_size = jnp.float32(cfg.grid_size)
    even_uv = (
        ((uv * grid_size).astype(jnp.int32) & ~jnp.int32(1)).astype(jnp.float32)
        / grid_size
    )
    target_lod = jnp.log2(2.0 * uniforms.morph_distance / view_distance)
    lod_f = lod.astype(jnp.float32)
    ratio = jnp.where(
        lod == 0,
        0.0,
        inverse_mix(lod_f + uniforms.morph_range, lod_f, target_lod),
    )[..., None]
    return uv + (even_uv - uv) * ratio  # mix(uv, even_uv, ratio)


def compute_blend(view_distance, uniforms: FrameUniforms, cfg: StaticTerrainConfig):
    """Blend lod + ratio from view distance (functions.wgsl:51-62).

    Returns (lod int32, ratio f32)."""
    target_lod = jnp.minimum(
        jnp.log2(uniforms.blend_distance / view_distance),
        jnp.float32(cfg.lod_count) - 0.00001,
    )
    # Rust `as u32` saturates negatives to 0 (tile_tree.rs:227-228)
    lod = jnp.maximum(target_lod, 0.0).astype(jnp.int32)
    if cfg.blend:
        lod_f = lod.astype(jnp.float32)
        ratio = jnp.where(
            lod == 0,
            0.0,
            inverse_mix(lod_f + uniforms.blend_range, lod_f, target_lod),
        )
    else:
        ratio = jnp.zeros_like(target_lod)
    return lod, ratio


def compute_tile_uv(vertex_index, cfg: StaticTerrainConfig):
    """Degenerate-triangle-strip grid uv per vertex (functions.wgsl:64-71).

    ``vertex_index`` int32 (...,) -> uv (..., 2) f32.
    """
    vpr = jnp.int32(cfg.vertices_per_row)
    grid_index = vertex_index % jnp.int32(cfg.vertices_per_tile)
    row_index = jnp.clip(grid_index % vpr, 1, vpr - 2) - 1
    column_index = grid_index // vpr
    u = (column_index + (row_index & 1)).astype(jnp.float32)
    v = (row_index >> 1).astype(jnp.float32)
    return jnp.stack([u, v], axis=-1) / jnp.float32(cfg.grid_size)


def lookup_tile_tree_entry(entries, side, lod, xy, cfg: StaticTerrainConfig):
    """Wrapping-modulo tile tree entry gather (functions.wgsl:198-206).

    ``entries`` is (sides, lods, tree, tree, 2) int32; returns
    (atlas_index, atlas_lod) int32 arrays.
    """
    tree_xy = xy % jnp.int32(cfg.tree_size)
    lod_c = jnp.clip(lod, 0, cfg.lod_count - 1)
    entry = entries[side, lod_c, tree_xy[..., 0], tree_xy[..., 1]]
    return entry[..., 0], entry[..., 1]


def lookup_tile(entries, side, lod, xy, uv, blend_lod, cfg: StaticTerrainConfig, lod_offset=0):
    """Find the best-loaded atlas tile for a coordinate at the blend lod
    (functions.wgsl:232-246, the non-TILE_TREE_LOD path).

    Returns (atlas_index i32, atlas_lod i32, atlas_xy i32, atlas_uv f32);
    atlas_index is -1 when nothing is loaded.
    """
    target = jnp.maximum(blend_lod - lod_offset, 0)
    t_lod, t_xy, t_uv = coordinate_change_lod(lod, xy, uv, target)
    atlas_index, atlas_lod = lookup_tile_tree_entry(entries, side, t_lod, t_xy, cfg)
    # invalid entries carry atlas_lod == -1; clamp the lod-change to stay
    # in-range, the caller masks on atlas_index < 0
    safe_lod = jnp.where(atlas_lod < 0, t_lod, atlas_lod)
    a_lod, a_xy, a_uv = coordinate_change_lod(t_lod, t_xy, t_uv, safe_lod)
    return atlas_index, a_lod, a_xy, a_uv


def compute_tile_tree_uv(origins, side, lod, xy, uv, cfg: StaticTerrainConfig):
    """Position of a coordinate within the wrapping tree window
    (functions.wgsl:190-195). Used by lookup_best."""
    origin_xy = origins[side, lod]  # (..., 2)
    tree_size = jnp.minimum(jnp.float32(cfg.tree_size), tile_count(lod))[..., None]
    return ((xy - origin_xy).astype(jnp.float32) + uv) / tree_size


def lookup_best(entries, origins, side, lod, xy, uv, cfg: StaticTerrainConfig):
    """Walk down lods while the coordinate stays inside the tree window, then
    take that entry (functions.wgsl:209-230). Fixed-trip-count scan version
    of the WGSL while-loop.

    Returns (atlas_index, atlas_lod, atlas_xy, atlas_uv).
    """
    best_lod = jnp.zeros_like(lod)
    for cand in range(1, cfg.lod_count):
        c_lod, c_xy, c_uv = coordinate_change_lod(lod, xy, uv, cand)
        tuv = compute_tile_tree_uv(origins, side, c_lod, c_xy, c_uv, cfg)
        inside = jnp.all((tuv > 0.0) & (tuv < 1.0), axis=-1)
        # the WGSL keeps ascending while inside; once outside it stops
        keep = inside & (best_lod == cand - 1)
        best_lod = jnp.where(keep, cand, best_lod)
    b_lod, b_xy, b_uv = coordinate_change_lod(lod, xy, uv, best_lod)
    atlas_index, atlas_lod = lookup_tile_tree_entry(entries, side, b_lod, b_xy, cfg)
    safe_lod = jnp.where(atlas_lod < 0, b_lod, atlas_lod)
    a_lod, a_xy, a_uv = coordinate_change_lod(b_lod, b_xy, b_uv, safe_lod)
    return atlas_index, a_lod, a_xy, a_uv


def tile_visible(side, lod, xy, uniforms: FrameUniforms, cfg: StaticTerrainConfig):
    """Conservative frustum test of a tile's bounding volume.

    The reference's declared-but-unpopulated culling design
    (culling_bind_group.rs:25-44) realized inside the refinement kernel
    (SURVEY L3 target): the tile's 8 bounding corners (4 surface corners at
    min/max height along the surface normal) are tested against the 5 view
    planes; the tile is invisible only if ALL corners are outside ONE plane
    — conservative for any convex volume containing the corners. Curved
    (cube-sphere) tiles bulge outside their corner hull, so a per-lod
    sagitta margin ``R * (1 - cos(1.2 * (pi/2) / 2^lod))`` is added for
    spherical terrains (the chord-to-arc distance upper bound; C_SQR
    warping stretches a tile's angular span by < 1.2x).

    Returns (...,) bool.
    """
    planes = uniforms.culling_planes  # (5, 4)
    hmin = jnp.minimum(uniforms.min_height, 0.0)
    hmax = jnp.maximum(uniforms.max_height, 0.0)

    if not cfg.spherical:
        # planar tiles are exact parallelepipeds (affine image of
        # rect x height), so max-over-corners equals the box support
        # function: d_max = p . center + sum |p . half_axis| — three mads
        # per plane instead of eight full corner chains (the dense
        # refinement evaluates every tile of every level, refinement.py)
        m = uniforms.world_from_local  # (3, 4)
        inv_count = jnp.exp2(-lod.astype(jnp.float32))  # (...)
        n_up = uniforms.normal_matrix[:, 1]
        n_up = n_up / jnp.linalg.norm(n_up)
        cx = (xy[..., 0].astype(jnp.float32) + 0.5) * inv_count - 0.5
        cz = (xy[..., 1].astype(jnp.float32) + 0.5) * inv_count - 0.5
        hmid = 0.5 * (hmin + hmax)
        hhalf = 0.5 * (hmax - hmin)
        # center = M @ (cx, 0, cz) + t + hmid * n_up
        px = m[0, 0] * cx + m[0, 2] * cz + m[0, 3] + hmid * n_up[0]
        py = m[1, 0] * cx + m[1, 2] * cz + m[1, 3] + hmid * n_up[1]
        pz = m[2, 0] * cx + m[2, 2] * cz + m[2, 3] + hmid * n_up[2]
        # per-plane projections of the three half-axes (scalars / (...,))
        # (elementwise products: a default-precision dot may run in TF32
        # on the GPU, and the culling decision must match the reference)
        pn = planes[:, :3]  # (5, 3)
        pa = jnp.abs(jnp.sum(pn * m[:, 0], axis=-1))  # (5,) |p . Mcol0|
        pc = jnp.abs(jnp.sum(pn * m[:, 2], axis=-1))
        ph = jnp.abs(jnp.sum(pn * n_up, axis=-1)) * hhalf
        d = (
            px[..., None] * planes[:, 0]
            + py[..., None] * planes[:, 1]
            + pz[..., None] * planes[:, 2]
            + planes[:, 3]
        )
        r = (pa + pc) * (0.5 * inv_count[..., None]) + ph
        return jnp.all(d + r >= 0.0, axis=-1)

    # spherical: ONE bounding sphere per tile (center at the tile-center
    # surface point, radius = arc bound over the tile's angular span +
    # the height range) instead of eight full corner chains — the dense
    # refinement evaluates every tile of every level, so the per-lane
    # cost matters. Every surface point of the tile lies within angular
    # distance theta of the center (1.2x covers the C_SQR warp stretch),
    # hence within arc (scale + hmax) * theta of the center point.
    center_uv = jnp.full(jnp.shape(xy), 0.5, jnp.float32)
    local = compute_local_position(side, lod, xy, center_uv, True)
    world = position_local_to_world(local, uniforms.world_from_local)
    normal = normal_local_to_world(local, uniforms.normal_matrix, True)
    hmid = 0.5 * (hmin + hmax)
    p = world + hmid * normal
    d = (
        p[..., 0, None] * planes[:, 0]
        + p[..., 1, None] * planes[:, 1]
        + p[..., 2, None] * planes[:, 2]
        + planes[:, 3]
    )  # (..., 5)
    theta = jnp.minimum(
        1.2 * (jnp.pi / 2.0) * jnp.exp2(-lod.astype(jnp.float32)), jnp.pi
    )
    r = (uniforms.terrain_scale + jnp.abs(hmax)) * theta + (hmax - hmin)
    return jnp.all(d + r[..., None] >= 0.0, axis=-1)
