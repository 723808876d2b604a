"""Atlas texture sampling as explicit gathers — attachments.wgsl twin.

The reference samples array textures with a filtering sampler (bilinear,
anisotropy 16, clamp-to-edge; terrain_bind_group.rs:118-127). JAX reaches
no texture units, so filtering is explicit gathers from the attachment
slabs:

* slab layout: one ``(atlas_size, H>>m, W>>m, C)`` array per attachment per
  mip level, stored in the attachment's native integer dtype (uint8/uint16)
  to halve HBM bandwidth; normalization to f32 happens in-kernel (the unorm
  semantics of the reference's texture formats, terrain_data/mod.rs:58-74).
* uv convention: the border-inset transform ``uv * scale + offset``
  (attachments.wgsl:7-10) happens here, as does clamp-to-edge.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bevy_terrain_tpu.ops.params import FrameUniforms, StaticTerrainConfig


def attachment_uv(uv, scale: float, offset: float):
    """Border-inset uv (attachments.wgsl:7-10)."""
    return uv * scale + offset


def sample_bilinear(slab, atlas_index, uv, max_value: float):
    """Bilinear clamp-to-edge sample of an atlas slab at mip 0.

    ``slab``: (A, H, W, C) integer array; ``atlas_index``: (...,) i32
    (-1 == invalid -> returns 0, mirroring tile_atlas.rs:250-251);
    ``uv``: (..., 2) f32 already border-inset. Returns (..., C) f32 in [0,1].
    """
    H, W = slab.shape[1], slab.shape[2]
    # pixel-center convention of GPU samplers: uv * size - 0.5
    px = uv[..., 0] * W - 0.5
    py = uv[..., 1] * H - 0.5
    x0 = jnp.floor(px)
    y0 = jnp.floor(py)
    fx = (px - x0)[..., None]
    fy = (py - y0)[..., None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 1)
    x1i = jnp.clip(x0i + 1, 0, W - 1)
    y1i = jnp.clip(y0i + 1, 0, H - 1)

    valid = (atlas_index >= 0)[..., None]
    a = jnp.maximum(atlas_index, 0)

    v00 = slab[a, y0i, x0i].astype(jnp.float32)
    v10 = slab[a, y0i, x1i].astype(jnp.float32)
    v01 = slab[a, y1i, x0i].astype(jnp.float32)
    v11 = slab[a, y1i, x1i].astype(jnp.float32)

    top = v00 + (v10 - v00) * fx
    bot = v01 + (v11 - v01) * fx
    value = (top + (bot - top) * fy) / max_value
    return jnp.where(valid, value, 0.0)


def sample_trilinear(slabs, atlas_index, uv, mip_level, max_value: float):
    """Trilinear sample across a mip chain.

    ``slabs`` is a list of per-mip (A, H>>m, W>>m, C) arrays; ``mip_level``
    is a fractional f32 (...,). Implements textureSampleGrad's mip blend
    (attachments.wgsl:17 SAMPLE_GRAD path).
    """
    n_mips = len(slabs)
    if n_mips == 1:
        return sample_bilinear(slabs[0], atlas_index, uv, max_value)
    level = jnp.clip(mip_level, 0.0, n_mips - 1.000001)
    lo = jnp.floor(level).astype(jnp.int32)
    frac = (level - lo.astype(jnp.float32))[..., None]
    # gather both adjacent mips for every lane, select by level
    result_lo = jnp.zeros(uv.shape[:-1] + (slabs[0].shape[-1],), jnp.float32)
    result_hi = jnp.zeros_like(result_lo)
    for m in range(n_mips):
        s = sample_bilinear(slabs[m], atlas_index, uv, max_value)
        result_lo = jnp.where((lo == m)[..., None], s, result_lo)
        result_hi = jnp.where((jnp.minimum(lo + 1, n_mips - 1) == m)[..., None], s, result_hi)
    return result_lo + (result_hi - result_lo) * frac


def mip_level_from_grad(uv_dx, uv_dy, texture_size: int):
    """Isotropic mip selection from uv screen derivatives (the GPU
    textureSampleGrad rule): level = log2(max gradient footprint)."""
    dx = uv_dx * texture_size
    dy = uv_dy * texture_size
    rho2 = jnp.maximum(jnp.sum(dx * dx, axis=-1), jnp.sum(dy * dy, axis=-1))
    return 0.5 * jnp.log2(jnp.maximum(rho2, 1e-12))


def sample_height(slab, atlas_index, uv, uniforms: FrameUniforms, scale, offset):
    """Height sample: attachment 0, rescaled to [min_height, max_height]
    (attachments.wgsl:45-49)."""
    a_uv = attachment_uv(uv, scale, offset)
    h = sample_bilinear(slab, atlas_index, a_uv, 65535.0)[..., 0]
    return uniforms.min_height + (uniforms.max_height - uniforms.min_height) * h


# Per-side "up" used to build the cube-face TBN (attachments.wgsl:55-64).
_FACE_UP = np.array(
    [
        [0.0, 1.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, 0.0, -1.0],
        [0.0, 0.0, -1.0],
        [-1.0, 0.0, 0.0],
        [-1.0, 0.0, 0.0],
    ],
    np.float32,
)


def sample_normal(
    slab,
    atlas_index,
    side,
    lod,
    uv,
    vertex_normal,
    uniforms: FrameUniforms,
    cfg: StaticTerrainConfig,
    scale,
    offset,
    texture_size: int,
):
    """Central-difference surface normal from 4 height taps with per-face TBN
    (attachments.wgsl:51-107)."""
    a_uv = attachment_uv(uv, scale, offset)
    off = 0.5 / texture_size

    def tap(du, dv):
        h = sample_bilinear(
            slab, atlas_index, a_uv + np.array([du, dv], np.float32), 65535.0
        )[..., 0]
        return uniforms.min_height + (uniforms.max_height - uniforms.min_height) * h

    left = tap(-off, 0.0)
    up = tap(0.0, -off)
    right = tap(off, 0.0)
    down = tap(0.0, off)

    if cfg.spherical:
        face_up = jnp.asarray(_FACE_UP)[side]  # (..., 3)
        normal = vertex_normal / jnp.linalg.norm(vertex_normal, axis=-1, keepdims=True)
        tangent = jnp.cross(face_up, normal)
        bitangent = jnp.cross(normal, tangent)
        side_length = jnp.float32(3.14159265359 / 4.0) * uniforms.terrain_scale
    else:
        tangent = jnp.broadcast_to(
            np.array([1.0, 0.0, 0.0], np.float32), vertex_normal.shape
        )
        bitangent = jnp.broadcast_to(
            np.array([0.0, 0.0, 1.0], np.float32), vertex_normal.shape
        )
        normal = jnp.broadcast_to(
            np.array([0.0, 1.0, 0.0], np.float32), vertex_normal.shape
        )
        side_length = uniforms.terrain_scale

    pixels_per_side = jnp.float32(texture_size) * jnp.exp2(lod.astype(jnp.float32))
    distance_between_samples = side_length / pixels_per_side

    surface = jnp.stack(
        [left - right, down - up, jnp.broadcast_to(distance_between_samples, left.shape)],
        axis=-1,
    )
    surface = surface / jnp.linalg.norm(surface, axis=-1, keepdims=True)
    world = (
        tangent * surface[..., 0:1]
        + bitangent * surface[..., 1:2]
        + normal * surface[..., 2:3]
    )
    return world / jnp.linalg.norm(world, axis=-1, keepdims=True)


def _query_locate(uniforms: FrameUniforms, cfg: StaticTerrainConfig,
                  positions):
    """World query points -> (side, blend_lod, blend_ratio, xy, frac).

    The shared front half of the CPU sampling chain
    (terrain_data/mod.rs:267-281): world-to-local, cube face pick +
    sigmoid warp (spherical), surface projection at the approximate
    height, blend(lod, ratio) from view distance, and the tree coordinate
    at the blend lod.
    """
    from bevy_terrain_tpu.math.coordinate import (
        FACE_UV_DEN, FACE_UV_NUM, pick_cube_face, sigmoid_warp_forward,
    )
    from bevy_terrain_tpu.ops import coords

    positions = jnp.asarray(positions, jnp.float32)
    m = uniforms.world_from_local
    # inv(m3) = normal_matrix.T (normal_matrix is inv(m3).T by definition)
    m3inv = uniforms.normal_matrix.T
    rel = positions - m[:, 3]
    local = rel @ m3inv.T  # (N, 3) local coordinates

    if cfg.spherical:
        unit = local / jnp.linalg.norm(local, axis=-1, keepdims=True)
        side = pick_cube_face(unit, xp=jnp)
        num = coords.take_side_rows(
            jnp.asarray(np.asarray(FACE_UV_NUM, np.float32)), side,
            cfg.side_count,
        )  # (N, 2, 3)
        den = coords.take_side_rows(
            jnp.asarray(np.asarray(FACE_UV_DEN, np.float32)), side,
            cfg.side_count,
        )  # (N, 3)
        numer = jnp.sum(num * unit[:, None, :], axis=-1)
        denom = jnp.sum(den * unit, axis=-1)[:, None]
        uv = sigmoid_warp_forward(numer / denom, xp=jnp)
        surf_local = unit
        normal = coords.normal_local_to_world(unit, uniforms.normal_matrix, True)
    else:
        side = jnp.zeros(positions.shape[:1], jnp.int32)
        uv = jnp.clip(
            jnp.stack([local[:, 0] + 0.5, local[:, 2] + 0.5], axis=-1), 0.0, 1.0
        )
        surf_local = jnp.stack(
            [local[:, 0], jnp.zeros_like(local[:, 0]), local[:, 2]], axis=-1)
        normal = coords.normal_local_to_world(
            surf_local, uniforms.normal_matrix, False)

    # surface point at the approximate height (mod.rs:272-276)
    surface = coords.position_local_to_world(surf_local, m)
    surface = surface + uniforms.approximate_height * normal
    dist = jnp.linalg.norm(surface - uniforms.view_world_position, axis=-1)
    blend_lod, blend_ratio = coords.compute_blend(dist, uniforms, cfg)

    count = coords.tile_count(blend_lod).astype(jnp.float32)
    scaled = jnp.minimum(uv * count[:, None], count[:, None] - 1e-6)
    xy = scaled.astype(jnp.int32)
    frac = scaled - xy.astype(jnp.float32)
    return side, blend_lod, blend_ratio, xy, frac


def query_attachment(slab, uniforms: FrameUniforms, cfg: StaticTerrainConfig,
                     positions, attachment_scale, attachment_offset,
                     max_value: float):
    """Batched device-side attachment queries at world positions.

    ``sample_attachment`` (terrain_data/mod.rs:267-295) as one jitted op:
    locate (see _query_locate), tile-tree lookup at the blend lod and the
    coarser lod, bilinear sample of ``slab`` (mip 0), blend lerp. Returns
    (N, C) normalized values in [0, 1].
    """
    from bevy_terrain_tpu.ops import coords

    side, blend_lod, blend_ratio, xy, frac = _query_locate(
        uniforms, cfg, positions
    )

    def tap(lod_offset):
        idx, _, _, auv = coords.lookup_tile(
            uniforms.entries, side, blend_lod, xy, frac, blend_lod, cfg,
            lod_offset=lod_offset,
        )
        a_uv = attachment_uv(auv, attachment_scale, attachment_offset)
        return sample_bilinear(slab, idx, a_uv, max_value)

    value = tap(0)
    if cfg.blend:
        value2 = tap(1)
        value = jnp.where(
            blend_ratio[:, None] > 0.0,
            value + (value2 - value) * blend_ratio[:, None], value,
        )
    return value


def query_heights(height_slab, uniforms: FrameUniforms, cfg: StaticTerrainConfig,
                  positions, attachment_scale, attachment_offset):
    """Batched device-side terrain height queries at world positions.

    The CPU sampling API (terrain_data/mod.rs:267-307,
    terrain_data/sampling_api.py) as ONE jitted op over (N, 3) query
    points — the hook for collision/physics/placement services that need
    thousands of heights per tick without a host round trip per point.
    Exact chain parity: surface projection, blend(lod, ratio) from view
    distance, tile-tree lookup at the blend lod, bilinear mip-0 sample,
    lerp toward the coarser lod.

    Gather-based (one lane per query); batch large workloads.
    Returns (N,) f32 heights (world units).
    """
    h = query_attachment(
        height_slab, uniforms, cfg, positions, attachment_scale,
        attachment_offset, 65535.0,
    )[:, 0]
    return uniforms.min_height + (uniforms.max_height - uniforms.min_height) * h
