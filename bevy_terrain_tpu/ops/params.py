"""Static config and per-frame uniforms for the device kernels.

The reference ships this data in four bind groups (culling @0, terrain @1,
view @2, indirect @3 — src/shaders/bindings.wgsl:6-57). Here the same
information splits into:

* :class:`StaticTerrainConfig` — hashable, jit-static: shapes, counts, and
  pipeline flags. Changing any of these recompiles, mirroring the reference's
  pipeline specialization (terrain_material.rs:174-227, tiling_prepass.rs:31-78).
* :class:`FrameUniforms` — a pytree of small device arrays recomputed by the
  host every frame (view position, Taylor approximation, tile-tree origins,
  tile-tree entries, distances).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(
    dataclasses.dataclass,
    frozen=True,
)
class StaticTerrainConfig:
    """jit-static kernel parameters.

    Counts/flags from TerrainConfig + TerrainViewConfig
    (reference terrain.rs:27-49, terrain_view.rs:19-64) plus the debug/render
    flags that specialize shaders (terrain_material.rs:73-97).
    """

    spherical: bool
    side_count: int
    lod_count: int
    tree_size: int
    grid_size: int
    refinement_count: int
    # static shape bounds (see TerrainViewConfig.tile_capacity)
    queue_capacity: int
    tile_capacity: int
    origin_lod: int
    attachment_count: int = 1
    # pipeline flags (reference terrain_material.rs:174-227)
    morph: bool = True
    blend: bool = True
    # apply the blend ratio per vertex (the reference's crossfade,
    # fragment.wgsl blend) instead of per tile center: tighter cross-lod
    # seams at the cost of value-space mixing of two half-grids + a second
    # window interpolation
    blend_per_vertex: bool = False
    high_precision: bool = False
    # SAMPLE_GRAD exists in the reference for screen-space-gradient
    # (anisotropy-16) mip selection in the fragment stage
    # (terrain_bind_group.rs:124, attachments.wgsl:12-24); the per-vertex
    # model has no screen derivatives — patch_geometry instead pins the
    # mip to the vertex half-grid density, which MEASURABLY bounds the
    # height error by the field's super-Nyquist energy while reproducing
    # representable content to interpolation error
    # (tests/test_patch_sampling.py::TestVertexDensityMipBound: a 5 m
    # 3-texel ripple on 100 m range -> p95 total error < 7 m, banded
    # error median < 1 m). Screen-space anisotropic resampling is the
    # consuming rasterizer's concern. The flag is retained for config
    # parity and, like the reference's pipeline bit, only respecializes.
    sample_grad: bool = True
    tile_tree_lod: bool = False  # lookup_best walk instead of blend lod
    # frustum-cull tiles during refinement (SURVEY L3 target; the
    # reference declares the 5-plane CullingUniform but ships it
    # unpopulated, culling_bind_group.rs:25-55). Requires
    # FrameUniforms.culling_planes from a real camera projection.
    culling: bool = False
    # TEST1-3: respecialization hooks whose shader defs no reference
    # shader consumes (terrain_material.rs:93-97; grep over src/shaders/*
    # is empty) — identical here: they only change the jit-static hash
    test1: bool = False
    test2: bool = False
    test3: bool = False

    @property
    def vertices_per_row(self) -> int:
        # reference terrain_view_bind_group.rs:84
        return 2 * (self.grid_size + 2)

    @property
    def vertices_per_tile(self) -> int:
        # reference terrain_view_bind_group.rs:85
        return self.grid_size * self.vertices_per_row


def _field(**kw):
    return dataclasses.field(**kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TaylorParams:
    """Device-side TerrainModelApproximation (reference terrain_model.rs:228-259)."""

    origin_xy: jax.Array  # (6, 2) i32
    origin_uv: jax.Array  # (6, 2) f32
    c: jax.Array  # (6, 3) f32
    c_s: jax.Array  # (6, 3) f32
    c_t: jax.Array  # (6, 3) f32
    c_ss: jax.Array  # (6, 3) f32
    c_st: jax.Array  # (6, 3) f32
    c_tt: jax.Array  # (6, 3) f32

    @staticmethod
    def from_host(approx) -> "TaylorParams":
        return TaylorParams(
            origin_xy=jnp.asarray(approx.origin_xy, jnp.int32),
            origin_uv=jnp.asarray(approx.origin_uv, jnp.float32),
            c=jnp.asarray(approx.c, jnp.float32),
            c_s=jnp.asarray(approx.c_s, jnp.float32),
            c_t=jnp.asarray(approx.c_t, jnp.float32),
            c_ss=jnp.asarray(approx.c_ss, jnp.float32),
            c_st=jnp.asarray(approx.c_st, jnp.float32),
            c_tt=jnp.asarray(approx.c_tt, jnp.float32),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FrameUniforms:
    """Per-frame dynamic inputs to the frame step (one view).

    Gathers what the reference's extract/prepare systems write into
    uniform/storage buffers each frame (gpu_tile_tree.rs:84-95,
    terrain_view_bind_group.rs:193-236, culling_bind_group.rs:87-101).
    """

    # view
    view_world_position: jax.Array  # (3,) f32 — f32 world; fine w/ Taylor path
    approximate_height: jax.Array  # () f32
    # model transform (f32 mirrors of the host f64 affine)
    world_from_local: jax.Array  # (3, 4) f32 affine
    normal_matrix: jax.Array  # (3, 3) f32 = (M^-1)^T upper 3x3
    min_height: jax.Array  # () f32
    max_height: jax.Array  # () f32
    terrain_scale: jax.Array  # () f32 — model.scale() for normal spacing
    # distances (world units; TerrainViewConfig * model.scale(),
    # reference tile_tree.rs:139-153)
    morph_distance: jax.Array  # () f32
    blend_distance: jax.Array  # () f32
    load_distance: jax.Array  # () f32
    subdivision_distance: jax.Array  # () f32
    precision_threshold_distance: jax.Array  # () f32
    morph_range: jax.Array  # () f32
    blend_range: jax.Array  # () f32
    # Taylor approximation
    taylor: TaylorParams
    # tile tree state (host-maintained, device-consumed)
    origins: jax.Array  # (sides, lods, 2) i32 — per-lod tree origin
    entries: jax.Array  # (sides, lods, tree, tree, 2) i32 (atlas_index, atlas_lod)
    # per-(side, lod) view anchor in tile units: integer part + fraction
    # (host f64-computed to keep precision at deep lods)
    view_tile_int: jax.Array  # (sides, lods, 2) i32
    view_tile_frac: jax.Array  # (sides, lods, 2) f32
    # frustum planes [nx ny nz d], normalized; inside <=> dot(n,p)+d >= 0
    # (reference CullingUniform, culling_bind_group.rs:39-44; extraction
    # math/frustum.py). accept_all_planes() when no camera projection.
    culling_planes: jax.Array  # (5, 4) f32


def pack_frame_uniforms(
    model,
    view_world_position,
    approx,
    origins: np.ndarray,
    entries: np.ndarray,
    view_tile_int: np.ndarray,
    view_tile_frac: np.ndarray,
    view_config,
    view_proj: np.ndarray | None = None,
) -> np.ndarray:
    """Pack all per-frame uniforms into ONE host int32 blob.

    Each device_put is a separate latency-bound host->device transfer, and
    FrameUniforms holds ~20 small arrays. The f32 section is bitcast to
    int32 on the host and bitcast back in-trace — one transfer total.
    :func:`unpack_frame_uniforms` rebuilds the pytree inside the jitted
    step for free.
    """
    scale = model.scale
    m = np.asarray(model.world_from_local, np.float64)
    normal_matrix = np.linalg.inv(m[:3, :3]).T
    S, L = origins.shape[0], origins.shape[1]
    nf = packed_f32_count(S, L)
    ni = 12 + 2 * (S * L * 2) + entries.size
    blob = np.empty(nf + ni, np.int32)
    f32 = blob[:nf].view(np.float32)
    o = 0

    def put(values, n):
        nonlocal o
        f32[o:o + n] = values
        o += n

    put(np.asarray(view_world_position, np.float32), 3)
    f32[3:14] = (
        approx.approximate_height,
        model.min_height,
        model.max_height,
        scale,
        view_config.morph_distance * scale,
        view_config.blend_distance * scale,
        view_config.load_distance * scale,
        view_config.morph_distance * scale * (1.0 + view_config.subdivision_tolerance),
        view_config.precision_threshold_distance * scale,
        view_config.morph_range,
        view_config.blend_range,
    )
    o = 14
    put(m[:3, :4].ravel(), 12)
    put(normal_matrix.ravel(), 9)
    put(approx.origin_uv.ravel(), 12)
    for coeff in (approx.c, approx.c_s, approx.c_t, approx.c_ss, approx.c_st,
                  approx.c_tt):
        put(coeff.ravel(), 18)
    put(np.asarray(view_tile_frac).reshape(-1), S * L * 2)
    put(_planes_of(view_proj).ravel(), 20)
    assert o == nf, (o, nf)
    i32 = blob[nf:]
    i32[0:12] = approx.origin_xy.ravel()
    p = 12
    for arr in (origins, view_tile_int, entries):
        flat = np.asarray(arr).reshape(-1)
        i32[p:p + flat.size] = flat
        p += flat.size
    return blob


def _planes_of(view_proj) -> np.ndarray:
    """Frustum planes from an optional camera projection (accept-all when
    absent — culling then never rejects, matching the reference's shipped
    default-planes state, culling_bind_group.rs:47-55)."""
    from bevy_terrain_tpu.math import frustum

    if view_proj is None:
        return frustum.accept_all_planes()
    return frustum.frustum_planes(view_proj)


def packed_f32_count(side_count: int, lod_count: int) -> int:
    """Length of the f32 section inside the packed uniform blob."""
    return 3 + 11 + 12 + 9 + 12 + 6 * 18 + side_count * lod_count * 2 + 20


def unpack_frame_uniforms(blob, side_count: int, lod_count: int,
                          tree_size: int) -> FrameUniforms:
    """Rebuild FrameUniforms from the packed blob (jit-traceable slicing)."""
    nf = packed_f32_count(side_count, lod_count)
    f32 = jax.lax.bitcast_convert_type(
        jax.lax.dynamic_slice_in_dim(blob, 0, nf), jnp.float32
    )
    i32 = jax.lax.dynamic_slice_in_dim(blob, nf, blob.shape[0] - nf)
    o = 0

    def take_f(n, shape=None):
        nonlocal o
        v = jax.lax.dynamic_slice_in_dim(f32, o, n)
        o += n
        return v.reshape(shape) if shape else v

    view_world_position = take_f(3)
    s = take_f(11)
    world_from_local = take_f(12, (3, 4))
    normal_matrix = take_f(9, (3, 3))
    origin_uv = take_f(12, (6, 2))
    c = take_f(18, (6, 3))
    c_s = take_f(18, (6, 3))
    c_t = take_f(18, (6, 3))
    c_ss = take_f(18, (6, 3))
    c_st = take_f(18, (6, 3))
    c_tt = take_f(18, (6, 3))
    SL2 = side_count * lod_count * 2
    view_tile_frac = take_f(SL2, (side_count, lod_count, 2))
    culling_planes = take_f(20, (5, 4))

    p = 0

    def take_i(n, shape):
        nonlocal p
        v = jax.lax.dynamic_slice_in_dim(i32, p, n)
        p += n
        return v.reshape(shape)

    origin_xy = take_i(12, (6, 2))
    origins = take_i(SL2, (side_count, lod_count, 2))
    view_tile_int = take_i(SL2, (side_count, lod_count, 2))
    entries = take_i(
        side_count * lod_count * tree_size * tree_size * 2,
        (side_count, lod_count, tree_size, tree_size, 2),
    )

    return FrameUniforms(
        view_world_position=view_world_position,
        approximate_height=s[0],
        world_from_local=world_from_local,
        normal_matrix=normal_matrix,
        min_height=s[1],
        max_height=s[2],
        terrain_scale=s[3],
        morph_distance=s[4],
        blend_distance=s[5],
        load_distance=s[6],
        subdivision_distance=s[7],
        precision_threshold_distance=s[8],
        morph_range=s[9],
        blend_range=s[10],
        taylor=TaylorParams(
            origin_xy=origin_xy, origin_uv=origin_uv, c=c, c_s=c_s, c_t=c_t,
            c_ss=c_ss, c_st=c_st, c_tt=c_tt,
        ),
        origins=origins,
        entries=entries,
        view_tile_int=view_tile_int,
        view_tile_frac=view_tile_frac,
        culling_planes=culling_planes,
    )


def make_frame_uniforms(
    model,
    view_world_position,
    approx,
    origins: np.ndarray,
    entries: np.ndarray,
    view_tile_int: np.ndarray,
    view_tile_frac: np.ndarray,
    view_config,
    view_proj: np.ndarray | None = None,
) -> FrameUniforms:
    """Assemble FrameUniforms from host-side f64 state."""
    scale = model.scale
    m = np.asarray(model.world_from_local, np.float64)
    normal_matrix = np.linalg.inv(m[:3, :3]).T
    return FrameUniforms(
        view_world_position=jnp.asarray(view_world_position, jnp.float32),
        approximate_height=jnp.float32(approx.approximate_height),
        world_from_local=jnp.asarray(m[:3, :4], jnp.float32),
        normal_matrix=jnp.asarray(normal_matrix, jnp.float32),
        min_height=jnp.float32(model.min_height),
        max_height=jnp.float32(model.max_height),
        terrain_scale=jnp.float32(scale),
        morph_distance=jnp.float32(view_config.morph_distance * scale),
        blend_distance=jnp.float32(view_config.blend_distance * scale),
        load_distance=jnp.float32(view_config.load_distance * scale),
        subdivision_distance=jnp.float32(
            view_config.morph_distance * scale * (1.0 + view_config.subdivision_tolerance)
        ),
        precision_threshold_distance=jnp.float32(
            view_config.precision_threshold_distance * scale
        ),
        morph_range=jnp.float32(view_config.morph_range),
        blend_range=jnp.float32(view_config.blend_range),
        taylor=TaylorParams.from_host(approx),
        origins=jnp.asarray(origins, jnp.int32),
        entries=jnp.asarray(entries, jnp.int32),
        view_tile_int=jnp.asarray(view_tile_int, jnp.int32),
        view_tile_frac=jnp.asarray(view_tile_frac, jnp.float32),
        culling_planes=jnp.asarray(_planes_of(view_proj), jnp.float32),
    )
