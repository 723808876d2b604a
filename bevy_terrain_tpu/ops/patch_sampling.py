"""Terrain height sampling at tile granularity: per-tile patches + tent
resampling.

This replaces the reference's per-vertex ``textureSampleLevel``
(vertex.wgsl:85-98 + attachments.wgsl:12-24) with a pipeline that fetches
at *tile* granularity and does the rest as dense per-tile arithmetic:

1. **Per-tile atlas lookup** — one entry fetch per tile instead of per
   vertex. Valid because blend data lods are coarser than geometry lods
   (blend_distance 2 << morph_distance 16, terrain_view.rs), so a whole
   tile maps into one tile-tree cell at the blend lod.
2. **Blocked patch fetch** — attachment mips >= 1 are stored as a single
   unified array of row-interleaved 2x2 block quads; each tile fetches the
   quad covering its uv window at the mip whose texel density matches the
   vertex half-grid (~= GPU vertex texture fetch with explicit LOD). ONE
   16 KB quad gather per tile.
3. **Tent-weight resample** — the 33x33 half-grid heights of the tile are
   two small batched matmuls with tent (hat) weight matrices: exact
   bilinear interpolation of the patch evaluated at the half-grid.
4. **Static-window vertex interpolation** — a morphed vertex uv lies
   inside a statically-known 3x3 half-grid window (morph blends toward the
   even grid, functions.wgsl:35-49), so per-vertex heights are an
   elementwise 9-tap weighted sum over strided slices.

The blend between two data lods samples the coarse lod from the same patch
by crossfading the resample weights toward their 1-2-1-smoothed closed
form (equivalent to the next mip's bilinear up to the mipmap box filter),
saving both the second fetch round and any smoothing pass; and
the morphed vertex positions interpolate the half-grid rather than raw
texels (band-limited to 2x the vertex density — detail beyond that cannot
be represented by the mesh anyway). The per-vertex-gather path
(sampling.py, meshgen.generate_mesh) is the exact reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from bevy_terrain_tpu.ops import coords
from bevy_terrain_tpu.ops.params import StaticTerrainConfig

BLOCK = 32

# Block arrays are stored as *row-interleaved overlapping quads*: entry i
# holds the 2x2 block window (i, i+1, i+g, i+g+1) of its mip laid out as
# Q[r, 32q + c] = block_q[r, c] — a dense (32, 128) int32 tile, so ONE
# gathered row fetches a tile's whole patch AND the patch halves are plain
# slices (top = Q[:, :64] is [tl | tr], bottom = Q[:, 64:] is [bl | br]).
# Quad validity relies on patch_geometry clamping bx/by to g-2, which
# makes tr = tl+1 and bl = tl+g unconditionally. The price is 4x the
# texel storage of mips >= 1.
QUAD_SHAPE = (BLOCK, 4 * BLOCK)


def quad_rows(blocks: np.ndarray, g: int) -> np.ndarray:
    """(g*g, 32, 32) texel-block mip run -> (g*g, 32, 128) quad rows.

    Entry i = blocks (i, i+1, i+g, i+g+1) concatenated along columns,
    clamped to the run; only entries with bx <= g-2 and by <= g-2 are ever
    requested (tl ids from patch_geometry), so clamped content is never
    read.
    """
    n = blocks.shape[0]
    idx = np.arange(n)
    return np.concatenate(
        [
            blocks,
            blocks[np.minimum(idx + 1, n - 1)],
            blocks[np.minimum(idx + g, n - 1)],
            blocks[np.minimum(idx + g + 1, n - 1)],
        ],
        axis=2,
    )


class PatchPlan(NamedTuple):
    """Static description of an attachment's unified block array."""

    texture_size: int
    mip_count: int
    min_mip: int  # fast path never uses mip 0 (block assembly limit)
    max_mip: int  # deepest mip with size >= 64 (2x2 blocks exist)
    bases: tuple  # per-mip flat block base offset (0 for mips < min_mip)
    total_blocks_per_slot: int
    border_size: int

    @property
    def usable(self) -> bool:
        return self.max_mip >= self.min_mip


def make_patch_plan(texture_size: int, mip_count: int, border_size: int) -> PatchPlan:
    """Layout of the unified blocked mip array for one attachment.

    Mips ``min_mip..max_mip`` (sizes texture/2 .. 64) are stored as
    consecutive runs of (32, 32) blocks: slot a's mip m occupies flat block
    indices ``base[m] + a * g_m^2 + by * g_m + bx`` where
    ``g_m = size_m / 32``.
    """
    min_mip = 1
    max_mip = min(mip_count - 1, int(math.log2(max(texture_size, 1))) - 6)
    bases = []
    per_slot = []
    offset = 0
    for m in range(mip_count):
        if min_mip <= m <= max_mip:
            g = (texture_size >> m) // BLOCK
            bases.append(offset)
            per_slot.append(g * g)
            offset += g * g
        else:
            bases.append(-1)
            per_slot.append(0)
    return PatchPlan(
        texture_size=texture_size,
        mip_count=mip_count,
        min_mip=min_mip,
        max_mip=max_mip,
        bases=tuple(bases),
        total_blocks_per_slot=sum(per_slot),
        border_size=border_size,
    )


def blocks_from_tile(mips: list[np.ndarray], plan: PatchPlan, channel: int = 0) -> np.ndarray:
    """Host: cut one tile's mip chain into the unified block run for a slot.

    Returns (total_blocks_per_slot, 32, 128) row-interleaved block quads
    in the attachment dtype, ordered mip-major to match
    :func:`make_patch_plan` offsets.
    """
    out = []
    for m in range(plan.min_mip, plan.max_mip + 1):
        data = mips[m][..., channel]
        g = data.shape[0] // BLOCK
        blocks = (
            data.reshape(g, BLOCK, g, BLOCK).transpose(0, 2, 1, 3).reshape(-1, BLOCK, BLOCK)
        )
        out.append(quad_rows(blocks, g))
    return np.concatenate(out, axis=0)


def blocks_from_tile_packed(mips: list[np.ndarray], plan: PatchPlan) -> np.ndarray:
    """Host: ALL channels of one tile packed little-endian into ONE int32
    block run (channel c in bits [c*bits, (c+1)*bits)).

    A multi-channel texel is one word in the reference's texture formats
    (Rgba8 = 4 bytes, Rg16 = 2 u16s — src/terrain_data/mod.rs:38-84);
    storing it planar would cost one patch gather PER channel. Packed, the
    sampler gathers once and unpacks each channel with shifts.
    """
    channels = mips[0].shape[-1]
    bits = 8 * mips[0].dtype.itemsize
    assert channels * bits <= 32, (channels, bits)
    packed = blocks_from_tile(mips, plan, 0).astype(np.uint32)
    for c in range(1, channels):
        packed |= blocks_from_tile(mips, plan, c).astype(np.uint32) << (bits * c)
    return packed.view(np.int32)


# ---------------------------------------------------------------------------
# Device pipeline
# ---------------------------------------------------------------------------


class PatchBatch(NamedTuple):
    """Per-frame patch-fetch schedule for the quad-id-sorted tile list."""

    geom: jax.Array  # (F, 5) f32: p0x p0y dp valid ratio
    ids: jax.Array  # (F,) i32 sorted tl quad ids


def plan_patch_batch(
    tiles,
    uniforms,
    cfg: StaticTerrainConfig,
    plan: PatchPlan,
    n_blocks: int,
    assume_sorted: bool = False,
):
    """Per-tile atlas lookup + patch geometry + quad-id sort (see PatchBatch).

    Returns (sorted_tiles: RefinementOutput with (F,) arrays, PatchBatch).
    Sorting by quad id groups tiles that read the same atlas quad (deep
    tiles sample coarse ancestors). With ``assume_sorted`` the tile list is
    taken to be already in quad-id order for this plan (true for sibling
    attachments sharing the height attachment's plan) and the sort is
    skipped, preserving row order.
    """
    from bevy_terrain_tpu.ops.refinement import RefinementOutput

    F = cfg.tile_capacity
    t_side = tiles.tile_side[:F]
    t_lod = jnp.maximum(tiles.tile_lod[:F], 0)
    t_xy = tiles.tile_xy[:F]

    # --- per-tile blend target + atlas entry (functions.wgsl:232-246 at
    # tile granularity: blend data lods are coarser than geometry lods,
    # so a whole tile maps into one tile-tree cell at the blend lod) ---
    center_uv = jnp.full(t_xy.shape, 0.5, jnp.float32)
    dist = coords.approximate_view_distance(
        t_side, t_lod, t_xy, center_uv, uniforms, cfg
    )
    blend_lod, center_ratio = coords.compute_blend(dist, uniforms, cfg)
    if cfg.tile_tree_lod:
        _, walk_lod, _, _ = coords.lookup_best(
            uniforms.entries, uniforms.origins, t_side, t_lod, t_xy, center_uv, cfg
        )
        t0 = jnp.minimum(walk_lod, t_lod)
    else:
        t0 = jnp.minimum(blend_lod, t_lod)
    e_lod, e_xy, _ = coords.coordinate_change_lod(
        t_lod, t_xy, jnp.zeros(t_xy.shape, jnp.float32), jnp.clip(t0, 0, cfg.lod_count - 1)
    )
    a_idx, a_lod = coords.lookup_tile_tree_entry(
        uniforms.entries, t_side, e_lod, e_xy, cfg
    )
    a_lod = jnp.where(a_lod < 0, t_lod, a_lod)

    _, _, window_uv = coords.coordinate_change_lod(
        t_lod, t_xy, jnp.zeros((F, 2), jnp.float32), a_lod
    )
    ids4, p0, dp = patch_geometry(a_idx, t_lod, a_lod, window_uv, plan, cfg)
    ids0 = ids4[:, 0]
    lane = jnp.arange(F, dtype=jnp.int32)
    live = lane < tiles.tile_count
    valid = ((a_idx >= 0) & live).astype(jnp.float32)
    per_vertex = cfg.blend and cfg.blend_per_vertex
    ratio = (
        center_ratio if cfg.blend and not per_vertex else jnp.zeros_like(center_ratio)
    )

    # --- sort tiles by quad id; dead lanes (>= tile_count) to the end ---
    key = jnp.where(live, ids0, jnp.int32(2**31 - 1))
    if assume_sorted:
        s_key, s_side, s_lod, s_x, s_y = key, t_side, t_lod, t_xy[:, 0], t_xy[:, 1]
        s_p0x, s_p0y, s_dp, s_valid, s_ratio = p0[:, 0], p0[:, 1], dp, valid, ratio
    else:
        (s_key, s_side, s_lod, s_x, s_y, s_p0x, s_p0y, s_dp, s_valid, s_ratio) = (
            jax.lax.sort(
                (key, t_side, t_lod, t_xy[:, 0], t_xy[:, 1],
                 p0[:, 0], p0[:, 1], dp, valid, ratio),
                num_keys=1, is_stable=True,
            )
        )

    geom = jnp.stack([s_p0x, s_p0y, s_dp, s_valid, s_ratio], axis=-1)
    sorted_tiles = RefinementOutput(
        tile_side=s_side,
        tile_lod=jnp.where(lane < tiles.tile_count, s_lod, -1),
        tile_xy=jnp.stack([s_x, s_y], axis=-1),
        tile_count=tiles.tile_count,
        overflow=tiles.overflow,
    )
    return sorted_tiles, PatchBatch(geom=geom, ids=jnp.clip(s_key, 0, n_blocks - 1))


def patch_geometry(
    atlas_index,  # (F,) i32 (-1 invalid)
    tile_lod,  # (F,) i32
    atlas_lod,  # (F,) i32
    window_uv,  # (F, 2) f32 — window origin within the atlas tile
    plan: PatchPlan,
    cfg: StaticTerrainConfig,
):
    """Block ids + sample geometry of each tile's patch window.

    Returns (ids (F, 4) i32 flat block indices tl/tr/bl/br,
    p0 (F, 2) f32 patch-local start, dp (F,) f32 texel step) so that the
    half-grid texel positions within the patch are ``p0 + k * dp``.
    """
    T = plan.texture_size
    log2T = int(math.log2(T))
    d = jnp.clip(tile_lod - atlas_lod, 0, 30)
    m = jnp.clip(log2T - 5 - d, plan.min_mip, plan.max_mip)

    size_m = jnp.int32(T) >> m
    g_m = size_m // BLOCK
    bases = jnp.asarray(np.asarray(plan.bases, np.int32))[m]

    # texture uv of half-grid point k: (window + k/HG * 2^-d) * scale + inset
    # (border-inset transform, attachments.wgsl:7-10)
    scale = (T - 2 * plan.border_size) / T
    inset = plan.border_size / T
    inv_win = jnp.exp2(-d.astype(jnp.float32))
    HG = 2 * cfg.grid_size
    # texel centers at mip m: p = uv * size_m - 0.5
    size_f = size_m.astype(jnp.float32)
    start = (window_uv * scale + inset) * size_f[..., None] - 0.5  # (F, 2)
    dp = (inv_win / HG) * scale * size_f  # (F,) texel step per half-grid index

    bx = jnp.clip((start[..., 0] / BLOCK).astype(jnp.int32), 0, jnp.maximum(g_m - 2, 0))
    by = jnp.clip((start[..., 1] / BLOCK).astype(jnp.int32), 0, jnp.maximum(g_m - 2, 0))

    # slot-major layout: all blocks of a slot are contiguous (matches the
    # upload path, blocks_from_tile), mips at per-slot offsets plan.bases
    a = jnp.maximum(atlas_index, 0)
    slot_base = a * plan.total_blocks_per_slot + bases
    gm1 = g_m - 1

    def bid(dy, dx):
        return slot_base + jnp.minimum(by + dy, gm1) * g_m + jnp.minimum(bx + dx, gm1)

    ids = jnp.stack([bid(0, 0), bid(0, 1), bid(1, 0), bid(1, 1)], axis=-1)
    p0 = start - jnp.stack([bx, by], axis=-1).astype(jnp.float32) * BLOCK
    return ids, p0, dp


def fetch_patches_xla(block_array, ids, keep_int: bool = False):
    """XLA fallback patch assembly: one quad take + concat (F, 64, 64).

    ``block_array`` is (N, 32, 128) row-interleaved quad storage (see
    :func:`quad_rows`); only ids column 0 (tl) is fetched — tr/bl/br ride
    along in the quad's lanes. ``keep_int`` preserves the int32 words for
    packed multi-channel storage (the caller unpacks then casts).
    """
    q = jnp.take(block_array, ids[:, 0], axis=0)  # (F, 32, 128)
    if not keep_int:
        q = q.astype(jnp.float32)
    return jnp.concatenate([q[:, :, :64], q[:, :, 64:]], axis=-2)  # (F, 64, 64)


def halfgrid_resample(patch, p0, dp, cfg: StaticTerrainConfig, ratio=None):
    """Exact bilinear of the patch at the (HG+1)^2 half-grid points, as two
    batched tent-weight matmuls. Returns (F, HG+1, HG+1) f32 (raw
    texel values; caller normalizes).

    With ``ratio`` (per-tile blend fraction toward the coarser data lod),
    the tent weights are crossfaded toward their 1-2-1-smoothed form:
    S @ (wy @ patch @ wx.T) @ S == (S@wy) @ patch @ (S@wx).T and S@w has
    the closed form 0.25 t(p-dp) + 0.5 t(p) + 0.25 t(p+dp) (clamped rows
    duplicate the boundary), so the coarse-lod sample costs no extra
    matmuls. Blending the weights instead of the values differs from the
    reference's value crossfade only at second order in the smoothing
    delta (the 1-2-1 coarse sample is itself a documented approximation
    of the next mip).
    """
    HG = 2 * cfg.grid_size
    K = HG + 1
    k = jnp.arange(K, dtype=jnp.float32)  # (K,)
    r = jnp.arange(64, dtype=jnp.float32)  # (P,)

    def tents(start_1d, koff):
        # (F, K, P): hat function -> exact bilinear with clamp-to-edge
        p = start_1d[:, None] + (k[None, :] + koff) * dp[:, None]  # (F, K)
        p = jnp.clip(p, 0.0, 63.0)
        return jnp.maximum(0.0, 1.0 - jnp.abs(p[..., None] - r))  # (F, K, P)

    def weights(start_1d):
        w = tents(start_1d, 0.0)
        if ratio is None:
            return w
        wm = jnp.where((k == 0)[None, :, None], w, tents(start_1d, -1.0))
        wp = jnp.where((k == K - 1)[None, :, None], w, tents(start_1d, 1.0))
        w2 = 0.25 * wm + 0.5 * w + 0.25 * wp
        return w + (w2 - w) * ratio[:, None, None]

    wx = weights(p0[:, 0])
    wy = weights(p0[:, 1])
    # rows: (F, K, P) @ (F, P, P) -> (F, K, P); cols -> (F, K, K).
    # HIGHEST: the resample stands in for the reference's exact bilinear
    # texture fetch; a default-precision f32 dot may run in TF32 on the
    # GPU (11 significant bits), which would round 16-bit texel values.
    hi = jax.lax.Precision.HIGHEST
    rows = jnp.einsum("fkp,fpq->fkq", wy, patch, precision=hi,
                      preferred_element_type=jnp.float32)
    return jnp.einsum("fkq,flq->fkl", rows, wx, precision=hi,
                      preferred_element_type=jnp.float32)


def smooth_halfgrid(half):
    """1-2-1 separable smoothing ~= the next-coarser mip's bilinear
    (mip box filter + interpolation), used for the blend's coarse sample."""

    def smooth_axis(x, axis):
        lo = jnp.concatenate(
            [jax.lax.slice_in_dim(x, 0, 1, axis=axis), jax.lax.slice_in_dim(x, 0, -1, axis=axis)],
            axis=axis,
        )
        hi = jnp.concatenate(
            [jax.lax.slice_in_dim(x, 1, None, axis=axis), jax.lax.slice_in_dim(x, -1, None, axis=axis)],
            axis=axis,
        )
        return 0.25 * lo + 0.5 * x + 0.25 * hi

    return smooth_axis(smooth_axis(half, 1), 2)


def halfgrid_perm(K: int) -> np.ndarray:
    """Evens-first half-grid index order [0,2,..,1,3,..] (see _window9)."""
    return np.concatenate([np.arange(0, K, 2), np.arange(1, K, 2)])


def permute_halfgrid(half):
    """Reorder a natural (F, K, K) half-grid into evens-first rows/cols
    (the layout _window9 consumes)."""
    p = halfgrid_perm(half.shape[-1])
    return half[:, p][:, :, p]


def smooth_halfgrid_permuted(half_p):
    """smooth_halfgrid conjugated into the evens-first layout (batched
    matmuls with the static permuted 1-2-1 matrix; exact up to f32
    reassociation)."""
    K = half_p.shape[-1]
    A = np.zeros((K, K), np.float32)
    for i in range(K):
        lo, hi = max(i - 1, 0), min(i + 1, K - 1)
        A[i, lo] += 0.25
        A[i, i] += 0.5
        A[i, hi] += 0.25
    p = halfgrid_perm(K)
    Ap = jnp.asarray(A[np.ix_(p, p)])
    # HIGHEST: exact f32 smoothing of the resampled heights (a TF32 pass
    # would round them to 11 significant bits)
    hi = jax.lax.Precision.HIGHEST
    out = jnp.einsum("kl,fln->fkn", Ap, half_p, precision=hi,
                     preferred_element_type=jnp.float32)
    return jnp.einsum("fkn,ln->fkl", out, Ap, precision=hi,
                      preferred_element_type=jnp.float32)


def _window9(half_p, G: int):
    """Per-vertex 3x3 interpolation windows from an evens-first half grid.

    ``half_p`` is (F, HG+1, HG+1) with rows/cols in evens-first order
    ([e0..eG*2?, o0..]): vertex i's window covers natural half-grid indices
    {max(2i-2, 0) + b}, which in this layout are UNIT-stride slices of the
    even block (b=0: e[max(i-1,0)], b=2: e[i]) and odd block (b=1:
    o[i-1], clamped to e0 at i=0). Natural-order stride-2 slices would
    invite XLA to materialize transposed copies of the half tensor; these
    are plain unit-stride slices.

    Returned lazily as a dict of 9 (F, G+1, G+1) terms: consumed
    term-by-term they fuse into the weighted sum.
    """
    E = G + 1  # even block size

    def sel(x, axis, o):
        first = jax.lax.slice_in_dim(x, 0, 1, axis=axis)
        if o == 0:  # natural {0, 0, 2, .., 2G-2} -> e[0], e[0..G-1]
            body = jax.lax.slice_in_dim(x, 0, G, axis=axis)
        elif o == 1:  # natural {0, 1, 3, .., 2G-1} -> e[0], o[0..G-1]
            body = jax.lax.slice_in_dim(x, E, E + G, axis=axis)
        else:  # natural {0, 2, .., 2G} -> e[0..G]
            return jax.lax.slice_in_dim(x, 0, G + 1, axis=axis)
        return jnp.concatenate([first, body], axis=axis)

    return {(b, a): sel(sel(half_p, 2, a), 1, b) for b in range(3) for a in range(3)}


def vertex_values_from_halfgrid(half_p, morphed_uv, cfg: StaticTerrainConfig):
    """Interpolate half-grid values at morphed vertex uvs — elementwise.

    ``half_p``: (F, HG+1, HG+1) in evens-first order (permute_halfgrid). ``morphed_uv``: (F, G+1, G+1, 2) with u in
    [even_u, u] per vertex. Returns (F, G+1, G+1) f32.
    """
    G = cfg.grid_size
    HG = 2 * G
    win = _window9(half_p, G)  # dict (b, a) -> (F, G+1, G+1)

    i = np.arange(G + 1)
    xbase = np.maximum(2 * i - 2, 0).astype(np.float32)  # (G+1,)
    lx = morphed_uv[..., 0] * HG - xbase[None, None, :]
    ly = morphed_uv[..., 1] * HG - xbase[None, :, None]

    value = None
    for (b, a), term in win.items():
        w = jnp.maximum(0.0, 1.0 - jnp.abs(ly - b)) * jnp.maximum(
            0.0, 1.0 - jnp.abs(lx - a)
        )
        value = w * term if value is None else value + w * term
    return value


def sample_attachment_vertices(
    block_arrays,  # list per channel of (N, 32, 128) quad block arrays
    tiles,  # RefinementOutput — the frame's quad-id-SORTED tile list
    morphed_uv,  # (F, G+1, G+1, 2) from the frame's GridMeshOutput
    uniforms,
    cfg: StaticTerrainConfig,
    plan: PatchPlan,
    max_value: float,
    packed_channels: int = 0,
    packed_bits: int = 0,
):
    """Sample an arbitrary attachment at the frame's morphed vertex uvs.

    The fragment-stage attachment fetch (attachments.wgsl:12-43) for color /
    splat / normal-map attachments, using the same gather-free pipeline as
    heights: per-tile lookup, blocked patch fetch per channel, half-grid
    resample, static-window interpolation. Returns (F, G+1, G+1, C) f32 in
    [0, 1].

    The input tiles are the frame's canonical (quad-id-sorted) list and the
    output row order must match the mesh, so no re-sort happens here.
    """
    F = cfg.tile_capacity
    _, batch = plan_patch_batch(
        tiles, uniforms, cfg, plan, block_arrays[0].shape[0],
        assume_sorted=True,
    )

    def xla_channel(patch):
        half = halfgrid_resample(
            patch, batch.geom[:F, 0:2], batch.geom[:F, 2], cfg
        ) / max_value
        half = permute_halfgrid(half * batch.geom[:F, 3][:, None, None])
        return vertex_values_from_halfgrid(half, morphed_uv, cfg)

    if packed_channels:
        packed = fetch_patches_xla(block_arrays[0], batch.ids[:F, None],
                                   keep_int=True)
        mask = jnp.int32((1 << packed_bits) - 1)
        channels = [
            xla_channel((jax.lax.shift_right_logical(
                packed, jnp.int32(packed_bits * c)) & mask
            ).astype(jnp.float32))
            for c in range(packed_channels)
        ]
        return jnp.stack(channels, axis=-1)
    channels = [
        xla_channel(fetch_patches_xla(block_array, batch.ids[:F, None]))
        for block_array in block_arrays
    ]
    return jnp.stack(channels, axis=-1)


def grad_tile_span(mesh, uniforms, cfg: StaticTerrainConfig,
                   max_anisotropy: float = 16.0):
    """Per-TILE anisotropic footprint — the SAMPLE_GRAD answer for COLOR
    attachments (reference attachments.wgsl:12-24 textureSampleGrad with
    anisotropy 16).

    The reference's footprint is the screen-pixel preimage, elongated at
    grazing angles along the view direction's surface projection. The
    vertex-grid equivalent: project the view ray onto the surface tangent
    plane, express that direction in tile-uv space via the vertex grid's
    own world-per-uv Jacobian (finite differences — no extra fetches), and
    stretch it by tan(theta) = |tangential| / (view . normal), clamped to
    ``max_anisotropy`` (default 16 — the reference's sampler anisotropy,
    terrain_bind_group.rs:118-127). The isotropic footprint unit is the HALF-GRID
    sample spacing 1/(2 G) — the density the mip selection pins to
    (patch_geometry), so one anisotropy unit ~= one sampled texel
    regardless of which mip the tile landed on.

    The per-vertex spans are reduced to ONE span per tile (grid mean).
    Taps are applied at the half-grid RESAMPLE, not at the vertex window:
    the per-vertex 3x3 tent window only reaches natural half-grid indices
    [2i-2, 2i] — an unmorphed vertex sits at its TOP edge, so symmetric
    uv offsets fall off the window and read zero weight (measured: taps
    at the vertex level pulled values toward 0, doubling the grazing
    deviation). Shifting the patch-texel start ``p0`` instead re-samples
    the fetched patch at tap positions with exact bilinear tents (clip to
    the patch is edge-clamp, not zero), shares the patch fetch across
    taps, and lets the footprint reach real anisotropy > 2 — the taps
    box-filter mip content the vertex/half grid undersamples, exactly
    what textureSampleGrad's aniso taps do. View direction is near
    constant across one tile at grazing distances, so the per-tile
    reduction loses nothing where it matters.

    Returns (F, 2) f32: full footprint extent in tile-uv units, oriented
    along the view's surface projection.
    """
    pos = mesh.positions  # (F, G1, G1, 3)
    n = mesh.normals

    def diff(x, axis):
        lo = jnp.concatenate(
            [jax.lax.slice_in_dim(x, 0, 1, axis=axis),
             jax.lax.slice_in_dim(x, 0, -1, axis=axis)], axis=axis,
        )
        hi = jnp.concatenate(
            [jax.lax.slice_in_dim(x, 1, None, axis=axis),
             jax.lax.slice_in_dim(x, -1, None, axis=axis)], axis=axis,
        )
        return (hi - lo) * 0.5

    # world-per-uv Jacobian columns from the grid itself (du along lanes,
    # dv along rows; grid spacing = 1/G in uv)
    G = cfg.grid_size
    xu = diff(pos, 2) * G  # d(world)/d(u)
    xv = diff(pos, 1) * G
    v = uniforms.view_world_position - pos
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-8)
    vn = jnp.sum(v * n, axis=-1, keepdims=True)
    t = v - vn * n  # tangential view component
    tlen = jnp.linalg.norm(t, axis=-1, keepdims=True)
    aniso = jnp.minimum(tlen / jnp.maximum(jnp.abs(vn), 1e-3), max_anisotropy)
    tdir = t / jnp.maximum(tlen, 1e-8)
    # uv direction of the tangential view ray (grid axes are near-orthogonal)
    du = jnp.sum(tdir * xu, axis=-1) / jnp.maximum(
        jnp.sum(xu * xu, axis=-1), 1e-12
    )
    dv = jnp.sum(tdir * xv, axis=-1) / jnp.maximum(
        jnp.sum(xv * xv, axis=-1), 1e-12
    )
    d_uv = jnp.stack([du, dv], axis=-1)
    d_uv = d_uv / jnp.maximum(
        jnp.linalg.norm(d_uv, axis=-1, keepdims=True), 1e-8
    )
    sample_spacing = 1.0 / (2.0 * G)  # half-grid spacing in tile uv
    span = d_uv * (aniso * sample_spacing)  # full anisotropic footprint
    return jnp.mean(span, axis=(1, 2))  # (F, 2) per-tile


def sample_attachment_vertices_grad(
    block_arrays, tiles, morphed_uv, mesh, uniforms,
    cfg: StaticTerrainConfig, plan: PatchPlan, max_value: float,
    taps: int = 4,
    max_anisotropy: float = 16.0, packed_channels: int = 0,
    packed_bits: int = 0,
):
    """Grad-weighted multi-tap attachment sampling (the textureSampleGrad
    equivalent; see grad_tile_span): each tap shifts the half-grid
    resample's patch-texel start along the per-tile anisotropy axis and
    the taps are averaged — a box filter along the grazing direction.

    The patch fetch is shared across taps; per tap the cost is one
    half-grid resample (2 batched tent matmuls) + one window
    interpolation. Its quality is tested in
    tests/test_patch_sampling.py; its cost on the card is not measured.
    """
    F = cfg.tile_capacity
    _, batch = plan_patch_batch(
        tiles, uniforms, cfg, plan, block_arrays[0].shape[0],
        assume_sorted=True,
    )
    p0 = batch.geom[:F, 0:2]
    dp = batch.geom[:F, 2]
    valid = batch.geom[:F, 3]
    # tile-uv offset du maps to texels as du * HG * dp (half-grid index k
    # is tile-uv k/HG and sits at texel p0 + k*dp, patch_geometry)
    HG = 2 * cfg.grid_size
    span_tex = grad_tile_span(mesh, uniforms, cfg, max_anisotropy) * (
        HG * dp
    )[:, None]  # (F, 2) texels
    ks = (np.arange(taps, dtype=np.float32) + 0.5) / taps - 0.5

    def tap_channel(patch):
        acc = None
        for k in ks:
            half = halfgrid_resample(
                patch, p0 + float(k) * span_tex, dp, cfg
            ) / max_value
            half = permute_halfgrid(half * valid[:, None, None])
            v = vertex_values_from_halfgrid(half, morphed_uv, cfg)
            acc = v if acc is None else acc + v
        return acc / taps

    if packed_channels:
        packed = fetch_patches_xla(block_arrays[0], batch.ids[:F, None],
                                   keep_int=True)
        mask = jnp.int32((1 << packed_bits) - 1)
        channels = [
            tap_channel((jax.lax.shift_right_logical(
                packed, jnp.int32(packed_bits * c)) & mask
            ).astype(jnp.float32))
            for c in range(packed_channels)
        ]
        return jnp.stack(channels, axis=-1)
    channels = [
        tap_channel(fetch_patches_xla(block_array, batch.ids[:F, None]))
        for block_array in block_arrays
    ]
    return jnp.stack(channels, axis=-1)
