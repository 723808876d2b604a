"""Tiled software rasterizer in JAX: terrain frame products -> framebuffer.

The reference renders per PIXEL: bevy's render graph rasterizes the
terrain mesh and fragment.wgsl:35-113 runs per fragment (per-pixel
atlas lookup, screen-space-derivative filtering via textureSampleGrad,
bevy_pbr lighting). Everywhere else this framework keeps the frame's
products as vertex/attribute tensors (SURVEY's buffers-not-rasterization
choice); this module closes the per-pixel half when an actual image is
wanted — captures, goldens, debug stills, offline tooling.

JAX exposes no raster hardware, so the design re-expresses rasterization
as dense array work:

* **Hierarchical binning by sort compaction** — bins form a mip
  pyramid (level-0 bins of ``bin_px``, each coarser level 2x). A
  triangle lands at the unique level where its AABB spans at most
  2x2 bins, so EVERY triangle emits exactly <=4 (level-bin, tri)
  pairs — terrain's LOD size spread (subpixel horizon slivers next to
  screen-filling near quads) costs no clamping. One stable sort + a
  rank pass build dense per-bin candidate lists per level, which are
  gathered back onto the level-0 grid and concatenated — per-level
  caps are static capacities whose clamping is *counted*, never
  silent (the same idiom as ops/refinement.py). No atomics, no
  dynamic shapes.
* **Edge functions as one matmul** — an edge function is affine in screen
  space, so 3 edges + the (screen-affine) NDC depth of a candidate
  triangle are a ``(4, 3)`` coefficient matrix, and testing a whole
  bin's pixel block against a chunk of candidates is ONE dot:
  ``(px, 3) @ (3, chunk*4)``. The depth race is a running max carried
  through a ``lax.scan`` (reverse-Z, matching math/frustum.perspective).
  The dot runs at HIGHEST precision: the fill rule tests ``E == 0``.
* **Perspective-correct resolve as gathers + elementwise math** — the winning
  triangle id per pixel gathers its 3 vertices once; barycentrics are
  recomputed per pixel and perspective-corrected with the vertices'
  1/w (the hardware attribute interpolator's formula).

Follows the D3D/Vulkan raster contract where it matters for seams:
pixel centers at +0.5, top-left fill rule (raster_coverage_rule), so
shared triangle edges are drawn exactly once.

Reference parity notes:
- fragment.wgsl:35-49's per-pixel tile lookup + mip blend is reproduced
  by interpolating morphed uv + tile identity and running the lookup
  per pixel (see render_view(sample_attachments=...)).
- Per-pixel PBR (fragment.wgsl:95-113 -> bevy_pbr) = pbr_lighting on
  the interpolated normal/position/albedo maps (Phong shading; the
  per-vertex path in render/material.py is the Gouraud sibling).
- Near-plane handling culls triangles with any vertex at w <= near_eps
  (counted in ``near_culled``) instead of clipping — the terrain camera
  sits above the surface, so such triangles only appear when geometry
  crosses the near plane. The reference inherits real clipping from the
  GPU; capture renderers conventionally accept this cut (documented in
  MIGRATING.md).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class RasterOutput(NamedTuple):
    """Per-pixel frame buffers (H, W, ...) plus loss counters."""

    depth: jax.Array  # (H, W) f32 NDC depth (reverse-Z: 0 = far/empty)
    tri_id: jax.Array  # (H, W) i32 global triangle id, -1 = uncovered
    covered: jax.Array  # (H, W) bool
    bary: jax.Array  # (H, W, 3) f32 perspective-correct barycentrics
    # verts of the winning triangle, flat indices into (F*G1*G1):
    vert_idx: jax.Array  # (H, W, 3) i32 (garbage where uncovered)
    near_culled: jax.Array  # () i32 triangles cut by the near plane
    bin_overflow: jax.Array  # () i32 candidates lost to per-level caps


def _triangle_vertex_indices(F: int, R: int, C: int | None = None):
    """Static (T, 3) flat vertex indices for the grid triangulation.

    Each quad (r, c) splits along the same diagonal the reference's strip
    order induces (functions.wgsl:64-71 row strips):
    tri 0 = (v[r,c], v[r,c+1], v[r+1,c]), tri 1 = (v[r+1,c], v[r,c+1],
    v[r+1,c+1]). T = F * (R-1) * (C-1) * 2.
    """
    if C is None:
        C = R
    r = np.arange(R - 1).reshape(R - 1, 1)
    c = np.arange(C - 1).reshape(1, C - 1)
    v00 = r * C + c
    v01 = r * C + (c + 1)
    v10 = (r + 1) * C + c
    v11 = (r + 1) * C + (c + 1)
    tris = np.stack(
        [
            np.stack([v00, v01, v10], axis=-1),
            np.stack([v10, v01, v11], axis=-1),
        ],
        axis=2,
    )  # (R-1, C-1, 2, 3)
    per_tile = tris.reshape(-1, 3)
    base = (np.arange(F) * (R * C)).reshape(F, 1, 1)
    return (base + per_tile[None]).reshape(-1, 3).astype(np.int32)


def _project(positions, view_proj, width, height):
    """World -> (screen_x, screen_y, ndc_depth, w) per vertex.

    ``view_proj`` is column-vector convention (math/frustum.
    view_projection): clip = VP @ [p; 1]. Screen origin top-left, pixel
    centers at +0.5, y down.
    """
    vp = jnp.asarray(view_proj, jnp.float32)
    # column-vector convention (frustum.view_projection): clip = VP @ [p;1].
    # HIGHEST: a default-precision f32 dot may run in TF32 on the GPU; the
    # projected vertices feed the exact-f32 edge functions and fill rule
    clip = jnp.einsum(
        "ij,...j->...i", vp[:, :3], positions,
        precision=jax.lax.Precision.HIGHEST,
    ) + vp[:, 3]
    w = clip[..., 3]
    safe_w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    ndc = clip[..., :3] / safe_w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[..., 1] * 0.5) * height
    # GPU-style fixed-point vertex snapping (D3D's 16.8 raster grid):
    # coincident-but-not-bitwise vertices (adjacent tiles compute their
    # shared boundary through different f32 chains, ~1 ulp apart) collapse
    # to the same raster position, so the canonical-edge watertightness
    # holds ACROSS tiles too — no pinholes along tile seams.
    sx = jnp.round(sx * 256.0) * (1.0 / 256.0)
    sy = jnp.round(sy * 256.0) * (1.0 / 256.0)
    return sx, sy, ndc[..., 2], w


def raster_coverage_rule(e, is_top_left):
    """Top-left fill rule: pixels on a shared edge belong to exactly one
    triangle (e > 0, or e == 0 when the edge is a top/left edge)."""
    return (e > 0) | ((e == 0) & is_top_left)


def edge_coef(x0, y0, x1, y1):
    """Watertight edge coefficients: evaluate every edge in a CANONICAL
    endpoint order (lexicographic by screen coordinate) and fold the
    orientation back as a +-1 factor. Two triangles sharing an edge then
    compute bitwise-identical (a, b, c) before their opposite signs — E
    values are exact f32 negations, so with the fill rule every boundary
    pixel lands in exactly one triangle: no cracks, no double-draw (the
    GPU rasterizer's watertightness guarantee, which naive per-triangle
    edge math loses)."""
    swap = (x0 > x1) | ((x0 == x1) & (y0 > y1))
    xl = jnp.where(swap, x1, x0)
    yl = jnp.where(swap, y1, y0)
    xh = jnp.where(swap, x0, x1)
    yh = jnp.where(swap, y0, y1)
    a = -(yh - yl)
    b = xh - xl
    c = (yh - yl) * xl - (xh - xl) * yl
    sgn = jnp.where(swap, -1.0, 1.0)
    return a * sgn, b * sgn, c * sgn


def _level_caps(bin_cap: int, levels: int):
    """Per-level candidate capacities: level 0 gets ``bin_cap``; coarser
    levels halve (floor 16) — big triangles are few (depth complexity),
    and there are few coarse bins for them to spread over."""
    return tuple(max(bin_cap >> (L + 1), 16) if L else bin_cap
                 for L in range(levels))


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "bin_px", "bin_cap", "chunk",
        "cull_backfaces", "near_eps",
    ),
)
def rasterize_grid(
    positions,
    tile_mask,
    view_proj,
    width: int,
    height: int,
    bin_px: int = 32,
    bin_cap: int = 256,
    chunk: int = 8,
    cull_backfaces: bool = False,
    near_eps: float = 1e-4,
) -> RasterOutput:
    """Rasterize (F, G1, G1, 3) world-space vertex grids to (H, W) buffers.

    Static knobs follow the framework's capacity idiom: the per-level
    candidate caps (``bin_cap`` at level 0, halving for coarser levels)
    are compile-time capacities whose clamping is *counted*, never
    silent (``bin_overflow``).

    Sizing ``bin_cap``: UDLOD emits roughly one vertex per output pixel
    at the view's design resolution, so expect about
    ``2 * bin_px^2 * (design_px / (W * H))`` triangles per level-0 bin on
    average; give hotspots ~4x headroom. Rendering a frame refined for
    1080p into a tiny thumbnail concentrates hundreds of subpixel
    triangles per bin — raise ``bin_cap`` or render nearer the design
    resolution, and treat ``bin_overflow > 0`` as the signal.
    """
    F, R, C = positions.shape[0], positions.shape[1], positions.shape[2]
    tri_vidx = jnp.asarray(_triangle_vertex_indices(F, R, C))  # (T, 3)
    T = tri_vidx.shape[0]

    sx, sy, sz, w = _project(positions.reshape(-1, 3), view_proj, width, height)
    # (T, 3) per-corner screen data
    vx, vy = sx[tri_vidx], sy[tri_vidx]
    vz, vw = sz[tri_vidx], w[tri_vidx]

    tile_of_tri = tri_vidx[:, 0] // (R * C)
    alive = tile_mask[tile_of_tri]
    in_front = jnp.all(vw > near_eps, axis=-1)
    near_culled = jnp.sum((alive & ~in_front).astype(jnp.int32))

    # signed area x2 (screen space, y down -> clockwise is positive)
    area = (vx[:, 1] - vx[:, 0]) * (vy[:, 2] - vy[:, 0]) - (
        vy[:, 1] - vy[:, 0]
    ) * (vx[:, 2] - vx[:, 0])
    if cull_backfaces:
        face_ok = area > 0
    else:
        face_ok = area != 0
    valid = alive & in_front & face_ok

    # --- hierarchical binning: each triangle goes to the pyramid level
    # where its AABB spans <= 2x2 bins, emitting exactly <= 4 pairs ---
    nbx = -(-width // bin_px)
    nby = -(-height // bin_px)
    NB = nbx * nby
    levels = max(int(np.ceil(np.log2(max(nbx, nby)))), 0) + 1
    caps = _level_caps(bin_cap, levels)
    # level grids and their flat-key offsets (host-static)
    nbx_l = [-(-nbx // (1 << L)) for L in range(levels)]
    nby_l = [-(-nby // (1 << L)) for L in range(levels)]
    nb_l = [a * b for a, b in zip(nbx_l, nby_l)]
    key_off = np.concatenate([[0], np.cumsum(nb_l)]).astype(np.int32)
    NKEYS = int(key_off[-1])

    minx = jnp.min(vx, axis=-1)
    maxx = jnp.max(vx, axis=-1)
    miny = jnp.min(vy, axis=-1)
    maxy = jnp.max(vy, axis=-1)
    offscreen = (maxx < 0) | (minx >= width) | (maxy < 0) | (miny >= height)
    valid = valid & ~offscreen

    px0 = jnp.clip(jnp.floor(minx).astype(jnp.int32), 0, width - 1)
    px1 = jnp.clip(jnp.floor(maxx).astype(jnp.int32), 0, width - 1)
    py0 = jnp.clip(jnp.floor(miny).astype(jnp.int32), 0, height - 1)
    py1 = jnp.clip(jnp.floor(maxy).astype(jnp.int32), 0, height - 1)
    # level-0 bin index span; level L guarantees a <= 2x2 bin cover iff
    # max(dx, dy) <= 2^L (then idx>>L differs by at most 1 per axis)
    cbx0, cbx1 = px0 // bin_px, px1 // bin_px
    cby0, cby1 = py0 // bin_px, py1 // bin_px
    d = jnp.maximum(cbx1 - cbx0, cby1 - cby0)
    lvl = jnp.clip(
        jnp.ceil(jnp.log2(jnp.maximum(d, 1).astype(jnp.float32))).astype(
            jnp.int32
        ),
        0,
        levels - 1,
    )
    shift = lvl  # bins at level L cover (bin_px << L) pixels
    bx0, bx1 = cbx0 >> shift, cbx1 >> shift
    by0, by1 = cby0 >> shift, cby1 >> shift
    lvl_nbx = jnp.asarray(nbx_l, jnp.int32)[lvl]
    lvl_off = jnp.asarray(key_off, jnp.int32)[lvl]

    e = jnp.arange(4, dtype=jnp.int32)
    ex = jnp.minimum(bx0[:, None] + (e & 1)[None, :], bx1[:, None])
    ey = jnp.minimum(by0[:, None] + (e >> 1)[None, :], by1[:, None])
    dup = ((e & 1)[None, :] > (bx1 - bx0)[:, None]) | (
        (e >> 1)[None, :] > (by1 - by0)[:, None]
    )
    pair_ok = valid[:, None] & ~dup
    key = jnp.where(
        pair_ok,
        lvl_off[:, None] + ey * lvl_nbx[:, None] + ex,
        NKEYS,
    )
    tri_id = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[:, None], (T, 4))
    # depth-prioritized binning: within a bin, order candidates near to
    # far (reverse-Z: larger z = nearer), so when a bin exceeds its cap
    # the DROPPED triangles are the farthest — overwhelmingly occluded
    # anyway (hardware early-Z's effect on overflow, made deterministic).
    zmax_tri = jnp.max(vz, axis=-1)  # (T,) nearest corner depth
    # exact near-to-far order at ANY depth scale: positive IEEE floats
    # order like their bit patterns, so the negated bitcast is an
    # ascending near-first integer key (a 2^20 quantizer loses all
    # resolution on far scenes — reverse-Z packs a whole planet disc
    # into ~1e-9 of z)
    znear_key = jnp.broadcast_to(
        -jax.lax.bitcast_convert_type(
            jnp.maximum(zmax_tri, 0.0), jnp.int32
        )[:, None],
        (T, 4),
    )
    # Pack [bin key | depth priority | tri id] into TWO uint32 sort keys
    # (x64 is off by default in JAX) instead of a
    # 3-operand 2-key stable sort: the low tri-id bits make the total
    # order strict, so the result is deterministic without a stability
    # flag, and the comparator moves 8 bytes/element instead of 12.
    # Depth keeps its top (64 - kbits - tbits) bitcast bits: truncation
    # can only reorder the DROP priority among triangles whose nearest
    # corners agree to that relative-depth resolution (ties resolve by
    # tri id); kept-candidate correctness is unaffected — the raster
    # scan depth-tests every candidate anyway.
    kbits = max(int(np.ceil(np.log2(NKEYS + 1))), 1)
    tbits = max(int(np.ceil(np.log2(max(T, 2)))), 1)
    if kbits > 24 or tbits > 31:  # absurd sizes: exact 3-operand sort
        s_key, _, s_tri = jax.lax.sort(
            (key.reshape(-1), znear_key.reshape(-1), tri_id.reshape(-1)),
            num_keys=2,
            is_stable=True,
        )
    else:
        dhi = 32 - kbits  # depth bits carried in the high word
        dlo = max(32 - tbits, 0)  # further depth bits in the low word
        dprio = jax.lax.bitcast_convert_type(
            znear_key.reshape(-1), jnp.uint32
        ) ^ jnp.uint32(0x80000000)  # signed -> order-preserving unsigned
        high = (key.reshape(-1).astype(jnp.uint32) << dhi) | (
            dprio >> kbits
        )
        d_rest = dprio & jnp.uint32((1 << kbits) - 1)
        d_rest = d_rest >> max(kbits - dlo, 0)
        low = (d_rest << tbits) | tri_id.reshape(-1).astype(jnp.uint32)
        s_high, s_low = jax.lax.sort((high, low), num_keys=2)
        s_key = (s_high >> dhi).astype(jnp.int32)
        s_tri = (s_low & jnp.uint32((1 << tbits) - 1)).astype(jnp.int32)

    # rank within (level, bin): i - first index of this key's segment.
    # A cummax over segment starts is O(n) elementwise work; searchsorted
    # here would binary-search the whole 4T array per element (log n
    # dependent gathers each).
    idx = jnp.arange(s_key.shape[0], dtype=jnp.int32)
    seg_start = jnp.concatenate(
        [jnp.ones((1,), bool), s_key[1:] != s_key[:-1]]
    )
    first = jax.lax.associative_scan(
        jnp.maximum, jnp.where(seg_start, idx, 0)
    )
    rank = idx - first

    # dense per-level tables built with ONE global scatter (not one per
    # level), then gathered back onto the level-0 grid and concatenated
    # into ONE (NB, sum(caps)) candidate table
    b0 = jnp.arange(NB, dtype=jnp.int32)
    b0x, b0y = b0 % nbx, b0 // nbx
    table_base = np.concatenate(
        [[0], np.cumsum([nb_l[L] * caps[L] for L in range(levels)])]
    ).astype(np.int64)
    TOTAL_TAB = int(table_base[-1])
    lvl_e = jnp.zeros_like(s_key)
    for L in range(1, levels):
        lvl_e = lvl_e + (s_key >= int(key_off[L])).astype(jnp.int32)
    cap_e = jnp.asarray(caps, jnp.int32)[lvl_e]
    base_e = jnp.asarray(table_base[:-1], jnp.int32)[lvl_e]
    off_e = jnp.asarray(key_off[:levels], jnp.int32)[lvl_e]
    real = s_key < NKEYS
    keep = real & (rank < cap_e)
    bin_overflow = jnp.sum((real & (rank >= cap_e)).astype(jnp.int32))
    gslot = jnp.where(keep, base_e + (s_key - off_e) * cap_e + rank, TOTAL_TAB)
    flat_tab = jnp.full((TOTAL_TAB + 1,), -1, jnp.int32)
    flat_tab = flat_tab.at[gslot].set(s_tri, mode="drop")
    tables = []
    for L in range(levels):
        tab = flat_tab[int(table_base[L]) : int(table_base[L + 1])].reshape(
            nb_l[L], caps[L]
        )
        up = (b0y >> L) * nbx_l[L] + (b0x >> L)  # level-0 bin -> its L bin
        tables.append(tab[up])
    table = jnp.concatenate(tables, axis=1)  # (NB, sum(caps))
    total_cap = int(sum(caps))

    # --- raster scan: running (depth, tri) max over candidate chunks ---
    px_local = jnp.arange(bin_px, dtype=jnp.float32) + 0.5
    lx = jnp.tile(px_local, bin_px)  # (P,) x-fast
    ly = jnp.repeat(px_local, bin_px)
    bins = jnp.arange(NB, dtype=jnp.int32)
    ox = (bins % nbx).astype(jnp.float32) * bin_px
    oy = (bins // nbx).astype(jnp.float32) * bin_px
    # (NB, P, 3) homogeneous pixel coords
    pix = jnp.stack(
        [
            ox[:, None] + lx[None, :],
            oy[:, None] + ly[None, :],
            jnp.ones((NB, bin_px * bin_px), jnp.float32),
        ],
        axis=-1,
    )

    def step(carry, c_idx):
        best_z, best_t = carry
        cand = jax.lax.dynamic_slice(
            table, (0, c_idx * chunk), (NB, chunk)
        )  # (NB, C)
        safe = jnp.maximum(cand, 0)
        cvi = tri_vidx[safe]  # (NB, C, 3)
        cx, cy, cz = sx[cvi], sy[cvi], sz[cvi]

        # edges opposite each vertex, normalized by sign(area) so that
        # inside = all E >= 0 regardless of winding
        a0, b0, c0 = edge_coef(cx[..., 1], cy[..., 1], cx[..., 2], cy[..., 2])
        a1, b1, c1 = edge_coef(cx[..., 2], cy[..., 2], cx[..., 0], cy[..., 0])
        a2, b2, c2 = edge_coef(cx[..., 0], cy[..., 0], cx[..., 1], cy[..., 1])
        ar = a0 * cx[..., 0] + b0 * cy[..., 0] + c0  # = 2*area
        s = jnp.where(ar < 0, -1.0, 1.0)
        inv_ar = s / jnp.maximum(jnp.abs(ar), 1e-20)

        # depth is screen-affine: z(x,y) = sum_i bary_i(x,y) * z_i
        za = (a0 * cz[..., 0] + a1 * cz[..., 1] + a2 * cz[..., 2]) * inv_ar
        zb = (b0 * cz[..., 0] + b1 * cz[..., 1] + b2 * cz[..., 2]) * inv_ar
        zc = (c0 * cz[..., 0] + c1 * cz[..., 1] + c2 * cz[..., 2]) * inv_ar

        # (NB, C, 4, 3) coefficient block -> ONE dot with the pixel block
        coefs = jnp.stack(
            [
                jnp.stack([a0 * s, b0 * s, c0 * s], -1),
                jnp.stack([a1 * s, b1 * s, c1 * s], -1),
                jnp.stack([a2 * s, b2 * s, c2 * s], -1),
                jnp.stack([za, zb, zc], -1),
            ],
            axis=-2,
        ).reshape(NB, chunk * 4, 3)
        # HIGHEST: the top-left fill rule below tests E == 0 exactly; a
        # TF32 pass (the GPU's default for f32 dots) would round E and let
        # shared edges double-draw or crack
        vals = jax.lax.dot_general(
            pix,
            coefs,
            ((((2,), (2,)), ((0,), (0,)))),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        ).reshape(NB, bin_px * bin_px, chunk, 4)

        e0, e1, e2, z = vals[..., 0], vals[..., 1], vals[..., 2], vals[..., 3]
        # Fill rule on the sign-normalized edge (a, b): accept E == 0 when
        # (b < 0) or (b == 0 and a > 0). The two triangles sharing an edge
        # see opposite normalized signs, so exactly ONE accepts the
        # boundary pixels — shared edges draw once, seams never double.
        tl0 = ((b0 * s) < 0) | (((b0 * s) == 0) & ((a0 * s) > 0))
        tl1 = ((b1 * s) < 0) | (((b1 * s) == 0) & ((a1 * s) > 0))
        tl2 = ((b2 * s) < 0) | (((b2 * s) == 0) & ((a2 * s) > 0))
        inside = (
            raster_coverage_rule(e0, tl0[:, None, :])
            & raster_coverage_rule(e1, tl1[:, None, :])
            & raster_coverage_rule(e2, tl2[:, None, :])
            & (cand >= 0)[:, None, :]
        )
        z = jnp.where(inside, z, -jnp.inf)
        zi = jnp.argmax(z, axis=-1)  # (NB, P)
        zmax = jnp.take_along_axis(z, zi[..., None], axis=-1)[..., 0]
        tbest = jnp.take_along_axis(cand[:, None, :], zi[..., None], axis=-1)[
            ..., 0
        ]
        better = zmax > best_z
        return (
            jnp.where(better, zmax, best_z),
            jnp.where(better, tbest, best_t),
        ), None

    n_chunks = -(-total_cap // chunk)
    if total_cap % chunk:
        # pad the candidate table so dynamic_slice chunks stay in bounds
        table = jnp.concatenate(
            [
                table,
                jnp.full((NB, n_chunks * chunk - total_cap), -1, jnp.int32),
            ],
            axis=1,
        )
    init = (
        jnp.full((NB, bin_px * bin_px), -jnp.inf, jnp.float32),
        jnp.full((NB, bin_px * bin_px), -1, jnp.int32),
    )
    (best_z, best_t), _ = jax.lax.scan(
        step, init, jnp.arange(n_chunks, dtype=jnp.int32)
    )

    def to_image(binned):
        img = binned.reshape(nby, nbx, bin_px, bin_px)
        img = img.transpose(0, 2, 1, 3).reshape(nby * bin_px, nbx * bin_px)
        return img[:height, :width]

    depth_img = to_image(best_z)
    tri_img = to_image(best_t)
    covered_img = tri_img >= 0

    # --- resolve: perspective-correct barycentrics of the winner ---
    safe_tri = jnp.maximum(tri_img, 0)
    vids = tri_vidx[safe_tri]  # (H, W, 3)
    rx, ry, rw = sx[vids], sy[vids], w[vids]
    pxc = jnp.arange(width, dtype=jnp.float32)[None, :] + 0.5
    pyc = jnp.arange(height, dtype=jnp.float32)[:, None] + 0.5

    def edge_at(i, j):
        return (rx[..., j] - rx[..., i]) * (pyc - ry[..., i]) - (
            ry[..., j] - ry[..., i]
        ) * (pxc - rx[..., i])

    eb0 = edge_at(1, 2)
    eb1 = edge_at(2, 0)
    eb2 = edge_at(0, 1)
    denom = eb0 + eb1 + eb2
    denom = jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
    lin = jnp.stack([eb0, eb1, eb2], axis=-1) / denom[..., None]
    pc = lin / rw  # perspective correction: weights over w
    den = jnp.sum(pc, axis=-1, keepdims=True)
    pc = pc / jnp.where(jnp.abs(den) < 1e-20, 1e-20, den)
    bary = jnp.where(covered_img[..., None], pc, 0.0)

    return RasterOutput(
        depth=jnp.where(covered_img, depth_img, 0.0),
        tri_id=tri_img,
        covered=covered_img,
        bary=bary,
        vert_idx=vids,
        near_culled=near_culled,
        bin_overflow=bin_overflow,
    )


def _skirt_vertex_map(F: int, G1: int):
    """Flat vertex remap from the skirted (G1+2)^2 grids back to the
    original G1^2 grids: ring vertices map to their nearest boundary
    vertex, so attribute interpolation stretches edge values down the
    skirt (the standard terrain-skirt look)."""
    S = G1 + 2
    rr = np.clip(np.arange(S) - 1, 0, G1 - 1)
    inner = (rr[:, None] * G1 + rr[None, :])[None]  # (1, S, S)
    base = (np.arange(F) * (G1 * G1)).reshape(F, 1, 1)
    return (base + inner).reshape(-1).astype(np.int32)


def add_skirts(positions, depth_frac: float = 0.05, spherical: bool = False):
    """(F, G1, G1, 3) -> (F, G1+2, G1+2, 3): pad each tile with a ring of
    boundary-vertex copies displaced downward by ``depth_frac`` of the
    tile's world edge length.

    Terrain skirts close the sub-pixel seams that remain when adjacent
    tiles' boundary heights differ inside the engine's documented
    envelope (per-tile vertex-density mip selection, see
    StaticTerrainConfig.sample_grad; and cross-lod morph tolerance) —
    the same trick production GPU terrain renderers use. Pure geometry:
    attribute interpolation should use :func:`_skirt_vertex_map`.
    """
    F, G1 = positions.shape[0], positions.shape[1]
    S = G1 + 2
    padded = jnp.pad(positions, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    if spherical:
        n = jnp.linalg.norm(padded, axis=-1, keepdims=True)
        down = -padded / jnp.maximum(n, 1e-8)
    else:
        down = jnp.asarray([0.0, -1.0, 0.0], jnp.float32)
    edge_len = jnp.linalg.norm(
        positions[:, 0, -1, :] - positions[:, 0, 0, :], axis=-1
    )  # (F,) world-size of the tile edge
    depth = (depth_frac * edge_len)[:, None, None, None]
    rim = np.zeros((S, S), np.float32)
    rim[0, :] = rim[-1, :] = rim[:, 0] = rim[:, -1] = 1.0
    rim = jnp.asarray(rim)[None, :, :, None]
    return padded + down * depth * rim


def render_view(
    mesh,
    tiles,
    uniforms,
    cfg,
    view_proj,
    width: int,
    height: int,
    material=None,
    lighting: bool = True,
    debug_view: Optional[str] = None,
    shade_mode: str = "pixel",
    attachment_samples: Optional[dict] = None,
    texture_size: int = 512,
    background=(0.0, 0.0, 0.0, 0.0),
    skirts: bool = True,
    pixel_attachment: Optional[tuple] = None,
    **raster_knobs,
):
    """Rasterize one terrain view to an (H, W, 4) image.

    ``shade_mode="pixel"`` is the reference's shading rate
    (fragment.wgsl:95-113): the material's base color and the shading
    normal are interpolated perspective-correct per pixel and
    :func:`pbr_lighting` runs on the pixel maps (Phong shading).
    ``shade_mode="vertex"`` lights per vertex and interpolates the lit
    color (Gouraud) — cheaper, and the mode debug views use (they
    replace color, so lighting placement is moot).

    ``skirts=True`` (default) rasterizes each tile with a downward edge
    skirt (:func:`add_skirts`) so residual cross-tile height deltas
    inside the engine's documented envelope can't open pinholes.

    ``pixel_attachment=(slabs, scale, offset, max_value, tex_size)``
    switches the material's base color to TRUE per-pixel deferred
    texturing: :func:`sample_attachment_pixel` with analytic screen
    derivatives — the reference's textureSampleGrad filtering, per
    pixel (only meaningful with ``shade_mode="pixel"``).

    Returns ``(image, RasterOutput)``; compose/inspect the aux buffers
    (depth, tri_id, counters) as needed. Works under jit except for the
    Python-level mode/material branches (static per specialization).
    """
    from bevy_terrain_tpu.render import material as mat

    if skirts:
        pos_in = add_skirts(mesh.positions, spherical=cfg.spherical)
        raster = rasterize_grid(
            pos_in, mesh.tile_mask, view_proj, width, height, **raster_knobs,
        )
        F, G1 = mesh.positions.shape[0], mesh.positions.shape[1]
        vmap_ = jnp.asarray(_skirt_vertex_map(F, G1))
        raster = raster._replace(vert_idx=vmap_[raster.vert_idx])
    else:
        raster = rasterize_grid(
            mesh.positions, mesh.tile_mask, view_proj, width, height,
            **raster_knobs,
        )
    bg = jnp.asarray(np.asarray(background, np.float32))

    if debug_view is not None or shade_mode == "vertex":
        colors_v = mat.shade(
            mesh, tiles, uniforms, cfg, material=material, lighting=lighting,
            debug_view=debug_view, texture_size=texture_size,
            attachment_samples=attachment_samples,
        )
        img = interpolate(raster, colors_v, background=0.0)
        img = jnp.where(raster.covered[..., None], img, bg)
        return img, raster

    # per-pixel PBR: interpolate base color, shading normal, position
    normals_v = mat.surface_normals_from_heights(mesh, tiles, uniforms, cfg)
    ctx = mat.ShadeContext(
        mesh=mesh, tiles=tiles, normals=normals_v, uniforms=uniforms,
        cfg=cfg, texture_size=texture_size,
        attachment_samples=attachment_samples,
    )
    if pixel_attachment is not None:
        slabs, a_scale, a_offset, a_maxv, a_tex = pixel_attachment
        base_p = sample_attachment_pixel(
            raster, mesh, tiles, uniforms, cfg, slabs, a_scale, a_offset,
            a_maxv, a_tex, view_proj=view_proj, width=width, height=height,
        )
        if base_p.shape[-1] < 4:
            base_p = jnp.concatenate(
                [base_p] + [jnp.ones_like(base_p[..., :1])]
                * (4 - base_p.shape[-1]),
                axis=-1,
            )
    else:
        base_v = (material or mat.default_color)(ctx)
        base_p = interpolate(raster, base_v)
    n_p = interpolate(raster, normals_v)
    n_p = n_p / jnp.maximum(jnp.linalg.norm(n_p, axis=-1, keepdims=True), 1e-8)
    pos_p = interpolate(raster, mesh.positions)
    if lighting:
        if isinstance(material, mat.StandardMaterial):
            img = mat.pbr_lighting(
                base_p, n_p, pos_p, uniforms.view_world_position,
                perceptual_roughness=material.perceptual_roughness,
                metallic=material.metallic,
                reflectance=material.reflectance,
                emissive=material.emissive,
                lights=material.lights,
                ambient=material.ambient,
            )
        else:
            img = mat.pbr_lighting(
                base_p, n_p, pos_p, uniforms.view_world_position
            )
    else:
        img = base_p
    img = jnp.where(raster.covered[..., None], img, bg)
    return img, raster


def pixel_uv_and_grads(raster: RasterOutput, mesh, view_proj, width, height):
    """Per-pixel morphed tile uv + ANALYTIC screen-space derivatives.

    The reference's fragment stage gets duv/dx, duv/dy from the GPU's
    quad derivatives and feeds textureSampleGrad
    (fragment.wgsl:35-49, attachments.wgsl:12-24). Here the winning
    triangle's projective interpolation u(x, y) = N/D (N = sum u_i L_i
    / w_i, D = sum L_i / w_i over the affine barycentrics L_i) has a
    closed-form gradient — dL_i/dx = a_i / 2A is constant per triangle —
    so the derivatives are exact per pixel, no quad neighborhoods
    needed. Returns (uv, duv_dx, duv_dy), each (H, W, 2), zero outside
    coverage.
    """
    flat_uv = mesh.uvs.reshape(-1, 2)
    sx, sy, _, w = _project(
        mesh.positions.reshape(-1, 3), view_proj, width, height
    )
    vids = raster.vert_idx  # (H, W, 3)
    uv3 = flat_uv[vids]  # (H, W, 3, 2)
    x3, y3, w3 = sx[vids], sy[vids], w[vids]
    pxc = jnp.arange(width, dtype=jnp.float32)[None, :] + 0.5
    pyc = jnp.arange(height, dtype=jnp.float32)[:, None] + 0.5

    # affine barycentric L_i via the edge opposite vertex i (cyclic)
    def edge(i):
        j, k = (i + 1) % 3, (i + 2) % 3
        e = (x3[..., k] - x3[..., j]) * (pyc - y3[..., j]) - (
            y3[..., k] - y3[..., j]
        ) * (pxc - x3[..., j])
        a = -(y3[..., k] - y3[..., j])
        b = x3[..., k] - x3[..., j]
        return e, a, b

    e0, a0, b0 = edge(0)
    e1, a1, b1 = edge(1)
    e2, a2, b2 = edge(2)
    two_a = e0 + e1 + e2  # constant per triangle
    two_a = jnp.where(jnp.abs(two_a) < 1e-20, 1e-20, two_a)
    L = jnp.stack([e0, e1, e2], -1) / two_a[..., None]  # (H, W, 3)
    dLdx = jnp.stack([a0, a1, a2], -1) / two_a[..., None]
    dLdy = jnp.stack([b0, b1, b2], -1) / two_a[..., None]

    inv_w = 1.0 / jnp.where(jnp.abs(w3) < 1e-12, 1e-12, w3)  # (H, W, 3)
    D = jnp.sum(L * inv_w, -1, keepdims=True)
    D = jnp.where(jnp.abs(D) < 1e-20, 1e-20, D)
    N = jnp.sum(uv3 * (L * inv_w)[..., None], -2)  # (H, W, 2)
    uv = N / D
    dDdx = jnp.sum(dLdx * inv_w, -1, keepdims=True)
    dDdy = jnp.sum(dLdy * inv_w, -1, keepdims=True)
    dNdx = jnp.sum(uv3 * (dLdx * inv_w)[..., None], -2)
    dNdy = jnp.sum(uv3 * (dLdy * inv_w)[..., None], -2)
    duv_dx = (dNdx - uv * dDdx) / D
    duv_dy = (dNdy - uv * dDdy) / D
    m = raster.covered[..., None]
    return (
        jnp.where(m, uv, 0.0),
        jnp.where(m, duv_dx, 0.0),
        jnp.where(m, duv_dy, 0.0),
    )


def sample_attachment_pixel(
    raster: RasterOutput,
    mesh,
    tiles,
    uniforms,
    cfg,
    slabs,
    scale: float,
    offset: float,
    max_value: float,
    texture_size: int,
    view_proj=None,
    width: int | None = None,
    height: int | None = None,
):
    """Per-pixel attachment sampling with screen-derivative mip selection
    — the reference's exact per-fragment path (fragment.wgsl:35-49 tile
    lookup + attachments.wgsl textureSampleGrad), reproduced pixel for
    pixel on the rasterized frame.

    Per pixel: interpolate the morphed tile uv, look up the best loaded
    atlas tile (the same lookup_best/lookup_tile chain the per-vertex
    shader uses), convert the analytic uv gradients into atlas texel
    units, pick the fractional mip, and trilinear-sample the slab chain.
    Returns (H, W, C) f32 in [0, 1], zero outside coverage.
    """
    from bevy_terrain_tpu.ops import coords, sampling

    G1 = mesh.positions.shape[1]
    if view_proj is not None:
        uv, ddx, ddy = pixel_uv_and_grads(
            raster, mesh, view_proj, width, height
        )
    else:
        uv = interpolate(raster, mesh.uvs)
        ddx = ddy = None

    f = raster.vert_idx[..., 0] // (G1 * G1)  # (H, W) tile lane
    F = cfg.tile_capacity
    side = tiles.tile_side[:F][f]
    lodt = jnp.maximum(tiles.tile_lod[:F], 0)[f]
    xy = tiles.tile_xy[:F][f]

    pos_p = interpolate(raster, mesh.positions)
    view_distance = jnp.linalg.norm(
        pos_p - uniforms.view_world_position, axis=-1
    )
    blend_lod, _ = coords.compute_blend(view_distance, uniforms, cfg)
    if cfg.tile_tree_lod:
        atlas_index, a_lod, _, a_uv = coords.lookup_best(
            uniforms.entries, uniforms.origins, side, lodt, xy, uv, cfg
        )
    else:
        atlas_index, a_lod, _, a_uv = coords.lookup_tile(
            uniforms.entries, side, lodt, xy, uv, blend_lod, cfg
        )
    atlas_index = jnp.where(raster.covered, atlas_index, -1)

    uv_in = sampling.attachment_uv(a_uv, scale, offset)
    if ddx is None:
        return sampling.sample_bilinear(slabs[0], atlas_index, uv_in, max_value)
    # tile-uv -> atlas-texel gradient scale: the atlas tile at a_lod
    # spans 2^(lodt - a_lod) geometry tiles, then border inset + texels
    g = jnp.exp2((a_lod - lodt).astype(jnp.float32))[..., None]
    texel_dx = ddx * g * scale * texture_size
    texel_dy = ddy * g * scale * texture_size
    mip = sampling.mip_level_from_grad(texel_dx, texel_dy, 1)
    return sampling.sample_trilinear(slabs, atlas_index, uv_in, mip, max_value)


def interpolate(raster: RasterOutput, vertex_values, background=0.0):
    """Perspective-correct per-pixel interpolation of per-vertex values.

    ``vertex_values``: (F, G1, G1, C) or (F, G1, G1) -> (H, W, C)/(H, W).
    """
    scalar = vertex_values.ndim == 3
    flat = vertex_values.reshape(
        (-1,) if scalar else (-1, vertex_values.shape[-1])
    )
    tri = flat[raster.vert_idx]  # (H, W, 3[, C])
    bary = raster.bary if scalar else raster.bary[..., None]
    out = jnp.sum(tri * bary, axis=2)
    mask = raster.covered if scalar else raster.covered[..., None]
    return jnp.where(mask, out, background)
