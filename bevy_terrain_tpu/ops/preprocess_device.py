"""Device-side (jitted) preprocess compute over whole-lod tile stacks.

The reference runs split/stitch/downsample as GPU compute over 8x8
workgroups per tile (/root/reference/src/preprocess/mod.rs:143-218,
src/shaders/preprocess/{split,stitch,downsample}.wgsl); SURVEY section 2.3
commits these plus mip generation to device code. Formulation here:
a lod level's tiles are ONE (N, ts, ts, C) stack and each pass is a jitted
tensor op over the stack — no per-texel threads, no write-section/readback
machinery:

* **split resample**: the lod mosaic as two tent-weight matmuls per row
  band (split.wgsl:18-48 bilinear; ops/preprocess.split_mosaic is the
  host twin).
* **downsample**: gather each parent's 4 children by index (tile-granular
  ``take``), assemble the (2*center)^2 field, nodata-masked 2x2 mean
  (downsample.wgsl:12-45).
* **stitch**: every border region is a gather of the neighbour's
  center-edge band + a STATIC transform (slice / flip / transpose) chosen
  by the cross-face remap code. The per-texel ``project_texels`` of
  stitch.wgsl:12-51 collapses to a signed axis permutation, so all 8
  regions x <=6 remap cases are static slicing — no per-texel gather at
  all. Missing neighbours clamp-repeat the tile's own edge
  (stitch.wgsl:98-103).
* **mips**: 2x2 box filter per level; the R16 nodata rule (skip zero
  texels, count-weighted) matches terrain_data/mod.rs:184-218.

The host numpy twins in ops/preprocess.py remain the parity oracles; see
tests/test_preprocess_device.py for stack-vs-oracle equivalence.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from bevy_terrain_tpu.math.coordinate import TileCoordinate
from bevy_terrain_tpu.ops.preprocess import _project_texels


# ---------------------------------------------------------------------------
# split resample
# ---------------------------------------------------------------------------


@jax.jit
def resize_rows(m, src):
    """(K, H) tent rows x (H, W, C) source -> (K, W, C)."""
    # HIGHEST: the resample feeds 16-bit stored heights; a default-precision
    # f32 dot may run in TF32 on the GPU (11 significant bits) and would
    # quantize the dataset itself
    return jnp.einsum(
        "kh,hwc->kwc", m, src, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


@jax.jit
def resize_cols(tmp, m):
    """(K, W, C) band x (L, W) tent rows -> (K, L, C)."""
    return jnp.einsum(
        "kwc,lw->klc", tmp, m, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


# ---------------------------------------------------------------------------
# downsample
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("texture_size", "border_size"))
def downsample_stack(children, child_idx, texture_size: int, border_size: int):
    """Parent tiles from child stacks (downsample.wgsl:12-45), batched.

    Args:
      children: (Nc, ts, ts, C) f32 child tiles (0 = nodata).
      child_idx: (Np, 4) i32 indices into ``children`` in the reference
        child order (2x,2y),(2x+1,2y),(2x,2y+1),(2x+1,2y+1); -1 = missing
        (counts as nodata).

    Returns (Np, ts, ts, C) f32 parents (borders zero).
    """
    b, ts = border_size, texture_size
    cs = ts - 2 * b
    Np = child_idx.shape[0]
    C = children.shape[-1]

    present = (child_idx >= 0)[..., None, None, None]  # (Np, 4, 1, 1, 1)
    centers = jnp.take(children, jnp.maximum(child_idx, 0), axis=0)[
        :, :, b:b + cs, b:b + cs, :
    ]  # (Np, 4, cs, cs, C)
    centers = jnp.where(present, centers, 0.0)

    # assemble (Np, 2cs, 2cs, C): quadrant q = (qx, qy) at block offsets
    top = jnp.concatenate([centers[:, 0], centers[:, 1]], axis=2)
    bottom = jnp.concatenate([centers[:, 2], centers[:, 3]], axis=2)
    field = jnp.concatenate([top, bottom], axis=1)  # (Np, 2cs, 2cs, C)

    quads = field.reshape(Np, cs, 2, cs, 2, C).transpose(0, 1, 3, 2, 4, 5)
    quads = quads.reshape(Np, cs, cs, 4, C)
    valid = jnp.any(quads != 0, axis=-1)  # (Np, cs, cs, 4)
    count = jnp.sum(valid, axis=-1)
    total = jnp.sum(quads * valid[..., None], axis=3)
    avg = jnp.where(
        (count > 0)[..., None], total / jnp.maximum(count, 1)[..., None], 0.0
    )
    return jnp.pad(avg, ((0, 0), (b, b), (b, b), (0, 0)))


# ---------------------------------------------------------------------------
# stitch
# ---------------------------------------------------------------------------

# border region rects (x, y, w, h) and neighbour offsets per slot
# (stitch.wgsl:58-67, 79-88) — slot order up, right, down, left, up-left,
# up-right, down-right, down-left (coordinate.rs:209-218)


def _region_rects(size: int, b: int):
    cs = size - 2 * b
    off = b + cs
    bounds = [
        (b, 0, cs, b), (off, b, b, cs), (b, off, cs, b), (0, b, b, cs),
        (0, 0, b, b), (off, 0, b, b), (off, off, b, b), (0, off, b, b),
    ]
    offsets = [
        (0, cs), (-cs, 0), (0, -cs), (cs, 0),
        (cs, cs), (-cs, cs), (-cs, -cs), (cs, -cs),
    ]
    return bounds, offsets


class _RemapDescriptor(NamedTuple):
    """Static recipe: out[region] = maybe_flip(maybe_T(neigh[src_rect]))."""

    src_x: int
    src_y: int
    src_w: int
    src_h: int
    transpose: bool
    flip_x: bool
    flip_y: bool


@functools.lru_cache(maxsize=None)
def _remap_descriptor(orig_side: int, proj_side: int, slot: int,
                      size: int, border: int) -> _RemapDescriptor:
    """Derive the static transform equivalent of the per-texel remap
    (stitch.wgsl:12-51) for one (tile side, neighbour side, slot)."""
    bounds, offsets = _region_rects(size, border)
    x, y, w, h = bounds[slot]
    ox, oy = offsets[slot]
    xs, ys = np.meshgrid(np.arange(x, x + w), np.arange(y, y + h), indexing="xy")
    coords = np.stack([xs.ravel(), ys.ravel()], axis=-1) + np.array([ox, oy])
    remapped = _project_texels(coords, orig_side, proj_side, size)
    rx = remapped[:, 0].reshape(h, w)
    ry = remapped[:, 1].reshape(h, w)
    sx0, sy0 = int(rx.min()), int(ry.min())
    src_w, src_h = int(rx.max()) - sx0 + 1, int(ry.max()) - sy0 + 1
    # the remap is a signed axis permutation — find the matching one of the
    # 8 slice/transpose/flip transforms against the per-texel oracle
    probe = np.arange(size * size).reshape(size, size)
    want = probe[ry, rx]
    for transpose in (False, True):
        for flip_x in (False, True):
            for flip_y in (False, True):
                d = _RemapDescriptor(
                    sx0, sy0, src_w, src_h, transpose, flip_x, flip_y)
                got = _apply_descriptor_np(probe, d)
                if got.shape == want.shape and (got == want).all():
                    return d
    raise AssertionError(
        f"no static transform matches remap {(orig_side, proj_side, slot)}")


def _apply_descriptor_np(tile2d: np.ndarray, d: _RemapDescriptor) -> np.ndarray:
    s = tile2d[d.src_y:d.src_y + d.src_h, d.src_x:d.src_x + d.src_w]
    if d.transpose:
        s = s.T
    if d.flip_x:
        s = s[:, ::-1]
    if d.flip_y:
        s = s[::-1, :]
    return s


def _apply_descriptor(stack, d: _RemapDescriptor):
    """(N, ts, ts, C) -> (N, h, w, C) static slice/transpose/flip."""
    s = stack[:, d.src_y:d.src_y + d.src_h, d.src_x:d.src_x + d.src_w, :]
    if d.transpose:
        s = jnp.swapaxes(s, 1, 2)
    if d.flip_x:
        s = jnp.flip(s, axis=2)
    if d.flip_y:
        s = jnp.flip(s, axis=1)
    return s


def stitch_plan(coordinates: list[TileCoordinate], index_of: dict,
                spherical: bool):
    """Host: neighbour indices + sides per tile for stitch_stack.

    ``index_of``: TileCoordinate -> row in the lod stack (tiles being
    stitched AND any extra neighbour rows appended by the caller).
    Returns (nbr_idx (N, 8) i32 with -1 missing, nbr_side (N, 8) i32).
    """
    N = len(coordinates)
    nbr_idx = np.full((N, 8), -1, np.int32)
    nbr_side = np.zeros((N, 8), np.int32)
    for i, c in enumerate(coordinates):
        for slot, n in enumerate(c.neighbours(spherical)):
            if n.is_valid and n in index_of:
                nbr_idx[i, slot] = index_of[n]
                nbr_side[i, slot] = n.side
    return nbr_idx, nbr_side


def stitch_stack(stack, tile_sides, nbr_idx, nbr_side, border_size: int,
                 spherical: bool):
    """Batched border stitch (stitch.wgsl:53-118) over a lod stack.

    Args:
      stack: (N, ts, ts, C) f32 — the tiles to stitch + any neighbour rows
        (only the first ``nbr_idx.shape[0]`` rows are stitched/returned).
      tile_sides: (N,) host numpy int — cube side per stitched tile (static
        grouping; a lod stack holds few distinct sides).
      nbr_idx / nbr_side: from :func:`stitch_plan`.

    Returns (Nst, ts, ts, C) f32 with all 8 border regions filled.
    """
    ts = stack.shape[1]
    b = border_size
    Nst = nbr_idx.shape[0]
    bounds, _ = _region_rects(ts, b)
    tile_sides = np.asarray(tile_sides)
    out = stack[:Nst]

    for slot in range(8):
        x, y, w, h = bounds[slot]
        idx = nbr_idx[:, slot]
        present = (idx >= 0)[:, None, None, None]
        neigh = jnp.take(stack, jnp.maximum(idx, 0), axis=0)  # (Nst, ts, ts, C)

        # cases: (orig_side, proj_side) pairs present in this frame — a
        # static, tiny set (planar: 1; cube faces: <= 3 per slot)
        if spherical:
            pairs = sorted(
                {(int(o), int(p))
                 for o, p in zip(tile_sides[:Nst], np.asarray(nbr_side)[:Nst, slot])}
            )
        else:
            pairs = [(0, 0)]
        region = None
        for (o, p) in pairs:
            d = _remap_descriptor(o, p, slot, ts, b)
            cand = _apply_descriptor(neigh, d)  # (Nst, h, w, C)
            if region is None:
                region = cand
            else:
                sel = ((tile_sides[:Nst] == o)
                       & (np.asarray(nbr_side)[:Nst, slot] == p))
                region = jnp.where(
                    jnp.asarray(sel)[:, None, None, None], cand, region)

        # missing neighbour: clamp-repeat own center edge (stitch.wgsl:98-103)
        cs = ts - 2 * b
        ry = np.clip(np.arange(y, y + h), b, b + cs - 1)
        rx = np.clip(np.arange(x, x + w), b, b + cs - 1)
        own = out[:, ry][:, :, rx, :]
        region = jnp.where(present, region, own)
        out = jax.lax.dynamic_update_slice(
            out, region.astype(out.dtype), (0, y, x, 0))
    return out


# ---------------------------------------------------------------------------
# border-strip readback
# ---------------------------------------------------------------------------
# Stitch only writes the border regions (stitch.wgsl:58-67) — border 2 of a
# 512 tile is ~1.5% of the texels. The host already knows the interiors
# (it ran split/downsample itself), so the readback only needs these
# strips: extract_borders packs them into one compact (N, K) tensor on
# device, composite_borders splices them back into the host tiles — ~60x
# fewer bytes than pulling whole stitched stacks.


def border_strip_length(texture_size: int, border_size: int,
                        channels: int) -> int:
    ts, b = texture_size, border_size
    return (2 * b * ts + 2 * (ts - 2 * b) * b) * channels


@functools.partial(jax.jit, static_argnames=("border_size",))
def extract_borders(stack, border_size: int):
    """(N, ts, ts, C) -> (N, K) compact border texels: top rows, bottom
    rows, left cols, right cols (corners ride the top/bottom strips)."""
    N, ts, _, C = stack.shape
    b = border_size
    top = stack[:, :b, :, :].reshape(N, -1)
    bottom = stack[:, ts - b:, :, :].reshape(N, -1)
    left = stack[:, b:ts - b, :b, :].reshape(N, -1)
    right = stack[:, b:ts - b, ts - b:, :].reshape(N, -1)
    return jnp.concatenate([top, bottom, left, right], axis=1)


def composite_borders(tile: np.ndarray, strip: np.ndarray,
                      border_size: int) -> None:
    """Host: splice one tile's extract_borders strip back in place."""
    ts, _, C = tile.shape
    b = border_size
    k1 = b * ts * C
    k2 = (ts - 2 * b) * b * C
    tile[:b] = strip[0:k1].reshape(b, ts, C)
    tile[ts - b:] = strip[k1:2 * k1].reshape(b, ts, C)
    tile[b:ts - b, :b] = strip[2 * k1:2 * k1 + k2].reshape(ts - 2 * b, b, C)
    tile[b:ts - b, ts - b:] = strip[2 * k1 + k2:].reshape(ts - 2 * b, b, C)


# ---------------------------------------------------------------------------
# mips
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("mip_level_count", "nodata_aware", "quantize")
)
def mip_stack(stack, mip_level_count: int, nodata_aware: bool,
              quantize: bool = True):
    """Box-filtered mip chain over a tile stack (terrain_data/mod.rs:143-219).

    ``stack``: (N, ts, ts, C) f32. Returns a list of per-level stacks
    [mip0, mip1, ...]; with ``nodata_aware`` (the R16 rule) zero texels are
    skipped and the average is count-weighted. ``quantize`` applies the
    host chain's truncating integer division per level
    (attachment.generate_mipmaps / reference mod.rs:144-198) — byte-exact
    with the integer-stored chain (f32 holds these integers exactly; the
    division quotients are quarters/thirds, so floor never straddles).
    """
    mips = [stack]
    for _ in range(1, mip_level_count):
        p = mips[-1]
        N, H, W, C = p.shape
        quads = p.reshape(N, H // 2, 2, W // 2, 2, C).transpose(0, 1, 3, 2, 4, 5)
        quads = quads.reshape(N, H // 2, W // 2, 4, C)
        if nodata_aware:
            valid = quads != 0  # per channel (mod.rs:184-188)
            count = jnp.sum(valid, axis=3)
            total = jnp.sum(quads * valid, axis=3)
            child = jnp.where(
                count > 0, total / jnp.maximum(count, 1), 0.0
            )
        else:
            child = jnp.sum(quads, axis=3) / 4.0
        mips.append(jnp.floor(child) if quantize else child)
    return mips
