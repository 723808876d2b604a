"""Preprocessing data ops: split / downsample / stitch / mosaic resize.

Array-program equivalents of the reference's preprocess compute shaders
(/root/reference/src/shaders/preprocess/):

* **split** (split.wgsl:18-48): sample the source image into each tile's
  center region with dataset-bounds remap and nodata checks. Instead of one
  GPU thread per texel, the whole lod level is resampled at once as a
  *mosaic* with a separable 2-tap bilinear (value-identical to two
  tent-weight matmuls), then cut into tiles. Validity (textureGather
  nodata test) is evaluated with exact 4-tap semantics.
* **downsample** (downsample.wgsl:12-45): parent center = nodata-masked
  2x2 average of the 4 children's centers.
* **stitch** (stitch.wgsl:12-123): fill border texels from the 8
  neighbours with the cube-sphere cross-face texel remap, falling back to
  clamp-repeat of the tile's own edge when a neighbour is missing.

All of it is host numpy (with native C++ helpers where built); the
jitted stack twins live in ops/preprocess_device.py.
"""

from __future__ import annotations

import functools

import numpy as np

# stitch.wgsl texel-remap codes (stitch.wgsl:13-16)
PS, PT, NS, NT = 0, 1, 2, 3

# stitch.wgsl:18-33 — indexed by (6 + projected_side - original_side) % 6
_STITCH_EVEN = [(PS, PT), (PS, PT), (NT, PS), (NT, NS), (PT, NS), (PS, PT)]
_STITCH_ODD = [(PS, PT), (PS, PT), (PT, NS), (PT, PS), (NT, PS), (PS, PT)]

# border region bounds (x, y, w, h) per neighbour index (stitch.wgsl:58-67):
# up, right, down, left, up-left, up-right, down-right, down-left
# and the texel offsets into the neighbour (stitch.wgsl:79-88)


def _tent_matrix(positions: np.ndarray, size: int) -> np.ndarray:
    """(K, size) tent weights = exact clamp-to-edge bilinear row matrix."""
    p = np.clip(positions, 0.0, size - 1.0)
    r = np.arange(size, dtype=np.float64)
    return np.maximum(0.0, 1.0 - np.abs(p[:, None] - r[None, :])).astype(np.float32)


def _tap_weights(positions: np.ndarray, size: int):
    """The two nonzero taps of each tent row: (w0, w1, i0, i1) f32/i64.

    w0 = f32(1 - (p - floor(p))), w1 = f32(p - floor(p)) with p clamped to
    [0, size-1] — bit-identical to the corresponding `_tent_matrix` row
    entries (same f64 math, same final f32 rounding); at the top edge
    w1 == 0 so the clamped duplicate tap contributes nothing."""
    p = np.clip(positions, 0.0, size - 1.0)
    i0 = np.floor(p).astype(np.int64)
    i1 = np.minimum(i0 + 1, size - 1)
    f = p - i0
    return (
        (1.0 - f).astype(np.float32),
        f.astype(np.float32),
        i0,
        i1,
    )


def split_mosaic(
    source: np.ndarray,  # (H, W, C) float32 source image, 0 = nodata
    lod: int,
    center_size: int,
    top_left: tuple[float, float],
    bottom_right: tuple[float, float],
    row_band: int = 2048,
    naive: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Resample the source into the full lod mosaic (count*center)^2.

    Texel k (center texels only, all tiles of the lod) has terrain uv
    (k + 0.5) / (count * center); the dataset remap is
    ``inverse_mix(top_left, bottom_right, uv)`` (split.wgsl:28-30); bilinear
    sample with clamp-to-edge.

    Returns (mosaic (P, P, C) f32, valid (P, P) bool) where valid mirrors
    the reference's textureGather nodata test (all 4 taps nonzero,
    split.wgsl:34).
    """
    H, W, C = source.shape
    count = 1 << lod
    P = count * center_size
    uv = (np.arange(P, dtype=np.float64) + 0.5) / P

    def src_positions(axis):
        tl, br = top_left[axis], bottom_right[axis]
        s = (uv - tl) / (br - tl)  # inverse_mix
        size = W if axis == 0 else H
        return s * size - 0.5

    px = src_positions(0)
    py = src_positions(1)

    bands = []
    if naive:
        # pinned CPU-reference oracle: dense tent-matrix matmuls, the
        # straightforward single-thread implementation of split.wgsl's
        # per-texel bilinear (the baseline the >10x preprocess target is
        # measured against — see bench.py). Value-identical to the fast
        # paths below.
        mx = _tent_matrix(px, W)
        for y0 in range(0, P, row_band):
            my = _tent_matrix(py[y0 : y0 + row_band], H)
            band = np.einsum("kh,hwc->kwc", my, source).astype(np.float32)
            bands.append(np.einsum("kwc,lw->klc", band, mx).astype(np.float32))
    else:
        # direct 2-tap separable bilinear: value-identical to the dense
        # tent matmul (each tent row has exactly two nonzero weights,
        # computed here with the same f64->f32 rounding and the same
        # y-pass-then-x-pass f32 intermediate), ~10x faster (the dense
        # (P, W) matrices were 75% of the host preprocess time)
        from bevy_terrain_tpu import native as _native

        if _native.available():
            for y0 in range(0, P, row_band):
                bands.append(
                    _native.split_bilinear(
                        source, px, py[y0 : y0 + row_band]
                    )
                )
        else:
            xw0, xw1, x0i, x1i = _tap_weights(px, W)
            for y0 in range(0, P, row_band):
                yw0, yw1, y0i, y1i = _tap_weights(py[y0 : y0 + row_band], H)
                band = (
                    source[y0i] * yw0[:, None, None]
                    + source[y1i] * yw1[:, None, None]
                )  # (band, W, C) f32
                bands.append(
                    band[:, x0i] * xw0[None, :, None]
                    + band[:, x1i] * xw1[None, :, None]
                )
    mosaic = np.concatenate(bands, axis=0)  # (P, P, C)

    # validity: all 4 gather taps of CHANNEL 0 nonzero — the reference
    # gathers only the first channel (textureGather(0u, ...), split.wgsl:34)
    x0 = np.clip(np.floor(px).astype(np.int64), 0, W - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    y0_ = np.clip(np.floor(py).astype(np.int64), 0, H - 1)
    y1 = np.clip(y0_ + 1, 0, H - 1)
    nz = source[..., 0] != 0
    if nz.all():
        # nodata-free source (the common case): every tap is nonzero
        valid = np.ones((P, P), bool)
    else:
        # factorized 4-tap test: A[y, k] = nz[y, x0[k]] & nz[y, x1[k]]
        # collapses the x taps on the small (H, P) shape, then two
        # contiguous row-gathers finish the y taps (the naive 4x
        # (P, P) column-gather formulation measured 2.7 s at P = 4064)
        A = nz[:, x0] & nz[:, x1]  # (H, P)
        valid = A[y0_] & A[y1]
    return mosaic, valid


def extract_tile_from_mosaic(
    mosaic: np.ndarray,
    valid: np.ndarray,
    tile_x: int,
    tile_y: int,
    texture_size: int,
    border_size: int,
    dtype: np.dtype,
    max_value: float,
    existing: np.ndarray | None = None,
    quantized: np.ndarray | None = None,
) -> np.ndarray:
    """Cut one tile out of the mosaic: center texels from the resample
    (where valid), borders zero, invalid texels keep existing data
    (split.wgsl:19-42). ``quantized`` optionally passes the whole mosaic
    already quantized to ``dtype`` (native.quantize — bit-identical to the
    per-tile formula below) so the hot path is a plain slice copy."""
    center = texture_size - 2 * border_size
    y0, x0 = tile_y * center, tile_x * center
    v = valid[y0 : y0 + center, x0 : x0 + center]

    tile = (
        existing.copy()
        if existing is not None
        else np.zeros((texture_size, texture_size, mosaic.shape[-1]), dtype)
    )
    b = border_size
    if quantized is not None:
        quant = quantized[y0 : y0 + center, x0 : x0 + center]
    else:
        region = mosaic[y0 : y0 + center, x0 : x0 + center]
        quant = np.clip(np.rint(region * max_value), 0, max_value).astype(dtype)
    center_view = tile[b : b + center, b : b + center]
    tile[b : b + center, b : b + center] = np.where(v[..., None], quant, center_view)
    return tile


def downsample_tile(
    children: list[np.ndarray | None],
    texture_size: int,
    border_size: int,
) -> np.ndarray:
    """Parent tile from its 4 children (downsample.wgsl:12-45): parent
    center texel = nodata-masked average of a 2x2 child-center quad;
    borders zero. ``children`` ordered (2x, 2y), (2x+1, 2y), (2x, 2y+1),
    (2x+1, 2y+1) (coordinate.rs:197-206); missing children count as nodata.

    Dispatches to the C++ twin when available (same f64 accumulation and
    half-to-even rounding; parity-fuzzed in test_native.py);
    :func:`downsample_tile_numpy` stays as the oracle.
    """
    c = next((ch for ch in children if ch is not None), None)
    if c is not None and c.dtype in (np.uint8, np.uint16):
        from bevy_terrain_tpu import native as _native

        if _native.available():
            return _native.downsample(
                children, texture_size, border_size, c.dtype, c.shape[-1]
            )
    return downsample_tile_numpy(children, texture_size, border_size)


def downsample_tile_numpy(
    children: list[np.ndarray | None],
    texture_size: int,
    border_size: int,
) -> np.ndarray:
    """Numpy oracle for :func:`downsample_tile` (downsample.wgsl:12-45)."""
    b = border_size
    center = texture_size - 2 * border_size
    c = children[0] if children[0] is not None else next(
        (ch for ch in children if ch is not None), None
    )
    dtype = c.dtype if c is not None else np.uint16
    channels = c.shape[-1] if c is not None else 1

    # assemble the 2x2 children's centers into one (2*center, 2*center) field
    assembled = np.zeros((2 * center, 2 * center, channels), np.float64)
    for idx, child in enumerate(children):
        if child is None:
            continue
        qx, qy = idx % 2, idx // 2
        assembled[
            qy * center : (qy + 1) * center, qx * center : (qx + 1) * center
        ] = child[b : b + center, b : b + center]

    # nodata-masked 2x2 mean via strided slices (value-identical to the
    # quad gather/transpose formulation, ~8x faster: no (center^2, 4, C)
    # materialization). Tap order (dy, dx) = (0,0), (0,1), (1,0), (1,1)
    # matches the quads reshape's axis-2 order.
    taps = [assembled[dy::2, dx::2] for dy in (0, 1) for dx in (0, 1)]
    valids = [(t != 0).any(axis=-1) for t in taps]
    count = valids[0].astype(np.int64)
    for v in valids[1:]:
        count = count + v
    total = taps[0] * valids[0][..., None]
    for t, v in zip(taps[1:], valids[1:]):
        total = total + t * v[..., None]
    avg = np.where(count[..., None] > 0, total / np.maximum(count, 1)[..., None], 0.0)

    tile = np.zeros((texture_size, texture_size, channels), dtype)
    tile[b : b + center, b : b + center] = np.rint(avg).astype(dtype)
    return tile


def _project_texels(coords_xy: np.ndarray, original_side: int, projected_side: int,
                    texture_size: int) -> np.ndarray:
    """Cross-face texel remap (stitch.wgsl:12-51). coords (N, 2) -> (N, 2)."""
    index = (6 + projected_side - original_side) % 6
    info = (_STITCH_EVEN if original_side % 2 == 0 else _STITCH_ODD)[index]
    out = np.empty_like(coords_xy)
    for comp in range(2):
        code = info[comp]
        if code == PS:
            out[:, comp] = coords_xy[:, 0]
        elif code == PT:
            out[:, comp] = coords_xy[:, 1]
        elif code == NS:
            out[:, comp] = texture_size - 1 - coords_xy[:, 0]
        else:  # NT
            out[:, comp] = texture_size - 1 - coords_xy[:, 1]
    return out


@functools.lru_cache(maxsize=None)
def _stitch_region_maps(n: int, tile_side: int, n_side: int, size: int,
                        b: int):
    """Cached gather maps for border region ``n`` (up, right, down, left,
    up-left, up-right, down-right, down-left): destination (ys, xs) and,
    keyed by the (tile_side, n_side) cross-face remap, the source
    (rys, rxs) into the neighbour / the clamp-repeat (cys, cxs) into the
    tile itself. The maps are pure functions of the geometry, so the per-
    tile meshgrid/stack/remap work (measured ~1.7 ms/tile) runs once."""
    cs = size - 2 * b
    off = b + cs
    bounds = [
        (b, 0, cs, b),
        (off, b, b, cs),
        (b, off, cs, b),
        (0, b, b, cs),
        (0, 0, b, b),
        (off, 0, b, b),
        (off, off, b, b),
        (0, off, b, b),
    ]
    offsets = [
        (0, cs), (-cs, 0), (0, -cs), (cs, 0),
        (cs, cs), (-cs, cs), (-cs, -cs), (cs, -cs),
    ]
    (x, y, w, h), (ox, oy) = bounds[n], offsets[n]
    xs, ys = np.meshgrid(np.arange(x, x + w), np.arange(y, y + h), indexing="xy")
    coords = np.stack([xs.ravel(), ys.ravel()], axis=-1)
    # clamp-repeat own center edge (stitch.wgsl:98-103)
    cxs = np.clip(coords[:, 0], b, b + cs - 1)
    cys = np.clip(coords[:, 1], b, b + cs - 1)
    shifted = coords + np.array([ox, oy])
    remapped = _project_texels(shifted, tile_side, n_side, size)
    return (ys.ravel(), xs.ravel(), remapped[:, 1], remapped[:, 0], cys, cxs)


def stitch_tile(
    tile: np.ndarray,
    tile_side: int,
    neighbour_tiles: list[tuple[int, np.ndarray | None]],
    border_size: int,
) -> np.ndarray:
    """Fill the 8 border regions from neighbours (stitch.wgsl:53-118).

    ``neighbour_tiles``: 8 (side, data) pairs in the order up, right, down,
    left, up-left, up-right, down-right, down-left (coordinate.rs:209-218);
    data None == missing -> clamp-repeat own edge (stitch.wgsl:98-103).
    """
    size = tile.shape[0]
    b = border_size
    out = tile.copy()
    for n, (n_side, n_data) in enumerate(neighbour_tiles):
        ys, xs, rys, rxs, cys, cxs = _stitch_region_maps(
            n, tile_side, n_side, size, b
        )
        if n_data is None:
            out[ys, xs] = tile[cys, cxs]
        else:
            out[ys, xs] = n_data[rys, rxs]
    return out
