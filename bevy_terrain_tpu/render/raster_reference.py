"""Plain numpy scanline rasterizer: the reference that render/raster.py is
held to.

It implements the rasterizer's contract in f64 — pixel centers at +0.5,
sign-normalized edge functions, the top-left fill rule, reverse-Z depth
max, triangles touching w <= near_eps culled — one triangle at a time over
a pixel window, so a crop of a full-size frame stays affordable.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from bevy_terrain_tpu.render.raster import _triangle_vertex_indices


class ReferenceRaster(NamedTuple):
    """Per-pixel results over the window, shape (rows, cols) each."""

    tri_id: np.ndarray  # winner, indexing _triangle_vertex_indices; -1 empty
    depth: np.ndarray  # winner's interpolated NDC z; -inf where empty
    margin: np.ndarray  # winner's smallest barycentric; inf where empty
    edge_px: np.ndarray  # winner's distance to its nearest edge, pixels
    lead: np.ndarray  # winner's relative depth lead over the runner-up


def reference_raster(positions, tile_mask, vp, width: int, height: int,
                     x0: int = 0, y0: int = 0, cols: int | None = None,
                     rows: int | None = None,
                     near_eps: float = 1e-4) -> ReferenceRaster:
    """Rasterize the (F, G1, G1, 3) grid mesh over the pixel window
    [y0, y0 + rows) x [x0, x0 + cols) of a width x height target (the
    whole target by default)."""
    cols = width - x0 if cols is None else cols
    rows = height - y0 if rows is None else rows
    F, G1 = positions.shape[0], positions.shape[1]
    p = np.asarray(positions).reshape(-1, 3).astype(np.float64)
    m = np.asarray(vp, np.float64)
    clip = p @ m[:, :3].T + m[:, 3]
    w = clip[:, 3]
    sx = (clip[:, 0] / w * 0.5 + 0.5) * width
    sy = (0.5 - clip[:, 1] / w * 0.5) * height
    sz = clip[:, 2] / w
    all_tri = _triangle_vertex_indices(F, G1)
    live = np.asarray(tile_mask)[all_tri[:, 0] // (G1 * G1)]
    kept = np.nonzero(live & (w[all_tri] > near_eps).all(axis=1))[0]
    tx, ty = sx[all_tri[kept]], sy[all_tri[kept]]
    hit = ((tx.max(1) >= x0) & (tx.min(1) <= x0 + cols)
           & (ty.max(1) >= y0) & (ty.min(1) <= y0 + rows))

    tri_img = np.full((rows, cols), -1, np.int64)
    depth = np.full((rows, cols), -np.inf)
    depth2 = np.full((rows, cols), -np.inf)
    margin = np.full((rows, cols), np.inf)
    edge_px = np.full((rows, cols), np.inf)
    cy, cx = np.mgrid[y0:y0 + rows, x0:x0 + cols] + 0.5
    for t in np.nonzero(hit)[0]:
        x, y, z = tx[t], ty[t], sz[all_tri[kept[t]]]
        area = (x[1] - x[0]) * (y[2] - y[0]) - (y[1] - y[0]) * (x[2] - x[0])
        if area == 0:
            continue
        s = -1.0 if area < 0 else 1.0
        inside = np.ones(cx.shape, bool)
        es, dist = [], np.full(cx.shape, np.inf)
        for i in range(3):
            j, k = (i + 1) % 3, (i + 2) % 3
            a = -(y[k] - y[j]) * s
            b = (x[k] - x[j]) * s
            e = ((x[k] - x[j]) * (cy - y[j]) - (y[k] - y[j]) * (cx - x[j])) * s
            tl = (b < 0) or (b == 0 and a > 0)
            inside &= (e > 0) | ((e == 0) & tl)
            es.append(e)
            dist = np.minimum(dist, np.abs(e) / max(np.hypot(a, b), 1e-30))
        zval = (es[0] * z[0] + es[1] * z[1] + es[2] * z[2]) / abs(area)
        win = inside & (zval > depth)
        depth2 = np.where(win, depth,
                          np.where(inside, np.maximum(depth2, zval), depth2))
        depth = np.where(win, zval, depth)
        tri_img = np.where(win, kept[t], tri_img)
        margin = np.where(win, np.minimum(np.minimum(es[0], es[1]), es[2])
                          / abs(area), margin)
        edge_px = np.where(win, dist, edge_px)
    lead = np.full((rows, cols), np.inf)  # no runner-up: an infinite lead
    two = np.isfinite(depth2)
    lead[two] = (depth[two] - depth2[two]) / np.maximum(np.abs(depth[two]), 1e-30)
    return ReferenceRaster(tri_img, depth, margin, edge_px, lead)
