#!/usr/bin/env python3
"""Chip smoke test: the streamed terrain frame, end to end, on one GPU.

Drives the system's main path through the entry points a user calls —
``Preprocessor`` -> ``Terrain.update`` streaming -> refinement, mesh
generation and sampling -> ``render_view`` — at the planar headline size
(an 8192^2 16-bit source, lod_count 5, 512^2 tiles, 1024-slot atlas,
capacity 4096) and on the flagship Earth sphere, and checks every product
against a plain reference: the same jitted frame step on the CPU device
of the same process, the per-vertex ``meshgen.generate_mesh`` path, and a
numpy scanline rasterizer. Then it runs the GPU-only golden tests.

    python chip_smoke.py                 # one card, every phase
    python chip_smoke.py --four-cards    # MultiViewTerrain on four cards

Exits non-zero — printing no result line — when JAX finds no GPU or any
phase fails. On success the last line of stdout is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# The headline sizes (bench.py) and a tiny variant for CPU rehearsal.
FULL = dict(
    source_n=8192, lod_count=5, atlas=1024, capacity=4096, queue=1024,
    frames=20, earth_lods=13, earth_atlas=512, earth_capacity=2048,
    earth_queue=2048, earth_face=256, raster_w=1920, raster_h=1080,
    raster_crop=128, bin_cap=2048, mv_capacity=16384, mv_queue=8192,
)
TINY = dict(
    source_n=1024, lod_count=3, atlas=64, capacity=4096, queue=1024,
    frames=2, earth_lods=6, earth_atlas=128, earth_capacity=2048,
    earth_queue=2048, earth_face=64, raster_w=640, raster_h=360,
    raster_crop=48, bin_cap=8192, mv_capacity=16384, mv_queue=8192,
)

# Tolerances (metres). The GPU runs the same XLA program as the CPU with
# every dot pinned to exact f32 (Precision.HIGHEST), so the two differ
# only by f32 rounding order, fused multiply-adds and transcendental
# implementations.
PLANAR_ATOL = 1e-3  # CPU golden bound (tests/test_goldens.py)
# On the sphere, positions are stored in world f32 at ~6.4e6 m, where one
# ulp is 0.5 m: the Taylor anchor and the height offset are each rounded
# there, and either rounding may land one ulp apart across backends. The
# CPU golden bounds (heights 1e-3, relative positions 1e-2) hold only for
# a bit-exact regeneration; the card is held to three world ulps for
# positions and two ulps of the 9 km height range for heights.
EARTH_RADIUS = 6_371_000.0
EARTH_POS_ATOL = 3 * float(np.spacing(np.float32(EARTH_RADIUS)))  # 1.5 m
EARTH_HEIGHT_ATOL = 2 * float(np.spacing(np.float32(9000.0)))  # 1.95e-3 m
EARTH_GOLDEN_BOUNDS = (1e-3, 1e-2)  # (heights, positions), printed beside
FRUSTUM_TIE_BOUND = 8  # node-set difference allowed on the sphere
# per-vertex reference (tests/test_patch_sampling.py::test_fast_matches_exact_path)
EXACT_MEDIAN, EXACT_P99 = 0.2, 1.0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# -- shared frame helpers ---------------------------------------------------


def resident(atlas) -> bool:
    return not atlas.state.to_load and not any(
        a.loading for a in atlas.attachments
    )


def stream(update, atlas, max_frames: int = 400):
    """Call ``update()`` until the atlas has loaded everything requested."""
    for i in range(max_frames):
        out = update()
        if i >= 3 and resident(atlas):
            return out, i + 1
        time.sleep(0.005)
    raise AssertionError(f"atlas not resident after {max_frames} frames")


def replay_step(terrain, view_id, device):
    """Re-run the view's last frame step on ``device`` with the very same
    inputs (block store + packed uniforms) and program. Returns
    (tiles, mesh).

    CPU compiles are kept out of the persistent compilation cache: an
    XLA:CPU executable is tuned for the host that compiled it, and the
    cache directory may travel to another host."""
    import jax

    from bevy_terrain_tpu import Terrain

    height = terrain.atlas.attachments[0]
    cfg = terrain._last_frame_cfgs[view_id]
    blocks, blob = jax.device_put(
        (height.block_array, terrain._last_uniforms[view_id]), device
    )
    step = jax.jit(lambda b, u: Terrain._frame_step_grid(
        b, u, cfg, height.patch_plan, height.config.format.max_value)[:2])
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    if device.platform == "cpu":
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    try:
        return jax.block_until_ready(step(blocks, blob))
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_secs)


def keyed_rows(tiles, mesh, view):
    """{(side, lod, x, y): (heights (G1, G1), positions relative to view)}."""
    n = int(tiles.tile_count)
    keys = np.stack(
        [np.asarray(tiles.tile_side[:n]), np.asarray(tiles.tile_lod[:n]),
         np.asarray(tiles.tile_xy[:n, 0]), np.asarray(tiles.tile_xy[:n, 1])],
        axis=-1,
    )
    h = np.asarray(mesh.heights[:n], np.float64)
    p = np.asarray(mesh.positions[:n], np.float64) - np.asarray(view, np.float64)
    return {tuple(int(v) for v in k): (h[i], p[i]) for i, k in enumerate(keys)}


def compare_rows(a: dict, b: dict, keys):
    dh = max((np.abs(a[k][0] - b[k][0]).max() for k in keys), default=0.0)
    dp = max((np.abs(a[k][1] - b[k][1]).max() for k in keys), default=0.0)
    return float(dh), float(dp)


def frame_times(update, ready, frames: int):
    ts = []
    for _ in range(frames):
        t0 = time.perf_counter()
        out = update()
        ready(out)
        ts.append(time.perf_counter() - t0)
    return out, ts


def peak_memory_gb(device) -> float:
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use", float("nan")) / 1e9


# -- phase: planar ----------------------------------------------------------


def planar_dataset(root: Path, s: dict, seed: int, device=None):
    """Synthesize the planar source from ``seed`` and preprocess it.
    Returns (TerrainConfig, Preprocessor that ran)."""
    from bevy_terrain_tpu.config import AttachmentConfig, TerrainConfig
    from bevy_terrain_tpu.formats.tiff import array_to_source
    from bevy_terrain_tpu.preprocess import PreprocessDataset, Preprocessor
    from bevy_terrain_tpu.terrain_data import TileAtlas
    from bevy_terrain_tpu.utils.synthetic import default_height_fn

    import bench

    src = root / "source.png"
    if not src.exists():
        n = s["source_n"]
        rng = np.random.default_rng(seed)
        du, dv = rng.uniform(-0.05, 0.05, 2)
        uv = (np.arange(n) + 0.5) / n
        uu, vv = np.meshgrid(uv + du, uv + dv, indexing="xy")
        array_to_source(default_height_fn(uu, vv), src)
    config = TerrainConfig(
        lod_count=s["lod_count"], model=bench.planar_model(),
        atlas_size=s["atlas"], path="planar",
        assets_root=str(root / f"assets_{device}"),
        attachments=(AttachmentConfig(
            name="height", texture_size=bench.TEXTURE_SIZE,
            border_size=bench.BORDER, mip_level_count=bench.MIPS),),
    )
    pp = Preprocessor(TileAtlas(config), device=device)
    pp.clear_attachment(0).preprocess_tile(PreprocessDataset(
        attachment_index=0, path=str(src), lod_range=range(0, s["lod_count"]),
    )).run(verbose=False)
    return config, pp


def tile_files(config) -> dict:
    root = Path(config.assets_root) / config.path
    files = {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
             if p.is_file()}
    check(files, f"no preprocessed files under {root}")
    return files


def phase_preprocess(root: Path, s: dict, seed: int, expect_device: bool):
    """Preprocessor(device=None) must choose the device path on the card,
    and write the very files of the host path (device=False):
    tests/test_preprocess_device.py's byte-identity contract."""
    t0 = time.perf_counter()
    config, pp = planar_dataset(root, s, seed, device=None)
    t_auto = time.perf_counter() - t0
    check(pp.device == expect_device,
          f"Preprocessor(device=None) chose device={pp.device}")
    t0 = time.perf_counter()
    host_config, _ = planar_dataset(root, s, seed, device=False)
    t_host = time.perf_counter() - t0
    a, b = tile_files(config), tile_files(host_config)
    check(set(a) == set(b), "device and host paths wrote different file sets")
    diff = [k for k in a if a[k] != b[k]]
    log(f"preprocess: Preprocessor(device=None) chose the "
        f"{'device' if pp.device else 'host'} path; {len(a)} files, "
        f"{len(diff)} differ from device=False (tolerance 0); "
        f"{t_auto:.1f}s auto incl. source synthesis and compile, "
        f"{t_host:.1f}s host")
    check(not diff, "device preprocess is not byte-identical to the host path")
    return config


def phase_planar(root: Path, s: dict, seed: int, ref_device, expect_device=True,
                 card: str = "not a GPU"):
    import jax

    import bench
    from bevy_terrain_tpu import Terrain
    from bevy_terrain_tpu.config import TerrainViewConfig
    from bevy_terrain_tpu.math.approximation import TerrainModelApproximation
    from bevy_terrain_tpu.ops import meshgen, refinement
    from bevy_terrain_tpu.ops.params import make_frame_uniforms
    from bevy_terrain_tpu.utils.timing import device_time_ms

    config = phase_preprocess(root, s, seed, expect_device)
    terrain = Terrain(config)
    vc = TerrainViewConfig(tile_capacity=s["capacity"])
    terrain.add_view("cam", vc, queue_capacity=s["queue"], culling=True)
    view, vp = bench.bench_camera()

    def update():
        return terrain.update({"cam": view}, {"cam": vp})["cam"]

    def ready(out):
        jax.block_until_ready(out.mesh)

    t0 = time.perf_counter()
    ready(update())
    first_s = time.perf_counter() - t0
    out, n_stream = stream(update, terrain.atlas)
    dev_ms = device_time_ms(update) if jax.default_backend() == "gpu" else None
    # the last timed frame is the one checked below
    out, ts = frame_times(update, ready, s["frames"])
    check(out.overflow == 0, f"overflow {out.overflow}")

    # reference 1: the same jitted step, same inputs, on the CPU device
    dev = jax.devices()[0]
    got = keyed_rows(out.tiles, out.mesh, view)
    ref = keyed_rows(*replay_step(terrain, "cam", ref_device), view)
    check(set(got) == set(ref),
          f"tile sets differ from the CPU step: {len(set(got) ^ set(ref))}")
    dh, dp = compare_rows(got, ref, got)
    log(f"planar vs CPU step: {len(got)} tiles, tile set exact; max |dh| "
        f"{dh:.3e} m, max |dpos| {dp:.3e} m (tolerance {PLANAR_ATOL} m, "
        f"f32 with HIGHEST-precision dots)")
    check(dh <= PLANAR_ATOL and dp <= PLANAR_ATOL, "planar frame off the CPU step")

    # reference 2: the per-vertex gather path (meshgen.generate_mesh)
    tree = terrain.tile_trees["cam"]
    approx = TerrainModelApproximation.compute(
        config.model, view, tree.origin_lod, tree.approximate_height
    )
    u = make_frame_uniforms(
        config.model, view, approx, tree.origins, tree.entries,
        tree.view_tile_int, tree.view_tile_frac, vc, view_proj=vp,
    )
    cfg = terrain._static_cfgs["cam"]
    height = terrain.atlas.attachments[0]

    @jax.jit
    def exact_step(slab, u):
        tiles = refinement.refine_tiles(u, cfg)
        return tiles, meshgen.generate_mesh(
            tiles, slab, u, cfg, height.config.scale, height.config.offset
        )

    e_tiles, e_mesh = exact_step(height.slabs[0], u)
    n = int(e_tiles.tile_count)
    e_keys = [tuple(int(v) for v in k) for k in np.stack(
        [np.asarray(e_tiles.tile_side[:n]), np.asarray(e_tiles.tile_lod[:n]),
         np.asarray(e_tiles.tile_xy[:n, 0]), np.asarray(e_tiles.tile_xy[:n, 1])],
        axis=-1)]
    check(set(e_keys) == set(got), "per-vertex path refined another tile set")
    order = {k: i for i, k in enumerate(e_keys)}
    idx = np.array([order[k] for k in got])  # got keeps out's row order
    strip = meshgen.grid_to_strip_order(out.mesh.heights, cfg)[:len(got)]
    err = np.abs(strip - np.asarray(e_mesh.heights)[idx])
    med, p99 = float(np.median(err)), float(np.percentile(err, 99))
    log(f"planar vs per-vertex generate_mesh: median |dh| {med:.4f} m "
        f"(< {EXACT_MEDIAN}), p99 {p99:.4f} m (< {EXACT_P99}), max "
        f"{float(err.max()):.4f} m on a 250 m range")
    check(med < EXACT_MEDIAN and p99 < EXACT_P99, "per-vertex reference off")

    log(f"planar: {out.tile_count} tiles of capacity {s['capacity']}, "
        f"overflow 0, streamed in {n_stream} frames; first frame (compile "
        f"included) {first_s:.1f}s; median frame {np.median(ts) * 1e3:.3f} ms "
        f"over {len(ts)} frames (update to ready) on {card}; step device time "
        + (f"{dev_ms:.3f} ms" if dev_ms is not None else "not measured")
        + f"; peak device memory {peak_memory_gb(dev):.2f} GB")
    return terrain, out, view


# -- phase: earth -----------------------------------------------------------


def earth_terrain(root: Path, s: dict, seed: int):
    """The flagship sphere of tools/earth_frame_bench.py."""
    import bevy_terrain_tpu as bt
    from bevy_terrain_tpu.formats.tiff import array_to_source
    from bevy_terrain_tpu.math.coordinate import local_position_from_side_uv
    from bevy_terrain_tpu.models import height_attachment
    from bevy_terrain_tpu.terrain_data import TileAtlas

    radius = EARTH_RADIUS
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 0.2)
    n = s["earth_face"]
    uv = (np.arange(n) + 0.5) / n
    uu, vv = np.meshgrid(uv, uv, indexing="xy")
    grid_uv = np.stack([uu, vv], axis=-1)
    paths = []
    for side in range(6):
        p = local_position_from_side_uv(side, grid_uv)
        h = np.clip(0.5 + 0.3 * np.sin(3 * p[..., 0] + phase)
                    * np.cos(2 * p[..., 2]), 0.05, 1.0)
        path = root / f"face{side}.png"
        array_to_source(h, path)
        paths.append(str(path))
    config = bt.TerrainConfig(
        lod_count=s["earth_lods"],
        model=bt.TerrainModel.sphere(np.zeros(3), radius, 0.0, 9000.0),
        atlas_size=s["earth_atlas"], path="earth",
        assets_root=str(root / "assets_earth"),
        attachments=(height_attachment(texture_size=512, mips=4),),
    )
    bt.Preprocessor(TileAtlas(config)).clear_attachment(0).preprocess_spherical(
        bt.SphericalDataset(attachment_index=0, paths=paths,
                            lod_range=range(0, 3))
    ).run(verbose=False)
    terrain = bt.Terrain(config)
    terrain.add_view(
        "cam", bt.TerrainViewConfig(tile_capacity=s["earth_capacity"]),
        queue_capacity=s["earth_queue"], culling=True,
    )
    return terrain, radius


def phase_earth(root: Path, s: dict, seed: int, ref_device):
    import jax

    from bevy_terrain_tpu.math.frustum import view_projection
    from bevy_terrain_tpu.utils.timing import device_time_ms

    terrain, radius = earth_terrain(root, s, seed)
    view = np.array([0.0, 0.0, radius + 60_000.0])
    vp = view_projection(view, view * 0.5, np.pi / 3, 16 / 9)

    def update():
        return terrain.update({"cam": view}, {"cam": vp})["cam"]

    out, n_stream = stream(update, terrain.atlas)
    dev_ms = device_time_ms(update) if jax.default_backend() == "gpu" else None
    # the last timed frame is the one checked below
    out, ts = frame_times(update, lambda o: jax.block_until_ready(o.mesh),
                          s["frames"])
    check(out.overflow == 0, f"overflow {out.overflow}")
    got = keyed_rows(out.tiles, out.mesh, view)
    ref = keyed_rows(*replay_step(terrain, "cam", ref_device), view)
    n_diff = len(set(got) ^ set(ref))
    check(n_diff <= FRUSTUM_TIE_BOUND,
          f"node sets differ by {n_diff} (> {FRUSTUM_TIE_BOUND})")
    deep = sorted(k for k in set(got) & set(ref) if k[1] >= 10)[:192]
    check(deep, "no deep (lod >= 10) tiles near the camera")
    dh, dp = compare_rows(got, ref, deep)
    gh, gp = EARTH_GOLDEN_BOUNDS
    log(f"earth vs CPU step: {len(got)} tiles ({n_diff} differ, bound "
        f"{FRUSTUM_TIE_BOUND}); {len(deep)} deep tiles: max |dh| {dh:.3e} m "
        f"(tolerance {EARTH_HEIGHT_ATOL:.3e} = 2 f32 ulps at 9 km; CPU "
        f"golden bound {gh} {'met' if dh <= gh else 'exceeded'}), max |dpos| "
        f"relative to view {dp:.3e} m (tolerance {EARTH_POS_ATOL} = 3 f32 "
        f"ulps at the 6.4e6 m world magnitude; CPU golden bound {gp} "
        f"{'met' if dp <= gp else 'exceeded'}), f32 Taylor path")
    check(dh <= EARTH_HEIGHT_ATOL and dp <= EARTH_POS_ATOL,
          "earth frame off the CPU step")
    log(f"earth: {out.tile_count} tiles of capacity {s['earth_capacity']}, "
        f"overflow 0, streamed in {n_stream} frames; median frame "
        f"{np.median(ts) * 1e3:.3f} ms over {len(ts)} frames; step device "
        "time " + (f"{dev_ms:.3f} ms" if dev_ms is not None else "not measured"))


# -- phase: raster ----------------------------------------------------------


def shared_edges_once():
    """Two adjacent 8x8-quad tiles whose vertices sit exactly on pixel
    centers, so every edge passes through pixel centers (E == 0): each
    tile alone, and both together. Exact f32 edge functions with the
    top-left rule cover each pixel once: the tiles' coverage is disjoint,
    their union is the joint coverage, and the pixel count is the exact
    area. A rounded (TF32) edge evaluation fails the count."""
    import jax.numpy as jnp

    from bevy_terrain_tpu.render.raster import rasterize_grid

    W = H = 128  # powers of two keep the screen mapping exact
    vp = np.array([[2.0 / W, 0, 0, -1.0], [0, 0, -2.0 / H, 1.0],
                   [0, 0, 0, 0.5], [0, 0, 0, 1.0]], np.float32)
    g = np.arange(9) * 4.0 + 0.5

    def tile(x_off):
        gx, gz = np.meshgrid(g + x_off, g + 10.0, indexing="xy")
        return np.stack([gx, np.zeros_like(gx), gz], -1)[None]

    def cov(*tiles):
        pos = np.concatenate(tiles).astype(np.float32)
        out = rasterize_grid(jnp.asarray(pos), jnp.ones(len(tiles), bool),
                             jnp.asarray(vp), W, H, bin_px=16, bin_cap=512)
        return np.asarray(out.covered)

    a, b = tile(10.0), tile(42.0)
    ca, cb, cab = cov(a), cov(b), cov(a, b)
    overlap = int((ca & cb).sum())
    cracks = int((cab != (ca | cb)).sum())
    log(f"raster shared edges: tile A {int(ca.sum())} px, tile B "
        f"{int(cb.sum())} px (each exactly 32x32 = 1024), overlap "
        f"{overlap}, union mismatch {cracks}, joint {int(cab.sum())} px "
        f"(exactly 2048)")
    check(ca.sum() == 1024 and cb.sum() == 1024 and cab.sum() == 2048,
          "coverage count differs from the exact area")
    check(overlap == 0 and cracks == 0, "a shared edge drew twice or cracked")


def phase_raster(terrain, out, view, s: dict):
    """Render the settled planar frame with ``render_view`` and hold its
    coverage and depth to the scanline oracle on a crop. The camera is the
    frame's own eye pitched 45 degrees down: the frame's 60-degree forward
    view packs thousands of horizon triangles into single 32-px bins,
    past any sensible candidate budget, while this view keeps the
    triangle density at the rasterizer's design point (about a few
    hundred per bin at 1080p)."""
    import jax
    import jax.numpy as jnp

    from bevy_terrain_tpu.math.frustum import view_projection
    from bevy_terrain_tpu.render.raster import render_view
    from bevy_terrain_tpu.render.raster_reference import reference_raster

    W, H, c = s["raster_w"], s["raster_h"], s["raster_crop"]
    vp = view_projection(view, view + np.array([700.0, -700.0, 210.0]),
                         np.pi / 3, W / H)
    uniforms, cfg = terrain.frame_inputs("cam")
    render = jax.jit(lambda mesh, tiles, u, m: render_view(
        mesh, tiles, u, cfg, m, W, H, skirts=False, bin_px=32,
        bin_cap=s["bin_cap"],
    ))
    vp32 = jnp.asarray(vp, jnp.float32)
    t0 = time.perf_counter()
    img, r = jax.block_until_ready(render(out.mesh, out.tiles, uniforms, vp32))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(render(out.mesh, out.tiles, uniforms, vp32))
    again_ms = (time.perf_counter() - t0) * 1e3
    check(int(r.bin_overflow) == 0, f"bin overflow {int(r.bin_overflow)}")
    covered = np.asarray(r.covered)
    check(covered.mean() > 0.2, f"coverage {covered.mean():.3f}")
    check(np.isfinite(np.asarray(img)).all(), "non-finite pixels")
    # the crop: bottom centre, where the terrain is near and dense
    x0, y0 = W // 2 - c // 2, int(H * 0.75) - c // 2
    o = reference_raster(
        np.asarray(out.mesh.positions), np.asarray(out.mesh.tile_mask), vp,
        W, H, x0, y0, c, c,
    )
    o_tri, o_depth = o.tri_id, o.depth
    # decisive: the winner's nearest edge is more than 0.02 px away (sub-
    # pixel vertex snapping and f32 edge evaluation cannot flip it) and,
    # where triangles overlap, its depth leads the runner-up by 1e-4
    decisive = (o_tri < 0) | ((o.edge_px > 0.02) & (o.lead > 1e-4))
    g_tri = np.asarray(r.tri_id)[y0:y0 + c, x0:x0 + c]
    g_depth = np.asarray(r.depth)[y0:y0 + c, x0:x0 + c]
    frac = float(decisive.mean())
    mism = int((g_tri[decisive] != o_tri[decisive]).sum())
    cov_d = decisive & (o_tri >= 0)
    rel = np.abs(g_depth[cov_d] - o_depth[cov_d]) / np.abs(o_depth[cov_d])
    max_rel = float(rel.max()) if rel.size else 0.0
    log(f"raster {W}x{H}: coverage {covered.mean():.3f}, bin overflow 0, "
        f"near-culled {int(r.near_culled)}; first call (compile included) "
        f"{first_s:.1f}s, again {again_ms:.1f} ms. Oracle crop {c}x{c} at "
        f"({x0},{y0}): {frac:.3f} of pixels decisive, {mism} winner "
        f"mismatches (tolerance 0), max relative depth error {max_rel:.2e} "
        f"(tolerance 1e-4: f32 projection and barycentric interpolation)")
    check(frac > 0.9, "too few decisive pixels in the oracle crop")
    check(mism == 0, "coverage differs from the scanline oracle")
    check(max_rel <= 1e-4, "depth differs from the scanline oracle")
    shared_edges_once()


# -- phase: live goldens ----------------------------------------------------


def phase_goldens():
    """The GPU-only golden tests (tests/test_goldens.py, marker ``gpu``),
    in this process — one JAX process holds the card."""
    import pytest

    os.environ["BT_GPU_TESTS"] = "1"
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      str(REPO / "tests" / "test_goldens.py")])
    check(rc == 0, f"GPU golden tests failed (pytest exit {rc})")
    log("goldens: GPU live-golden tests passed")


# -- four cards -------------------------------------------------------------


def four_views():
    import bench

    view, _ = bench.bench_camera()
    offsets = [(0, 0, 0), (900.0, 60.0, 400.0), (-1200.0, 180.0, 700.0),
               (500.0, 350.0, -1500.0)]
    return {f"v{i}": view + np.array(o) for i, o in enumerate(offsets)}


def phase_four_cards(root: Path, s: dict, seed: int, devices):
    import jax

    from bevy_terrain_tpu import Terrain
    from bevy_terrain_tpu.config import TerrainViewConfig
    from bevy_terrain_tpu.parallel import MultiViewTerrain

    check(len(devices) == 4, f"need 4 devices, have {len(devices)}")
    config, _ = planar_dataset(root, s, seed, device=False)
    vc = TerrainViewConfig(tile_capacity=s["mv_capacity"])
    views = four_views()

    single = Terrain(config)
    for v in views:
        single.add_view(v, vc, queue_capacity=s["mv_queue"])
    ref, _ = stream(lambda: single.update(views), single.atlas)

    for shard in (False, True):
        mvt = MultiViewTerrain(config, list(views), devices=devices,
                               view_config=vc, queue_capacity=s["mv_queue"],
                               shard_atlas=shard)
        outs, _ = stream(lambda: mvt.update(views), mvt.atlas)
        outs, ts = frame_times(lambda: mvt.update(views),
                               lambda o: jax.block_until_ready(o["v0"]._s),
                               s["frames"])
        worst = 0.0
        for v in views:
            a = keyed_rows(outs[v].tiles, outs[v].mesh, views[v])
            b = keyed_rows(ref[v].tiles, ref[v].mesh, views[v])
            check(int(outs[v].tiles.overflow) == 0 and ref[v].overflow == 0,
                  f"{v}: overflow {int(outs[v].tiles.overflow)} (multi-view), "
                  f"{ref[v].overflow} (Terrain)")
            check(set(a) == set(b), f"{v}: tile set differs from Terrain")
            dh, _ = compare_rows(a, b, a)
            worst = max(worst, dh)
        stats = mvt.audit_step()
        mode = "sharded" if shard else "replicated"
        log(f"four cards, {mode} atlas: {[outs[v].tile_count for v in views]} "
            f"tiles per view, max |dh| vs single-device Terrain {worst:.3e} m "
            f"(tolerance 2e-3); collectives {stats or 'none'}; median 4-view "
            f"frame {np.median(ts) * 1e3:.3f} ms")
        check(worst <= 2e-3, f"{mode}: heights differ from Terrain")
        if not shard:
            check(not stats, f"replicated step has collectives: {stats}")


# -- entry ------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic datasets")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the MultiViewTerrain path on four cards")
    args = ap.parse_args(argv)

    import jax

    from bevy_terrain_tpu.utils.device import card_info, device_summary, require_gpu

    require_gpu()
    from bevy_terrain_tpu import native
    from bevy_terrain_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    dev = device_summary()
    card = card_info()
    log(card)
    log(f"jax {jax.__version__}; {dev['count']} x {dev['kind']} "
        f"({dev['platform']}); compile cache {cache}")
    log(f"native runtime: {'loaded' if native.available() else 'NOT loaded'}"
        + ("" if native.available() else f" ({native.build_error()})"))
    check(native.available(), "the native runtime did not load")

    cpu = jax.devices("cpu")[0]
    s = FULL
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        if args.four_cards:
            t0 = time.perf_counter()
            phase_four_cards(root, s, args.seed, jax.devices()[:4])
            log(f"phase four_cards ok ({time.perf_counter() - t0:.1f}s)")
        else:
            t0 = time.perf_counter()
            terrain, out, view = phase_planar(root, s, args.seed, cpu,
                                              card=card)
            log(f"phase planar ok ({time.perf_counter() - t0:.1f}s)")
            t0 = time.perf_counter()
            phase_raster(terrain, out, view, s)
            log(f"phase raster ok ({time.perf_counter() - t0:.1f}s)")
            del terrain, out
            t0 = time.perf_counter()
            phase_earth(root, s, args.seed, cpu)
            log(f"phase earth ok ({time.perf_counter() - t0:.1f}s)")
            t0 = time.perf_counter()
            phase_goldens()
            log(f"phase goldens ok ({time.perf_counter() - t0:.1f}s)")
    if args.four_cards:
        dev = dict(dev, count=4)
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
