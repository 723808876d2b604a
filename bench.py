"""Driver benchmark: quadtree update + tile mesh generation per frame/view.

The planar headline: an 8k^2 heightmap with 512^2 tiles (508-texel
centers) is lod_count 5 (16x16 finest tiles); the per-frame device work is
the jitted refinement -> CDLOD mesh-gen step over the streamed atlas
block store, under a 60-degree culling camera.

Runs on a GPU only (``main`` exits non-zero on any other backend). Prints
the device on a ``#`` line, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline"} where vs_baseline is the
speedup against BASELINE.json's 1 ms/frame bound (>1 means faster; the
reference publishes no numbers of its own, BASELINE.md). Diagnostics go
to stderr.

    python bench.py
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

TEXTURE_SIZE, BORDER, MIPS = 512, 2, 4
LOD_COUNT = 5  # finest lod: 16x16 tiles x 508 texels ~= 8k^2 heightmap
SIDE = 8000.0
ATLAS_SLOTS = 1024


def planar_model():
    from bevy_terrain_tpu.math import TerrainModel

    return TerrainModel.planar(np.zeros(3), SIDE, 0.0, 250.0)


def bench_camera():
    """The headline view and its 60-degree forward frustum (8173 -> 2582
    tiles under culling on this frame)."""
    from bevy_terrain_tpu.math import frustum

    view = np.array([SIDE * 0.03, 120.0, -SIDE * 0.02])
    view_proj = frustum.view_projection(
        view, view + np.array([1000.0, -40.0, 300.0]), np.pi / 3, 16 / 9
    )
    return view, view_proj


def build_frame(tile_capacity: int = 4096, queue_capacity: int = 1024,
                seed: int = 0, atlas_slots: int = ATLAS_SLOTS):
    """The headline frame step on a fully streamed synthetic state.

    Returns ``(frame, args, cfg)``: ``frame`` is the jitted
    refinement -> ``generate_mesh_grid`` step, ``args`` its (block store,
    uniforms) arguments. Every tile-tree slot points at a random loaded
    atlas slot; the block store holds random 16-bit texels."""
    import jax
    import jax.numpy as jnp

    from bevy_terrain_tpu.config import TerrainViewConfig
    from bevy_terrain_tpu.math import TerrainModelApproximation
    from bevy_terrain_tpu.ops import meshgen, patch_sampling, refinement
    from bevy_terrain_tpu.ops import tile_tree as tile_tree_ops
    from bevy_terrain_tpu.ops.params import StaticTerrainConfig, make_frame_uniforms

    model = planar_model()
    # capacity sized with ~1.6x headroom over the culled frame's 2582
    # tiles; the overflow counter guards the honesty of the static bound
    vc = TerrainViewConfig(tile_capacity=tile_capacity)
    cfg = StaticTerrainConfig(
        spherical=False,
        side_count=1,
        lod_count=LOD_COUNT,
        tree_size=vc.tree_size,
        grid_size=vc.grid_size,
        refinement_count=vc.refinement_count,
        # the queue only handles the spill BEYOND the dense refinement
        # levels (a few hundred tiles/level here); overflow guards it
        queue_capacity=queue_capacity,
        tile_capacity=vc.tile_capacity,
        origin_lod=vc.origin_lod,
        culling=True,
    )
    view, view_proj = bench_camera()
    origins, vt_int, vt_frac = tile_tree_ops.compute_view_anchors(
        model, view, LOD_COUNT, vc.tree_size
    )
    approx = TerrainModelApproximation.compute(model, view, vc.origin_lod, 125.0)
    rng = np.random.default_rng(seed)
    S, L, T = 1, LOD_COUNT, vc.tree_size
    entries = np.zeros((S, L, T, T, 2), np.int32)
    entries[..., 0] = rng.integers(0, atlas_slots, (S, L, T, T))
    entries[..., 1] = np.arange(L)[None, :, None, None]
    uniforms = make_frame_uniforms(
        model, view, approx, origins, entries, vt_int, vt_frac, vc,
        view_proj=view_proj,
    )
    plan = patch_sampling.make_patch_plan(TEXTURE_SIZE, MIPS, BORDER)
    blocks = jnp.asarray(
        rng.integers(
            0, 65535, (atlas_slots * plan.total_blocks_per_slot, 32, 128)
        ).astype(np.int32)
    )

    def _frame(block_array, u):
        tiles = refinement.refine_tiles(u, cfg)
        mesh, tiles = meshgen.generate_mesh_grid(
            tiles, block_array, u, cfg, plan, 65535.0
        )
        return tiles, mesh

    return jax.jit(_frame), (blocks, uniforms), cfg


def _streamed_terrain(tmp: Path):
    """A real streamed dataset for the end-to-end frame (2048^2 source)."""
    from bevy_terrain_tpu import Terrain
    from bevy_terrain_tpu.config import (
        AttachmentConfig, TerrainConfig, TerrainViewConfig,
    )
    from bevy_terrain_tpu.formats.tiff import array_to_source
    from bevy_terrain_tpu.preprocess import PreprocessDataset, Preprocessor
    from bevy_terrain_tpu.terrain_data import TileAtlas
    from bevy_terrain_tpu.utils.synthetic import default_height_fn

    n = 2048
    uv01 = (np.arange(n) + 0.5) / n
    uu, vv = np.meshgrid(uv01, uv01, indexing="xy")
    array_to_source(default_height_fn(uu, vv), tmp / "src.png")
    config = TerrainConfig(
        lod_count=LOD_COUNT, model=planar_model(), atlas_size=ATLAS_SLOTS,
        path="e2e", assets_root=str(tmp / "assets"),
        attachments=(AttachmentConfig(
            name="height", texture_size=TEXTURE_SIZE, border_size=BORDER,
            mip_level_count=MIPS),),
    )
    Preprocessor(TileAtlas(config), device=False).clear_attachment(
        0
    ).preprocess_tile(
        PreprocessDataset(attachment_index=0, path=str(tmp / "src.png"),
                          lod_range=range(0, LOD_COUNT))
    ).run(verbose=False)
    terrain = Terrain(config)
    terrain.add_view(
        "cam", TerrainViewConfig(tile_capacity=4096),
        queue_capacity=1024, culling=True,
    )
    return terrain


def _end_to_end(tmp: Path) -> None:
    """The streamed frame as a caller of Terrain.update sees it: host
    prologue + dispatch, and the step's device time."""
    import jax

    from bevy_terrain_tpu.utils.timing import device_time_ms

    terrain = _streamed_terrain(tmp)
    view, view_proj = bench_camera()
    for i in range(300):
        out = terrain.update({"cam": view}, {"cam": view_proj})
        if i > 3 and not terrain.atlas.state.to_load and not any(
            a.loading for a in terrain.atlas.attachments
        ):
            break
    host_ts, wall_ts = [], []
    for _ in range(30):
        t0 = time.perf_counter()
        out = terrain.update({"cam": view}, {"cam": view_proj})
        host_ts.append(time.perf_counter() - t0)  # async dispatch returns
        jax.block_until_ready(out["cam"].mesh)
        wall_ts.append(time.perf_counter() - t0)
    dev_us = device_time_ms(
        lambda: terrain.update({"cam": view}, {"cam": view_proj})
    ) * 1e3
    print(
        f"# end-to-end streamed frame: host prologue+dispatch "
        f"{np.median(host_ts) * 1e6:.1f}us, wall to ready "
        f"{np.median(wall_ts) * 1e6:.1f}us, step device {dev_us:.1f}us "
        f"(tiles={out['cam'].tile_count}, overflow={out['cam'].overflow})",
        file=sys.stderr,
    )


def _preprocess(tmp: Path) -> None:
    """Preprocess throughput of the auto-selected path against the pinned
    single-thread numpy reference (BASELINE.md's comparator); every path
    writes byte-identical .bin files (tests/test_preprocess_device.py)."""
    from bevy_terrain_tpu.config import AttachmentConfig, TerrainConfig
    from bevy_terrain_tpu.formats.tiff import array_to_source
    from bevy_terrain_tpu.preprocess import PreprocessDataset, Preprocessor
    from bevy_terrain_tpu.terrain_data import TileAtlas
    from bevy_terrain_tpu.utils.synthetic import default_height_fn

    n = 1024
    uv01 = (np.arange(n) + 0.5) / n
    uu, vv = np.meshgrid(uv01, uv01, indexing="xy")
    array_to_source(default_height_fn(uu, vv), tmp / "src.png")
    config = TerrainConfig(
        lod_count=4, model=planar_model(), atlas_size=256, path="bench_pp",
        assets_root=str(tmp / "assets"),
        attachments=(AttachmentConfig(
            name="height", texture_size=TEXTURE_SIZE, border_size=BORDER,
            mip_level_count=MIPS),),
    )

    def run_pp(device, naive: bool = False):
        atlas = TileAtlas(config)
        t0 = time.perf_counter()
        pp = Preprocessor(atlas, device=device, naive=naive)
        pp.clear_attachment(0).preprocess_tile(
            PreprocessDataset(attachment_index=0, path=str(tmp / "src.png"),
                              lod_range=range(0, 4))
        ).run(verbose=False)
        return len(atlas.state.existing_tiles), time.perf_counter() - t0, pp.device

    run_pp(None)  # warm jit/import caches before timing
    n_tiles, dt_prod, used_device = min(
        (run_pp(None) for _ in range(2)), key=lambda r: r[1]
    )
    _, dt_naive, _ = run_pp(False, naive=True)
    label = "device" if used_device else "host-c++"
    print(
        f"# preprocess: {n_tiles} tiles ({TEXTURE_SIZE}^2 R16, 4 lods) "
        f"{label} {n_tiles / dt_prod:.1f} tiles/s vs naive-cpu-reference "
        f"{n_tiles / dt_naive:.1f} tiles/s (vs_cpu {dt_naive / dt_prod:.2f}x)",
        file=sys.stderr,
    )


def main() -> None:
    import jax

    from bevy_terrain_tpu.utils.device import card_info, device_summary, require_gpu

    require_gpu()
    from bevy_terrain_tpu.utils.compile_cache import enable_compile_cache
    from bevy_terrain_tpu.utils.timing import device_time_ms

    enable_compile_cache()
    dev = device_summary()
    print(f"# platform={dev['platform']} device_kind={dev['kind']} "
          f"count={dev['count']} card={card_info()}")

    frame, args, cfg = build_frame()
    tiles, _ = jax.block_until_ready(frame(*args))
    median_us = device_time_ms(frame, *args) * 1e3
    print(
        f"# tiles={int(tiles.tile_count)} overflow={int(tiles.overflow)} "
        f"verts/tile={cfg.vertices_per_tile} frame={median_us:.1f}us",
        file=sys.stderr,
    )
    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        (Path(tmp) / "e2e").mkdir()
        (Path(tmp) / "pp").mkdir()
        _end_to_end(Path(tmp) / "e2e")
        _preprocess(Path(tmp) / "pp")
    print(
        json.dumps(
            {
                "metric": "quadtree_update_plus_meshgen_per_frame_per_view_8k2",
                "value": round(median_us, 2),
                "unit": "us",
                "vs_baseline": round(1000.0 / median_us, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
