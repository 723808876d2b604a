"""Generate the committed golden fixtures (tests/goldens/*.npz).

SURVEY section 4 / BASELINE's bit-comparability north star: with cargo
unavailable, the anchor for cross-round regressions is a COMMITTED capture
of node-selection lists and strip-order mesh buffers on fixed camera
frames, produced by this script and compared exactly (integers) /
tightly (f32 buffers) by tests/test_goldens.py every run.

Regenerate ONLY when a change intentionally alters node selection or mesh
output, and say so in the commit: ``python tools/make_goldens.py``.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

GOLDEN_DIR = Path(__file__).resolve().parent.parent / "tests" / "goldens"


def node_selection_cases():
    """Pure-refinement cases: (name, model, view, lods, caps)."""
    from bevy_terrain_tpu.math import TerrainModel

    planar = TerrainModel.planar(np.array([0.0, -100.0, 0.0]), 1000.0, 0.0, 250.0)
    sphere = TerrainModel.sphere(np.zeros(3), 6.4e6, 0.0, 9000.0)
    return [
        ("nodes_planar_overview", planar, np.array([100.0, 50.0, -200.0]), 8),
        ("nodes_planar_ground", planar, np.array([-380.0, -70.0, 310.0]), 8),
        (
            "nodes_sphere_approach",
            sphere,
            sphere.position_local_to_world(
                np.array([0.35, 0.2, 0.91]) / np.linalg.norm([0.35, 0.2, 0.91]),
                3000.0,
            ),
            8,
        ),
    ]


def frame_inputs(model, view_config, view_pos, lod_count, queue_capacity):
    """(StaticTerrainConfig, FrameUniforms) of a refinement-only frame in
    which every tile-tree slot reports the root tile loaded at slot 0."""
    from bevy_terrain_tpu.math import TerrainModelApproximation
    from bevy_terrain_tpu.ops import tile_tree
    from bevy_terrain_tpu.ops.params import StaticTerrainConfig, make_frame_uniforms

    cfg = StaticTerrainConfig(
        spherical=model.is_spherical, side_count=model.side_count,
        lod_count=lod_count, tree_size=view_config.tree_size,
        grid_size=view_config.grid_size,
        refinement_count=view_config.refinement_count,
        tile_capacity=view_config.tile_capacity,
        origin_lod=view_config.origin_lod, queue_capacity=queue_capacity,
    )
    origins, vt_int, vt_frac = tile_tree.compute_view_anchors(
        model, view_pos, lod_count, view_config.tree_size
    )
    approx = TerrainModelApproximation.compute(
        model, view_pos, view_config.origin_lod,
        (model.min_height + model.max_height) / 2,
    )
    entries = np.zeros(
        (model.side_count, lod_count, cfg.tree_size, cfg.tree_size, 2), np.int32
    )
    return cfg, make_frame_uniforms(
        model, view_pos, approx, origins, entries, vt_int, vt_frac, view_config
    )


def refine_nodes(model, view, lods):
    import jax

    from bevy_terrain_tpu.config import TerrainViewConfig
    from bevy_terrain_tpu.ops import refinement

    vc = TerrainViewConfig(tile_capacity=32768)
    cfg, uniforms = frame_inputs(model, vc, view, lods, queue_capacity=32768)
    tiles = jax.jit(refinement.refine_tiles, static_argnames="cfg")(uniforms, cfg)
    n = int(tiles.tile_count)
    assert int(tiles.overflow) == 0
    nodes = np.stack(
        [
            np.asarray(tiles.tile_side[:n]),
            np.asarray(tiles.tile_lod[:n]),
            np.asarray(tiles.tile_xy[:n, 0]),
            np.asarray(tiles.tile_xy[:n, 1]),
        ],
        axis=-1,
    ).astype(np.int32)
    # a tile list is a set: canonicalize by lexicographic sort
    order = np.lexsort(nodes.T[::-1])
    return nodes[order]


def _capture_streamed(terrain, view, view_proj=None):
    """Stream to quiescence, then capture (sorted nodes, strip heights,
    strip positions RELATIVE to the view) from one frame."""
    from bevy_terrain_tpu.ops import meshgen

    vps = {"cam": view_proj} if view_proj is not None else None
    for _ in range(60):
        out = terrain.update({"cam": view}, vps)
        if not terrain.atlas.state.to_load and not any(
            a.loading for a in terrain.atlas.attachments
        ):
            break
        time.sleep(0.01)
    out = terrain.update({"cam": view}, vps)["cam"]
    n = out.tile_count
    assert out.overflow == 0
    nodes = np.stack(
        [
            np.asarray(out.tiles.tile_side[:n]),
            np.asarray(out.tiles.tile_lod[:n]),
            np.asarray(out.tiles.tile_xy[:n, 0]),
            np.asarray(out.tiles.tile_xy[:n, 1]),
        ],
        axis=-1,
    ).astype(np.int32)
    order = np.lexsort(nodes.T[::-1])
    cfg = terrain._last_cfgs.get("cam", terrain._static_cfgs["cam"])
    heights = meshgen.grid_to_strip_order(out.mesh.heights, cfg)[:n][order]
    positions = meshgen.grid_to_strip_order(out.mesh.positions, cfg)[:n][order]
    relative = positions - np.asarray(view, np.float64)
    return nodes[order], heights.astype(np.float32), relative.astype(np.float32)


def mesh_case(tmp_root):
    """Streamed planar frame -> (sorted nodes, strip heights, relative
    positions).

    blend_per_vertex pins the reference's per-vertex crossfade. One
    committed capture anchors both the CPU regeneration (exact) and the
    live-GPU frame (tests/test_goldens.py::TestGpuLiveGoldens).
    """
    from bevy_terrain_tpu import (
        AttachmentConfig, Terrain, TerrainConfig, TerrainModel, TerrainViewConfig,
    )
    from bevy_terrain_tpu.utils.synthetic import generate_planar_dataset

    att = AttachmentConfig(
        name="height", texture_size=512, border_size=2, mip_level_count=4
    )
    generate_planar_dataset("terrains/golden", 3, att, root=str(tmp_root))
    config = TerrainConfig(
        lod_count=3,
        model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
        atlas_size=128, path="terrains/golden", attachments=(att,),
        assets_root=str(tmp_root),
    )
    terrain = Terrain(config)
    terrain.add_view(
        "cam",
        TerrainViewConfig(tile_capacity=512, morph_distance=4.0, blend_distance=1.5),
        queue_capacity=2048,
        blend_per_vertex=True,
    )
    view = np.array([-120.0, 90.0, 160.0])
    return _capture_streamed(terrain, view)


def mesh_spherical_case(tmp_root):
    """Streamed FLAGSHIP spherical frame capture: Earth radius, geometry
    lods to 13 over 3 data lods, Taylor hp path, 60-degree culled camera
    at 60 km — the tools/earth_frame_bench.py configuration, where the
    f32 precision of the Taylor path is exercised hardest.

    Positions are stored relative to the camera (world f32 at 6.4e6 m
    carries ~0.5 m quantization by itself). Geometry tile size sets the
    noise floor of any cross-backend comparison (a morph-distance ulp
    shifts a vertex by a fraction of its GEOMETRY cell), so the committed
    buffers cover the DEEP subset (lod >= 10: cells <= 300 m) — see
    spherical_deep_subset; the full node list is still committed exactly.
    """
    from bevy_terrain_tpu import (
        AttachmentConfig, SphericalDataset, Preprocessor, Terrain,
        TerrainConfig, TerrainModel, TerrainViewConfig,
    )
    from bevy_terrain_tpu.formats.tiff import array_to_source
    from bevy_terrain_tpu.math.coordinate import local_position_from_side_uv
    from bevy_terrain_tpu.math.frustum import view_projection
    from bevy_terrain_tpu.terrain_data import TileAtlas

    radius = 6.371e6
    model = TerrainModel.sphere(np.zeros(3), radius, 0.0, 9000.0)
    att = AttachmentConfig(
        name="height", texture_size=512, border_size=2, mip_level_count=4
    )
    config = TerrainConfig(
        lod_count=13, model=model, atlas_size=512, path="terrains/golden_sph",
        attachments=(att,), assets_root=str(tmp_root),
    )
    n = 256
    uv = (np.arange(n) + 0.5) / n
    uu, vv = np.meshgrid(uv, uv, indexing="xy")
    grid_uv = np.stack([uu, vv], axis=-1)
    paths = []
    src = Path(tmp_root) / "src"
    src.mkdir(parents=True, exist_ok=True)
    for side in range(6):
        p = local_position_from_side_uv(side, grid_uv)
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        h = np.clip(
            0.45 + 0.25 * np.sin(3 * x + 1) * np.cos(4 * y)
            + 0.18 * np.sin(5 * z + 2), 0.02, 1.0,
        )
        path = src / f"face{side}.png"
        array_to_source(h, path)
        paths.append(str(path))
    atlas = TileAtlas(config)
    Preprocessor(atlas).clear_attachment(0).preprocess_spherical(
        SphericalDataset(attachment_index=0, paths=paths, lod_range=range(0, 3))
    ).run(verbose=False)

    terrain = Terrain(config)
    terrain.add_view(
        "cam", TerrainViewConfig(tile_capacity=2048), queue_capacity=2048,
        culling=True, blend_per_vertex=True,
    )
    view = np.array([0.0, 0.0, radius + 60_000.0])
    vp = view_projection(view, view * 0.5, np.pi / 3, 16 / 9)
    return _capture_streamed(terrain, view, view_proj=vp)


def spherical_deep_subset(nodes, heights, positions, min_lod=10, cap=192):
    """Deterministic committed-buffer subset: the first ``cap`` tiles (in
    canonical node-sorted order) with geometry lod >= ``min_lod`` — near
    the camera, cells <= ~300 m, where cross-backend comparison measures
    KERNEL precision rather than morph-threshold noise on planet-sized
    cells."""
    idx = np.nonzero(nodes[:, 1] >= min_lod)[0][:cap]
    return nodes[idx], heights[idx], positions[idx]


def backend_nodes() -> None:
    """Write per-backend node goldens ``{name}.{backend}.npz`` for cases
    where the CURRENT backend's integer selection differs from the base
    (CPU) golden.

    Needed because f32 at planetary scale is backend-dependent: on the
    6.4e6 m sphere the view distance survives a large cancellation
    (|world - view| ~ 3e3 from operands ~6e6), so CPU and GPU land
    metres apart (~1e-3 relative) and tiles whose subdivision margin is
    inside that envelope flip. Node selections stay EXACT per backend;
    tests/test_goldens.py loads the backend-suffixed file when present
    (cross-backend flips are pinned to threshold ties by
    TestNodeSelectionGoldens::test_cross_backend_flips_are_threshold_ties).
    """
    import jax

    backend = jax.default_backend()
    GOLDEN_DIR.mkdir(parents=True, exist_ok=True)
    for name, model, view, lods in node_selection_cases():
        nodes = refine_nodes(model, view, lods)
        base = np.load(GOLDEN_DIR / f"{name}.npz")["nodes"]
        out = GOLDEN_DIR / f"{name}.{backend}.npz"
        if nodes.shape == base.shape and (nodes == base).all():
            if out.exists():
                out.unlink()
            print(f"{name}: matches base golden on {backend}; no suffix file")
        else:
            np.savez_compressed(out, nodes=nodes)
            print(f"{name}: {len(nodes)} nodes on {backend} "
                  f"(base {len(base)}) -> {out.name}")


def main() -> None:
    # goldens are platform-pinned: generated AND compared on the CPU
    # backend (the tests run under conftest's CPU forcing; the GPU's f32
    # output is validated against these separately with tolerances)
    import jax

    jax.config.update("jax_platforms", "cpu")
    GOLDEN_DIR.mkdir(parents=True, exist_ok=True)
    for name, model, view, lods in node_selection_cases():
        nodes = refine_nodes(model, view, lods)
        np.savez_compressed(GOLDEN_DIR / f"{name}.npz", nodes=nodes)
        print(f"{name}: {len(nodes)} nodes")
    with tempfile.TemporaryDirectory() as tmp:
        nodes, heights, positions = mesh_case(Path(tmp))
    np.savez_compressed(
        GOLDEN_DIR / "mesh_planar_streamed.npz",
        nodes=nodes, heights=heights, positions=positions,
    )
    print(f"mesh_planar_streamed: {len(nodes)} tiles, strip {heights.shape}")
    with tempfile.TemporaryDirectory() as tmp:
        nodes, heights, positions = mesh_spherical_case(Path(tmp))
    dn, dh, dp = spherical_deep_subset(nodes, heights, positions)
    np.savez_compressed(
        GOLDEN_DIR / "mesh_spherical_streamed.npz",
        nodes=nodes, deep_nodes=dn, deep_heights=dh, deep_positions=dp,
    )
    print(
        f"mesh_spherical_streamed: {len(nodes)} tiles "
        f"({len(dn)} deep committed), strip {dh.shape}"
    )


if __name__ == "__main__":
    if "--backend-nodes" in sys.argv:
        backend_nodes()
    else:
        main()
