"""Planar terrain with an albedo attachment and a custom material.

Twin of reference examples/planar.rs (custom material sampling a color
attachment, debug views). Self-contained: synthesizes height + albedo
sources and preprocesses both attachments on first run.

    python examples/planar.py [--assets DIR]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bevy_terrain_tpu import (
    PreprocessDataset,
    Preprocessor,
    Terrain,
    TerrainConfig,
    TerrainModel,
    TerrainViewConfig,
)
from bevy_terrain_tpu.formats.tiff import array_to_source
from bevy_terrain_tpu.models import albedo_attachment, height_attachment
from bevy_terrain_tpu.terrain_data import TileAtlas

PATH = "terrains/planar_albedo"
SIZE = 1000.0
HEIGHT = 250.0
LOD_COUNT = 3


def height_field(u, v):
    return np.clip(
        0.5 + 0.3 * np.sin(2 * np.pi * 2 * u) * np.cos(2 * np.pi * 3 * v), 0.02, 1.0
    )


def albedo_field(u, v):
    """RGB from a simple biome colormap over the height field."""
    h = height_field(u, v)
    r = np.clip(1.8 * h - 0.4, 0.05, 1.0)
    g = np.clip(1.2 - 1.5 * np.abs(h - 0.45), 0.05, 1.0)
    b = np.clip(0.9 - h, 0.05, 1.0)
    a = np.ones_like(h)
    return np.stack([r, g, b, a], axis=-1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--assets", default="assets")
    args = ap.parse_args()

    config = TerrainConfig(
        lod_count=LOD_COUNT,
        model=TerrainModel.planar(np.zeros(3), SIZE, 0.0, HEIGHT),
        atlas_size=256,
        path=PATH,
        assets_root=args.assets,
        attachments=(height_attachment(), albedo_attachment()),
    )

    manifest = Path(args.assets) / PATH / "config.tc"
    if not manifest.exists():
        n = 1024
        uv = (np.arange(n) + 0.5) / n
        uu, vv = np.meshgrid(uv, uv, indexing="xy")
        src_dir = Path(args.assets) / "source"
        src_dir.mkdir(parents=True, exist_ok=True)
        array_to_source(height_field(uu, vv), src_dir / "pa_height.png")
        from bevy_terrain_tpu.formats.tiff import write_png

        rgba = (albedo_field(uu, vv) * 255).astype(np.uint8)
        write_png(src_dir / "pa_albedo.png", rgba)

        atlas = TileAtlas(config)
        pre = Preprocessor(atlas).clear_attachment(0)
        pre.preprocess_tile(
            PreprocessDataset(attachment_index=0, path=str(src_dir / "pa_height.png"),
                              lod_range=range(0, LOD_COUNT))
        )
        pre.preprocess_tile(
            PreprocessDataset(attachment_index=1, path=str(src_dir / "pa_albedo.png"),
                              lod_range=range(0, LOD_COUNT))
        )
        pre.run()

    terrain = Terrain(config)
    terrain.add_view("camera", TerrainViewConfig(tile_capacity=2048), queue_capacity=4096)

    # the reference example's custom TerrainMaterial (examples/planar.rs +
    # assets/shaders/planar.wgsl): ALBEDO branch = color straight from the
    # albedo attachment, fetched INSIDE the frame step, lit by the PBR
    # stage
    from bevy_terrain_tpu import StandardMaterial, albedo_material, gradient_material

    terrain.set_shading(
        material=StandardMaterial(base_color=albedo_material(1)),
        lighting=True,
        sample_attachments=(1,),
    )
    view = np.array([120.0, 200.0, -150.0])
    out = None
    for _ in range(40):
        out = terrain.update({"camera": view})["camera"]
        if not terrain.atlas.state.to_load and not any(
            a.loading for a in terrain.atlas.attachments
        ):
            break
        time.sleep(0.02)
    out = terrain.update({"camera": view})["camera"]

    lit = np.asarray(out.colors)[np.asarray(out.mesh.tile_mask)]
    print(f"tiles={out.tile_count} lit RGBA shape={out.colors.shape}")
    print(f"lit mean RGB = {lit[..., :3].reshape(-1, 3).mean(axis=0)}")

    # the non-ALBEDO branch: gradient LUT at pow(height, 0.9)
    terrain.set_shading(material=gradient_material(), lighting=True)
    out_g = terrain.update({"camera": view})["camera"]
    g = np.asarray(out_g.colors)[np.asarray(out_g.mesh.tile_mask)]
    print(f"gradient-material mean RGB = {g[..., :3].reshape(-1, 3).mean(axis=0)}")

    albedo = terrain.sample_attachment_grid("camera", out, attachment_index=1)
    a = np.asarray(albedo)[np.asarray(out.mesh.tile_mask)]
    print(f"albedo grid shape={albedo.shape}")
    print(f"albedo mean RGB = {a[..., :3].reshape(-1, 3).mean(axis=0)}")

    # sanity: compare a vertex's sampled albedo against the analytic colormap
    pos = np.asarray(out.mesh.positions)[np.asarray(out.mesh.tile_mask)]
    u = pos[..., 0] / SIZE + 0.5
    v = pos[..., 2] / SIZE + 0.5
    expect = albedo_field(u, v)
    err = np.abs(a[..., :3] - expect[..., :3])
    print(f"albedo vs analytic: median err {np.median(err):.4f} (0..1 scale)")


if __name__ == "__main__":
    main()
