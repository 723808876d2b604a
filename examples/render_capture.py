"""Render terrain views to PNG images with the JAX rasterizer.

The reference's examples open a bevy window and rasterize on the GPU;
this is the same visual result as files — per-pixel PBR shading plus the
debug views (debug.wgsl's palette) — produced entirely by
``bevy_terrain_tpu.render.raster`` (binning + matmul edge functions +
perspective-correct resolve).

    python examples/render_capture.py [--assets DIR] [--out DIR] [--size N]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bevy_terrain_tpu import (
    StandardMaterial,
    Terrain,
    TerrainConfig,
    TerrainModel,
    TerrainViewConfig,
)
from bevy_terrain_tpu.math.frustum import view_projection

SIZE = 1000.0
HEIGHT = 180.0


def terrain_height(u, v):
    ridge = np.abs(np.sin(2 * np.pi * 1.5 * u) * np.cos(2 * np.pi * 1.0 * v))
    bowl = ((u - 0.5) ** 2 + (v - 0.5) ** 2) * 1.2
    return np.clip(0.25 + 0.55 * ridge - bowl, 0.02, 1.0)


def save_png(img, path):
    from bevy_terrain_tpu.formats.tiff import write_png

    arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    write_png(path, arr)
    print(f"wrote {path}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--assets", default="assets")
    ap.add_argument("--out", default="captures")
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args()
    Path(args.out).mkdir(parents=True, exist_ok=True)

    from bevy_terrain_tpu.models import albedo_attachment, height_attachment

    config = TerrainConfig(
        lod_count=3,
        model=TerrainModel.planar(np.zeros(3), SIZE, 0.0, HEIGHT),
        atlas_size=64, path="terrains/capture",
        attachments=(height_attachment(), albedo_attachment()),
        assets_root=args.assets,
    )
    manifest = Path(args.assets) / "terrains/capture" / "config.tc"
    if not manifest.exists():
        from bevy_terrain_tpu import PreprocessDataset, Preprocessor
        from bevy_terrain_tpu.formats.tiff import array_to_source, write_png
        from bevy_terrain_tpu.terrain_data import TileAtlas

        n = 1024
        g = (np.arange(n) + 0.5) / n
        uu, vv = np.meshgrid(g, g, indexing="xy")
        h = terrain_height(uu, vv)
        # biome colormap over the height field
        rgba = np.stack(
            [
                np.clip(0.45 + 0.8 * (h - 0.35), 0.1, 1.0),  # rock/ridge
                np.clip(0.75 - 0.9 * np.abs(h - 0.4), 0.12, 1.0),  # grass
                np.clip(0.55 - h, 0.08, 0.9),  # water-ish lows
                np.ones_like(h),
            ],
            -1,
        )
        src = Path(args.assets) / "source"
        src.mkdir(parents=True, exist_ok=True)
        array_to_source(h, src / "capture_height.png")
        write_png(src / "capture_albedo.png", (rgba * 255).astype(np.uint8))
        pre = Preprocessor(TileAtlas(config)).clear_attachment(0)
        pre.preprocess_tile(PreprocessDataset(
            attachment_index=0, path=str(src / "capture_height.png"),
            lod_range=range(0, 3),
        ))
        pre.preprocess_tile(PreprocessDataset(
            attachment_index=1, path=str(src / "capture_albedo.png"),
            lod_range=range(0, 3),
        ))
        pre.run()
    terrain = Terrain(config)
    # density matched to the capture resolution (see rasterize_grid's
    # sizing note): ~size/128 tiles of 16x16 quads across the view
    terrain.add_view(
        "cam",
        TerrainViewConfig(tile_capacity=2048, morph_distance=8.0),
        queue_capacity=4096,
    )
    from bevy_terrain_tpu import DirectionalLight, albedo_material

    # PBR radiometric output is unexposed linear light (bevy tonemaps);
    # boost illuminance + ambient so the raw capture reads well
    terrain.set_shading(
        material=StandardMaterial(
            base_color=albedo_material(1),
            metallic=0.05, perceptual_roughness=0.85,
            lights=(DirectionalLight(illuminance=3.0),),
            ambient=(0.18, 0.18, 0.2),
        ),
        lighting=True,
        sample_attachments=(1,),
    )

    eye = np.array([-320.0, 260.0, -420.0])
    target = np.array([60.0, 0.0, 40.0])
    out = None
    for _ in range(60):
        out = terrain.update({"cam": eye})["cam"]
        if not terrain.atlas.state.to_load and not any(
            a.loading for a in terrain.atlas.attachments
        ):
            break
        time.sleep(0.02)
    out = terrain.update({"cam": eye})["cam"]
    print(f"tiles={out.tile_count} overflow={out.overflow}")

    vp = view_projection(
        eye=eye, target=target, fov_y=np.radians(55.0),
        aspect=1.0, near=0.5,
    )
    import jax.numpy as jnp

    vp32 = jnp.asarray(vp, jnp.float32)
    W = H = args.size
    knobs = dict(bin_px=16, bin_cap=512)

    # full per-pixel fragment stage: deferred albedo texturing with
    # screen-derivative mips + per-pixel PBR (Terrain.render_image wires
    # the atlas slabs and the current material automatically)
    t0 = time.perf_counter()
    img, raster = terrain.render_image(
        "cam", out, vp32, W, H,
        background=(0.35, 0.55, 0.9, 1.0), **knobs,
    )
    img.block_until_ready()
    print(
        f"per-pixel textured PBR {W}x{H}: {time.perf_counter() - t0:.2f}s "
        f"wall (incl. compile), coverage "
        f"{float(np.asarray(raster.covered).mean()):.2f}, "
        f"bin_overflow {int(raster.bin_overflow)}"
    )
    save_png(img, Path(args.out) / "terrain_pbr.png")

    for view in ("geometry_lod", "uv"):
        img_d, _ = terrain.render_image(
            "cam", out, vp32, W, H,
            debug_view=view, background=(0.1, 0.1, 0.12, 1.0), **knobs,
        )
        save_png(img_d, Path(args.out) / f"terrain_{view}.png")


if __name__ == "__main__":
    main()
