"""Rasterizer tests (render/raster.py).

Oracle strategy: the numpy scanline rasterizer of
render/raster_reference.py implements the IDENTICAL contract (pixel
centers at +0.5, sign-normalized edge functions, the same fill rule,
reverse-Z depth max, perspective-correct barycentrics) — the device path
must agree per pixel away from edge ties. This mirrors the reference's own visual oracle role for its
raster output (fragment.wgsl / debug.wgsl views)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bevy_terrain_tpu.math.frustum import view_projection
from bevy_terrain_tpu.render.raster import (
    RasterOutput,
    interpolate,
    rasterize_grid,
    render_view,
)
from bevy_terrain_tpu.render.raster_reference import reference_raster


def _flat_tile(G1=3, size=10.0, y=0.0):
    xs = np.linspace(-size / 2, size / 2, G1)
    gx, gz = np.meshgrid(xs, xs, indexing="xy")
    return np.stack([gx, np.full_like(gx, y), gz], -1)[None].astype(np.float32)


VP_TOPDOWN = view_projection(
    eye=[0.0, 20.0, 0.01], target=[0.0, 0.0, 0.0],
    fov_y=np.radians(60.0), aspect=1.0, near=0.1,
)


class TestRasterCore:
    def test_flat_quad_coverage_matches_analytic(self):
        pos = _flat_tile()
        out = rasterize_grid(
            jnp.asarray(pos), jnp.array([True]),
            jnp.asarray(VP_TOPDOWN, jnp.float32), 64, 64,
            bin_px=16, bin_cap=32,
        )
        cov = np.asarray(out.covered)
        # camera 20 up, fov 60 deg: half-extent at ground = 20*tan(30)
        half = 20.0 * np.tan(np.radians(30.0))
        px_per_world = 64 / (2 * half)
        centers = (np.arange(64) + 0.5) / px_per_world - half
        inside = (np.abs(centers)[None, :] <= 5.0) & (
            np.abs(centers)[:, None] <= 5.0
        )
        # agreement away from the square's boundary (f32 edge ties)
        boundary = np.zeros_like(inside)
        d = np.minimum(np.abs(np.abs(centers) - 5.0)[None, :],
                       np.abs(np.abs(centers) - 5.0)[:, None])
        interior = d > (2.0 / px_per_world)
        assert np.array_equal(cov[interior], inside[interior])
        assert int(out.near_culled) == 0
        assert int(out.bin_overflow) == 0

    def test_no_cracks_inside_projected_grid(self):
        # bumpy single tile: union of triangles must tile the projected
        # quad with NO holes along internal edges (the crack artifact)
        rng = np.random.default_rng(7)
        G1 = 5
        pos = _flat_tile(G1=G1)
        pos[..., 1] += rng.uniform(0, 3.0, pos[..., 1].shape).astype(np.float32)
        out = rasterize_grid(
            jnp.asarray(pos), jnp.array([True]),
            jnp.asarray(VP_TOPDOWN, jnp.float32), 96, 96,
            bin_px=16, bin_cap=64,
        )
        cov = np.asarray(out.covered)
        # viewed from above, heights don't change the footprint: same
        # analytic square as the flat case
        half = 20.0 * np.tan(np.radians(30.0))
        px_per_world = 96 / (2 * half)
        centers = (np.arange(96) + 0.5) / px_per_world - half
        d = np.minimum(np.abs(np.abs(centers) - 5.0)[None, :],
                       np.abs(np.abs(centers) - 5.0)[:, None])
        inside = (np.abs(centers)[None, :] <= 5.0) & (
            np.abs(centers)[:, None] <= 5.0
        )
        interior = inside & (d > 2.0 / px_per_world)
        assert cov[interior].all(), "hole inside the projected grid (crack)"

    def test_depth_test_near_wins(self):
        # two stacked flat tiles; the higher one (closer to the top-down
        # camera) must win everywhere they overlap
        lo = _flat_tile(y=0.0)
        hi = _flat_tile(y=5.0) * np.array([0.5, 1, 0.5], np.float32)  # smaller
        pos = np.concatenate([lo, hi], axis=0)
        out = rasterize_grid(
            jnp.asarray(pos), jnp.array([True, True]),
            jnp.asarray(VP_TOPDOWN, jnp.float32), 64, 64,
            bin_px=16, bin_cap=64,
        )
        G1 = 3
        tris_per_tile = 2 * (G1 - 1) * (G1 - 1)
        tri = np.asarray(out.tri_id)
        ys = np.asarray(interpolate(out, jnp.asarray(pos[..., 1])))
        center = tri[24:40, 24:40]
        assert (center >= tris_per_tile).all(), "near tile lost the z-test"
        assert np.allclose(ys[24:40, 24:40], 5.0, atol=1e-3)

    def test_winding_independence(self):
        # mirrored grid flips every triangle's winding; coverage must not
        # change with cull_backfaces=False
        pos = _flat_tile(G1=4)
        mirrored = pos[:, :, ::-1].copy()
        a = rasterize_grid(
            jnp.asarray(pos), jnp.array([True]),
            jnp.asarray(VP_TOPDOWN, jnp.float32), 64, 64,
            bin_px=16, bin_cap=64,
        )
        b = rasterize_grid(
            jnp.asarray(mirrored), jnp.array([True]),
            jnp.asarray(VP_TOPDOWN, jnp.float32), 64, 64,
            bin_px=16, bin_cap=64,
        )
        assert np.asarray(a.covered).sum() == np.asarray(b.covered).sum()

    def test_near_plane_cull_counted(self):
        pos = _flat_tile()
        vp = view_projection(
            eye=[0.0, 1.0, 0.0], target=[0.0, 0.0, 10.0],
            fov_y=np.radians(60.0), aspect=1.0, near=0.1,
        )
        # camera INSIDE the tile footprint looking forward: the tile
        # spans behind the camera -> some triangles have w <= 0
        out = rasterize_grid(
            jnp.asarray(pos), jnp.array([True]), jnp.asarray(vp, jnp.float32),
            64, 64, bin_px=16, bin_cap=64,
        )
        assert int(out.near_culled) > 0

    def test_bin_cap_overflow_counted(self):
        rng = np.random.default_rng(3)
        G1 = 9
        pos = _flat_tile(G1=G1)
        pos[..., 1] += rng.uniform(0, 1.0, pos[..., 1].shape).astype(np.float32)
        # bin_px=64 -> ONE bin holds the whole image; 128 tris > cap 8
        out = rasterize_grid(
            jnp.asarray(pos), jnp.array([True]),
            jnp.asarray(VP_TOPDOWN, jnp.float32), 64, 64,
            bin_px=64, bin_cap=8, chunk=8,
        )
        assert int(out.bin_overflow) > 0

    def test_masked_tiles_invisible(self):
        pos = np.concatenate([_flat_tile(), _flat_tile(y=5.0)], axis=0)
        out = rasterize_grid(
            jnp.asarray(pos), jnp.array([True, False]),
            jnp.asarray(VP_TOPDOWN, jnp.float32), 64, 64,
            bin_px=16, bin_cap=64,
        )
        ys = np.asarray(interpolate(out, jnp.asarray(pos[..., 1])))
        cov = np.asarray(out.covered)
        assert np.allclose(ys[cov], 0.0, atol=1e-4)


class TestSkirts:
    def test_skirts_close_boundary_gaps(self):
        # two abutting tiles whose shared edge disagrees in height by a
        # small delta (the vertex-density-mip envelope): raw raster shows
        # pinholes along the seam; skirts close them
        from bevy_terrain_tpu.render.raster import (
            _skirt_vertex_map,
            add_skirts,
        )

        a = _flat_tile(G1=5)
        b = _flat_tile(G1=5)
        a[..., 0] -= 5.0
        b[..., 0] += 5.0
        b[..., 1] += 0.35  # tile b sits higher: a step face opens at x=0
        pos = np.concatenate([a, b], axis=0)
        mask = jnp.array([True, True])
        # low oblique camera looking along +x at the step: the uncovered
        # vertical face projects as a sky band between the two surfaces
        vp = view_projection(
            eye=[-7.0, 1.3, 0.01], target=[2.0, 0.0, 0.0],
            fov_y=np.radians(50.0), aspect=1.0, near=0.1,
        )
        raw = rasterize_grid(
            jnp.asarray(pos), mask, jnp.asarray(vp, jnp.float32), 96, 96,
            bin_px=16, bin_cap=64,
        )
        skirted = rasterize_grid(
            add_skirts(jnp.asarray(pos)), mask,
            jnp.asarray(vp, jnp.float32), 96, 96, bin_px=16, bin_cap=64,
        )
        cov_raw = np.asarray(raw.covered)
        cov_sk = np.asarray(skirted.covered)

        def holes(c):
            # uncovered pixels sandwiched between covered ones in a column
            above = np.zeros_like(c)
            above[1:] = np.maximum.accumulate(c, axis=0)[:-1]
            below = np.zeros_like(c)
            below[:-1] = np.maximum.accumulate(c[::-1], axis=0)[::-1][1:]
            return int((~c & above & below).sum())

        assert holes(cov_raw) > 0, "fixture should open a seam"
        assert holes(cov_sk) == 0, "skirts must close the seam"
        # the vertex remap stretches boundary attributes down the skirt:
        # interpolation stays within the original value range
        vmap_ = jnp.asarray(_skirt_vertex_map(2, 5))
        skirted = skirted._replace(vert_idx=vmap_[skirted.vert_idx])
        ys = np.asarray(interpolate(skirted, jnp.asarray(pos[..., 1])))
        assert ys.min() >= 0.0 - 1e-5 and ys.max() <= 0.35 + 1e-5


class TestPixelTexturing:
    def test_analytic_uv_gradients_match_finite_differences(self):
        from bevy_terrain_tpu.render.raster import pixel_uv_and_grads

        # bumpy tile at an oblique view: analytic duv/dx vs numerical
        rng = np.random.default_rng(5)
        G1 = 5
        pos = _flat_tile(G1=G1, size=20.0)
        pos[..., 1] += rng.uniform(0, 4.0, pos[..., 1].shape).astype(np.float32)
        uv = np.zeros((1, G1, G1, 2), np.float32)
        g = np.linspace(0.0, 1.0, G1, dtype=np.float32)
        uv[0, :, :, 0] = g[None, :]
        uv[0, :, :, 1] = g[:, None]

        class MiniMesh:
            positions = jnp.asarray(pos)
            uvs = jnp.asarray(uv)
            tile_mask = jnp.array([True])

        vp = view_projection(
            eye=[6.0, 14.0, -18.0], target=[0.0, 0.0, 0.0],
            fov_y=np.radians(55.0), aspect=1.0, near=0.1,
        )
        W = H = 96
        out = rasterize_grid(
            MiniMesh.positions, MiniMesh.tile_mask,
            jnp.asarray(vp, jnp.float32), W, H, bin_px=16, bin_cap=64,
        )
        uvp, ddx, ddy = pixel_uv_and_grads(
            out, MiniMesh, jnp.asarray(vp, jnp.float32), W, H
        )
        uvp, ddx, ddy = map(np.asarray, (uvp, ddx, ddy))
        tri = np.asarray(out.tri_id)
        cov = np.asarray(out.covered)
        # compare where the pixel and its +x neighbour share a triangle
        same = cov[:, :-1] & cov[:, 1:] & (tri[:, :-1] == tri[:, 1:])
        fd = uvp[:, 1:] - uvp[:, :-1]
        an = 0.5 * (ddx[:, 1:] + ddx[:, :-1])
        err = np.abs(fd - an)[same]
        scale = np.abs(fd[same]).mean()
        assert np.median(err) < 0.02 * scale + 1e-6
        samev = cov[:-1, :] & cov[1:, :] & (tri[:-1, :] == tri[1:, :])
        fdy = uvp[1:, :] - uvp[:-1, :]
        any_ = 0.5 * (ddy[1:, :] + ddy[:-1, :])
        erry = np.abs(fdy - any_)[samev]
        assert np.median(erry) < 0.02 * np.abs(fdy[samev]).mean() + 1e-6

    @pytest.fixture(scope="class")
    def albedo_terrain(self, tmp_path_factory):
        import time

        from PIL import Image

        from bevy_terrain_tpu import (
            PreprocessDataset,
            Preprocessor,
            StandardMaterial,
            Terrain,
            TerrainConfig,
            TerrainModel,
            TerrainViewConfig,
            albedo_material,
        )
        from bevy_terrain_tpu.formats.tiff import array_to_source
        from bevy_terrain_tpu.models import (
            albedo_attachment,
            height_attachment,
        )
        from bevy_terrain_tpu.terrain_data import TileAtlas

        root = tmp_path_factory.mktemp("assets")
        n = 512
        g = (np.arange(n) + 0.5) / n
        uu, vv = np.meshgrid(g, g, indexing="xy")
        height = 0.3 + 0.2 * np.sin(6.28 * uu) * np.cos(6.28 * vv)
        # analytic colormap: R = u, G = v, B = 0.25
        rgba = np.stack(
            [uu, vv, np.full_like(uu, 0.25), np.ones_like(uu)], -1
        )
        src = root / "source"
        src.mkdir(parents=True, exist_ok=True)
        array_to_source(height, src / "h.png")
        Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(
            src / "a.png"
        )
        config = TerrainConfig(
            lod_count=2,
            model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 120.0),
            atlas_size=32, path="terrains/rast_alb",
            attachments=(height_attachment(), albedo_attachment()),
            assets_root=str(root),
        )
        atlas = TileAtlas(config)
        pre = Preprocessor(atlas).clear_attachment(0)
        pre.preprocess_tile(PreprocessDataset(
            attachment_index=0, path=str(src / "h.png"),
            lod_range=range(0, 2),
        ))
        pre.preprocess_tile(PreprocessDataset(
            attachment_index=1, path=str(src / "a.png"),
            lod_range=range(0, 2),
        ))
        pre.run()
        t = Terrain(config)
        t.add_view(
            "cam",
            TerrainViewConfig(tile_capacity=1024, morph_distance=4.0),
            queue_capacity=2048,
        )
        t.set_shading(
            material=StandardMaterial(base_color=albedo_material(1)),
            lighting=True, sample_attachments=(1,),
        )
        view = np.array([0.0, 320.0, 1.0])
        out = None
        for _ in range(40):
            out = t.update({"cam": view})["cam"]
            if not t.atlas.state.to_load and not any(
                a.loading for a in t.atlas.attachments
            ):
                break
            time.sleep(0.01)
        out = t.update({"cam": view})["cam"]
        assert out.overflow == 0
        return t, view, out

    def test_per_pixel_albedo_matches_colormap(self, albedo_terrain):
        t, view, out = albedo_terrain
        vp = view_projection(
            eye=view, target=[0.0, 0.0, 0.0], fov_y=np.radians(60.0),
            aspect=1.0, near=0.5,
        )
        img, raster = t.render_image(
            "cam", out, jnp.asarray(vp, jnp.float32), 160, 160,
            lighting=False, bin_px=16, bin_cap=256,
        )
        cov = np.asarray(raster.covered)
        assert cov.mean() > 0.9
        img = np.asarray(img)
        # reconstruct world xz per pixel -> expected colormap u, v
        from bevy_terrain_tpu.render.raster import interpolate

        pos = np.asarray(interpolate(raster, out.mesh.positions))
        u_exp = pos[..., 0] / 1000.0 + 0.5
        v_exp = pos[..., 2] / 1000.0 + 0.5
        err_u = np.abs(img[..., 0] - u_exp)[cov]
        err_v = np.abs(img[..., 1] - v_exp)[cov]
        assert np.median(err_u) < 0.02
        assert np.median(err_v) < 0.02
        assert np.abs(img[..., 2] - 0.25)[cov].max() < 0.04

    def test_pixel_vs_vertex_albedo_agree(self, albedo_terrain):
        t, view, out = albedo_terrain
        vp = jnp.asarray(
            view_projection(
                eye=view, target=[0.0, 0.0, 0.0], fov_y=np.radians(60.0),
                aspect=1.0, near=0.5,
            ),
            jnp.float32,
        )
        img_px, r1 = t.render_image(
            "cam", out, vp, 128, 128, lighting=False,
            bin_px=16, bin_cap=256,
        )
        img_vx, _ = t.render_image(
            "cam", out, vp, 128, 128, lighting=False, pixel_texturing=False,
            bin_px=16, bin_cap=256,
        )
        cov = np.asarray(r1.covered)
        d = np.abs(np.asarray(img_px) - np.asarray(img_vx))[cov]
        # per-pixel filtering vs vertex bilinear: same image up to
        # sub-vertex detail
        assert np.median(d) < 0.02

    def test_grazing_pixels_pick_coarser_mips(self, albedo_terrain):
        from bevy_terrain_tpu.ops.sampling import mip_level_from_grad
        from bevy_terrain_tpu.render.raster import pixel_uv_and_grads

        t, view, out = albedo_terrain
        # low camera looking toward the horizon: far rows must select
        # coarser mips than near rows (screen-derivative mip selection)
        eye = np.array([0.0, 40.0, 0.0])
        out2 = t.update({"cam": eye})["cam"]
        uniforms, cfg = t.frame_inputs("cam")
        vp = jnp.asarray(
            view_projection(
                eye=eye, target=[0.0, 20.0, 300.0],
                fov_y=np.radians(60.0), aspect=1.0, near=0.5,
            ),
            jnp.float32,
        )
        from bevy_terrain_tpu.render.raster import rasterize_grid

        raster = rasterize_grid(
            out2.mesh.positions, out2.mesh.tile_mask, vp, 128, 128,
            bin_px=16, bin_cap=512,
        )
        uvp, ddx, ddy = pixel_uv_and_grads(raster, out2.mesh, vp, 128, 128)
        mip = np.asarray(mip_level_from_grad(ddx, ddy, 512))
        cov = np.asarray(raster.covered)
        rows = [r for r in range(0, 128, 8) if cov[r].mean() > 0.5]
        assert len(rows) > 4
        prof = [np.median(mip[r][cov[r]]) for r in rows]
        # screen rows toward the horizon (smaller r) see coarser mips
        assert prof[0] > prof[-1] + 1.0


class TestSphericalRaster:
    def test_planet_disc_renders_hole_free(self, tmp_path):
        import time

        import bevy_terrain_tpu as bt
        from bevy_terrain_tpu.formats.tiff import array_to_source
        from bevy_terrain_tpu.math.coordinate import (
            local_position_from_side_uv,
        )
        from bevy_terrain_tpu.models import height_attachment
        from bevy_terrain_tpu.terrain_data import TileAtlas

        R, MAXH = 6_371_000.0, 9_000.0

        def planet(p):
            return np.clip(
                0.5 + 0.3 * np.sin(3 * p[..., 0]) * np.cos(2 * p[..., 2]),
                0.05, 1.0,
            )

        n = 128
        g = (np.arange(n) + 0.5) / n
        uu, vv = np.meshgrid(g, g, indexing="xy")
        guv = np.stack([uu, vv], -1)
        paths = []
        for side in range(6):
            p = local_position_from_side_uv(side, guv)
            f = tmp_path / f"f{side}.png"
            array_to_source(planet(p), f)
            paths.append(str(f))
        config = bt.TerrainConfig(
            lod_count=6,
            model=bt.TerrainModel.sphere(np.zeros(3), R, 0.0, MAXH),
            atlas_size=128, path="earth_raster",
            assets_root=str(tmp_path / "assets"),
            attachments=(height_attachment(texture_size=128, mips=4),),
        )
        atlas = TileAtlas(config)
        bt.Preprocessor(atlas).clear_attachment(0).preprocess_spherical(
            bt.SphericalDataset(
                attachment_index=0, paths=paths, lod_range=range(0, 2)
            )
        ).run(verbose=False)
        t = bt.Terrain(config)
        # density matched to the capture resolution (morph_distance 4)
        t.add_view(
            "cam",
            bt.TerrainViewConfig(tile_capacity=1024, morph_distance=4.0),
            queue_capacity=2048, culling=True,
        )
        view = np.array([0.0, 0.0, R + 600e3])
        vp = view_projection(
            view, view * 0.5, np.radians(60.0), 1.0, near=1e3
        )
        out = None
        for i in range(100):
            out = t.update({"cam": view}, {"cam": vp})
            if i > 3 and not t.atlas.state.to_load and not any(
                a.loading for a in t.atlas.attachments
            ):
                break
            time.sleep(0.01)
        out = t.update({"cam": view}, {"cam": vp})["cam"]
        assert out.overflow == 0

        img, raster = t.render_image(
            "cam", out, jnp.asarray(vp, jnp.float32), 192, 192,
            bin_px=16, bin_cap=512, background=(0, 0, 0, 0),
        )
        cov = np.asarray(raster.covered)
        assert int(raster.bin_overflow) == 0
        # the planet disc nearly fills a 60-degree view from 600 km
        assert cov.mean() > 0.5
        # no holes inside the disc (spherical skirts point to the center)
        above = np.zeros_like(cov)
        above[1:] = np.maximum.accumulate(cov, 0)[:-1]
        below = np.zeros_like(cov)
        below[:-1] = np.maximum.accumulate(cov[::-1], 0)[::-1][1:]
        assert int((~cov & above & below).sum()) == 0
        img = np.asarray(img)
        assert np.isfinite(img).all()
        assert img[cov].max() <= 1.0 + 1e-5


class TestOracleParity:
    def test_matches_numpy_scanline_oracle(self):
        rng = np.random.default_rng(11)
        G1 = 5
        tiles = []
        for dx in (-5.0, 5.0):
            t = _flat_tile(G1=G1)
            t[..., 0] += dx
            t[..., 1] += rng.uniform(0, 4.0, t[..., 1].shape).astype(np.float32)
            tiles.append(t)
        pos = np.concatenate(tiles, axis=0)
        mask = np.array([True, True])
        vp = view_projection(
            eye=[3.0, 15.0, 12.0], target=[0.0, 0.0, 0.0],
            fov_y=np.radians(55.0), aspect=1.0, near=0.1,
        )
        W = H = 80
        out = rasterize_grid(
            jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(vp, jnp.float32),
            W, H, bin_px=16, bin_cap=128,
        )
        o_tri, o_depth, o_margin, _, _ = reference_raster(pos, mask, vp, W, H)
        got_tri = np.asarray(out.tri_id)
        got_depth = np.asarray(out.depth)
        # compare where the oracle's winner is decisively inside (f32
        # vs f64 edge evaluation may disagree within ~1e-4 of an edge)
        decisive = (o_margin > 1e-3) | (o_tri < 0)
        assert decisive.mean() > 0.95
        assert np.array_equal(got_tri[decisive], o_tri[decisive])
        covd = decisive & (o_tri >= 0)
        np.testing.assert_allclose(
            got_depth[covd], o_depth[covd], rtol=0, atol=1e-5
        )

    def test_perspective_correct_interpolation(self):
        # ground plane at a grazing angle: a midscreen sample of a linear
        # ramp must follow the projective (1/w) formula, not the affine one
        G1 = 2
        size = 40.0
        pos = _flat_tile(G1=G1, size=size)
        ramp = pos[..., 2].copy()  # value = world z (depth direction)
        vp = view_projection(
            eye=[0.0, 2.0, -25.0], target=[0.0, 0.0, 0.0],
            fov_y=np.radians(60.0), aspect=1.0, near=0.1,
        )
        W = H = 64
        out = rasterize_grid(
            jnp.asarray(pos), jnp.array([True]), jnp.asarray(vp, jnp.float32),
            W, H, bin_px=16, bin_cap=16,
        )
        vals = np.asarray(interpolate(out, jnp.asarray(ramp)))
        cov = np.asarray(out.covered)
        ys, xs = np.nonzero(cov)
        # oracle: cast a ray through each covered pixel center onto y=0
        ivp = np.linalg.inv(
            np.asarray(vp, np.float64)
            @ np.eye(4)  # vp already maps world -> clip
        )
        for py, px in list(zip(ys, xs))[:: max(1, len(ys) // 37)]:
            ndc = np.array(
                [
                    (px + 0.5) / W * 2 - 1,
                    1 - (py + 0.5) / H * 2,
                    0.5,
                    1.0,
                ]
            )
            world = ivp @ ndc
            world = world[:3] / world[3]
            eye = np.array([0.0, 2.0, -25.0])
            d = world - eye
            thit = -eye[1] / d[1]
            zhit = eye[2] + thit * d[2]
            assert abs(vals[py, px] - zhit) < 0.05, (py, px)


class TestRenderView:
    @pytest.fixture(scope="class")
    def terrain_frame(self, tmp_path_factory):
        import time

        from bevy_terrain_tpu import (
            AttachmentConfig,
            AttachmentFormat,
            Terrain,
            TerrainConfig,
            TerrainModel,
            TerrainViewConfig,
        )
        from bevy_terrain_tpu.utils.synthetic import generate_planar_dataset

        root = tmp_path_factory.mktemp("assets")
        att = AttachmentConfig(
            name="height", texture_size=512, border_size=2,
            mip_level_count=4, format=AttachmentFormat.R16,
        )

        def bumps(u, v):
            return 0.4 + 0.25 * np.sin(6.28 * 2 * u) * np.cos(6.28 * 3 * v)

        generate_planar_dataset(
            "terrains/raster", 2, att, height_fn=bumps, root=str(root)
        )
        config = TerrainConfig(
            lod_count=2,
            model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
            atlas_size=16, path="terrains/raster", attachments=(att,),
            assets_root=str(root),
        )
        t = Terrain(config)
        # morph_distance 4 (default 16) keeps the scene at a triangle
        # density matched to the small test framebuffers
        t.add_view(
            "cam",
            TerrainViewConfig(tile_capacity=1024, morph_distance=4.0),
            queue_capacity=2048,
        )
        view = np.array([0.0, 300.0, 1.0])
        out = None
        for _ in range(30):
            out = t.update({"cam": view})["cam"]
            if not t.atlas.state.to_load and not any(
                a.loading for a in t.atlas.attachments
            ):
                break
            time.sleep(0.01)
        out = t.update({"cam": view})["cam"]
        assert out.overflow == 0, "fixture must not drop tiles"
        return t, view, out

    def _uniforms_cfg(self, terrain, view_id="cam"):
        # the public accessor for out-of-pipeline consumers
        return terrain.frame_inputs(view_id)

    def test_per_pixel_pbr_image(self, terrain_frame):
        t, view, out = terrain_frame
        uniforms, cfg = self._uniforms_cfg(t)
        vp = view_projection(
            eye=view, target=[0.0, 0.0, 0.0], fov_y=np.radians(60.0),
            aspect=1.0, near=0.5,
        )
        img, raster = render_view(
            out.mesh, out.tiles, uniforms, cfg,
            jnp.asarray(vp, jnp.float32), 192, 192,
            shade_mode="pixel", bin_px=16, bin_cap=256,
        )
        assert int(raster.bin_overflow) == 0
        assert img.shape == (192, 192, 4)
        img = np.asarray(img)
        cov = np.asarray(raster.covered)
        assert cov.mean() > 0.5, "camera looks at terrain; expect coverage"
        assert img[cov].min() >= 0.0 and img[cov].max() <= 1.0 + 1e-5
        assert (img[~cov] == 0).all()
        # lighting must vary across the bumpy surface
        lum = img[..., :3].mean(-1)
        assert lum[cov].std() > 0.01

    def test_vertex_vs_pixel_shading_agree_broadly(self, terrain_frame):
        t, view, out = terrain_frame
        uniforms, cfg = self._uniforms_cfg(t)
        vp = view_projection(
            eye=view, target=[0.0, 0.0, 0.0], fov_y=np.radians(60.0),
            aspect=1.0, near=0.5,
        )
        common = dict(bin_px=16, bin_cap=256)
        img_p, r1 = render_view(
            out.mesh, out.tiles, uniforms, cfg,
            jnp.asarray(vp, jnp.float32), 96, 96, shade_mode="pixel",
            **common,
        )
        img_v, r2 = render_view(
            out.mesh, out.tiles, uniforms, cfg,
            jnp.asarray(vp, jnp.float32), 96, 96, shade_mode="vertex",
            **common,
        )
        cov = np.asarray(r1.covered)
        diff = np.abs(np.asarray(img_p) - np.asarray(img_v))[cov]
        # Gouraud vs Phong: same image up to shading-rate differences
        assert np.median(diff) < 0.03
        assert diff.mean() < 0.08

    def test_debug_view_renders(self, terrain_frame):
        t, view, out = terrain_frame
        uniforms, cfg = self._uniforms_cfg(t)
        vp = view_projection(
            eye=view, target=[0.0, 0.0, 0.0], fov_y=np.radians(60.0),
            aspect=1.0, near=0.5,
        )
        img, raster = render_view(
            out.mesh, out.tiles, uniforms, cfg,
            jnp.asarray(vp, jnp.float32), 64, 64, debug_view="geometry_lod",
            bin_px=16, bin_cap=128,
        )
        img = np.asarray(img)
        cov = np.asarray(raster.covered)
        # the lod palette is saturated colors; expect variation
        assert img[cov, :3].std() > 0.05
