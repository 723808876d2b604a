"""Shading / material / debug-view tests (render/material.py + debug/)."""

import time

import numpy as np
import pytest

from bevy_terrain_tpu import (
    AttachmentConfig,
    AttachmentFormat,
    Terrain,
    TerrainConfig,
    TerrainModel,
    TerrainViewConfig,
)
from bevy_terrain_tpu.debug import ApproachCamera, DebugTerrain, OrbitCamera
from bevy_terrain_tpu.render import material as mat
from bevy_terrain_tpu.utils.synthetic import generate_planar_dataset


def ramp_field(u, v):
    # gradient only along u: dh/du = 0.5, flat along v
    return 0.25 + 0.5 * u


@pytest.fixture(scope="module")
def shaded_terrain(tmp_path_factory):
    root = tmp_path_factory.mktemp("assets")
    att = AttachmentConfig(
        name="height", texture_size=512, border_size=2, mip_level_count=4,
        format=AttachmentFormat.R16,
    )
    generate_planar_dataset("terrains/mat", 2, att, height_fn=ramp_field, root=str(root))
    config = TerrainConfig(
        lod_count=2,
        model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
        atlas_size=16, path="terrains/mat", attachments=(att,), assets_root=str(root),
    )
    t = Terrain(config)
    t.add_view("cam", TerrainViewConfig(tile_capacity=256), queue_capacity=1024)
    t.set_shading(lighting=True)
    view = np.array([0.0, 150.0, 0.0])
    for _ in range(30):
        out = t.update({"cam": view})
        if not t.atlas.state.to_load and not any(a.loading for a in t.atlas.attachments):
            break
        time.sleep(0.01)
    out = t.update({"cam": view})["cam"]
    return t, view, out


class TestShading:
    def test_colors_shape_and_range(self, shaded_terrain):
        t, _, out = shaded_terrain
        assert out.colors is not None
        F, G1 = out.mesh.heights.shape[0], out.mesh.heights.shape[1]
        assert out.colors.shape == (F, G1, G1, 4)
        c = np.asarray(out.colors)[np.asarray(out.mesh.tile_mask)]
        assert c.min() >= 0.0 and c.max() <= 1.0 + 1e-6

    def test_normals_match_ramp_gradient(self, shaded_terrain):
        t, _, out = shaded_terrain
        from bevy_terrain_tpu.ops import refinement

        cfg = t._static_cfgs["cam"]
        # surface normal of h = 100*(0.25 + 0.5*(x/1000+0.5)) => dh/dx = 0.05
        # => n ~ normalize(-0.05, 1, 0)
        tiles = out.tiles
        normals = mat.surface_normals_from_heights(
            out.mesh, tiles,
            # uniforms only used for scale fields; rebuild quickly
            _uniforms(t, "cam"), cfg,
        )
        n = np.asarray(normals)[np.asarray(out.mesh.tile_mask)]
        # interior vertices only (edges are one-sided)
        n = n[:, 2:-2, 2:-2]
        expect = np.array([-0.05, 1.0, 0.0])
        expect = expect / np.linalg.norm(expect)
        err = np.linalg.norm(n - expect, axis=-1)
        assert np.median(err) < 0.02, float(np.median(err))

    def test_debug_view_geometry_lod(self, shaded_terrain):
        t, view, _ = shaded_terrain
        t.set_shading(debug_view="geometry_lod")
        out = t.update({"cam": view})["cam"]
        c = np.asarray(out.colors)[np.asarray(out.mesh.tile_mask)]
        # checkerboard: distinct colors present, all rows uniform per tile
        assert len(np.unique(c.reshape(-1, 4), axis=0)) > 1
        t.set_shading(lighting=True)  # restore

    def test_custom_material(self, shaded_terrain):
        t, view, _ = shaded_terrain

        def red_material(ctx):
            import jax.numpy as jnp

            h = ctx.mesh.heights
            return jnp.stack(
                [jnp.ones_like(h), jnp.zeros_like(h), jnp.zeros_like(h), jnp.ones_like(h)],
                axis=-1,
            )

        t.set_shading(material=red_material, lighting=False)
        out = t.update({"cam": view})["cam"]
        c = np.asarray(out.colors)[np.asarray(out.mesh.tile_mask)]
        assert (c[..., 0] == 1.0).all() and (c[..., 1] == 0.0).all()
        t.set_shading(lighting=True)

    def test_shading_disabled(self, shaded_terrain):
        t, view, _ = shaded_terrain
        t.set_shading(enabled=False)
        out = t.update({"cam": view})["cam"]
        assert out.colors is None
        t.set_shading(lighting=True)


class TestPbrLighting:
    """pbr_lighting mirrors bevy_pbr's Filament direct-light model
    (fragment.wgsl:52-63 PbrInput -> apply_pbr_lighting)."""

    def _flat(self, n=(0.0, 1.0, 0.0), base=(0.8, 0.8, 0.8)):
        normals = np.broadcast_to(np.asarray(n, np.float32), (1, 4, 4, 3))
        colors = np.concatenate(
            [
                np.broadcast_to(np.asarray(base, np.float32), (1, 4, 4, 3)),
                np.ones((1, 4, 4, 1), np.float32),
            ],
            axis=-1,
        )
        positions = np.zeros((1, 4, 4, 3), np.float32)
        view = np.array([0.0, 100.0, 0.0], np.float32)
        return colors, normals, positions, view

    def test_facing_light_brighter_than_away(self):
        light = mat.DirectionalLight(direction=(0.0, -1.0, 0.0))
        c, n, p, v = self._flat()
        lit_up = np.asarray(
            mat.pbr_lighting(c, n, p, v, lights=(light,))
        )
        lit_down = np.asarray(
            mat.pbr_lighting(c, -n, p, v, lights=(light,))
        )
        assert lit_up[..., :3].mean() > lit_down[..., :3].mean() + 0.1
        # away-facing only sees ambient on the diffuse color
        np.testing.assert_allclose(
            lit_down[..., :3], 0.8 * 0.05, atol=1e-5
        )

    def test_defaults_match_reference_pbr_input_and_stay_in_range(self):
        # fragment.wgsl:54-56: roughness 1.0, reflectance 0.0 -> the
        # default terrain look is Burley diffuse + ambient, no specular
        c, n, p, v = self._flat()
        lit = np.asarray(mat.pbr_lighting(c, n, p, v))
        assert lit.min() >= 0.0 and lit.max() <= 1.0 + 1e-6
        assert lit[..., 3].max() == 1.0  # alpha untouched

    def test_metallic_kills_diffuse(self):
        light = mat.DirectionalLight(direction=(0.0, -1.0, 0.0))
        c, n, p, v = self._flat(base=(0.9, 0.2, 0.1))
        dielectric = np.asarray(
            mat.pbr_lighting(c, n, p, v, metallic=0.0, lights=(light,),
                             ambient=(0, 0, 0))
        )
        metal = np.asarray(
            mat.pbr_lighting(c, n, p, v, metallic=1.0,
                             perceptual_roughness=1.0, lights=(light,),
                             ambient=(0, 0, 0))
        )
        # metal: no diffuse; rough specular remains, tinted by base (F0)
        assert metal[..., :3].mean() < dielectric[..., :3].mean()
        assert metal[..., 0].mean() > metal[..., 2].mean()  # F0 tint

    def test_smooth_specular_peak(self):
        # mirror geometry: light straight down, viewer straight above ->
        # low roughness concentrates energy vs high roughness
        light = mat.DirectionalLight(direction=(0.0, -1.0, 0.0))
        c, n, p, v = self._flat(base=(0.5, 0.5, 0.5))
        smooth = np.asarray(
            mat.pbr_lighting(c, n, p, v, perceptual_roughness=0.15,
                             reflectance=0.5, lights=(light,),
                             ambient=(0, 0, 0))
        )
        rough = np.asarray(
            mat.pbr_lighting(c, n, p, v, perceptual_roughness=1.0,
                             reflectance=0.5, lights=(light,),
                             ambient=(0, 0, 0))
        )
        assert smooth[..., :3].max() > rough[..., :3].max() * 1.5

    def test_two_lights_superpose(self):
        # direct lighting is additive across the light loop
        # (pbr_lighting.wgsl accumulates per-light contributions); with
        # ambient/emissive zeroed, two lights = sum of each alone
        a = mat.DirectionalLight(direction=(0.0, -1.0, 0.0),
                                 color=(1.0, 0.5, 0.25), illuminance=0.6)
        b = mat.DirectionalLight(direction=(-1.0, -1.0, 0.0),
                                 color=(0.2, 0.4, 1.0), illuminance=0.9)
        c, n, p, v = self._flat(base=(0.7, 0.6, 0.5))
        kw = dict(ambient=(0, 0, 0), reflectance=0.4,
                  perceptual_roughness=0.5)
        both = np.asarray(mat.pbr_lighting(c, n, p, v, lights=(a, b), **kw))
        only_a = np.asarray(mat.pbr_lighting(c, n, p, v, lights=(a,), **kw))
        only_b = np.asarray(mat.pbr_lighting(c, n, p, v, lights=(b,), **kw))
        np.testing.assert_allclose(
            both[..., :3], only_a[..., :3] + only_b[..., :3], atol=1e-5
        )

    def test_point_light_falloff_and_range(self):
        # Filament windowed inverse-square: nearer is brighter, beyond
        # `range` the window zeroes the light entirely
        c, n, p, v = self._flat()
        near = mat.PointLight(position=(0.0, 2.0, 0.0), range=20.0)
        far = mat.PointLight(position=(0.0, 8.0, 0.0), range=20.0)
        out_of_range = mat.PointLight(position=(0.0, 30.0, 0.0), range=20.0)
        kw = dict(ambient=(0, 0, 0))
        lit_near = np.asarray(mat.pbr_lighting(c, n, p, v, lights=(near,), **kw))
        lit_far = np.asarray(mat.pbr_lighting(c, n, p, v, lights=(far,), **kw))
        lit_out = np.asarray(
            mat.pbr_lighting(c, n, p, v, lights=(out_of_range,), **kw)
        )
        assert lit_near[..., :3].mean() > lit_far[..., :3].mean() * 2.0
        np.testing.assert_allclose(lit_out[..., :3], 0.0, atol=1e-6)

    def test_spot_cone_window(self):
        # a spot pointing straight down lights the surface under it; the
        # same light aimed sideways leaves it dark (cone window)
        c, n, p, v = self._flat()
        down = mat.SpotLight(position=(0.0, 3.0, 0.0),
                             direction=(0.0, -1.0, 0.0),
                             inner_angle=0.5, outer_angle=0.8)
        aside = mat.SpotLight(position=(0.0, 3.0, 0.0),
                              direction=(1.0, 0.0, 0.0),
                              inner_angle=0.5, outer_angle=0.8)
        kw = dict(ambient=(0, 0, 0))
        lit = np.asarray(mat.pbr_lighting(c, n, p, v, lights=(down,), **kw))
        dark = np.asarray(mat.pbr_lighting(c, n, p, v, lights=(aside,), **kw))
        assert lit[..., :3].mean() > 0.01
        np.testing.assert_allclose(dark[..., :3], 0.0, atol=1e-6)

    def test_shadow_hook_multiplies_contribution(self):
        # the shadow hook is bevy's fetch_*_shadow slot: factor 0 removes
        # the light, 0.5 halves it, and only that light is affected
        c, n, p, v = self._flat()
        lit_l = mat.DirectionalLight(direction=(0.0, -1.0, 0.0))
        kw = dict(ambient=(0, 0, 0))

        def half(positions):
            return np.float32(0.5) * np.ones(positions.shape[:-1] + (1,),
                                             np.float32)

        def full_shadow(positions):
            return np.zeros(positions.shape[:-1] + (1,), np.float32)

        base = np.asarray(mat.pbr_lighting(c, n, p, v, lights=(lit_l,), **kw))
        halved = np.asarray(mat.pbr_lighting(
            c, n, p, v,
            lights=(mat.DirectionalLight(direction=(0.0, -1.0, 0.0),
                                         shadow=half),),
            **kw,
        ))
        gone = np.asarray(mat.pbr_lighting(
            c, n, p, v,
            lights=(mat.DirectionalLight(direction=(0.0, -1.0, 0.0),
                                         shadow=full_shadow),),
            **kw,
        ))
        np.testing.assert_allclose(halved[..., :3], base[..., :3] * 0.5,
                                   atol=1e-6)
        np.testing.assert_allclose(gone[..., :3], 0.0, atol=1e-6)

    def test_mixed_light_types_through_terrain(self, shaded_terrain):
        # >= 2 lights of different kinds flow through the full frame step
        t, view, _ = shaded_terrain
        m = mat.StandardMaterial(
            perceptual_roughness=0.6, reflectance=0.3,
            lights=(
                mat.DirectionalLight(direction=(-0.3, -0.8, -0.5)),
                mat.PointLight(position=(100.0, 200.0, 100.0),
                               range=2000.0, intensity=0.5),
            ),
        )
        t.set_shading(material=m, lighting=True)
        out = t.update({"cam": view})["cam"]
        c = np.asarray(out.colors)[np.asarray(out.mesh.tile_mask)]
        assert np.isfinite(c).all() and c.min() >= 0.0
        t.set_shading(lighting=True)

    def test_standard_material_through_terrain(self, shaded_terrain):
        t, view, _ = shaded_terrain
        m = mat.StandardMaterial(perceptual_roughness=0.5, metallic=0.1,
                                 reflectance=0.4)
        t.set_shading(material=m, lighting=True)
        out = t.update({"cam": view})["cam"]
        c = np.asarray(out.colors)[np.asarray(out.mesh.tile_mask)]
        assert np.isfinite(c).all() and c.min() >= 0.0
        t.set_shading(lighting=True)


class TestExampleMaterials:
    def test_gradient_material_follows_height(self, shaded_terrain):
        """planar.wgsl sample_color non-ALBEDO: gradient LUT at
        pow(height, 0.9)."""
        t, view, _ = shaded_terrain
        lut = np.stack(
            [np.linspace(0, 1, 16), np.zeros(16), np.linspace(1, 0, 16),
             np.ones(16)],
            axis=-1,
        ).astype(np.float32)
        t.set_shading(material=mat.gradient_material(lut), lighting=False)
        out = t.update({"cam": view})["cam"]
        mask = np.asarray(out.mesh.tile_mask)
        c = np.asarray(out.colors)[mask]
        h = np.asarray(out.mesh.heights)[mask]
        hn = np.clip(h / 100.0, 0, 1) ** 0.9
        np.testing.assert_allclose(c[..., 0], hn, atol=1.5 / 15)
        np.testing.assert_allclose(c[..., 2], 1.0 - hn, atol=1.5 / 15)
        t.set_shading(lighting=True)


class TestDebugToggles:
    def test_defaults_match_reference(self):
        d = DebugTerrain()
        assert d.morph and d.blend and d.lighting and not d.freeze
        assert d.debug_view is None

    def test_debug_view_selection(self):
        d = DebugTerrain(show_uv=True)
        assert d.debug_view == "uv"
        assert DebugTerrain(show_geometry_lod=True).debug_view == "geometry_lod"

    def test_static_overrides(self):
        d = DebugTerrain(morph=False)
        assert d.static_overrides()["morph"] is False


class TestCameras:
    def test_orbit_path(self):
        cam = OrbitCamera(center=np.zeros(3), radius=100.0, height=50.0)
        path = cam.path(10)
        assert len(path) == 10
        radii = [np.hypot(p[0], p[2]) for p in path]
        np.testing.assert_allclose(radii, 100.0, atol=1e-9)

    def test_approach_path_monotone(self):
        cam = ApproachCamera(target=np.zeros(3), start_distance=1e6, end_distance=100.0)
        d = [np.linalg.norm(p) for p in cam.path(20)]
        assert all(a > b for a, b in zip(d, d[1:]))
        assert d[-1] == pytest.approx(100.0)


def _uniforms(terrain, view_id):
    from bevy_terrain_tpu.math.approximation import TerrainModelApproximation
    from bevy_terrain_tpu.ops.params import make_frame_uniforms

    tree = terrain.tile_trees[view_id]
    approx = TerrainModelApproximation.compute(
        terrain.config.model, tree.view_world_position, tree.origin_lod,
        tree.approximate_height,
    )
    return make_frame_uniforms(
        terrain.config.model, tree.view_world_position, approx, tree.origins,
        tree.entries, tree.view_tile_int, tree.view_tile_frac,
        terrain.view_configs[view_id],
    )


class TestAttachmentSampling:
    def test_albedo_grid_matches_colormap(self, tmp_path):
        from bevy_terrain_tpu import PreprocessDataset, Preprocessor
        from bevy_terrain_tpu.formats.tiff import array_to_source
        from bevy_terrain_tpu.models import albedo_attachment, height_attachment
        from bevy_terrain_tpu.terrain_data import TileAtlas
        from PIL import Image

        n = 512
        uv = (np.arange(n) + 0.5) / n
        uu, vv = np.meshgrid(uv, uv, indexing="xy")
        h = np.clip(0.4 + 0.3 * uu, 0.02, 1.0)
        # channel 0 must stay nonzero: 0 is the reference's nodata sentinel
        # (textureGather(0u) validity, split.wgsl:34)
        red = 0.1 + 0.85 * uu
        rgba = np.stack([red, vv, 0.5 * np.ones_like(uu), np.ones_like(uu)], axis=-1)
        array_to_source(h, tmp_path / "h.png")
        Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(tmp_path / "a.png")

        config = TerrainConfig(
            lod_count=2,
            model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
            atlas_size=16, path="t", assets_root=str(tmp_path / "assets"),
            attachments=(height_attachment(), albedo_attachment()),
        )
        atlas = TileAtlas(config)
        pre = Preprocessor(atlas).clear_attachment(0)
        pre.preprocess_tile(PreprocessDataset(0, str(tmp_path / "h.png"), lod_range=range(0, 2)))
        pre.preprocess_tile(PreprocessDataset(1, str(tmp_path / "a.png"), lod_range=range(0, 2)))
        pre.run(verbose=False)

        t = Terrain(config)
        t.add_view("cam", TerrainViewConfig(tile_capacity=128), queue_capacity=512)
        view = np.array([0.0, 120.0, 0.0])
        for _ in range(30):
            out = t.update({"cam": view})
            if not t.atlas.state.to_load and not any(a.loading for a in t.atlas.attachments):
                break
            time.sleep(0.01)
        out = t.update({"cam": view})["cam"]
        albedo = np.asarray(t.sample_attachment_grid("cam", out, 1))
        mask = np.asarray(out.mesh.tile_mask)
        pos = np.asarray(out.mesh.positions)[mask]
        a = albedo[mask]
        u = pos[..., 0] / 1000.0 + 0.5
        v = pos[..., 2] / 1000.0 + 0.5
        err_r = np.abs(a[..., 0] - (0.1 + 0.85 * u))
        err_g = np.abs(a[..., 1] - v)
        assert np.median(err_r) < 0.02 and np.median(err_g) < 0.02
        assert np.median(np.abs(a[..., 2] - 0.5)) < 0.02

        # the planar example's ALBEDO material: the same fetch runs INSIDE
        # the frame step (set_shading(sample_attachments=(1,))) and colors
        # come out of the jit equal to the post-hoc sampler above
        from bevy_terrain_tpu import albedo_material

        t.set_shading(material=albedo_material(1), lighting=False,
                      sample_attachments=(1,))
        out2 = t.update({"cam": view})["cam"]
        c = np.asarray(out2.colors)[np.asarray(out2.mesh.tile_mask)]
        a2 = np.asarray(t.sample_attachment_grid("cam", out2, 1))[
            np.asarray(out2.mesh.tile_mask)
        ]
        np.testing.assert_allclose(c, a2[..., :4], atol=1e-6)
        # and lighting composes on top of the albedo (the example's
        # fragment_output path with LIGHTING)
        t.set_shading(material=albedo_material(1), lighting=True,
                      sample_attachments=(1,))
        out3 = t.update({"cam": view})["cam"]
        c3 = np.asarray(out3.colors)[np.asarray(out3.mesh.tile_mask)]
        assert np.isfinite(c3).all() and (c3[..., :3] <= c[..., :3] + 0.2).all()


    @pytest.mark.parametrize("grad_taps", [1, 4])
    def test_single_channel_grid_matches_query(self, shaded_terrain,
                                               grad_taps):
        """A one-channel attachment (the R16 height) is stored unpacked:
        the grid sampler must take it like a packed RGBA one and agree
        with the per-vertex query chain at the frame's vertices."""
        t, view, _ = shaded_terrain
        out = t.update({"cam": view})["cam"]
        got = np.asarray(
            t.sample_attachment_grid("cam", out, 0, grad_taps=grad_taps))
        mask = np.asarray(out.mesh.tile_mask)
        assert got.shape == out.mesh.heights.shape + (1,)
        pos = np.asarray(out.mesh.positions)[mask].reshape(-1, 3)
        want = np.asarray(t.query_attachment("cam", pos, 0))[:, 0]
        err = np.abs(got[mask].reshape(-1) - want)
        # both read the linear ramp: exact up to 16-bit quantization,
        # the f32 position round trip and the mip the grid picks
        assert np.median(err) < 1e-3 and err.max() < 5e-3, (
            float(np.median(err)), float(err.max()))
        u = pos[:, 0] / 1000.0 + 0.5
        np.testing.assert_allclose(
            np.median(np.abs(got[mask].reshape(-1) - ramp_field(u, 0.0))),
            0.0, atol=1e-3)


class TestTileTreeView:
    def test_show_tile_tree(self, shaded_terrain):
        t, view, _ = shaded_terrain
        t.set_shading(debug_view="tile_tree")
        out = t.update({"cam": view})["cam"]
        c = np.asarray(out.colors)[np.asarray(out.mesh.tile_mask)]
        # outlines produce the grey 0.1 value somewhere; interiors colored
        assert (np.abs(c - 0.1) < 1e-3).any()
        assert c.max() > 0.5
        t.set_shading(lighting=True)


class TestMorphInvariantOverlay:
    def test_healthy_config_shows_no_red_green(self, shaded_terrain):
        """With the reference defaults the two morph invariants hold, so the
        geometry_lod view must not flag any vertex (debug.wgsl:80-92)."""
        t, view, _ = shaded_terrain
        t.set_shading(debug_view="geometry_lod")
        out = t.update({"cam": view})["cam"]
        c = np.asarray(out.colors)[np.asarray(out.mesh.tile_mask)]
        pure_red = (c[..., 0] == 1.0) & (c[..., 1] == 0.0) & (c[..., 2] == 0.0)
        pure_green = (c[..., 0] == 0.0) & (c[..., 1] == 1.0) & (c[..., 2] == 0.0)
        assert pure_red.mean() < 0.01 and pure_green.mean() < 0.01
        t.set_shading(lighting=True)


class TestDataLodAndPixelsViews:
    def test_show_data_lod_colors(self, shaded_terrain):
        t, view, _ = shaded_terrain
        t.set_shading(debug_view="data_lod", lighting=False)
        out = t.update({"cam": view})["cam"]
        c = np.asarray(out.colors)[np.asarray(out.mesh.tile_mask)]
        # checkerboard of index colors: nonuniform, in range; alpha follows
        # the reference's vec4 darkening (mix toward vec4(0.0) scales alpha
        # too, debug.wgsl:31-32) so it is in (0, 1], not constant 1
        assert c.min() >= 0.0 and c.max() <= 1.0 + 1e-6
        assert np.asarray(c[..., :3]).std() > 0.05
        assert c[..., 3].min() > 0.0 and c[..., 3].max() <= 1.0 + 1e-6
        t.set_shading(enabled=True, lighting=True)

    def test_show_pixels_overlay(self, shaded_terrain):
        t, view, _ = shaded_terrain
        t.set_shading(lighting=False)
        base = t.update({"cam": view})["cam"]
        t.set_shading(debug_view="pixels", lighting=False)
        over = t.update({"cam": view})["cam"]
        mask = np.asarray(base.mesh.tile_mask)
        cb = np.asarray(base.colors)[mask]
        co = np.asarray(over.colors)[mask]
        # 50% mix toward a 0.5/0.1 checkerboard: every texel moved, values
        # are exactly mix(base, {0.5,0.1}, 0.5)
        expect_hi = cb[..., :3] * 0.5 + 0.25
        expect_lo = cb[..., :3] * 0.5 + 0.05
        close = (np.abs(co[..., :3] - expect_hi) < 1e-5) | (
            np.abs(co[..., :3] - expect_lo) < 1e-5
        )
        assert close.all()
        t.set_shading(enabled=True, lighting=True)

    def test_debug_view_priority_tuple(self):
        d = DebugTerrain(show_data_lod=True, show_pixels=True)
        assert d.debug_view == ("data_lod", "pixels")
        d = DebugTerrain(show_normals=True, show_pixels=True)
        assert d.debug_view == "normals"
        assert DebugTerrain(show_pixels=True).debug_view == "pixels"


class TestFreeze:
    def test_freeze_pins_tile_list(self, shaded_terrain):
        t, view, _ = shaded_terrain
        d = DebugTerrain(freeze=True)
        t.set_debug(d)
        def tile_set(out):
            n = out.tile_count
            return {
                (int(l), int(x), int(y))
                for l, (x, y) in zip(
                    np.asarray(out.tiles.tile_lod[:n]),
                    np.asarray(out.tiles.tile_xy[:n]),
                )
            }

        def rows(out):
            n = out.tile_count
            return {
                (int(l), int(x), int(y)): np.asarray(out.mesh.uvs[i])
                for i, (l, (x, y)) in enumerate(zip(
                    np.asarray(out.tiles.tile_lod[:n]),
                    np.asarray(out.tiles.tile_xy[:n]),
                ))
            }

        out1 = t.update({"cam": view})["cam"]
        frozen = tile_set(out1)
        n1 = out1.tile_count
        # move the camera far enough that refinement WOULD change; the
        # tile SET must stay pinned (row order re-sorts by atlas quad id —
        # a tile list is a set)
        moved = view + np.array([300.0, -120.0, 200.0])
        out2 = t.update({"cam": moved})["cam"]
        assert out2.tile_count == n1
        assert tile_set(out2) == frozen
        # mesh still re-morphs from the NEW camera (not a frozen mesh)
        r1, r2 = rows(out1), rows(out2)
        diffs = [
            float(np.abs(r1[k] - r2[k]).max()) for k in frozen
        ]
        assert max(diffs) > 1e-4
        # unfreeze: refinement resumes and the tile list changes
        t.set_debug(DebugTerrain(freeze=False))
        out3 = t.update({"cam": moved})["cam"]
        assert tile_set(out3) != frozen
        t.set_debug(None)


class TestTuneView:
    def test_distance_tuning_no_recompile(self, shaded_terrain):
        t, view, _ = shaded_terrain
        # overflow-free operating points: the fixture's default
        # morph_distance saturates its small tile_capacity
        t.tune_view("cam", morph_distance=1.0)
        coarse = t.update({"cam": view})["cam"]
        t.tune_view("cam", morph_distance=2.0)  # doubling -> finer tiles
        fine = t.update({"cam": view})["cam"]
        assert coarse.overflow == 0 and fine.overflow == 0
        assert coarse.tile_count < fine.tile_count
        t.tune_view("cam", morph_distance=16.0)

    def test_grid_size_respecializes(self, shaded_terrain):
        t, view, _ = shaded_terrain
        t.tune_view("cam", grid_size=8)
        out = t.update({"cam": view})["cam"]
        assert out.mesh.heights.shape[1] == 9
        t.tune_view("cam", grid_size=16)
        out = t.update({"cam": view})["cam"]
        assert out.mesh.heights.shape[1] == 17


class TestWireframe:
    def test_wireframe_darkens_tile_borders(self, shaded_terrain):
        t, view, _ = shaded_terrain
        t.set_shading(lighting=False)
        base = t.update({"cam": view})["cam"]
        t.set_shading(lighting=False, wireframe=True)
        wf = t.update({"cam": view})["cam"]
        mask = np.asarray(base.mesh.tile_mask)
        cb = np.asarray(base.colors)[mask][..., :3]
        cw = np.asarray(wf.colors)[mask][..., :3]
        # everything darkens; borders darken more than interiors
        assert (cw <= cb + 1e-6).all()
        border = np.zeros((17, 17), bool)
        border[0] = border[-1] = border[:, 0] = border[:, -1] = True
        db = (cb - cw)[:, border].mean()
        di = (cb - cw)[:, ~border].mean()
        assert db > di > 0.0
        t.set_shading(enabled=True, lighting=True)


class TestDeviceHeightQueriesGridPath:
    def test_blob_uniform_branch(self, shaded_terrain):
        """query_heights must also work on the grid path, where the
        view's last uniforms are the packed blob (unpacked in-jit)."""
        t, view, _ = shaded_terrain
        assert t.use_grid_mesh
        from bevy_terrain_tpu.terrain_data.sampling_api import sample_height

        rng = np.random.default_rng(3)
        pts = np.stack([
            rng.uniform(-450, 450, 32),
            np.zeros(32),
            rng.uniform(-450, 450, 32),
        ], axis=-1)
        got = np.asarray(t.query_heights("cam", pts))
        want = np.array([
            sample_height(t.tile_trees["cam"], t.atlas, p) for p in pts
        ])
        np.testing.assert_allclose(got, want, atol=0.3)
        # ramp field: height = (0.25 + 0.5 * u) * 100
        u = pts[:, 0] / 1000.0 + 0.5
        np.testing.assert_allclose(got, (0.25 + 0.5 * u) * 100.0, atol=1.0)


class TestAdaptiveCapacityGridPath:
    def test_ladder_on_fused_path(self, shaded_terrain):
        """The capacity ladder must also respecialize the grid step
        (and attachment sampling must follow the frame's adapted config)."""
        t, _, _ = shaded_terrain
        assert t.use_grid_mesh
        view = np.array([0.0, 900.0, 0.0])  # high camera: few coarse tiles
        old_morph = t.view_configs["cam"].morph_distance
        t.tune_view("cam", morph_distance=0.5)  # shallow subdivision
        t.update({"cam": view})
        full = t.update({"cam": view})["cam"]
        n_full = int(np.asarray(full.tiles.tile_count))
        assert n_full * 2 <= 128, n_full  # the ladder CAN step down
        t.enable_adaptive_capacity("cam", ladder=[64, 128, 256])
        try:
            outs = [t.update({"cam": view})["cam"] for _ in range(3)]
            ad = t._adaptive["cam"]
            assert ad["capacity"] < 256
            last = outs[-1]
            assert int(np.asarray(last.overflow)) == 0
            assert int(np.asarray(last.tiles.tile_count)) == n_full
            assert last.mesh.heights.shape[0] == ad["capacity"]
        finally:
            t.disable_adaptive_capacity("cam")
            t.tune_view("cam", morph_distance=old_morph)


class TestDeviceAttachmentQueries:
    def test_albedo_points_match_cpu_chain(self, tmp_path):
        """Terrain.query_attachment (device op) vs the CPU sample_attachment
        per point on a streamed height+albedo terrain."""
        from bevy_terrain_tpu import PreprocessDataset, Preprocessor
        from bevy_terrain_tpu.formats.tiff import array_to_source
        from bevy_terrain_tpu.models import albedo_attachment, height_attachment
        from bevy_terrain_tpu.terrain_data import TileAtlas
        from bevy_terrain_tpu.terrain_data.sampling_api import sample_attachment
        from PIL import Image

        n = 512
        uv = (np.arange(n) + 0.5) / n
        uu, vv = np.meshgrid(uv, uv, indexing="xy")
        h = np.clip(0.4 + 0.3 * uu, 0.02, 1.0)
        red = 0.1 + 0.85 * uu
        rgba = np.stack([red, vv, 0.5 * np.ones_like(uu), np.ones_like(uu)], axis=-1)
        array_to_source(h, tmp_path / "h.png")
        Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(tmp_path / "a.png")

        config = TerrainConfig(
            lod_count=2,
            model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
            atlas_size=16, path="t", assets_root=str(tmp_path / "assets"),
            attachments=(height_attachment(), albedo_attachment()),
        )
        atlas = TileAtlas(config)
        pre = Preprocessor(atlas).clear_attachment(0)
        pre.preprocess_tile(PreprocessDataset(0, str(tmp_path / "h.png"), lod_range=range(0, 2)))
        pre.preprocess_tile(PreprocessDataset(1, str(tmp_path / "a.png"), lod_range=range(0, 2)))
        pre.run(verbose=False)

        t = Terrain(config)
        t.add_view("cam", TerrainViewConfig(tile_capacity=128), queue_capacity=512)
        view = np.array([0.0, 120.0, 0.0])
        for _ in range(30):
            t.update({"cam": view})
            if not t.atlas.state.to_load and not any(a.loading for a in t.atlas.attachments):
                break
            time.sleep(0.01)
        t.update({"cam": view})

        rng = np.random.default_rng(21)
        pts = np.stack([
            rng.uniform(-450, 450, 24), np.zeros(24), rng.uniform(-450, 450, 24),
        ], axis=-1)
        got = np.asarray(t.query_attachment("cam", pts, 1))
        want = np.array([
            sample_attachment(t.tile_trees["cam"], t.atlas, 1, p) for p in pts
        ])
        np.testing.assert_allclose(got, want, atol=0.02)
        # the analytic colormap too: red tracks u, green tracks v
        u, v = pts[:, 0] / 1000.0 + 0.5, pts[:, 2] / 1000.0 + 0.5
        assert np.median(np.abs(got[:, 0] - (0.1 + 0.85 * u))) < 0.02
        assert np.median(np.abs(got[:, 1] - v)) < 0.02


class TestFlyCamera:
    def test_update_law_matches_reference(self):
        """FlyCamera reproduces DebugCameraController's update law
        (camera.rs:160-204): velocity lerp, speed acceleration, yaw wrap,
        pitch clamp, camera-basis movement."""
        from bevy_terrain_tpu.debug import FlyCamera

        # velocity lerp: v' = v + (target - v) * (1 - smoothness)
        c = FlyCamera(translational_smoothness=0.9, translation_speed=100.0)
        c.update(0.1, move=(1.0, 0.0, 0.0))
        np.testing.assert_allclose(
            c.translation_velocity, [100.0 * 0.1 * 0.1, 0.0, 0.0]
        )
        # speed acceleration: *= 1 + a * accel_speed * dt
        s0 = c.translation_speed
        c.update(0.5, accelerate=1.0)
        assert c.translation_speed == pytest.approx(s0 * (1.0 + 4.0 * 0.5))
        # pitch clamps at +/- pi/2; yaw wraps at tau
        c = FlyCamera(rotational_smoothness=0.0, rotation_speed=1.0)
        for _ in range(100):
            c.update(1.0, look=(1.0, 1.0))
        assert c.pitch == pytest.approx(np.pi / 2)
        assert 0.0 <= c.yaw < 2.0 * np.pi
        # movement is basis-relative: after a half-turn yaw, forward flips
        c = FlyCamera(translational_smoothness=0.0)
        c.yaw = np.pi
        c.update(0.1, move=(0.0, 0.0, 1.0))
        assert c.position[2] > 0  # -Z forward rotated to +Z
        # frustum matrix is well-formed for culling
        vp = c.view_projection()
        assert vp.shape == (4, 4) and np.isfinite(vp).all()

    def test_drives_a_streamed_terrain(self, shaded_terrain):
        """The controller's poses drive Terrain.update directly."""
        from bevy_terrain_tpu.debug import FlyCamera

        t, view, _ = shaded_terrain
        c = FlyCamera(position=np.asarray(view, np.float64),
                      translation_speed=500.0)
        for _ in range(5):
            pos = c.update(0.05, move=(0.3, 0.0, 1.0), look=(0.2, -0.1))
            out = t.update({"cam": pos})["cam"]
        assert out.tile_count > 0
