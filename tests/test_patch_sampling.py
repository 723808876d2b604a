"""Tests for the gather-free patch sampling pipeline (ops/patch_sampling.py)
and the grid-layout mesh path, including fast-vs-exact comparison."""

import time

import jax.numpy as jnp
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
from bevy_terrain_tpu.ops import meshgen, patch_sampling as ps, refinement
from bevy_terrain_tpu.ops.params import StaticTerrainConfig
from bevy_terrain_tpu.utils.synthetic import generate_planar_dataset


def smooth_field(u, v):
    return 0.5 + 0.3 * np.sin(2 * np.pi * u) * np.cos(2 * np.pi * v)


CFG = StaticTerrainConfig(
    spherical=False, side_count=1, lod_count=2, tree_size=8, grid_size=16,
    refinement_count=8, queue_capacity=1024, tile_capacity=256, origin_lod=10,
)


class TestPatchPlan:
    def test_512_plan(self):
        plan = ps.make_patch_plan(512, 4, 2)
        assert plan.usable and plan.min_mip == 1 and plan.max_mip == 3
        # per-slot blocks: mip1 8x8 + mip2 4x4 + mip3 2x2
        assert plan.total_blocks_per_slot == 64 + 16 + 4
        assert plan.bases[1] == 0 and plan.bases[2] == 64 and plan.bases[3] == 80

    def test_small_texture_not_usable(self):
        assert not ps.make_patch_plan(64, 3, 2).usable
        assert not ps.make_patch_plan(512, 1, 2).usable


class TestHalfgridResample:
    def test_constant_patch(self):
        patch = jnp.full((3, 64, 64), 7.0)
        p0 = jnp.zeros((3, 2))
        dp = jnp.full((3,), 0.992)
        half = ps.halfgrid_resample(patch, p0, dp, CFG)
        np.testing.assert_allclose(np.asarray(half), 7.0, rtol=1e-6)

    def test_linear_ramp_exact(self):
        # bilinear interpolation reproduces a linear field exactly
        y, x = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
        patch = jnp.asarray((2.0 * x + 3.0 * y)[None].astype(np.float32))
        p0 = jnp.asarray([[1.25, 2.5]])
        dp = jnp.asarray([0.9])
        half = np.asarray(ps.halfgrid_resample(patch, p0, dp, CFG))
        k = np.arange(33)
        px = 1.25 + k * 0.9
        py = 2.5 + k * 0.9
        expect = 2.0 * px[None, :] + 3.0 * py[:, None]
        np.testing.assert_allclose(half[0], expect, rtol=1e-5)

    def test_clamp_to_edge(self):
        patch = jnp.asarray(np.arange(64, dtype=np.float32)[None, None, :].repeat(64, 1))
        p0 = jnp.asarray([[-0.5, 0.0]])  # starts left of the patch
        dp = jnp.asarray([1.0])
        half = np.asarray(ps.halfgrid_resample(patch, p0, dp, CFG))
        assert half[0, 0, 0] == pytest.approx(0.0)  # clamped, not negative


class TestVertexInterp:
    def test_unmorphed_vertices_hit_even_halfgrid(self):
        rng = np.random.default_rng(0)
        half = jnp.asarray(rng.uniform(size=(2, 33, 33)).astype(np.float32))
        g = np.arange(17) / 16.0
        guv = np.stack(np.meshgrid(g, g, indexing="xy"), axis=-1)
        uv = jnp.broadcast_to(jnp.asarray(guv[None], jnp.float32), (2, 17, 17, 2))
        vals = np.asarray(
            ps.vertex_values_from_halfgrid(ps.permute_halfgrid(half), uv, CFG)
        )
        expect = np.asarray(half)[:, ::2, ::2]
        np.testing.assert_allclose(vals, expect, atol=1e-6)

    def test_half_morphed_vertex(self):
        half = jnp.asarray(np.zeros((1, 33, 33), np.float32))
        half = half.at[0, 10, 14].set(1.0)
        # vertex at grid (7, 5): u=7/16 (hx=14); morph moves it toward the
        # even grid 6/16 (hx=12). At hx=13.5 the tent between half-grid
        # points 13 and 14 weights half[10,14] by 0.5.
        uv = np.zeros((1, 17, 17, 2), np.float32)
        g = np.arange(17) / 16.0
        uv[0, :, :, 0], uv[0, :, :, 1] = np.meshgrid(g, g, indexing="xy")
        uv[0, 5, 7, 0] = 13.5 / 32.0
        uv[0, 5, 7, 1] = 10.0 / 32.0
        half_p = ps.permute_halfgrid(half)
        vals = np.asarray(ps.vertex_values_from_halfgrid(half_p, jnp.asarray(uv), CFG))
        assert vals[0, 5, 7] == pytest.approx(0.5)
        # and exactly on the half-grid point 14 it is 1.0
        uv[0, 5, 7, 0] = 14.0 / 32.0
        vals = np.asarray(ps.vertex_values_from_halfgrid(half_p, jnp.asarray(uv), CFG))
        assert vals[0, 5, 7] == pytest.approx(1.0)


@pytest.fixture(scope="module")
def big_terrain(tmp_path_factory):
    root = tmp_path_factory.mktemp("assets")
    attachment = AttachmentConfig(
        name="height", texture_size=512, border_size=2, mip_level_count=4,
        format=AttachmentFormat.R16,
    )
    generate_planar_dataset("terrains/big", 2, attachment, height_fn=smooth_field,
                            root=str(root))
    config = TerrainConfig(
        lod_count=2,
        model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
        atlas_size=16, path="terrains/big", attachments=(attachment,),
        assets_root=str(root),
    )
    terrain = Terrain(config)
    terrain.add_view("cam", TerrainViewConfig(tile_capacity=256), queue_capacity=1024)
    view = np.array([120.0, 60.0, -80.0])
    for _ in range(30):
        out = terrain.update({"cam": view})
        if not terrain.atlas.state.to_load and not any(
            a.loading for a in terrain.atlas.attachments
        ):
            break
        time.sleep(0.01)
    out = terrain.update({"cam": view})
    return terrain, view, out["cam"]


class TestGridMeshPath:
    def test_grid_path_active(self, big_terrain):
        terrain, _, out = big_terrain
        assert terrain.use_grid_mesh
        assert isinstance(out.mesh, meshgen.GridMeshOutput)

    def test_heights_match_analytic(self, big_terrain):
        _, _, out = big_terrain
        mask = np.asarray(out.mesh.tile_mask)
        pos = np.asarray(out.mesh.positions)[mask]
        u = pos[..., 0] / 1000.0 + 0.5
        v = pos[..., 2] / 1000.0 + 0.5
        expect = smooth_field(u, v) * 100.0
        err = np.abs(pos[..., 1] - expect)
        assert np.median(err) < 0.5, float(np.median(err))
        assert err.max() < 3.0, float(err.max())

    def test_fast_matches_exact_path(self, big_terrain):
        terrain, view, out = big_terrain
        # run the exact per-vertex-gather path on the same frame state
        tree = terrain.tile_trees["cam"]
        from bevy_terrain_tpu.math.approximation import TerrainModelApproximation
        from bevy_terrain_tpu.ops.params import make_frame_uniforms

        approx = TerrainModelApproximation.compute(
            terrain.config.model, view, tree.origin_lod, tree.approximate_height
        )
        uniforms = make_frame_uniforms(
            terrain.config.model, view, approx, tree.origins, tree.entries,
            tree.view_tile_int, tree.view_tile_frac, terrain.view_configs["cam"],
        )
        cfg = terrain._static_cfgs["cam"]
        height = terrain.atlas.attachments[0]
        tiles = refinement.refine_tiles(uniforms, cfg)
        exact = meshgen.generate_mesh(
            tiles, height.slabs[0], uniforms, cfg,
            height.config.scale, height.config.offset,
        )
        n = int(tiles.tile_count)
        # the grid mesh rows are quad-id sorted (patch_sampling.PatchBatch);
        # align the exact (refinement-order) rows by tile coordinate
        key = lambda l, x, y: (int(l), int(x), int(y))
        exact_index = {
            key(l, x, y): i
            for i, (l, (x, y)) in enumerate(
                zip(np.asarray(tiles.tile_lod[:n]), np.asarray(tiles.tile_xy[:n]))
            )
        }
        fast_lod = np.asarray(out.tiles.tile_lod[:n])
        fast_xy = np.asarray(out.tiles.tile_xy[:n])
        order = np.array(
            [exact_index[key(l, x, y)] for l, (x, y) in zip(fast_lod, fast_xy)]
        )
        strip_fast = meshgen.grid_to_strip_order(out.mesh.heights, cfg)[:n]
        strip_exact = np.asarray(exact.heights)[order]
        err = np.abs(strip_fast - strip_exact)
        # fast path samples mips >= 1: expect sub-percent deviation on the
        # smooth field (100 m height range)
        assert np.median(err) < 0.2, float(np.median(err))
        assert np.percentile(err, 99) < 1.0, float(np.percentile(err, 99))


class TestSeamContinuity:
    def test_same_lod_edges_match_exactly(self, big_terrain):
        """Adjacent same-lod tiles must produce identical vertex positions
        along their shared edge (the no-cracks guarantee the reference's
        morph design provides, terrain_view.rs:34-37)."""
        terrain, _, out = big_terrain
        n = out.tile_count
        lod = np.asarray(out.tiles.tile_lod[:n])
        xy = np.asarray(out.tiles.tile_xy[:n])
        pos = np.asarray(out.mesh.positions[:n])

        index = {(int(l), int(x), int(y)): i for i, (l, (x, y)) in enumerate(zip(lod, xy))}
        pairs = 0
        for (l, x, y), i in index.items():
            j = index.get((l, x + 1, y))
            if j is None:
                continue
            left_edge = pos[i][:, -1]  # u = 1 column of tile i
            right_edge = pos[j][:, 0]  # u = 0 column of tile j
            d = np.abs(left_edge - right_edge)
            # x/z must match exactly (same lattice); heights may differ by
            # f32 sub-texel sampling noise (each tile samples the shared
            # edge through its own atlas window) — bound it at 0.1% of the
            # height range, far below a visible crack
            np.testing.assert_array_equal(d[:, 0], 0.0)
            np.testing.assert_array_equal(d[:, 2], 0.0)
            assert d[:, 1].max() < 0.1, float(d[:, 1].max())
            pairs += 1
        assert pairs > 0

    def test_cross_lod_edges_close(self, big_terrain):
        """At a coarse-fine boundary the fine tile's even edge vertices sit
        on the coarse tile's edge (morph collapses the odd ones); heights may
        differ by the data-lod blend but positions must be near-continuous.

        The fixture frame is re-refined from a ground-level corner camera
        with a short morph distance, which GUARANTEES a lod gradient (and
        therefore cross-lod right-edge boundaries) — the assertion can
        never silently skip."""
        terrain, _, _ = big_terrain
        terrain.tune_view("cam", morph_distance=2.0)
        out = terrain.update({"cam": np.array([-380.0, 30.0, -380.0])})["cam"]
        terrain.tune_view("cam", morph_distance=16.0)
        n = out.tile_count
        lod = np.asarray(out.tiles.tile_lod[:n])
        xy = np.asarray(out.tiles.tile_xy[:n])
        pos = np.asarray(out.mesh.positions[:n])
        index = {(int(l), int(x), int(y)): i for i, (l, (x, y)) in enumerate(zip(lod, xy))}
        checked = 0
        for (l, x, y), i in index.items():
            # coarse neighbour to the right: tile at lod l-1 covering x+1
            j = index.get((l - 1, (x + 1) >> 1, y >> 1))
            if j is None or (x + 1) % 2 != 0:
                continue
            fine_edge = pos[i][:, -1]  # 17 vertices
            coarse_edge = pos[j][:, 0]  # 17 vertices over twice the span
            # fine tile covers half the coarse edge: its even vertices should
            # approach coarse vertices (sub-half-grid deviation allowed: the
            # blend/morph transition is mid-fade at such boundaries)
            half = coarse_edge[: 9] if (y % 2 == 0) else coarse_edge[8:]
            fine_even = fine_edge[::2]
            err = np.linalg.norm(fine_even - half, axis=-1)
            # tile size at this lod bounds the acceptable deviation
            tile_size = 1000.0 / (1 << int(l))
            assert np.median(err) < 0.15 * tile_size, (l, x, y, float(np.median(err)))
            checked += 1
        assert checked > 0, "fixture frame lost its lod gradient"


class TestQuadRows:
    def test_layout_and_adjacency(self):
        """quad_rows entry i holds blocks (i, i+1, i+g, i+g+1) as lane
        groups Q[r, 32q+c] (the one-gather patch layout)."""
        from bevy_terrain_tpu.ops.patch_sampling import quad_rows

        rng = np.random.default_rng(3)
        g = 4
        blocks = rng.integers(0, 1000, (g * g, 32, 32)).astype(np.int32)
        quads = quad_rows(blocks, g)
        assert quads.shape == (g * g, 32, 128)
        for bx in range(g - 1):
            for by in range(g - 1):
                i = by * g + bx
                np.testing.assert_array_equal(quads[i, :, 0:32], blocks[i])
                np.testing.assert_array_equal(quads[i, :, 32:64], blocks[i + 1])
                np.testing.assert_array_equal(quads[i, :, 64:96], blocks[i + g])
                np.testing.assert_array_equal(quads[i, :, 96:128], blocks[i + g + 1])

    def test_fetch_assembles_patch(self):
        from bevy_terrain_tpu.ops.patch_sampling import fetch_patches_xla, quad_rows

        rng = np.random.default_rng(4)
        g = 4
        blocks = rng.integers(0, 1000, (g * g, 32, 32)).astype(np.int32)
        quads = jnp.asarray(quad_rows(blocks, g))
        tl = 1 * g + 1  # interior block
        ids = np.array([[tl, tl + 1, tl + g, tl + g + 1]], np.int32)
        patch = np.asarray(fetch_patches_xla(quads, jnp.asarray(ids)))[0]
        want = np.block([[blocks[tl], blocks[tl + 1]], [blocks[tl + g], blocks[tl + g + 1]]])
        np.testing.assert_array_equal(patch, want.astype(np.float32))


class TestWeightBlend:
    def _setup(self):
        from bevy_terrain_tpu.ops.params import StaticTerrainConfig

        cfg = StaticTerrainConfig(
            spherical=False, side_count=1, lod_count=1, tree_size=1, grid_size=16,
            refinement_count=1, queue_capacity=8, tile_capacity=8, origin_lod=0,
        )
        rng = np.random.default_rng(5)
        F = 8
        patch = jnp.asarray(rng.uniform(0, 100, (F, 64, 64)).astype(np.float32))
        p0 = jnp.asarray(rng.uniform(5, 25, (F, 2)).astype(np.float32))
        dp = jnp.asarray(rng.uniform(0.5, 1.0, (F,)).astype(np.float32))
        return cfg, patch, p0, dp

    def test_ratio_zero_is_plain_bilinear(self):
        from bevy_terrain_tpu.ops.patch_sampling import halfgrid_resample

        cfg, patch, p0, dp = self._setup()
        plain = halfgrid_resample(patch, p0, dp, cfg)
        zero = halfgrid_resample(patch, p0, dp, cfg, ratio=jnp.zeros(patch.shape[0]))
        np.testing.assert_allclose(np.asarray(plain), np.asarray(zero), rtol=1e-6)

    def test_ratio_one_equals_value_space_smoothing(self):
        """S@(wy patch wx.T)@S == (S@wy) patch (S@wx).T — the closed-form
        smoothed tents reproduce smooth_halfgrid exactly at ratio 1."""
        from bevy_terrain_tpu.ops.patch_sampling import halfgrid_resample, smooth_halfgrid

        cfg, patch, p0, dp = self._setup()
        plain = halfgrid_resample(patch, p0, dp, cfg)
        want = np.asarray(smooth_halfgrid(plain))
        got = np.asarray(
            halfgrid_resample(patch, p0, dp, cfg, ratio=jnp.ones(patch.shape[0]))
        )
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-3)


class TestTakeSideRows:
    def test_matches_direct_indexing(self):
        from bevy_terrain_tpu.ops.coords import take_side_rows

        rng = np.random.default_rng(6)
        for tail in [(2,), (3,), (3, 3)]:
            table = jnp.asarray(rng.uniform(-1, 1, (6, *tail)).astype(np.float32))
            side = jnp.asarray(rng.integers(0, 6, (5, 7)).astype(np.int32))
            got = np.asarray(take_side_rows(table, side, 6))
            want = np.asarray(table)[np.asarray(side)]
            np.testing.assert_array_equal(got, want)
        # planar: broadcast of row 0 regardless of side values
        table = jnp.asarray(rng.uniform(-1, 1, (6, 2)).astype(np.float32))
        got = np.asarray(take_side_rows(table, jnp.zeros((4,), jnp.int32), 1))
        np.testing.assert_array_equal(got, np.broadcast_to(np.asarray(table)[0], (4, 2)))


class TestPerVertexBlend:
    def test_per_vertex_blend_runs_and_tightens_seams(self, tmp_path):
        """blend_per_vertex applies the reference's per-vertex crossfade
        (fragment.wgsl blend) instead of the per-tile-center ratio; heights
        stay valid, the flag changes blend-zone output, and coincident
        vertices stay within the band-limit tolerance in both modes."""
        root = tmp_path
        attachment = AttachmentConfig(
            name="height", texture_size=512, border_size=2, mip_level_count=4,
            format=AttachmentFormat.R16,
        )
        generate_planar_dataset("terrains/pv", 3, attachment,
                                height_fn=smooth_field, root=str(root))
        config = TerrainConfig(
            lod_count=3,
            model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
            atlas_size=128, path="terrains/pv", attachments=(attachment,),
            assets_root=str(root),
        )

        def spread(out):
            mask = np.asarray(out.mesh.tile_mask)
            pos = np.asarray(out.mesh.positions)[mask].reshape(-1, 3)
            key = np.round(pos[:, [0, 2]] * 64).astype(np.int64)
            flat = key[:, 0] * 10_000_019 + key[:, 1]
            order = np.argsort(flat, kind="stable")
            fs, ys = flat[order], pos[order, 1]
            grp = np.flatnonzero(np.diff(fs) != 0)
            starts = np.concatenate([[0], grp + 1])
            ends = np.concatenate([grp + 1, [len(fs)]])
            sp = [ys[a:b].max() - ys[a:b].min() for a, b in zip(starts, ends) if b - a > 1]
            return pos, float(np.percentile(sp, 99)) if sp else (pos, 0.0)

        view = np.array([60.0, 40.0, -40.0])

        def run(**overrides):
            terrain = Terrain(config)
            terrain.add_view("cam", TerrainViewConfig(tile_capacity=1024),
                             queue_capacity=4096, **overrides)
            for _ in range(30):
                out = terrain.update({"cam": view})
                if not terrain.atlas.state.to_load and not any(
                    a.loading for a in terrain.atlas.attachments
                ):
                    break
                time.sleep(0.01)
            return terrain.update({"cam": view})["cam"]

        out_tile = run()
        out_vert = run(blend_per_vertex=True)
        pos_t, p99_t = spread(out_tile)
        pos_v, p99_v = spread(out_vert)
        assert np.isfinite(pos_v).all()
        # heights must stay in range and close to the per-tile mode
        diff = np.abs(pos_v[:, 1] - pos_t[:, 1])
        assert diff.max() < 5.0
        # the flag takes effect (crossfade differs inside blend zones)
        assert diff.max() > 1e-5
        # both modes keep coincident vertices within the documented
        # band-limit tolerance (0.1% of the 100 m range)
        assert p99_t < 0.1 and p99_v < 0.1, (p99_t, p99_v)


class TestTileTreeLodMode:
    def test_tile_tree_lod_walk_produces_valid_frame(self, big_terrain, tmp_path):
        """TILE_TREE_LOD (functions.wgsl:232-246 #ifdef): data lod from the
        deepest containing tree window instead of the blend lod."""
        terrain, view, _ = big_terrain
        terrain.add_view("walk", TerrainViewConfig(tile_capacity=256),
                         queue_capacity=1024, tile_tree_lod=True)
        for _ in range(30):
            out = terrain.update({"walk": view})
            if not terrain.atlas.state.to_load and not any(
                a.loading for a in terrain.atlas.attachments
            ):
                break
            time.sleep(0.01)
        out = terrain.update({"walk": view})["walk"]
        assert out.tile_count > 0
        mask = np.asarray(out.mesh.tile_mask)
        h = np.asarray(out.mesh.heights)[mask]
        assert np.isfinite(h).all() and h.max() <= 100.0 + 1e-3
        # heights still track the analytic field through the walk lookup
        pos = np.asarray(out.mesh.positions)[mask].reshape(-1, 3)
        u = pos[:, 0] / 1000.0 + 0.5
        v = pos[:, 2] / 1000.0 + 0.5
        err = np.abs(pos[:, 1] - smooth_field(u, v) * 100.0)
        assert np.median(err) < 3.0, float(np.median(err))
        terrain.remove_view("walk")


class TestVertexDensityMipBound:
    """The aniso question, measured.

    The reference samples attachments with anisotropy-16 textureSampleGrad
    in the FRAGMENT stage (terrain_bind_group.rs:124, attachments.wgsl:
    12-24) — a screen-space resampling concern. This build has no screen
    derivatives at the vertex stage; instead patch_geometry picks the mip
    whose texel density matches the vertex half-grid (2x vertex density).
    The claim retired with SAMPLE_GRAD: that choice bounds the height
    error by the field's energy ABOVE the half-grid Nyquist (detail the
    mesh cannot represent anyway), while sub-Nyquist content is exact to
    interpolation error. Here both halves are measured.
    """

    def _frame_heights(self, tmp_path, field):
        att = AttachmentConfig(
            name="height", texture_size=512, border_size=2, mip_level_count=4,
            format=AttachmentFormat.R16,
        )
        generate_planar_dataset(
            "terrains/aniso", 1, att, height_fn=field, root=str(tmp_path)
        )
        config = TerrainConfig(
            lod_count=1,
            model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
            atlas_size=8, path="terrains/aniso", attachments=(att,),
            assets_root=str(tmp_path),
        )
        terrain = Terrain(config)
        terrain.add_view(
            "cam", TerrainViewConfig(tile_capacity=16), queue_capacity=64
        )
        view = np.array([0.0, 400.0, 0.0])
        for _ in range(30):
            out = terrain.update({"cam": view})
            if not terrain.atlas.state.to_load and not any(
                a.loading for a in terrain.atlas.attachments
            ):
                break
            time.sleep(0.01)
        out = terrain.update({"cam": view})["cam"]
        mask = np.asarray(out.mesh.tile_mask)
        pos = np.asarray(out.mesh.positions)[mask]
        return pos[..., 0], pos[..., 2], pos[..., 1]

    def test_error_bounded_by_super_nyquist_energy(self, tmp_path):
        # sub-Nyquist smooth content + a ripple at ~3-texel wavelength
        # (far above the half-grid Nyquist at every streamed lod here)
        A_HF = 0.05  # 5 m of 100 m range

        def rough(u, v):
            return (
                0.5
                + 0.3 * np.sin(2 * np.pi * u) * np.cos(2 * np.pi * v)
                + A_HF * np.sin(2 * np.pi * 170 * u) * np.cos(2 * np.pi * 170 * v)
            )

        def smooth(u, v):
            return 0.5 + 0.3 * np.sin(2 * np.pi * u) * np.cos(2 * np.pi * v)

        x, z, h = self._frame_heights(tmp_path / "r", rough)
        u, v = x / 1000.0 + 0.5, z / 1000.0 + 0.5
        # 1) total error vs the full analytic field is bounded by the
        # super-Nyquist amplitude (the mip chain averages the ripple out;
        # the mesh could never carry it)
        err_full = np.abs(h - rough(u, v) * 100.0)
        assert np.percentile(err_full, 95) < (A_HF * 100.0) * 1.4, float(
            np.percentile(err_full, 95)
        )
        # 2) against the band-limited (representable) field the error is
        # interpolation-level — the ripple does NOT alias into the mesh
        err_band = np.abs(h - smooth(u, v) * 100.0)
        assert np.median(err_band) < 1.0, float(np.median(err_band))
        assert np.percentile(err_band, 99) < 3.0, float(np.percentile(err_band, 99))


class TestGradTaps:
    """Anisotropic multi-tap color sampling: the
    SAMPLE_GRAD equivalent for albedo under grazing angles (reference
    attachments.wgsl:12-24, anisotropy 16). Heights keep the measured
    vertex-density-mip answer (TestVertexDensityMipBound); COLOR adds the
    optional grad-weighted taps tested here."""

    @pytest.fixture(scope="class")
    def striped(self, tmp_path_factory):
        from PIL import Image

        from bevy_terrain_tpu import PreprocessDataset, Preprocessor
        from bevy_terrain_tpu.formats.tiff import array_to_source
        from bevy_terrain_tpu.models import albedo_attachment, height_attachment
        from bevy_terrain_tpu.terrain_data import TileAtlas

        tmp = tmp_path_factory.mktemp("striped")
        n = 1024
        uv01 = (np.arange(n) + 0.5) / n
        uu, vv = np.meshgrid(uv01, uv01, indexing="xy")
        # flat terrain; stripes along u with period 64 source texels =
        # period 4 texels at the grazing lod-0 tiles' mip 3 (512-texture,
        # d=0 -> m=3): exactly representable through the mip chain (no
        # box-filter kill), ~2 half-grid samples per period (dp ~= 2
        # texels) — the band that aliases the vertex grid and that the
        # anisotropic taps (footprint aniso*dp ~= 8 texels) box-filter
        stripes = ((uu * n / 32).astype(np.int64) % 2).astype(np.float64)
        rgba = np.stack(
            [0.25 + 0.5 * stripes, 0.5 * np.ones_like(uu),
             np.ones_like(uu) - 0.5 * stripes, np.ones_like(uu)],
            axis=-1,
        )
        array_to_source(np.full_like(uu, 0.5), tmp / "h.png")
        Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(tmp / "a.png")
        config = TerrainConfig(
            lod_count=2,
            model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
            atlas_size=16, path="s", assets_root=str(tmp / "assets"),
            attachments=(height_attachment(), albedo_attachment()),
        )
        atlas = TileAtlas(config)
        pre = Preprocessor(atlas).clear_attachment(0)
        pre.preprocess_tile(PreprocessDataset(0, str(tmp / "h.png"), lod_range=range(0, 2)))
        pre.preprocess_tile(PreprocessDataset(1, str(tmp / "a.png"), lod_range=range(0, 2)))
        pre.run(verbose=False)
        t = Terrain(config)
        t.add_view("cam", TerrainViewConfig(tile_capacity=256), queue_capacity=1024)
        return t

    def _frame(self, t, view):
        for _ in range(30):
            out = t.update({"cam": view})
            if not t.atlas.state.to_load and not any(
                a.loading for a in t.atlas.attachments
            ):
                break
            time.sleep(0.01)
        return t.update({"cam": view})["cam"]

    def test_topdown_taps_match_single(self, striped):
        """No anisotropy looking straight down: the multi-tap footprint
        collapses and the result equals the single tap."""
        t = striped
        out = self._frame(t, np.array([0.0, 400.0, 0.0]))
        a1 = np.asarray(t.sample_attachment_grid("cam", out, 1))
        a8 = np.asarray(t.sample_attachment_grid("cam", out, 1, grad_taps=8))
        mask = np.asarray(out.mesh.tile_mask)
        pos = np.asarray(out.mesh.positions)[mask]
        # near-nadir vertices only (the frame spans the whole plane)
        near = np.linalg.norm(pos[..., [0, 2]], axis=-1) < 150.0
        np.testing.assert_allclose(a8[mask][near], a1[mask][near], atol=5e-3)

    def test_grazing_alias_reduced(self, striped):
        """At grazing angles the single tap aliases the stripes (full
        amplitude around the 0.5 mean); the anisotropic taps box-filter
        along the compressed axis and pull every sample toward the mean."""
        t = striped
        view = np.array([-480.0, 54.0, 0.0])  # 4 m above the 50 m surface
        out = self._frame(t, view)
        a1 = np.asarray(t.sample_attachment_grid("cam", out, 1))
        a8 = np.asarray(t.sample_attachment_grid("cam", out, 1, grad_taps=8))
        mask = np.asarray(out.mesh.tile_mask)
        pos = np.asarray(out.mesh.positions)[mask]
        d = pos - view
        # grazing AND far: view elevation angle below ~2 degrees
        graze = (np.abs(d[..., 1]) / np.maximum(
            np.linalg.norm(d, axis=-1), 1e-6)) < 0.035
        graze &= np.linalg.norm(d, axis=-1) > 200.0
        # the footprint elongates along the VIEW's surface projection —
        # like textureSampleGrad, it only crosses the stripes (which vary
        # along world x) where the view runs along x; viewed along z the
        # taps slide parallel to the stripes and must NOT blur them
        along_x = graze & (np.abs(d[..., 0]) > 3.0 * np.abs(d[..., 2]))
        along_z = graze & (np.abs(d[..., 2]) > 3.0 * np.abs(d[..., 0]))
        assert along_x.sum() > 500 and along_z.sum() > 500
        # red channel stripes: 0.25 / 0.75 around the 0.5 mean
        dev1 = np.abs(a1[mask][along_x][..., 0] - 0.5)
        dev8 = np.abs(a8[mask][along_x][..., 0] - 0.5)
        assert dev8.mean() < 0.65 * dev1.mean(), (
            float(dev1.mean()), float(dev8.mean())
        )
        # no cross-stripe blur in the perpendicular direction (measured
        # ratio ~0.98; guard against accidental isotropic blurring)
        dz1 = np.abs(a1[mask][along_z][..., 0] - 0.5)
        dz8 = np.abs(a8[mask][along_z][..., 0] - 0.5)
        assert dz8.mean() > 0.9 * dz1.mean(), (
            float(dz1.mean()), float(dz8.mean())
        )
