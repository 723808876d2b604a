"""Device-kernel tests: coordinate math, refinement, tile-tree scan, meshgen.

Property tests per SURVEY.md section 4: refinement coverage (complete,
non-overlapping), crack-freeness (neighbouring final tiles differ by <= 1
lod), request-scan equivalence with the exact f64 host twin, morph math
against the WGSL formulas.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bevy_terrain_tpu.config import TerrainViewConfig
from bevy_terrain_tpu.math import TerrainModel, TerrainModelApproximation
from bevy_terrain_tpu.ops import coords, meshgen, refinement, tile_tree
from bevy_terrain_tpu.ops.params import (
    FrameUniforms,
    StaticTerrainConfig,
    make_frame_uniforms,
)


def build_frame(model, view_config, view_pos, lod_count, entries=None,
                view_proj=None, **cfg_kw):
    cfg_kw.setdefault("queue_capacity", 4096)
    cfg = StaticTerrainConfig(
        spherical=model.is_spherical,
        side_count=model.side_count,
        lod_count=lod_count,
        tree_size=view_config.tree_size,
        grid_size=view_config.grid_size,
        refinement_count=view_config.refinement_count,
        tile_capacity=view_config.tile_capacity,
        origin_lod=view_config.origin_lod,
        **cfg_kw,
    )
    origins, vt_int, vt_frac = tile_tree.compute_view_anchors(
        model, view_pos, lod_count, view_config.tree_size
    )
    approx = TerrainModelApproximation.compute(
        model, view_pos, view_config.origin_lod, (model.min_height + model.max_height) / 2
    )
    if entries is None:
        # every slot reports "root tile loaded at atlas slot 0"
        entries = np.zeros(
            (model.side_count, lod_count, cfg.tree_size, cfg.tree_size, 2), np.int32
        )
    uniforms = make_frame_uniforms(
        model, view_pos, approx, origins, entries, vt_int, vt_frac, view_config,
        view_proj=view_proj,
    )
    return cfg, uniforms


PLANAR = TerrainModel.planar(np.array([0.0, -100.0, 0.0]), 1000.0, 0.0, 250.0)
SPHERE = TerrainModel.sphere(np.zeros(3), 6.4e6, 0.0, 9000.0)


class TestCoordinateChangeLod:
    def _host_change(self, lod, xy, uv, new_lod):
        # scalar python twin of functions.wgsl:164-188
        diff = new_lod - lod
        if diff == 0:
            return lod, list(xy), list(uv)
        if diff > 0:
            scaled = [u * 2.0**diff for u in uv]
            xy2 = [int(c) * (1 << diff) + int(s) for c, s in zip(xy, scaled)]
            uv2 = [s % 1.0 for s in scaled]
        else:
            d = -diff
            xy2 = [c >> d for c in xy]
            uv2 = [((c % (1 << d)) + u) * 2.0**diff for c, u in zip(xy, uv)]
        return new_lod, xy2, uv2

    def test_matches_host(self):
        rng = np.random.default_rng(3)
        for _ in range(100):
            lod = int(rng.integers(0, 12))
            new_lod = int(rng.integers(0, 12))
            xy = rng.integers(0, 1 << lod, size=2).astype(np.int32)
            uv = rng.uniform(0, 1, size=2).astype(np.float32)
            got_lod, got_xy, got_uv = coords.coordinate_change_lod(
                jnp.int32(lod), jnp.asarray(xy), jnp.asarray(uv), jnp.int32(new_lod)
            )
            ref_lod, ref_xy, ref_uv = self._host_change(lod, xy, uv.astype(np.float64), new_lod)
            assert int(got_lod) == ref_lod
            np.testing.assert_array_equal(np.asarray(got_xy), ref_xy)
            np.testing.assert_allclose(np.asarray(got_uv), ref_uv, atol=1e-5)

    def test_roundtrip_up_down(self):
        lod, xy, uv = jnp.int32(3), jnp.array([5, 2], jnp.int32), jnp.array([0.25, 0.75], jnp.float32)
        l2, xy2, uv2 = coords.coordinate_change_lod(lod, xy, uv, jnp.int32(7))
        l3, xy3, uv3 = coords.coordinate_change_lod(l2, xy2, uv2, jnp.int32(3))
        np.testing.assert_array_equal(np.asarray(xy3), [5, 2])
        np.testing.assert_allclose(np.asarray(uv3), [0.25, 0.75], atol=1e-6)


class TestTileUv:
    def test_grid_covers_unit_square(self):
        cfg, _ = build_frame(PLANAR, TerrainViewConfig(), np.array([0.0, 0.0, 0.0]), 4)
        uv = np.asarray(meshgen.vertex_grid_uv(cfg))
        assert uv.min() == 0.0 and uv.max() == 1.0
        # grid_size+1 distinct columns in each axis
        assert len(np.unique(uv[:, 0])) == cfg.grid_size + 1
        assert len(np.unique(uv[:, 1])) == cfg.grid_size + 1

    def test_strip_structure(self):
        # consecutive vertices within a row alternate v by one cell
        cfg, _ = build_frame(PLANAR, TerrainViewConfig(grid_size=4), np.zeros(3), 4)
        uv = np.asarray(meshgen.vertex_grid_uv(cfg))
        vpr = cfg.vertices_per_row
        row0 = uv[:vpr]
        # first and second vertex of a row are duplicated (degenerate strip)
        np.testing.assert_array_equal(row0[0], row0[1])
        np.testing.assert_array_equal(uv[vpr - 1], uv[vpr - 2])


class TestLocalPosition:
    def test_matches_host_math(self):
        from bevy_terrain_tpu.math.coordinate import local_position_from_side_uv

        rng = np.random.default_rng(5)
        side = rng.integers(0, 6, size=64).astype(np.int32)
        lod = rng.integers(0, 8, size=64).astype(np.int32)
        xy = np.stack([rng.integers(0, 1 << l) for l in lod]).astype(np.int32)
        xy = np.stack([xy, xy], axis=-1).reshape(64, 2)
        uv = rng.uniform(0, 1, size=(64, 2)).astype(np.float32)
        got = np.asarray(
            coords.compute_local_position(
                jnp.asarray(side), jnp.asarray(lod), jnp.asarray(xy), jnp.asarray(uv), True
            )
        )
        uv01 = (xy + uv) / (1 << lod)[:, None]
        want = local_position_from_side_uv(side, uv01)
        np.testing.assert_allclose(got, want, atol=2e-6)


class TestRefinement:
    def _run(self, model, view_pos, lod_count=6, queue_capacity=4096,
             tile_capacity=16384, **view_kw):
        vc = TerrainViewConfig(tile_capacity=tile_capacity, **view_kw)
        cfg, uniforms = build_frame(
            model, vc, view_pos, lod_count, queue_capacity=queue_capacity
        )
        out = jax.jit(refinement.refine_tiles, static_argnums=1)(uniforms, cfg)
        n = int(out.tile_count)
        assert n > 0
        side = np.asarray(out.tile_side[:n])
        lod = np.asarray(out.tile_lod[:n])
        xy = np.asarray(out.tile_xy[:n])
        return side, lod, xy

    def test_planar_coverage_complete_and_disjoint(self):
        side, lod, xy = self._run(PLANAR, np.array([100.0, 0.0, -200.0]))
        # area conservation: sum of 4^-lod == 1 (full root coverage)
        area = np.sum(0.25**lod.astype(np.float64))
        assert area == pytest.approx(1.0, abs=1e-12)
        # disjoint: no tile is an ancestor of another
        keys = set()
        for l, (x, y) in zip(lod, xy):
            keys.add((int(l), int(x), int(y)))
        for l, (x, y) in zip(lod, xy):
            for al in range(l):
                shift = l - al
                assert (al, int(x) >> shift, int(y) >> shift) not in keys

    def test_spherical_coverage(self):
        view = SPHERE.position_local_to_world(np.array([0.0, 0.0, 1.0]), 2000.0)
        side, lod, xy = self._run(SPHERE, view, lod_count=8, queue_capacity=32768, tile_capacity=32768)
        for s in range(6):
            area = np.sum(0.25 ** lod[side == s].astype(np.float64))
            assert area == pytest.approx(1.0, abs=1e-12), f"side {s}"

    def test_crack_free_neighbours(self):
        # adjacent final tiles differ by at most 1 lod (the CDLOD guarantee
        # that morph can bridge, terrain_view.rs:34-37 docs)
        side, lod, xy = self._run(PLANAR, np.array([10.0, -50.0, 10.0]))
        cells = {}
        for l, (x, y) in zip(lod, xy):
            cells[(int(l), int(x), int(y))] = True
        max_lod = lod.max()
        for l, (x, y) in zip(lod, xy):
            n = 1 << l
            for dx, dy in [(1, 0), (-1, 0), (0, 1), (0, -1)]:
                nx, ny = int(x) + dx, int(y) + dy
                if nx < 0 or ny < 0 or nx >= n or ny >= n:
                    continue
                # find which final tile covers this neighbour cell at any lod
                found = None
                for al in range(0, int(max_lod) + 1):
                    if al <= l:
                        key = (al, nx >> (l - al), ny >> (l - al))
                        if key in cells:
                            found = al
                            break
                    else:
                        break
                if found is None:
                    # neighbour is covered by finer tiles; check one child cell
                    continue
                assert abs(found - int(l)) <= 1, (l, x, y, found)

    def test_closer_view_refines_deeper(self):
        _, lod_far, _ = self._run(PLANAR, np.array([0.0, 5000.0, 0.0]))
        _, lod_near, _ = self._run(PLANAR, np.array([0.0, 5.0, 0.0]))
        assert lod_near.max() > lod_far.max()


class TestTileTreeScan:
    def test_device_matches_host_f64(self):
        vc = TerrainViewConfig()
        view = np.array([120.0, -40.0, -300.0])
        cfg, uniforms = build_frame(PLANAR, vc, view, 4)
        xy_dev, req_dev = jax.jit(tile_tree.tile_tree_update, static_argnums=1)(
            uniforms, cfg
        )
        xy_host, req_host = tile_tree.tile_tree_update_host(PLANAR, view, uniforms, cfg)
        np.testing.assert_array_equal(np.asarray(xy_dev), xy_host)
        agree = np.mean(np.asarray(req_dev) == req_host)
        assert agree > 0.99, f"request masks agree only {agree:.4f}"

    def test_lod0_always_requested(self):
        vc = TerrainViewConfig()
        cfg, uniforms = build_frame(PLANAR, vc, np.array([1e7, 1e7, 1e7]), 4)
        _, req = tile_tree.tile_tree_update(uniforms, cfg)
        assert bool(jnp.all(req[:, 0]))

    def test_spherical_shapes(self):
        vc = TerrainViewConfig()
        view = SPHERE.position_local_to_world(np.array([1.0, 0.0, 0.0]), 1000.0)
        cfg, uniforms = build_frame(SPHERE, vc, view, 6)
        xy, req = tile_tree.tile_tree_update(uniforms, cfg)
        assert xy.shape == (6, 6, 8, 8, 2)
        # near tiles on the viewed side must be requested at the finest lod
        assert bool(jnp.any(req[:, -1]))


class TestMeshgen:
    def test_flat_terrain_positions(self):
        # constant-height atlas: every vertex must land exactly on the plane
        # y = translation.y + height
        vc = TerrainViewConfig(tile_capacity=1024)
        view = np.array([0.0, 200.0, 0.0])
        cfg, uniforms = build_frame(PLANAR, vc, view, 4)
        tiles = refinement.refine_tiles(uniforms, cfg)
        half = np.uint16(0x8000)
        slab = jnp.full((4, 512, 512, 1), half, jnp.uint16)  # ~0.5 normalized
        out = meshgen.generate_mesh(tiles, slab, uniforms, cfg, 508 / 512, 2 / 512)
        n = int(tiles.tile_count)
        pos = np.asarray(out.positions[:n])
        expected_h = 250.0 * (0x8000 / 0xFFFF)
        np.testing.assert_allclose(
            pos[..., 1], -100.0 + expected_h, atol=2e-3
        )
        # x/z inside the terrain bounds
        assert pos[..., 0].min() >= -500.0 - 1e-3 and pos[..., 0].max() <= 500.0 + 1e-3

    def test_masked_lanes_zero(self):
        vc = TerrainViewConfig(tile_capacity=1024)
        cfg, uniforms = build_frame(PLANAR, vc, np.array([0.0, 500.0, 0.0]), 4)
        tiles = refinement.refine_tiles(uniforms, cfg)
        slab = jnp.zeros((4, 512, 512, 1), jnp.uint16)
        out = meshgen.generate_mesh(tiles, slab, uniforms, cfg, 508 / 512, 2 / 512)
        n = int(tiles.tile_count)
        assert np.all(np.asarray(out.positions[n:]) == 0.0)

    def test_jit_compiles_once(self):
        vc = TerrainViewConfig(tile_capacity=1024)
        cfg, uniforms = build_frame(PLANAR, vc, np.array([0.0, 500.0, 0.0]), 4)
        slab = jnp.zeros((4, 512, 512, 1), jnp.uint16)

        @jax.jit
        def frame(u):
            t = refinement.refine_tiles(u, cfg)
            return meshgen.generate_mesh(t, slab, u, cfg, 508 / 512, 2 / 512)

        out1 = frame(uniforms)
        out2 = frame(uniforms)
        np.testing.assert_array_equal(np.asarray(out1.positions), np.asarray(out2.positions))


class TestFrustumCulling:
    """SURVEY L3 target: per-tile frustum test inside the refinement kernel
    (the reference declares the 5-plane CullingUniform but never populates
    it, culling_bind_group.rs:25-55)."""

    def _frames(self, spherical=False):
        from bevy_terrain_tpu.math import frustum

        model = SPHERE if spherical else PLANAR
        vc = TerrainViewConfig(tile_capacity=16384)
        scale = model.scale
        if spherical:
            eye = np.array([0.0, 0.0, 6.5e6])
            target = np.array([0.0, 0.0, 6.4e6])
        else:
            # ground-level side-looking camera
            eye = np.array([30.0, -80.0, -20.0])
            target = eye + np.array([200.0, 0.0, 10.0])
        vp = frustum.view_projection(eye, target, np.pi / 3, 16 / 9)
        lods = 8 if not spherical else 6
        kw = dict(queue_capacity=16384)
        cfg_on, u_on = build_frame(
            model, vc, eye, lods, view_proj=vp, culling=True, **kw)
        cfg_off, u_off = build_frame(model, vc, eye, lods, view_proj=vp, **kw)
        tiles_on = jax.jit(
            refinement.refine_tiles, static_argnames="cfg")(u_on, cfg_on)
        tiles_off = jax.jit(
            refinement.refine_tiles, static_argnames="cfg")(u_off, cfg_off)
        assert int(tiles_on.overflow) == 0 and int(tiles_off.overflow) == 0
        return vp, cfg_on, u_on, tiles_on, tiles_off

    @staticmethod
    def _tile_set(tiles):
        n = int(tiles.tile_count)
        return {
            (int(s), int(l), int(x), int(y))
            for s, l, (x, y) in zip(
                np.asarray(tiles.tile_side[:n]),
                np.asarray(tiles.tile_lod[:n]),
                np.asarray(tiles.tile_xy[:n]),
            )
        }

    def test_planar_reduction_and_subset(self):
        vp, cfg, u, tiles_on, tiles_off = self._frames()
        n_on, n_off = int(tiles_on.tile_count), int(tiles_off.tile_count)
        # a side-looking ground camera sees well under half the tree
        assert n_on < n_off / 1.5
        on, off = self._tile_set(tiles_on), self._tile_set(tiles_off)
        # culling only removes tiles; whatever survives exists identically
        # in the uncull frame (identical visible-set selection)
        assert on <= off

    def test_planar_culled_tiles_outside(self):
        """No tile intersecting the frustum is ever dropped: every OFF-set
        tile whose corners are all strictly inside appears in the ON set
        (conservative test, matching tile_visible's corner volume)."""
        from bevy_terrain_tpu.math import frustum

        vp, cfg, u, tiles_on, tiles_off = self._frames()
        on, off = self._tile_set(tiles_on), self._tile_set(tiles_off)
        planes = frustum.frustum_planes(vp)  # (5, 4)
        model = PLANAR
        m = np.asarray(model.world_from_local, np.float64)
        missing = off - on
        for s, l, x, y in off:
            corners = []
            for cu in (0.0, 1.0):
                for cv in (0.0, 1.0):
                    u01 = (np.array([x, y]) + [cu, cv]) / (1 << l)
                    local = np.array([u01[0] - 0.5, 0.0, u01[1] - 0.5])
                    world = m[:3, :3] @ local + m[:3, 3]
                    for h in (model.min_height, model.max_height):
                        corners.append(world + np.array([0.0, h, 0.0]))
            d = np.array(corners) @ planes[:, :3].T + planes[:, 3]
            fully_inside = (d > 1e-3).all()
            if fully_inside:
                assert (s, l, x, y) in on, (s, l, x, y)
            if (s, l, x, y) in missing:
                # the dropped tile (or an ancestor) was outside some plane;
                # at minimum it cannot be fully inside
                assert not fully_inside

    def test_accept_all_planes_is_identity(self):
        model = PLANAR
        vc = TerrainViewConfig(tile_capacity=16384)
        eye = np.array([30.0, -80.0, -20.0])
        cfg_on, u_on = build_frame(model, vc, eye, 8, culling=True)  # no vp
        cfg_off, u_off = build_frame(model, vc, eye, 8)
        t_on = jax.jit(refinement.refine_tiles, static_argnames="cfg")(u_on, cfg_on)
        t_off = jax.jit(refinement.refine_tiles, static_argnames="cfg")(u_off, cfg_off)
        assert int(t_on.tile_count) == int(t_off.tile_count)
        assert self._tile_set(t_on) == self._tile_set(t_off)

    def test_spherical_culling_conservative(self):
        vp, cfg, u, tiles_on, tiles_off = self._frames(spherical=True)
        n_on, n_off = int(tiles_on.tile_count), int(tiles_off.tile_count)
        assert 0 < n_on < n_off  # something culled (far side of planet)
        assert self._tile_set(tiles_on) <= self._tile_set(tiles_off)


class TestRefinementOverflow:
    def test_overflow_loud(self):
        vc = TerrainViewConfig(tile_capacity=64)
        eye = np.array([10.0, -95.0, 5.0])
        cfg, u = build_frame(PLANAR, vc, eye, 8)
        tiles = jax.jit(refinement.refine_tiles, static_argnames="cfg")(u, cfg)
        assert int(tiles.tile_count) == 64
        assert int(tiles.overflow) > 0

    def test_no_overflow_when_sized(self):
        vc = TerrainViewConfig(tile_capacity=2048)
        eye = np.array([10.0, -95.0, 5.0])
        cfg, u = build_frame(PLANAR, vc, eye, 8)
        tiles = jax.jit(refinement.refine_tiles, static_argnames="cfg")(u, cfg)
        assert int(tiles.overflow) == 0
        assert 0 < int(tiles.tile_count) < 2048


class TestCrossFaceSeams:
    """Numeric cross-face MESH seam check: final
    tiles on two different cube faces at (possibly) different LODs must
    produce coincident boundary geometry — every fine-tile edge vertex on
    a face boundary lies on the coarser neighbour's boundary polyline
    within the f32-at-planetary-scale envelope. This is the numeric twin
    of the reference's visual morph-invariant oracle (debug.wgsl:80-92)
    for the cube-edge case stitch.wgsl:12-74 exists to serve."""

    ENVELOPE_M = 2.5  # world f32 at 6.4e6 m: ~0.5 m/ulp, a few ulps of ops

    @staticmethod
    def _seg_dist(p, a, b):
        ab = b - a
        t = np.clip(np.dot(p - a, ab) / max(np.dot(ab, ab), 1e-12), 0.0, 1.0)
        return float(np.linalg.norm(p - (a + t * ab)))

    @staticmethod
    def _edge_verts(pos, direction):
        dx, dy = direction
        if dx == 1:
            return pos[:, -1, :]
        if dx == -1:
            return pos[:, 0, :]
        if dy == 1:
            return pos[-1, :, :]
        return pos[0, :, :]

    def test_cross_face_boundary_vertices_coincide(self):
        from bevy_terrain_tpu.math.coordinate import (
            TileCoordinate, local_position_from_side_uv,
        )
        from bevy_terrain_tpu.ops import patch_sampling

        # camera 30 km above a point near the side-0 boundary: side 0
        # refines deeper than its neighbour face -> cross-face lod steps
        d = local_position_from_side_uv(0, np.array([0.97, 0.43]))
        d = d / np.linalg.norm(d)
        view = SPHERE.position_local_to_world(d, 30e3)
        vc = TerrainViewConfig(tile_capacity=4096)
        cfg, uniforms = build_frame(
            SPHERE, vc, view, 8, queue_capacity=32768,
            high_precision=True, blend_per_vertex=True,
        )
        tiles0 = refinement.refine_tiles(uniforms, cfg)
        # constant-height atlas: seams are then pure geometry + morph
        plan = patch_sampling.make_patch_plan(512, 4, 2)
        blocks = jnp.full(
            (8 * plan.total_blocks_per_slot, 32, 128), 30000, jnp.int32
        )
        mesh, tiles = meshgen.generate_mesh_grid(
            tiles0, blocks, uniforms, cfg, plan, 65535.0
        )
        n = int(tiles.tile_count)
        side = np.asarray(tiles.tile_side[:n])
        lod = np.asarray(tiles.tile_lod[:n])
        xy = np.asarray(tiles.tile_xy[:n])
        pos = np.asarray(mesh.positions[:n])
        rows = {
            (int(s), int(l), int(x), int(y)): i
            for i, (s, l, (x, y)) in enumerate(zip(side, lod, xy))
        }

        def covering_row(tc, max_lod):
            """Row of the final tile covering coordinate tc at lod <= max_lod."""
            for al in range(int(max_lod), -1, -1):
                sh = int(tc.lod) - al
                key = (tc.side, al, tc.x >> sh, tc.y >> sh)
                if key in rows:
                    return rows[key], al
            return None, None

        checked_pairs = lod_steps = 0
        worst = 0.0
        for i in range(n):
            t = TileCoordinate(int(side[i]), int(lod[i]), int(xy[i][0]),
                               int(xy[i][1]))
            count = 1 << t.lod
            for direction in [(1, 0), (-1, 0), (0, 1), (0, -1)]:
                px, py = t.x + direction[0], t.y + direction[1]
                if 0 <= px < count and 0 <= py < count:
                    continue  # same-face neighbour: covered by the fuzz test
                nb = t.neighbour_coordinate((px, py), spherical=True)
                if nb.side < 0 or nb.side == t.side:
                    continue
                crow, clod = covering_row(nb, t.lod)
                if crow is None:
                    continue  # neighbour side is finer: tested from there
                cpos = pos[crow]
                # the coarse tile's four boundary polylines
                borders = [cpos[0, :, :], cpos[-1, :, :],
                           cpos[:, 0, :], cpos[:, -1, :]]
                for p in self._edge_verts(pos[i], direction):
                    best = min(
                        self._seg_dist(p, poly[k], poly[k + 1])
                        for poly in borders
                        for k in range(poly.shape[0] - 1)
                    )
                    worst = max(worst, best)
                    assert best <= self.ENVELOPE_M, (
                        t, nb, clod, best,
                        "cross-face seam crack beyond the f32 envelope",
                    )
                checked_pairs += 1
                if clod != t.lod:
                    lod_steps += 1
        # the fixture must actually exercise the interesting geometry
        assert checked_pairs >= 8, checked_pairs
        assert lod_steps >= 2, (checked_pairs, lod_steps)

    def test_cross_face_morph_invariants_clean(self):
        """The red/green morph-invariant overlay (debug.wgsl:80-92) is
        clean on the cross-face fixture: no tile overlaps two morph zones
        and none has insufficient LOD."""
        from bevy_terrain_tpu.math.coordinate import local_position_from_side_uv
        from bevy_terrain_tpu.ops import patch_sampling
        from bevy_terrain_tpu.render import material as mat

        d = local_position_from_side_uv(0, np.array([0.97, 0.43]))
        d = d / np.linalg.norm(d)
        view = SPHERE.position_local_to_world(d, 30e3)
        vc = TerrainViewConfig(tile_capacity=4096)
        cfg, uniforms = build_frame(
            SPHERE, vc, view, 8, queue_capacity=32768,
            high_precision=True, blend_per_vertex=True,
        )
        tiles0 = refinement.refine_tiles(uniforms, cfg)
        plan = patch_sampling.make_patch_plan(512, 4, 2)
        blocks = jnp.full(
            (8 * plan.total_blocks_per_slot, 32, 128), 30000, jnp.int32
        )
        mesh, tiles = meshgen.generate_mesh_grid(
            tiles0, blocks, uniforms, cfg, plan, 65535.0
        )
        colors = np.asarray(mat.show_geometry_lod(mat.ShadeContext(
            mesh=mesh, tiles=tiles, normals=mesh.normals,
            uniforms=uniforms, cfg=cfg,
        )))
        n = int(tiles.tile_count)
        live = colors[:n]
        red = (live[..., 0] == 1.0) & (live[..., 1] == 0.0) & (live[..., 2] == 0.0)
        green = (live[..., 0] == 0.0) & (live[..., 1] == 1.0) & (live[..., 2] == 0.0)
        assert not red.any(), f"{int(red.sum())} morph-overlap (red) vertices"
        assert not green.any(), f"{int(green.sum())} insufficient-LOD (green) vertices"


class TestRefinementFuzz:
    """Property fuzz over random cameras: the dense+spill refinement must
    always emit a complete, disjoint covering (area == 1 per side) with
    zero overflow at generous capacities."""

    @pytest.mark.parametrize("spherical", [False, True])
    def test_random_cameras(self, spherical):
        rng = np.random.default_rng(23)
        model = SPHERE if spherical else PLANAR
        vc = TerrainViewConfig(tile_capacity=32768)
        lods = 6 if spherical else 8
        for trial in range(4):
            if spherical:
                d = rng.uniform(6.45e6, 2.0e7)
                u = rng.normal(size=3)
                pos = u / np.linalg.norm(u) * d
            else:
                pos = np.array([
                    rng.uniform(-600, 600), rng.uniform(-99, 400),
                    rng.uniform(-600, 600),
                ])
            cfg, uniforms = build_frame(
                model, vc, pos, lods, queue_capacity=32768)
            t = jax.jit(refinement.refine_tiles, static_argnames="cfg")(
                uniforms, cfg)
            n = int(t.tile_count)
            assert int(t.overflow) == 0, (trial, int(t.overflow))
            assert n > 0
            side = np.asarray(t.tile_side[:n])
            lod = np.asarray(t.tile_lod[:n])
            xy = np.asarray(t.tile_xy[:n])
            for s in range(model.side_count):
                area = np.sum(0.25 ** lod[side == s].astype(np.float64))
                assert area == pytest.approx(1.0, abs=1e-12), (trial, s)
            keys = set(zip(side.tolist(), lod.tolist(),
                           xy[:, 0].tolist(), xy[:, 1].tolist()))
            assert len(keys) == n  # no duplicates
            for sd, l, x, y in keys:
                for al in range(l):
                    sh = l - al
                    assert (sd, al, x >> sh, y >> sh) not in keys
