"""Committed golden fixtures: node selections + strip-order mesh buffers.

The cross-round regression anchor for SURVEY section 4's bit-comparability
north star (tools/make_goldens.py writes them; regenerate only on
INTENTIONAL node-selection/mesh changes). Node lists are integers and must
match EXACTLY; mesh buffers are f32 XLA products compared at a tolerance
far below any geometric change (1e-3 of the 100 m height range).
"""

import tempfile
from pathlib import Path

import numpy as np
import pytest

GOLDEN_DIR = Path(__file__).resolve().parent / "goldens"


def _load(name):
    # Node selections are integer-exact PER BACKEND but not across
    # backends: f32 at planetary scale survives a large cancellation
    # (|world - view| ~ 3e3 from ~6.4e6 operands), so CPU and GPU land
    # ~1e-3 apart and threshold-tied tiles flip. When a backend-suffixed
    # golden exists (tools/make_goldens.py --backend-nodes), it pins this
    # backend exactly; test_cross_backend_flips_are_threshold_ties pins
    # the flips to the tie envelope.
    import jax

    suffixed = GOLDEN_DIR / f"{name}.{jax.default_backend()}.npz"
    if suffixed.exists():
        return np.load(suffixed)
    p = GOLDEN_DIR / f"{name}.npz"
    if not p.exists():
        pytest.fail(f"missing committed golden {p}; run tools/make_goldens.py")
    return np.load(p)


class TestNodeSelectionGoldens:
    @pytest.mark.parametrize(
        "case", ["nodes_planar_overview", "nodes_planar_ground", "nodes_sphere_approach"]
    )
    def test_exact_node_match(self, case):
        from tools.make_goldens import node_selection_cases, refine_nodes

        spec = {name: (m, v, l) for name, m, v, l in node_selection_cases()}
        model, view, lods = spec[case]
        got = refine_nodes(model, view, lods)
        want = _load(case)["nodes"]
        assert got.shape == want.shape, (got.shape, want.shape)
        np.testing.assert_array_equal(got, want)

    def test_cross_backend_flips_are_threshold_ties(self):
        """Where per-backend goldens diverge, every difference must be a
        FLIPPED SUBDIVISION of a parent whose subdivision margin sits
        inside the planetary-scale f32 envelope (|d - t| / t < 5e-3 at
        6.4e6 m radius; measured flips are within 2.5e-3) — never a
        structural difference. Skipped when no backend golden exists."""
        from tools.make_goldens import node_selection_cases

        from bevy_terrain_tpu.config import TerrainViewConfig
        from bevy_terrain_tpu.ops import coords
        from tests.test_ops import build_frame

        pairs = []
        for name, model, view, lods in node_selection_cases():
            base = GOLDEN_DIR / f"{name}.npz"
            for suffixed in GOLDEN_DIR.glob(f"{name}.*.npz"):
                pairs.append((np.load(base)["nodes"],
                              np.load(suffixed)["nodes"], model, view, lods))
        if not pairs:
            pytest.skip("no backend-divergent goldens committed")
        for base, other, model, view, lods in pairs:
            base_set = {tuple(r) for r in base}
            other_set = {tuple(r) for r in other}

            def children(n):
                s, l, x, y = n
                return {(s, l + 1, 2 * x + dx, 2 * y + dy)
                        for dx in (0, 1) for dy in (0, 1)}

            flipped = []
            for n in sorted(base_set ^ other_set):
                in_base = n in base_set
                has, lacks = (other_set, base_set) if in_base else (base_set, other_set)
                if children(n) <= has:
                    flipped.append(n)  # `has`'s backend subdivided it
                else:
                    # must be a child of a flipped parent, accounted there
                    s, l, x, y = n
                    parent = (s, l - 1, x // 2, y // 2)
                    assert parent in (base_set ^ other_set) or parent in flipped, (
                        f"structural divergence at {n}: not a flipped "
                        f"subdivision"
                    )
            assert flipped, "diverging goldens with no flipped parent"
            vc = TerrainViewConfig(tile_capacity=32768)
            cfg, uniforms = build_frame(model, vc, view, lods,
                                        queue_capacity=32768)
            for n in flipped:
                side = np.asarray([n[0]], np.int32)
                lod = np.asarray([n[1]], np.int32)
                xy = np.asarray([n[2:]], np.int32)
                uv = coords.compute_subdivision_coordinate(
                    side, lod, xy, uniforms.taylor, cfg.origin_lod,
                    cfg.side_count,
                )
                dist = coords.approximate_view_distance(
                    side, lod, xy, uv, uniforms, cfg
                )
                thresh = uniforms.subdivision_distance / coords.tile_count(lod)
                margin = abs(float(np.asarray(dist)[0])
                             / float(np.asarray(thresh)[0]) - 1.0)
                assert margin < 5e-3, (n, margin)


def _mesh_atol(cpu: float, gpu: float) -> float:
    """Streamed-mesh tolerance by backend. CPU regenerates the goldens'
    own XLA program (tight). The GPU runs the same program with every dot
    pinned to exact f32 (Precision.HIGHEST), so it differs from the CPU
    capture only by f32 rounding order, fused multiply-adds and the
    transcendental implementations; its bounds are pinned by
    TestGpuLiveGoldens."""
    import jax

    return cpu if jax.default_backend() == "cpu" else gpu


class TestMeshGolden:
    def test_streamed_mesh_matches(self):
        from tools.make_goldens import mesh_case

        with tempfile.TemporaryDirectory() as tmp:
            nodes, heights, positions = mesh_case(Path(tmp))
        g = _load("mesh_planar_streamed")
        np.testing.assert_array_equal(nodes, g["nodes"])
        atol = _mesh_atol(1e-3, GPU_PLANAR_ATOL)
        np.testing.assert_allclose(heights, g["heights"], atol=atol)
        np.testing.assert_allclose(positions, g["positions"], atol=atol)

    def test_streamed_spherical_mesh_matches(self):
        """Earth-radius flagship streamed frame (lod 13, culled, Taylor hp
        path). Relative-to-view positions: world f32 at 6.4e6 m carries
        ~0.5 m quantization, so the CPU regeneration bound is 1e-2 m, not
        the planar 1e-3."""
        from tools.make_goldens import mesh_spherical_case, spherical_deep_subset

        with tempfile.TemporaryDirectory() as tmp:
            nodes, heights, positions = mesh_spherical_case(Path(tmp))
        g = _load("mesh_spherical_streamed")
        np.testing.assert_array_equal(nodes, g["nodes"])
        dn, dh, dp = spherical_deep_subset(nodes, heights, positions)
        np.testing.assert_array_equal(dn, g["deep_nodes"])
        np.testing.assert_allclose(
            dh, g["deep_heights"], atol=_mesh_atol(1e-3, GPU_SPHERE_HEIGHT_ATOL))
        np.testing.assert_allclose(
            dp, g["deep_positions"], atol=_mesh_atol(1e-2, GPU_SPHERE_POS_ATOL))


# GPU-vs-CPU-capture bounds (metres) for the live goldens below. Every dot
# runs at Precision.HIGHEST, so what remains is f32 rounding: the planar
# frame keeps the CPU bound; on the sphere positions are stored in world
# f32 at ~6.4e6 m (one ulp = 0.5 m) after two roundings (Taylor anchor,
# height offset), so relative positions get three world ulps, and heights
# two ulps of the 9 km range (measured on an H100: 1.0 m and 9.8e-4 m).
GPU_PLANAR_ATOL = 1e-3
GPU_SPHERE_HEIGHT_ATOL = 2 * float(np.spacing(np.float32(9000.0)))
GPU_SPHERE_POS_ATOL = 3 * float(np.spacing(np.float32(6.371e6)))


@pytest.mark.gpu
class TestGpuLiveGoldens:
    """Pin the frame computed LIVE on the GPU against the committed CPU
    goldens, so a precision change on the card (a dot falling back to
    TF32, a changed fusion) fails loudly.

    Skipped on a CPU-only backend; chip_smoke.py runs them on the card
    (its ``goldens`` phase)."""

    @pytest.fixture(autouse=True)
    def _gpu_only(self):
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("live-GPU golden check (run by chip_smoke.py on the card)")

    def test_planar_matches_golden(self):
        from tools.make_goldens import mesh_case

        with tempfile.TemporaryDirectory() as tmp:
            nodes, heights, positions = mesh_case(Path(tmp))
        g = _load("mesh_planar_streamed")
        np.testing.assert_array_equal(nodes, g["nodes"])
        err_h = float(np.abs(heights - g["heights"]).max())
        err_p = float(np.abs(positions - g["positions"]).max())
        print(f"planar live golden: max |dh| {err_h:.3e} m, "
              f"max |dpos| {err_p:.3e} m")
        assert err_h <= GPU_PLANAR_ATOL, err_h
        assert err_p <= GPU_PLANAR_ATOL, err_p

    def test_spherical_matches_golden(self):
        """The flagship Earth frame on the card.

        Node selection may differ from the CPU capture by a handful of
        frustum-BOUNDARY tiles (the culling plane test is f32 and ties
        break differently across backends) — bounded, not ignored. Buffer
        comparison covers the committed deep subset (lod >= 10) matched BY
        NODE KEY, so a boundary-set difference can't misalign rows."""
        from tools.make_goldens import mesh_spherical_case, spherical_deep_subset

        with tempfile.TemporaryDirectory() as tmp:
            nodes, heights, positions = mesh_spherical_case(Path(tmp))
        g = _load("mesh_spherical_streamed")
        got = {tuple(r) for r in nodes.tolist()}
        want = {tuple(r) for r in g["nodes"].tolist()}
        assert len(got ^ want) <= 8, (
            f"node sets differ by {len(got ^ want)} (> frustum-tie bound)"
        )
        dn, dh, dp = spherical_deep_subset(nodes, heights, positions)
        rows = {tuple(r): i for i, r in enumerate(dn.tolist())}
        want_rows = [
            (rows[tuple(r)], j) for j, r in enumerate(g["deep_nodes"].tolist())
            if tuple(r) in rows
        ]
        assert len(want_rows) >= 0.9 * len(g["deep_nodes"])
        ours = np.array([i for i, _ in want_rows])
        theirs = np.array([j for _, j in want_rows])
        err_h = float(np.abs(dh[ours] - g["deep_heights"][theirs]).max())
        err_p = float(np.abs(dp[ours] - g["deep_positions"][theirs]).max())
        print(f"spherical live golden: max |dh| {err_h:.3e} m, "
              f"max |dpos| {err_p:.3e} m")
        assert err_h <= GPU_SPHERE_HEIGHT_ATOL, err_h
        assert err_p <= GPU_SPHERE_POS_ATOL, err_p
