"""What the GPU port pins down, checked on the CPU: exact tile-tree entry
lookups at large atlas indices, exact-f32 dots at every pinned site, the
compile-cache location, and the numpy PNG codec that replaces PIL on the
main path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bevy_terrain_tpu.config import TerrainViewConfig
from bevy_terrain_tpu.ops import coords, patch_sampling as ps, refinement
from bevy_terrain_tpu.ops.params import StaticTerrainConfig
from tests.test_ops import PLANAR, build_frame

CFG = StaticTerrainConfig(
    spherical=False, side_count=1, lod_count=2, tree_size=8, grid_size=16,
    refinement_count=8, queue_capacity=1024, tile_capacity=256, origin_lod=10,
)


class TestEntryLookupExact:
    """Atlas indices above 2^11 must come back exactly: a TF32 pass (11
    significant bits) would round slot 4095 to 4096 and sample the wrong
    tile without any error."""

    @pytest.mark.parametrize("atlas_size", [1024, 4096, 65536])
    def test_large_atlas_indices(self, atlas_size):
        vc = TerrainViewConfig(tile_capacity=512)
        lods = 4
        rng = np.random.default_rng(atlas_size)
        entries = np.zeros((1, lods, vc.tree_size, vc.tree_size, 2), np.int32)
        entries[..., 0] = rng.integers(atlas_size - 64, atlas_size,
                                       entries.shape[:-1])
        entries[..., 1] = np.arange(lods)[None, :, None, None]
        cfg, u = build_frame(PLANAR, vc, np.array([10.0, 40.0, -30.0]), lods,
                             entries=entries)

        # the per-coordinate gather is exact
        side = jnp.zeros((200,), jnp.int32)
        lod = jnp.asarray(rng.integers(0, lods, 200), jnp.int32)
        xy = jnp.asarray(rng.integers(0, 64, (200, 2)), jnp.int32)
        idx, a_lod = coords.lookup_tile_tree_entry(u.entries, side, lod, xy, cfg)
        t = np.asarray(xy) % vc.tree_size
        want = entries[0, np.asarray(lod), t[:, 0], t[:, 1]]
        np.testing.assert_array_equal(np.asarray(idx), want[:, 0])
        np.testing.assert_array_equal(np.asarray(a_lod), want[:, 1])

        # and the frame's per-tile patch ids land in those slots
        plan = ps.make_patch_plan(512, 4, 2)
        tiles = refinement.refine_tiles(u, cfg)
        n = int(tiles.tile_count)
        _, batch = ps.plan_patch_batch(
            tiles, u, cfg, plan, atlas_size * plan.total_blocks_per_slot
        )
        slots = np.asarray(batch.ids[:n]) // plan.total_blocks_per_slot
        assert n > 0
        assert slots.min() >= atlas_size - 64 and slots.max() < atlas_size
        assert set(slots.tolist()) <= set(entries[..., 0].ravel().tolist())


def _dot_precisions(closed):
    """Precision params of every dot_general in a jaxpr, sub-jaxprs too."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (tuple, list)) else (v,):
                    if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(closed.jaxpr)
    return found


def _resample():
    return jax.make_jaxpr(lambda p, p0, dp: ps.halfgrid_resample(p, p0, dp, CFG))(
        jnp.zeros((2, 64, 64)), jnp.zeros((2, 2)), jnp.ones((2,)))


def _smoothing():
    return jax.make_jaxpr(ps.smooth_halfgrid_permuted)(jnp.zeros((2, 33, 33)))


def _raster_clip():
    from bevy_terrain_tpu.render.raster import _project

    return jax.make_jaxpr(lambda p, m: _project(p, m, 64, 64))(
        jnp.zeros((1, 3, 3, 3)), jnp.eye(4))


def _raster_edges():
    from bevy_terrain_tpu.render.raster import rasterize_grid

    return jax.make_jaxpr(
        lambda p, m: rasterize_grid(p, jnp.ones((1,), bool), m, 32, 32,
                                    bin_px=16, bin_cap=32))(
        jnp.zeros((1, 3, 3, 3)), jnp.eye(4))


class TestPinnedPrecision:
    """Every dot at a pinned site runs at Precision.HIGHEST (exact f32):
    the GPU's default for f32 dots may be TF32."""

    @pytest.mark.parametrize(
        "site", [_resample, _smoothing, _raster_clip, _raster_edges],
        ids=["tent_resample", "halfgrid_smoothing", "raster_clip",
             "raster_edge_functions"],
    )
    def test_highest_in_jaxpr(self, site):
        precisions = _dot_precisions(site())
        assert precisions, "no dot_general at this site"
        highest = jax.lax.Precision.HIGHEST
        for p in precisions:
            assert p is not None and all(q == highest for q in p), p


class TestCompileCache:
    def test_honours_env_var(self, monkeypatch, tmp_path):
        from bevy_terrain_tpu.utils import compile_cache

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.compile_cache_dir() == tmp_path

    def test_fixed_in_checkout_path(self, monkeypatch):
        from pathlib import Path

        from bevy_terrain_tpu.utils import compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        repo = Path(__file__).resolve().parent.parent
        assert compile_cache.compile_cache_dir() == repo / ".jax_cache"


def _sample(kind, rng):
    shapes = {"gray8": ((37, 53), np.uint8), "gray16": ((33, 41), np.uint16),
              "rgb8": ((31, 29, 3), np.uint8), "rgba8": ((31, 29, 4), np.uint8),
              "rgba16": ((17, 23, 4), np.uint16)}
    shape, dtype = shapes[kind]
    return rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


class TestPngCodec:
    @pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8", "rgba8", "rgba16"])
    def test_round_trip(self, tmp_path, kind):
        from bevy_terrain_tpu.formats import tiff

        arr = _sample(kind, np.random.default_rng(1))
        tiff.write_png(tmp_path / "a.png", arr)
        got = tiff.read_png(tmp_path / "a.png")
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)

    @pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8", "rgba8"])
    def test_matches_pil_decode(self, tmp_path, kind):
        """PIL writes adaptively filtered rows (all five filter types)."""
        Image = pytest.importorskip("PIL.Image")
        from bevy_terrain_tpu.formats import tiff

        rng = np.random.default_rng(2)
        arr = _sample(kind, rng)
        # a smooth ramp plus noise makes PIL pick Sub/Up/Average/Paeth rows
        ramp = np.add.outer(np.arange(arr.shape[0]), np.arange(arr.shape[1]))
        ramp = ramp.reshape(ramp.shape + (1,) * (arr.ndim - 2))
        arr = (arr // 8 + ramp * 3).astype(arr.dtype)
        Image.fromarray(arr).save(tmp_path / "a.png")
        got = tiff.read_png(tmp_path / "a.png")
        np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "a.png")))

    def test_python_unfilter_matches_native(self, tmp_path, monkeypatch):
        Image = pytest.importorskip("PIL.Image")
        from bevy_terrain_tpu import native
        from bevy_terrain_tpu.formats import tiff

        arr = (np.add.outer(np.arange(40), np.arange(50)) * 5 % 251).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / "a.png")
        monkeypatch.setattr(native, "available", lambda: False)
        np.testing.assert_array_equal(tiff.read_png(tmp_path / "a.png"), arr)

    def test_source_loading_without_pil(self, tmp_path, monkeypatch):
        """array_to_source / load_source_image round-trip through the numpy
        codec and .npy, with PIL made unimportable."""
        import sys

        from bevy_terrain_tpu.config import AttachmentConfig
        from bevy_terrain_tpu.formats import tiff

        monkeypatch.setitem(sys.modules, "PIL", None)
        att = AttachmentConfig(name="height", texture_size=64, border_size=2,
                               mip_level_count=1)
        h = np.random.default_rng(3).uniform(0.02, 1.0, (48, 40))
        tiff.array_to_source(h, tmp_path / "h.png")
        got = tiff.load_source_image(str(tmp_path / "h.png"), att)
        np.testing.assert_allclose(got[..., 0], h, atol=0.5 / 65535)
        np.save(tmp_path / "h.npy", h.astype(np.float32))
        got = tiff.load_source_image(str(tmp_path / "h.npy"), att)
        np.testing.assert_allclose(got[..., 0], h, atol=1e-7)
        with pytest.raises(ImportError, match="Pillow"):
            tiff.load_source_image(str(tmp_path / "h.tif"), att)


class TestDeviceTime:
    """The trace-to-device-time reduction (utils/timing)."""

    def test_busy_time_counts_overlaps_once(self):
        from bevy_terrain_tpu.utils import timing

        events = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 25.0),
                  ("d", 21.0, 22.0)]
        assert timing.busy_ns(events) == 17.0
        assert timing.kernel_totals_ms(events) == {
            "a": 1e-5, "b": 7e-6, "c": 5e-6, "d": 1e-6}

    def test_cpu_trace_has_no_device_events(self):
        """A CPU-only trace raises instead of yielding a number."""
        from bevy_terrain_tpu.utils import timing

        f = jax.jit(lambda x: (x @ x).sum())
        with pytest.raises(RuntimeError, match="no device events"):
            timing.device_time_ms(f, jnp.ones((32, 32)), runs=1)
