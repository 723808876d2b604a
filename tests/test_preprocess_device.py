"""Device (jitted, stack-batched) preprocess ops vs the host numpy oracles.

SURVEY section 2.3 commits split/downsample/stitch/mipgen to device code;
ops/preprocess.py holds the exact per-tile host twins (themselves tested
against the WGSL semantics in test_preprocess.py). Here every stack op
must reproduce the oracle texel-for-texel.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from bevy_terrain_tpu.math.coordinate import TileCoordinate
from bevy_terrain_tpu.ops import preprocess as pp
from bevy_terrain_tpu.ops import preprocess_device as ppd

TS, B = 64, 2
CS = TS - 2 * B


def _rand_tile(rng, channels=1, zero_frac=0.2):
    t = rng.uniform(1, 1000, (TS, TS, channels))
    t[rng.uniform(size=(TS, TS)) < zero_frac] = 0.0
    t[:B] = t[-B:] = 0.0
    t[:, :B] = t[:, -B:] = 0.0
    return t.astype(np.float32)


class TestDownsampleStack:
    def test_matches_oracle(self):
        rng = np.random.default_rng(0)
        children = np.stack([_rand_tile(rng) for _ in range(8)])
        # parent 0: children 0-3; parent 1: children 4-6 + one missing
        child_idx = np.array([[0, 1, 2, 3], [4, 5, 6, -1]], np.int32)
        got = np.asarray(
            ppd.downsample_stack(jnp.asarray(children), jnp.asarray(child_idx), TS, B)
        )
        for p in range(2):
            kids = [
                children[i].astype(np.uint16) if i >= 0 else None
                for i in child_idx[p]
            ]
            want = pp.downsample_tile(kids, TS, B).astype(np.float64)
            np.testing.assert_allclose(
                np.rint(got[p]).astype(np.uint16), want, atol=1
            )

    def test_nodata_quad_stays_zero(self):
        children = np.zeros((4, TS, TS, 1), np.float32)
        idx = np.array([[0, 1, 2, 3]], np.int32)
        got = np.asarray(ppd.downsample_stack(jnp.asarray(children), jnp.asarray(idx), TS, B))
        assert (got == 0).all()


class TestRemapDescriptors:
    def test_all_cases_resolve(self):
        # every (orig, proj, slot) combination reachable on the cube must
        # have a static transform (the ctor asserts vs the per-texel oracle)
        from bevy_terrain_tpu.math.coordinate import NEIGHBOURING_SIDES

        for side in range(6):
            for slot in range(8):
                for proj in set(int(s) for s in NEIGHBOURING_SIDES[side]) | {side}:
                    if proj < 0:
                        continue
                    d = ppd._remap_descriptor(side, proj, slot, TS, B)
                    assert d.src_w > 0 and d.src_h > 0


class TestStitchStack:
    def _stitch_case(self, spherical, lod=1):
        rng = np.random.default_rng(7)
        sides = range(6) if spherical else [0]
        coords = [
            TileCoordinate(s, lod, x, y)
            for s in sides
            for x in range(1 << lod)
            for y in range(1 << lod)
        ]
        # drop one tile to exercise the clamp-repeat fallback
        missing = coords.pop(3)
        tiles = {c: _rand_tile(rng, zero_frac=0.0) for c in coords}
        index_of = {c: i for i, c in enumerate(coords)}
        stack = np.stack([tiles[c] for c in coords])
        nbr_idx, nbr_side = ppd.stitch_plan(coords, index_of, spherical)
        got = np.asarray(
            ppd.stitch_stack(
                jnp.asarray(stack), np.array([c.side for c in coords]),
                jnp.asarray(nbr_idx), nbr_side, B, spherical,
            )
        )
        for i, c in enumerate(coords):
            neighbours = []
            for n in c.neighbours(spherical):
                if n.is_valid and n in tiles:
                    neighbours.append((n.side, tiles[n]))
                else:
                    neighbours.append((0, None))
            want = pp.stitch_tile(tiles[c], c.side, neighbours, B)
            np.testing.assert_array_equal(got[i], want, err_msg=str(c))

    def test_planar_matches_oracle(self):
        self._stitch_case(spherical=False)

    def test_spherical_cross_face_matches_oracle(self):
        self._stitch_case(spherical=True)

    def test_spherical_lod0_matches_oracle(self):
        self._stitch_case(spherical=True, lod=0)


class TestMipStack:
    def test_r16_nodata_rule_matches_host(self):
        from bevy_terrain_tpu.terrain_data.attachment import generate_mipmaps

        rng = np.random.default_rng(3)
        tiles = np.rint(np.stack([
            _rand_tile(rng), _rand_tile(rng, zero_frac=0.9),
        ]))
        got = ppd.mip_stack(jnp.asarray(tiles), 4, True)
        assert len(got) == 4
        for i in range(2):
            want = generate_mipmaps(tiles[i].astype(np.uint16), 4)
            for level in range(4):
                np.testing.assert_array_equal(
                    np.asarray(got[level][i]).astype(np.int64),
                    want[level].astype(np.int64),
                )

    def test_plain_box_filter(self):
        x = jnp.asarray(np.arange(1 * 8 * 8 * 2, dtype=np.float32).reshape(1, 8, 8, 2))
        got = ppd.mip_stack(x, 2, False, quantize=False)
        want = np.asarray(x).reshape(1, 4, 2, 4, 2, 2).mean(axis=(2, 4))
        np.testing.assert_allclose(np.asarray(got[1]), want, rtol=1e-6)


class TestDeviceHostParity:
    """Same dataset through device=True and device=False must produce
    byte-identical .bin artifacts + config.tc (the on-disk format is the
    checkpoint; SURVEY section 5)."""

    def _run(self, tmp_path, device, spherical):
        from bevy_terrain_tpu.config import (
            AttachmentConfig, TerrainConfig)
        from bevy_terrain_tpu.formats.tiff import array_to_source
        from bevy_terrain_tpu.math import TerrainModel
        from bevy_terrain_tpu.preprocess import (
            PreprocessDataset, Preprocessor, SphericalDataset)
        from bevy_terrain_tpu.terrain_data import TileAtlas

        rng = np.random.default_rng(11)
        root = tmp_path / ("dev" if device else "host")
        root.mkdir()
        att = AttachmentConfig(
            name="height", texture_size=68, border_size=2, mip_level_count=2)
        if spherical:
            paths = []
            for side in range(6):
                p = root / f"face{side}.png"
                array_to_source(
                    rng.uniform(0.1, 1.0, (64, 64)).astype(np.float32), p)
                paths.append(str(p))
            model = TerrainModel.sphere(np.zeros(3), 100.0, 0.0, 10.0)
        else:
            src = rng.uniform(0.1, 1.0, (128, 128)).astype(np.float32)
            array_to_source(src, root / "src.png")
            model = TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0)
        config = TerrainConfig(
            lod_count=2, model=model, atlas_size=64, path="t",
            attachments=(att,), assets_root=str(root / "assets"))
        atlas = TileAtlas(config)
        pp = Preprocessor(atlas, device=device).clear_attachment(0)
        if spherical:
            pp.preprocess_spherical(SphericalDataset(
                attachment_index=0, paths=paths, lod_range=range(0, 2)))
        else:
            pp.preprocess_tile(PreprocessDataset(
                attachment_index=0, path=str(root / "src.png"),
                lod_range=range(0, 2)))
        pp.run(verbose=False)
        data_dir = root / "assets/t/data/height"
        return {
            p.name: p.read_bytes() for p in sorted(data_dir.glob("*.bin"))
        }, (root / "assets/t/config.tc").read_bytes()

    @pytest.mark.parametrize("spherical", [False, True])
    def test_bin_artifacts_identical(self, tmp_path, spherical):
        """Host interiors + device-stitched border strips are byte-EXACT
        vs the pure host path (stitch is a texel permutation — no
        arithmetic to skew)."""
        dev_bins, dev_tc = self._run(tmp_path, True, spherical)
        host_bins, host_tc = self._run(tmp_path, False, spherical)
        assert set(dev_bins) == set(host_bins) and dev_bins
        assert dev_tc == host_tc
        for name in sorted(dev_bins):
            assert dev_bins[name] == host_bins[name], name

    @pytest.mark.parametrize("spherical", [False, True])
    def test_delta_readback_byte_exact(self, tmp_path, spherical,
                                       monkeypatch):
        """The device path pulls back only the stitched border strips —
        a small fraction of the tile bytes it writes — and still writes
        the host path's files."""
        import jax

        pulled = []
        device_get = jax.device_get

        def counting_get(x):
            out = device_get(x)
            pulled.append(np.asarray(out).nbytes)
            return out

        monkeypatch.setattr(jax, "device_get", counting_get)
        dev_bins, _ = self._run(tmp_path, True, spherical)
        monkeypatch.setattr(jax, "device_get", device_get)
        host_bins, _ = self._run(tmp_path, False, spherical)
        assert dev_bins == host_bins
        # one pull per stitched lod stack; 68^2 tiles with 2-texel
        # borders: the strips are 1 - 64^2/68^2 ~= 11% of the texels
        written = sum(len(b) for b in dev_bins.values())
        assert pulled and sum(pulled) < 0.15 * written, (sum(pulled), written)


class TestAutoSelect:
    """Preprocessor(device=None) picks the device stitch on an accelerator
    backend and the host path on the CPU backend (where the jitted stack
    op is host compute); naive=True and device=False pin the host."""

    @pytest.mark.parametrize(
        "backend,kwargs,expect",
        [("gpu", {}, True), ("cpu", {}, False),
         ("gpu", {"naive": True}, False), ("gpu", {"device": False}, False)],
    )
    def test_auto_select_follows_backend(self, tmp_path, monkeypatch,
                                         backend, kwargs, expect):
        from bevy_terrain_tpu.config import AttachmentConfig, TerrainConfig
        from bevy_terrain_tpu.math import TerrainModel
        from bevy_terrain_tpu.preprocess import preprocessor as pre
        from bevy_terrain_tpu.terrain_data import TileAtlas
        import jax

        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        config = TerrainConfig(
            lod_count=2,
            model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
            atlas_size=64, path="t",
            attachments=(AttachmentConfig(
                name="height", texture_size=64, border_size=2,
                mip_level_count=1),),
            assets_root=str(tmp_path / "assets"))
        pp = pre.Preprocessor(TileAtlas(config), **kwargs)
        assert pp.device is expect
