"""Several views on one card, and the scale-out structure across cards.

Default (GPU): on bench.py's 8k^2 planar scene, the single-view frame
step against TWO distinct views stepped in one jit over one shared atlas
block store — device time per view should stay ~1x the single view.

``--cpu`` checks the SCALING STRUCTURE on a virtual 8-device CPU mesh:
the replicated-atlas multi-view step must compile to a program with NO
cross-device collectives (per-device cost is then independent of mesh
size), while the sharded-atlas step must show its all-gather +
reduce-scatter fetch. Wall-clock on the virtual mesh is not evidence
either way — the 8 "devices" share one host's cores.

Usage: python tools/multi_view_bench.py [--cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def second_view_uniforms(cfg):
    """Uniforms of a second, distinct camera on bench.py's scene."""
    import bench
    from bevy_terrain_tpu.config import TerrainViewConfig
    from bevy_terrain_tpu.math import TerrainModelApproximation, frustum
    from bevy_terrain_tpu.ops import tile_tree as tile_tree_ops
    from bevy_terrain_tpu.ops.params import make_frame_uniforms

    model = bench.planar_model()
    vc = TerrainViewConfig(tile_capacity=cfg.tile_capacity)
    view = np.array([-bench.SIDE * 0.11, 300.0, bench.SIDE * 0.07])
    vp = frustum.view_projection(
        view, view + np.array([-800.0, -60.0, 500.0]), np.pi / 3, 16 / 9
    )
    origins, vt_int, vt_frac = tile_tree_ops.compute_view_anchors(
        model, view, cfg.lod_count, vc.tree_size
    )
    approx = TerrainModelApproximation.compute(model, view, vc.origin_lod, 125.0)
    rng = np.random.default_rng(1)
    entries = np.zeros((1, cfg.lod_count, vc.tree_size, vc.tree_size, 2), np.int32)
    entries[..., 0] = rng.integers(0, bench.ATLAS_SLOTS, entries.shape[:-1])
    entries[..., 1] = np.arange(cfg.lod_count)[None, :, None, None]
    return make_frame_uniforms(
        model, view, approx, origins, entries, vt_int, vt_frac, vc,
        view_proj=vp,
    )


def main_gpu() -> None:
    import jax

    from bevy_terrain_tpu.utils.device import card_info, require_gpu

    require_gpu()
    import bench
    from bevy_terrain_tpu.utils.compile_cache import enable_compile_cache
    from bevy_terrain_tpu.utils.timing import device_time_ms

    enable_compile_cache()
    single, (blocks, u1), cfg = bench.build_frame()
    u2 = second_view_uniforms(cfg)
    double = jax.jit(lambda b, ua, ub: (single(b, ua), single(b, ub)))
    (t_a, _), (t_b, _) = jax.block_until_ready(double(blocks, u1, u2))
    t1 = device_time_ms(single, blocks, u1)
    t2 = device_time_ms(double, blocks, u1, u2)
    print(
        f"{card_info()}\n"
        f"single view: {t1 * 1e3:.1f} us ({int(t_a.tile_count)} tiles)\n"
        f"two views, one card, shared atlas: {t2 * 1e3:.1f} us total, "
        f"{t2 / 2 * 1e3:.1f} us/view ({int(t_a.tile_count)}+"
        f"{int(t_b.tile_count)} tiles) -> per-view ratio {t2 / 2 / t1:.3f}x"
    )


def main_cpu() -> None:
    import os

    # n virtual CPU devices must be requested before the backend starts
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) >= 8, "virtual 8-device CPU mesh unavailable"
    import tempfile

    from bevy_terrain_tpu.config import (
        AttachmentConfig, TerrainConfig, TerrainViewConfig,
    )
    from bevy_terrain_tpu.math import TerrainModel
    from bevy_terrain_tpu.parallel.multi_view import MultiViewTerrain
    from bevy_terrain_tpu.utils.synthetic import generate_planar_dataset

    root = tempfile.mkdtemp(prefix="mv_struct_")
    att = AttachmentConfig(
        name="height", texture_size=512, border_size=2, mip_level_count=4
    )
    generate_planar_dataset("terrains/mvs", 3, att, root=root)
    config = TerrainConfig(
        lod_count=3,
        model=TerrainModel.planar(np.zeros(3), 8000.0, 0.0, 250.0),
        atlas_size=128, path="terrains/mvs", attachments=(att,),
        assets_root=root,
    )
    rng = np.random.default_rng(3)
    positions = {
        f"v{i}": np.array([
            rng.uniform(-300, 300), rng.uniform(80, 400), rng.uniform(-300, 300)
        ])
        for i in range(8)
    }
    for shard_atlas in (False, True):
        mvt = MultiViewTerrain(
            config, list(positions), devices=jax.devices()[:8],
            view_config=TerrainViewConfig(
                tile_capacity=512, morph_distance=2.0, blend_distance=1.0
            ),
            queue_capacity=1024, shard_atlas=shard_atlas,
        )
        mvt.update(positions)
        stats = mvt.audit_step()
        label = "sharded-atlas" if shard_atlas else "replicated-atlas"
        if shard_atlas:
            assert stats, "sharded-atlas step lost its collective fetch"
            print(f"{label}: collectives {sorted(stats)} (the atlas fetch)")
        else:
            assert not stats, f"replicated-atlas step has collectives: {stats}"
            print(f"{label}: no cross-device collectives -> per-device cost "
                  "is mesh-size-independent")


if __name__ == "__main__":
    if "--cpu" in sys.argv:
        main_cpu()
    else:
        main_gpu()
