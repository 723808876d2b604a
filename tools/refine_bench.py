"""Refinement-stage timing: where do the refine microseconds go?

Times refine_tiles alone (planar 8k^2 bench scene + the Earth 60 km
spherical scene) and two structural ablations:

  sort_only   the dense stable 5-column sort on precomputed columns
  pred_only   the flat predicate batch alone (visible & should_divide)

Usage: python tools/refine_bench.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    import jax

    from bevy_terrain_tpu.utils.device import card_info, require_gpu

    require_gpu()
    import jax.numpy as jnp

    import bench
    from bevy_terrain_tpu.ops import coords, refinement
    from bevy_terrain_tpu.utils.compile_cache import enable_compile_cache
    from bevy_terrain_tpu.utils.timing import device_time_ms

    enable_compile_cache()
    _, (_, u1), cfg = bench.build_frame(atlas_slots=1)
    print(card_info())

    jref = jax.jit(refinement.refine_tiles, static_argnames="cfg")
    t = jax.block_until_ready(jref(u1, cfg))
    n = int(t.tile_count)
    ms = device_time_ms(jref, u1, cfg)
    print(f"planar refine_tiles   {ms * 1e3:8.1f} us (tiles {n})", flush=True)

    # flat predicate batch alone
    Ld = refinement.dense_level_cap(cfg)
    S = cfg.side_count
    np_side, np_lod, np_x, np_y = [], [], [], []
    for k in range(Ld + 1):
        c = 1 << k
        grid = np.mgrid[0:S, 0:c, 0:c].astype(np.int32)
        np_side.append(grid[0].reshape(-1))
        np_lod.append(np.full(S * c * c, k, np.int32))
        np_y.append(grid[1].reshape(-1))
        np_x.append(grid[2].reshape(-1))
    flat_side = jnp.asarray(np.concatenate(np_side))
    flat_lod = jnp.asarray(np.concatenate(np_lod))
    flat_x = jnp.asarray(np.concatenate(np_x))
    flat_y = jnp.asarray(np.concatenate(np_y))
    flat_xy = jnp.stack([flat_x, flat_y], axis=-1)

    def pred_only(u):
        vis = coords.tile_visible(flat_side, flat_lod, flat_xy, u, cfg)
        div = refinement.should_be_divided(flat_side, flat_lod, flat_xy, u, cfg)
        return vis & div

    jpred = jax.jit(pred_only)
    jax.block_until_ready(jpred(u1))
    ms = device_time_ms(jpred, u1)
    print(f"planar pred batch     {ms * 1e3:8.1f} us "
          f"({flat_side.shape[0]} lanes)", flush=True)

    # the dense 5-column stable sort alone (category randomized)
    rng = np.random.default_rng(3)
    cat0 = jnp.asarray(rng.integers(0, 3, flat_side.shape[0]).astype(np.int32))

    def sort_only(catv):
        return jax.lax.sort(
            (catv, flat_side, flat_lod, flat_x, flat_y),
            num_keys=1, is_stable=True,
        )[0]

    jsort = jax.jit(sort_only)
    jax.block_until_ready(jsort(cat0))
    ms = device_time_ms(jsort, cat0)
    print(f"planar dense sort x5  {ms * 1e3:8.1f} us", flush=True)

    # single-column packed-key sort for comparison
    def sort_packed(catv):
        c = 1 << Ld
        key = ((((catv * (Ld + 1) + flat_lod) * S + flat_side) * c
                + flat_y) * c + flat_x)
        return jax.lax.sort(key)

    jsp = jax.jit(sort_packed)
    jax.block_until_ready(jsp(cat0))
    ms = device_time_ms(jsp, cat0)
    print(f"planar dense sort x1  {ms * 1e3:8.1f} us (packed key)", flush=True)

    # (Earth spherical refine timing lives in tools/earth_frame_bench.py
    # — its scene build is monolithic; the planar decomposition above is
    # what drives the sort/predicate design decisions.)


if __name__ == "__main__":
    main()
