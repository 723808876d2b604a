"""Level-synchronous UDLOD tile refinement — refine_tiles.wgsl twin.

The reference runs an atomics-based ping-pong work queue on the GPU
(/root/reference/src/shaders/tiling_prepass/refine_tiles.wgsl:5-44 with the
indirect-dispatch bookkeeping of prepare_prepass.wgsl:4-44 and the host loop
of src/render/tiling_prepass.rs:204-271). All tiles in the queue at pass k
have lod == k (roots seed at lod 0, each pass emits lod k+1 children), so
the algorithm is level-synchronous by construction.

Here (two-stage, no atomics/scatters/gathers):

1. **Dense levels 0..Ld** — every tile of every shallow level is ONE
   (side, 2^k, 2^k) mask grid; reachability cascades by 2x mask
   upsampling (a tile is considered iff all ancestors divided), frustum
   culling and the subdivision predicate are pure elementwise math, and a
   single stable 3-way sort (emit | frontier | dead) compacts ALL levels'
   emissions at once. No per-level synchronization whatsoever.
2. **Queue spill beyond Ld** (deep planetary zoom) — the still-dividing
   frontier's children seed the original level-synchronous loop: per
   level, a stable sort partition (emitted | divided | dead — a sort-based
   compaction; prefix sum + scatter is the alternative on hardware with
   fast scatters), appends via contiguous ``dynamic_update_slice``, and
   4x child expansion from a contiguous ``dynamic_slice``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from bevy_terrain_tpu.ops import coords
from bevy_terrain_tpu.ops.params import FrameUniforms, StaticTerrainConfig


class RefinementOutput(NamedTuple):
    """Compacted final tile list (the reference's ``final_tiles`` buffer +
    indirect vertex count, prepare_prepass.wgsl:38-44).

    Buffers hold ``tile_capacity + queue_capacity`` lanes; lanes beyond
    ``tile_count`` are garbage from the append scheme and must be masked.
    """

    tile_side: jax.Array  # (F + Q,) i32
    tile_lod: jax.Array  # (F + Q,) i32
    tile_xy: jax.Array  # (F + Q, 2) i32
    tile_count: jax.Array  # () i32
    # () i32 — tiles/children dropped by the static capacity clamps
    # (tile_capacity append, queue_capacity expansion). The reference's 1M
    # geometry_tile_count cap (terrain_view.rs:23-25) never truncates in
    # practice; ours is sized tightly, so truncation must be LOUD: any
    # nonzero value means geometry was silently missing this frame and
    # tile_capacity/queue_capacity need headroom. (int default, not a jnp
    # scalar: materializing an array at class-definition time would force
    # backend init at import.)
    overflow: jax.Array = 0


def should_be_divided(side, lod, xy, uniforms: FrameUniforms, cfg: StaticTerrainConfig):
    """Subdivision predicate (refine_tiles.wgsl:17-22): the view distance to
    the closest point of the tile is below ``subdivision_distance / 2^lod``."""
    uv = coords.compute_subdivision_coordinate(
        side, lod, xy, uniforms.taylor, cfg.origin_lod, cfg.side_count
    )
    view_distance = coords.approximate_view_distance(side, lod, xy, uv, uniforms, cfg)
    return view_distance < uniforms.subdivision_distance / coords.tile_count(lod)


def dense_level_cap(cfg: StaticTerrainConfig, budget: int = 8192) -> int:
    """Deepest lod evaluated DENSELY (all side_count * 4^k tiles at once).

    Dense levels replace the queue's per-level sort-compactions with pure
    elementwise masks (see refine_tiles); deeper levels spill into the
    queue loop. The cap keeps the total dense lane count under ``budget``
    (measured on the culled 8k^2 bench frame: budget 8192 -> 249us refine
    vs 32768 -> 276us — the bigger dense sweep loses to a short spill).
    """
    total, k = 0, -1
    while True:
        nxt = total + cfg.side_count * (4 ** (k + 1))
        if nxt > budget or k + 1 >= cfg.refinement_count:
            return k
        total, k = nxt, k + 1


def refine_tiles(uniforms: FrameUniforms, cfg: StaticTerrainConfig) -> RefinementOutput:
    """Run the full refinement: seed roots, iterate subdivision, compact.

    Root seeding mirrors prepare_prepass.wgsl:4-23 (1 root planar, 6
    spherical); iteration count mirrors the host dispatch loop
    (tiling_prepass.rs:248-263, default refinement_count 30), with early
    exit once the queue drains. On the last pass still-subdividing parents
    are emitted instead of dropped (the reference's trailing dispatch
    discards their children, tiling_prepass.rs:259-263; emitting parents
    keeps coverage complete).

    Structure: levels 0..Ld run DENSELY — every tile of every
    level is evaluated as a (side, 2^k, 2^k) grid, reachability cascades
    by plain 2x-upsampling of parent masks, and ONE stable sort compacts
    all emitted tiles (no per-level sorts, no dynamic slices). Levels
    beyond Ld (deep planetary zoom) spill into the original level-sync
    queue loop, seeded with the still-dividing frontier. The emitted tile
    SET is identical to the pure queue algorithm by construction (same
    predicate, same last-pass rule).
    """
    Q = cfg.queue_capacity
    F = cfg.tile_capacity
    Ld = dense_level_cap(cfg)
    S = cfg.side_count

    # ---- dense levels 0..Ld: ONE flat predicate batch ----
    # The per-level (S, 2^k, 2^k) coordinate grids are compile-time
    # constants; concatenating every level into one flat column lets the
    # expensive predicates (frustum test + subdivision distance) run as a
    # SINGLE elementwise batch over all ~budget lanes instead of Ld+1
    # separate small-op chains (op-count-bound -> lane-bound; the
    # predicate math itself is trivial elementwise work); the emitted
    # tile SET is unchanged — only the evaluation order moved.
    offs = [0]
    np_side, np_lod, np_x, np_y = [], [], [], []
    for k in range(Ld + 1):
        c = 1 << k
        grid = np.mgrid[0:S, 0:c, 0:c].astype(np.int32)  # (3, S, c, c)
        np_side.append(grid[0].reshape(-1))
        np_lod.append(np.full(S * c * c, k, np.int32))
        np_y.append(grid[1].reshape(-1))
        np_x.append(grid[2].reshape(-1))
        offs.append(offs[-1] + S * c * c)
    flat_side = jnp.asarray(np.concatenate(np_side))
    flat_lod = jnp.asarray(np.concatenate(np_lod))
    flat_x = jnp.asarray(np.concatenate(np_x))
    flat_y = jnp.asarray(np.concatenate(np_y))
    flat_xy = jnp.stack([flat_x, flat_y], axis=-1)

    flat_visible = (
        coords.tile_visible(flat_side, flat_lod, flat_xy, uniforms, cfg)
        if cfg.culling else jnp.ones(flat_side.shape, jnp.bool_)
    )
    flat_should = (
        should_be_divided(flat_side, flat_lod, flat_xy, uniforms, cfg)
        & (flat_lod + 1 < cfg.refinement_count)
    )

    # reachability cascade (a tile is considered iff all ancestors
    # divided): masks only — 2x upsampling per level, no predicate math
    emit_flags = []
    reached = jnp.ones((S, 1, 1), jnp.bool_)
    frontier = None  # (reached & divide) at Ld
    for k in range(Ld + 1):
        c = 1 << k
        sl = slice(offs[k], offs[k + 1])
        active = reached & flat_visible[sl].reshape(S, c, c)
        divide = flat_should[sl].reshape(S, c, c) & active
        emit_flags.append((active & ~divide).reshape(-1))
        if k == Ld:
            frontier = divide
        else:
            reached = jnp.repeat(jnp.repeat(divide, 2, axis=1), 2, axis=2)

    # 3-way category so ONE sort yields both the emitted prefix and (for
    # the deepest dense level) the still-dividing frontier block:
    # 0 = emit, 1 = frontier parent, 2 = dead
    flat_emit = jnp.concatenate(emit_flags)
    is_front = jnp.zeros(flat_side.shape, jnp.bool_).at[offs[Ld]:].set(
        frontier.reshape(-1)
    )
    all_cat = jnp.where(flat_emit, 0, jnp.where(is_front, 1, 2)).astype(
        jnp.int32
    )
    # stable sort: emitted tiles first (level-major — the queue algorithm's
    # append order), then the frontier parents, then dead lanes
    s_key, s_side, s_lod, s_x, s_y = jax.lax.sort(
        (all_cat, flat_side, flat_lod, flat_x, flat_y),
        num_keys=1, is_stable=True,
    )
    n_emit = jnp.sum((all_cat == 0).astype(jnp.int32))

    final_side = jnp.zeros((F + Q,), jnp.int32)
    final_lod = jnp.full((F + Q,), -1, jnp.int32)
    final_x = jnp.zeros((F + Q,), jnp.int32)
    final_y = jnp.zeros((F + Q,), jnp.int32)
    n_dense = s_side.shape[0]
    w = min(F + Q, n_dense)
    final_side = final_side.at[:w].set(s_side[:w])
    final_lod = final_lod.at[:w].set(
        jnp.where(jnp.arange(w) < n_emit, s_lod[:w], -1)
    )
    final_x = final_x.at[:w].set(s_x[:w])
    final_y = final_y.at[:w].set(s_y[:w])
    final_count = jnp.minimum(n_emit, F)
    overflow0 = jnp.maximum(n_emit - F, 0)

    # ---- spill: still-dividing frontier at Ld -> children seed the queue
    # loop at level Ld+1 (planetary depth; empty for shallow frames). The
    # frontier parents are the category-1 block of the SAME sorted columns,
    # at dynamic offset n_emit ----
    n_front = jnp.sum(frontier.astype(jnp.int32))
    take = max(1, Q // 4)
    padded = lambda a: jnp.concatenate([a, jnp.zeros((take,), jnp.int32)])
    fr_side = jax.lax.dynamic_slice(padded(s_side), (n_emit,), (take,))
    fr_x = jax.lax.dynamic_slice(padded(s_x), (n_emit,), (take,))
    fr_y = jax.lax.dynamic_slice(padded(s_y), (n_emit,), (take,))
    # expand frontier parents to children (refine_tiles.wgsl:24-31)
    child_sub = jnp.arange(4, dtype=jnp.int32)
    c_side = jnp.repeat(fr_side, 4)
    c_x = ((fr_x[:, None] << 1) + (child_sub & 1)[None, :]).reshape(-1)
    c_y = ((fr_y[:, None] << 1) + (child_sub >> 1)[None, :]).reshape(-1)
    pad_q = Q - c_side.shape[0]
    if pad_q > 0:
        zp = jnp.zeros((pad_q,), jnp.int32)
        c_side = jnp.concatenate([c_side, zp])
        c_x = jnp.concatenate([c_x, zp])
        c_y = jnp.concatenate([c_y, zp])
    queue_side, queue_x, queue_y = c_side[:Q], c_x[:Q], c_y[:Q]
    queue_count = jnp.minimum(4 * n_front, Q)
    overflow0 = overflow0 + jnp.maximum(4 * n_front - Q, 0)

    lane = jnp.arange(Q, dtype=jnp.int32)
    k0 = Ld + 1
    L = 5 * Q  # merged batch: Q parents + 4Q speculative children

    # The spill loop is LAUNCH-bound, not lane-bound: each level costs a
    # few serial kernel launches (predicate fusion, distance fusion,
    # sort, glue) regardless of whether Q is 256 or 4096 lanes. So each
    # iteration processes TWO levels: the Q queued parents at level k
    # AND all 4Q of their speculative children at k+1, in ONE predicate
    # batch and ONE stable sort over 5Q lanes (children of non-dividing
    # parents die by mask). Same launches, double the levels. The emitted
    # tile
    # sequence is IDENTICAL to the one-level loop (same predicates, same
    # level-major stable order); only overflow accounting shifts:
    # children are never dropped before evaluation (4Q lanes always
    # hold them), the queue cap applies at the grandchild extraction.
    # State travels stacked — (3, Q) queue, (4, F + 5Q) final buffer —
    # so appends are ONE dynamic_update_slice.
    def cond(state):
        k, q_count = state[0], state[2]
        return (k < cfg.refinement_count) & (q_count > 0)

    def body(state):
        k, qcols, q_count, fbuf, f_count, dropped = state
        q_side, q_x, q_y = qcols[0], qcols[1], qcols[2]

        # speculative children of EVERY queue lane (refine_tiles.wgsl:24-31)
        child_sub = jnp.arange(4, dtype=jnp.int32)
        c_side = jnp.repeat(q_side, 4)
        c_x = ((q_x[:, None] << 1) + (child_sub & 1)[None, :]).reshape(-1)
        c_y = ((q_y[:, None] << 1) + (child_sub >> 1)[None, :]).reshape(-1)

        b_side = jnp.concatenate([q_side, c_side])
        b_x = jnp.concatenate([q_x, c_x])
        b_y = jnp.concatenate([q_y, c_y])
        is_child = jnp.arange(L, dtype=jnp.int32) >= Q
        b_lod = k + is_child.astype(jnp.int32)
        b_xy = jnp.stack([b_x, b_y], axis=-1)

        # ONE predicate batch for both levels
        vis = (
            coords.tile_visible(b_side, b_lod, b_xy, uniforms, cfg)
            if cfg.culling else jnp.ones((L,), jnp.bool_)
        )
        should = should_be_divided(b_side, b_lod, b_xy, uniforms, cfg)

        active_p = (lane < q_count) & vis[:Q]
        div_p = should[:Q] & active_p & (k + 1 < cfg.refinement_count)
        emit_p = active_p & ~div_p
        active_c = jnp.repeat(div_p, 4) & vis[Q:]
        div_c = should[Q:] & active_c & (k + 2 < cfg.refinement_count)
        emit_c = active_c & ~div_c

        # --- stable partition over both levels: parent emits (0) |
        # child emits (1) | divided children (2) | dead (3) — one sort
        # keeps the level-major emit order of the one-level loop ---
        cat_p = jnp.where(emit_p, 0, 3)
        cat_c = jnp.where(emit_c, 1, jnp.where(div_c, 2, 3))
        category = jnp.concatenate([cat_p, cat_c]).astype(jnp.int32)
        s_cat, s_side, s_x, s_y = jax.lax.sort(
            (category, b_side, b_x, b_y), num_keys=1, is_stable=True
        )
        n_emit_p = jnp.sum(emit_p.astype(jnp.int32))
        n_emit = n_emit_p + jnp.sum(emit_c.astype(jnp.int32))
        n_div = jnp.sum(div_c.astype(jnp.int32))

        # --- append both levels' emitted prefix in ONE update; the
        # non-emitted tail written here is overwritten by later appends ---
        offset = jnp.minimum(f_count, F)
        lodvec = k + (jnp.arange(L, dtype=jnp.int32) >= n_emit_p).astype(
            jnp.int32
        )
        srows = jnp.concatenate(
            [s_side[None], lodvec[None], s_x[None], s_y[None]], axis=0
        )  # (4, L): side / lod / x / y
        fbuf = jax.lax.dynamic_update_slice(fbuf, srows, (0, offset))
        dropped = dropped + jnp.maximum(f_count + n_emit - F, 0)
        f_count = jnp.minimum(f_count + n_emit, F)

        # --- next queue: expand the divided-children block (sorted rows
        # [n_emit, n_emit + n_div)) to their level-(k+2) children, which
        # the next iteration evaluates as its parents ---
        sorted3 = jnp.concatenate(
            [s_side[None], s_x[None], s_y[None]], axis=0
        )  # (3, L)
        padded = jnp.concatenate(
            [sorted3, jnp.zeros((3, Q), jnp.int32)], axis=1
        )  # (3, L + Q): zero-pad so the dynamic start is never clamped
        gpar = jax.lax.dynamic_slice(padded, (0, n_emit), (3, Q))
        g_side = jnp.repeat(gpar[0], 4)[:Q]
        g_x = ((gpar[1][:, None] << 1) + (child_sub & 1)[None, :]).reshape(
            -1)[:Q]
        g_y = ((gpar[2][:, None] << 1) + (child_sub >> 1)[None, :]).reshape(
            -1)[:Q]
        qcols = jnp.concatenate([g_side[None], g_x[None], g_y[None]], axis=0)
        dropped = dropped + jnp.maximum(4 * n_div - Q, 0)
        new_count = jnp.minimum(4 * n_div, Q)

        return (k + 2, qcols, new_count, fbuf, f_count, dropped)

    fbuf0 = jnp.zeros((4, F + L), jnp.int32)
    fbuf0 = fbuf0.at[1].set(-1)
    fbuf0 = jax.lax.dynamic_update_slice(
        fbuf0,
        jnp.concatenate(
            [final_side[None], final_lod[None], final_x[None], final_y[None]],
            axis=0,
        ),
        (0, 0),
    )
    state = (
        jnp.int32(k0),
        jnp.concatenate([queue_side[None], queue_x[None], queue_y[None]], 0),
        queue_count,
        fbuf0,
        final_count,
        overflow0,
    )
    state = jax.lax.while_loop(cond, body, state)
    (_, _, _, fbuf, f_count, dropped) = state
    return RefinementOutput(
        fbuf[0, :F + Q], fbuf[1, :F + Q],
        jnp.stack([fbuf[2, :F + Q], fbuf[3, :F + Q]], axis=-1), f_count,
        dropped,
    )
