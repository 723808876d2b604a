"""Data-parallel multi-view frame step over a device mesh.

Each view (camera, shadow-casting light, ...) is independent given the
shared atlas: the reference runs them serially on one GPU
(tiling_prepass.rs:228 per (terrain, view)); here the views axis shards
across devices with ``shard_map`` — the atlas slab and static config are
replicated, per-view uniforms and outputs are sharded. Collectives only
enter through the (optional) sharded-atlas path, so the replicated step scales
with no cross-device traffic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bevy_terrain_tpu.ops import meshgen, refinement
from bevy_terrain_tpu.ops.params import StaticTerrainConfig


def stack_uniforms(uniform_list):
    """Stack per-view FrameUniforms pytrees along a leading views axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *uniform_list)


def multi_view_frame_step(
    devices,
    cfg: StaticTerrainConfig,
    uniforms,
    slab,
    views_per_device: int = 1,
    attachment_scale: float = 124 / 128,
    attachment_offset: float = 2 / 128,
    audit: bool = False,
):
    """Run one frame step for ``len(devices) * views_per_device`` views.

    ``uniforms`` is a single view's FrameUniforms tiled to all views, OR a
    LIST of per-view FrameUniforms (distinct cameras) stacked via
    :func:`stack_uniforms`.

    Returns (positions, heights, tile_counts) with a leading views axis
    sharded over the mesh.
    """
    n_views = len(devices) * views_per_device
    mesh = Mesh(np.asarray(devices), ("views",))

    if isinstance(uniforms, (list, tuple)):
        assert len(uniforms) == n_views
        stacked = stack_uniforms(list(uniforms))
    else:
        stacked = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (n_views,) + x.shape), uniforms
        )
    stacked = jax.device_put(stacked, NamedSharding(mesh, P("views")))
    slab = jax.device_put(slab, NamedSharding(mesh, P()))

    def one_view(height_slab, u):
        tiles = refinement.refine_tiles(u, cfg)
        mesh_out = meshgen.generate_mesh(
            tiles, height_slab, u, cfg, attachment_scale, attachment_offset
        )
        return mesh_out.positions, mesh_out.heights, tiles.tile_count

    def sharded(height_slab, us):
        # us: (views_per_device, ...) local shard
        return jax.vmap(lambda u: one_view(height_slab, u))(us)

    step = jax.jit(
        jax.shard_map(
            sharded,
            mesh=mesh,
            in_specs=(P(), P("views")),
            out_specs=P("views"),
            check_vma=False,
        )
    )
    if audit:
        from bevy_terrain_tpu.parallel.hlo_audit import audit_compiled

        compiled = step.lower(slab, stacked).compile()
        return compiled(slab, stacked), audit_compiled(compiled)
    return step(slab, stacked)


class MultiViewFrameOutput:
    """One view's slice of the stacked multi-view frame products."""

    def __init__(self, stacked, index: int):
        self._s = stacked
        self._i = index

    @property
    def tiles(self):
        from bevy_terrain_tpu.ops.refinement import RefinementOutput

        t = self._s["tiles"]
        return RefinementOutput(
            t.tile_side[self._i], t.tile_lod[self._i], t.tile_xy[self._i],
            t.tile_count[self._i], t.overflow[self._i],
        )

    @property
    def mesh(self):
        from bevy_terrain_tpu.ops.meshgen import GridMeshOutput

        m = self._s["mesh"]
        return GridMeshOutput(*(x[self._i] for x in m))

    @property
    def tile_count(self) -> int:
        return int(self._s["tiles"].tile_count[self._i])


class MultiViewTerrain:
    """N DISTINCT views sharing one TileAtlas, stepped data-parallel over a
    device mesh — the promised scale-out of the reference's multi-view
    sharing (terrain_view.rs:6-7: N TileTrees, one atlas; SURVEY section
    2.2 scale-out row).

    Host side: every view runs its own request scan against the SHARED
    atlas (request-counted residency, exactly the single-device flow).
    Device side: per-view uniform blobs are stacked and sharded over the
    ``views`` mesh axis; ONE shard_map runs refinement + grid mesh-gen for
    each view on its device. The atlas block array is either replicated
    (default — every device holds the whole store) or sharded over the
    same axis (``shard_atlas=True``): each device owns N/n consecutive
    slot-major blocks and per-view patch fetches are reconstructed by one
    all-gather + reduce-scatter (parallel/sharded_atlas.py rationale).
    """

    def __init__(self, config, view_ids, devices=None, view_config=None,
                 queue_capacity: int = 8192, shard_atlas: bool = False,
                 **static_overrides):
        import jax

        from bevy_terrain_tpu.config import TerrainViewConfig
        from bevy_terrain_tpu.ops.params import StaticTerrainConfig
        from bevy_terrain_tpu.terrain_data.tile_atlas import TileAtlas
        from bevy_terrain_tpu.terrain_data.tile_tree import TileTree

        devices = list(devices if devices is not None else jax.devices())
        if len(devices) != len(view_ids):
            raise ValueError(
                f"{len(view_ids)} views need {len(view_ids)} devices, got "
                f"{len(devices)} (one view per mesh slot)"
            )
        self.config = config
        self.atlas = TileAtlas(config)
        self.view_ids = list(view_ids)
        self.view_config = view_config or TerrainViewConfig()
        self.tile_trees = {
            v: TileTree(self.atlas, self.view_config) for v in self.view_ids
        }
        self.mesh = Mesh(np.asarray(devices), ("views",))
        self.shard_atlas = shard_atlas
        model = config.model
        self.cfg = StaticTerrainConfig(
            spherical=model.is_spherical,
            side_count=model.side_count,
            lod_count=config.lod_count,
            tree_size=self.view_config.tree_size,
            grid_size=self.view_config.grid_size,
            refinement_count=self.view_config.refinement_count,
            queue_capacity=queue_capacity,
            tile_capacity=self.view_config.tile_capacity,
            origin_lod=self.view_config.origin_lod,
            attachment_count=len(config.attachments),
            high_precision=model.is_spherical,
            **static_overrides,
        )
        self._blocks = None
        self._step = None

    # -- device placement --

    def _place_blocks(self):
        import jax

        height = self.atlas.attachments[0]
        blocks = height.block_array
        self._src_blocks = blocks
        if self.shard_atlas:
            from bevy_terrain_tpu.parallel.sharded_atlas import shard_blocks

            self._n_blocks = int(blocks.shape[0])
            self._blocks = shard_blocks(self.mesh, blocks, axis="views")
        else:
            self._n_blocks = int(blocks.shape[0])
            self._blocks = jax.device_put(
                blocks, NamedSharding(self.mesh, P())
            )

    def _build_step(self):
        import jax

        from bevy_terrain_tpu.ops.params import unpack_frame_uniforms

        cfg = self.cfg
        height = self.atlas.attachments[0]
        plan = height.patch_plan
        max_value = height.config.format.max_value
        n_blocks = self._n_blocks
        n = len(self.view_ids)
        per_device = (n_blocks + n - 1) // n if self.shard_atlas else n_blocks
        shard_atlas = self.shard_atlas

        def fetch_sharded(blocks_local, ids):
            # ids (F, 1) global block indices OF THIS DEVICE'S VIEW. The
            # quads it needs are scattered across all shards, so the ids
            # all_gather over the axis, every device serves every view's
            # requests from its shard, and ONE psum_scatter both reduces
            # (each block has exactly one owner, so the sum reconstructs)
            # and routes chunk i — view i's patches — to device i: half
            # the bytes of a full psum, and no (n, F, ...) full reduction
            # materialized on any device. The volume is still O(n_views *
            # F * patch) per frame (dryrun_multichip prints the audited
            # number); a capacity-factor all_to_all exchange (route only
            # owned requests) is the next step if a deployment makes
            # this the bottleneck.
            rank = jax.lax.axis_index("views")
            ids_all = jax.lax.all_gather(ids[:, 0], "views")  # (n, F)
            local = ids_all - rank * per_device
            ok = (local >= 0) & (local < blocks_local.shape[0])
            v = jnp.take(
                blocks_local,
                jnp.clip(local, 0, blocks_local.shape[0] - 1).reshape(-1),
                axis=0,
            ).astype(jnp.float32).reshape(local.shape + blocks_local.shape[1:])
            v = v * ok[..., None, None]
            mine = jax.lax.psum_scatter(v, "views")  # (F, 32, 128)
            return jnp.concatenate(
                [mine[:, :, :64], mine[:, :, 64:]], axis=-2
            )

        def local_step(blocks, blobs):
            # blobs: (1, L) this device's view
            u = unpack_frame_uniforms(
                blobs[0], cfg.side_count, cfg.lod_count, cfg.tree_size
            )
            tiles = refinement.refine_tiles(u, cfg)
            mesh_out, tiles = meshgen.generate_mesh_grid(
                tiles, blocks, u, cfg, plan, max_value,
                fetch_fn=fetch_sharded if shard_atlas else None,
                n_blocks=n_blocks,
            )
            add = lambda x: jnp.asarray(x)[None]
            return {
                "tiles": jax.tree.map(add, tiles),
                "mesh": jax.tree.map(add, mesh_out),
            }

        self._step = jax.jit(
            jax.shard_map(
                local_step,
                mesh=self.mesh,
                in_specs=(P("views") if shard_atlas else P(), P("views")),
                out_specs=P("views"),
                check_vma=False,
            )
        )

    # -- per-frame orchestration (Terrain.update, N views) --

    def update(self, view_positions: dict) -> dict:
        import jax

        from bevy_terrain_tpu.math.approximation import TerrainModelApproximation
        from bevy_terrain_tpu.ops.params import pack_frame_uniforms

        released, requested = [], []
        for view_id in self.view_ids:
            tree = self.tile_trees[view_id]
            tree.compute_requests(view_positions[view_id])
            released.extend(tree.released_tiles)
            requested.extend(tree.requested_tiles)
        self.atlas.update(released, requested)
        self.atlas.flush_uploads()

        blobs = []
        for view_id in self.view_ids:
            tree = self.tile_trees[view_id]
            tree.adjust_to_tile_atlas(self.atlas)
            tree.update_approximate_height(self.atlas)
            approx = TerrainModelApproximation.compute(
                self.config.model, view_positions[view_id], tree.origin_lod,
                tree.approximate_height,
            )
            blobs.append(pack_frame_uniforms(
                self.config.model, view_positions[view_id], approx,
                tree.origins, tree.entries, tree.view_tile_int,
                tree.view_tile_frac, self.view_config,
            ))
        stacked = jax.device_put(
            np.stack(blobs), NamedSharding(self.mesh, P("views"))
        )
        # (re)place the block store on the mesh when streaming has swapped
        # the underlying array (donated scatters make a new array object)
        if (self._blocks is None
                or self.atlas.attachments[0].block_array is not self._src_blocks):
            rebuild = self._step is None
            self._place_blocks()
            if rebuild:
                self._build_step()
        self._last_stacked = stacked  # kept for HLO inspection (tools/)
        out = self._step(self._blocks, stacked)
        return {
            v: MultiViewFrameOutput(out, i) for i, v in enumerate(self.view_ids)
        }

    def audit_step(self) -> dict:
        """Collective op count + per-device byte volume of the COMPILED
        frame step (parallel/hlo_audit.py). Call after one update().
        Replicated-atlas mode must report {} — the step is then
        mesh-size-independent; sharded-atlas mode reports its
        all-gather + reduce-scatter fetch volume."""
        from bevy_terrain_tpu.parallel.hlo_audit import audit_compiled

        compiled = self._step.lower(self._blocks, self._last_stacked).compile()
        return audit_compiled(compiled)
