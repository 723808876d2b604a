"""The per-frame terrain pipeline: host orchestration + one jitted step.

This replaces the reference's whole render stack —
the plugin's frame schedule (plugin.rs:46-93), the tiling prepass node
(render/tiling_prepass.rs:204-271), and the indirect terrain draw
(terrain_material.rs:365-432) — collapsed into:

1. a small host prologue per view (f64 numpy): request scan, residency
   update, best-tile entries, Taylor approximation, and
2. one jitted device step per (terrain, view): refinement -> mesh-gen
   [-> optional shading], producing dense vertex/tile tensors.

The host prologue for frame N+1 naturally overlaps the device step for
frame N through jax async dispatch (the reference gets the same overlap
from its extract/prepare pipelining, SURVEY.md section 2.2).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import numpy as np

from bevy_terrain_tpu.config import TerrainConfig, TerrainViewConfig
from bevy_terrain_tpu.math.approximation import TerrainModelApproximation
from bevy_terrain_tpu.ops import meshgen, refinement
from bevy_terrain_tpu.ops.params import (
    FrameUniforms,
    StaticTerrainConfig,
    make_frame_uniforms,
    pack_frame_uniforms,
    unpack_frame_uniforms,
)
from bevy_terrain_tpu.terrain_data.tile_atlas import TileAtlas
from bevy_terrain_tpu.terrain_data.tile_tree import TileTree


class TerrainFrameOutput:
    """One view's frame products: the compacted tile list + vertex buffers.

    ``tiles``/``mesh``/``colors`` live on device; pull with numpy() only
    when needed.
    """

    def __init__(self, tiles, mesh, colors=None):
        self.tiles = tiles
        self.mesh = mesh
        self.colors = colors

    @property
    def tile_count(self) -> int:
        return int(self.tiles.tile_count)

    @property
    def overflow(self) -> int:
        """Tiles dropped by the static capacity clamps this frame. Nonzero
        means geometry was silently missing — raise ``tile_capacity`` /
        ``queue_capacity`` (the reference's 1M cap never truncates in
        practice, terrain_view.rs:23-25)."""
        return int(self.tiles.overflow)


class Terrain:
    """A terrain with its atlas and per-view tile trees.

    Equivalent of spawning a TerrainBundle + registering TileTrees
    (reference terrain.rs:58-98, examples/minimal.rs:23-59)::

        terrain = Terrain(config)
        terrain.add_view("camera", TerrainViewConfig())
        outputs = terrain.update({"camera": view_position})
    """

    def __init__(self, config: TerrainConfig, shading_fn: Optional[Callable] = None):
        self.config = config
        self.atlas = TileAtlas(config)
        self.tile_trees: dict[object, TileTree] = {}
        self.view_configs: dict[object, TerrainViewConfig] = {}
        self._static_cfgs: dict[object, StaticTerrainConfig] = {}
        self._step = jax.jit(self._frame_step, static_argnames=("cfg",))
        static_names = (
            "cfg", "plan", "max_value", "shade_opts", "material", "extra_meta",
        )
        self._step_grid = jax.jit(self._frame_step_grid, static_argnames=static_names)
        self.shading_fn = shading_fn
        # shading config: None = vertex buffers only; set via set_shading()
        self._shade_opts = None
        self._last_uniforms = {}
        self._last_frame_cfgs = {}
        self._last_cfgs = {}
        self._adaptive = {}
        # overflow guard bookkeeping (see _spike_suspected / update):
        # (position, height-above-terrain) per view + loud counters
        self._last_view_pos: dict = {}
        self.overflow_redispatches = 0
        self.overflow_checks = 0
        # freeze support (reference debug/mod.rs:186-192: the prepass is
        # skipped and the last tile list is re-drawn from the new camera)
        self.debug = None
        self._frozen_tiles: dict = {}
        self._step_grid_frozen = jax.jit(
            self._frame_step_grid_frozen, static_argnames=static_names
        )
        self.frame_index = 0
        # per-tile patch path (ops/patch_sampling.py); falls back to the
        # exact per-vertex path when the attachment is too small for the
        # patch pipeline
        self.use_grid_mesh = self.atlas.attachments and (
            self.atlas.attachments[0].patch_plan.usable
        )

    # -- setup --

    def add_view(
        self,
        view_id,
        view_config: Optional[TerrainViewConfig] = None,
        queue_capacity: int = 8192,
        **static_overrides,
    ) -> None:
        view_config = view_config or TerrainViewConfig()
        self.view_configs[view_id] = view_config
        self.tile_trees[view_id] = TileTree(self.atlas, view_config)
        model = self.config.model
        self._static_cfgs[view_id] = StaticTerrainConfig(
            spherical=model.is_spherical,
            side_count=model.side_count,
            lod_count=self.config.lod_count,
            tree_size=view_config.tree_size,
            grid_size=view_config.grid_size,
            refinement_count=view_config.refinement_count,
            queue_capacity=queue_capacity,
            tile_capacity=view_config.tile_capacity,
            origin_lod=view_config.origin_lod,
            attachment_count=len(self.config.attachments),
            **{
                # the reference's high_precision feature targets planetary
                # scale; enable the Taylor relative path for spherical models
                "high_precision": model.is_spherical,
                **static_overrides,
            },
        )

    def set_shading(self, material=None, lighting: bool = True,
                    debug_view=None, enabled: bool = True,
                    wireframe: bool = False,
                    sample_attachments: tuple = ()) -> None:
        """Enable per-vertex shading in the frame step (fragment-stage
        equivalent; see render/material.py). ``material`` must be a stable
        jittable callable — it is a jit-static argument.

        ``sample_attachments``: attachment indices (e.g. ``(1,)`` for the
        planar example's albedo) to sample at the frame's morphed vertex
        uvs INSIDE the frame step and expose as
        ``ShadeContext.attachment_samples``."""
        self.shading_fn = material
        ts = (
            self.atlas.attachments[0].config.texture_size
            if self.atlas.attachments else 512
        )
        self._shade_opts = (
            (lighting, debug_view, ts, wireframe, tuple(sample_attachments))
            if enabled else None
        )

    def set_debug(self, debug) -> None:
        """Apply a DebugTerrain resource (reference debug/mod.rs:94-260).

        Pipeline-specialization toggles (morph/blend/tile_tree_lod/
        sample_grad) rebuild each view's static config — a recompile,
        exactly like the reference's shader-def respecialization; view
        toggles select the debug color output; ``freeze`` pins every view's
        tile list until released."""
        self.debug = debug
        if debug is None:
            self._frozen_tiles.clear()
            return
        for view_id in list(self._static_cfgs):
            self._static_cfgs[view_id] = dataclasses.replace(
                self._static_cfgs[view_id], **debug.static_overrides()
            )
        if (debug.debug_view is not None or debug.wireframe
                or self._shade_opts is not None):
            self.set_shading(
                self.shading_fn, lighting=debug.lighting,
                debug_view=debug.debug_view, wireframe=debug.wireframe,
                sample_attachments=(
                    self._shade_opts[4] if self._shade_opts else ()
                ),
            )
        if not debug.freeze:
            self._frozen_tiles.clear()

    def tune_view(self, view_id, **changes) -> None:
        """Runtime view-parameter tuning (reference debug/mod.rs:216-260:
        morph/blend/load distance and grid-size halving/doubling).

        Distance/range changes flow into the next frame's uniforms with no
        recompile; ``grid_size``/``tree_size``/``tile_capacity`` changes
        rebuild the TileTree and static config (a respecialization, like
        the reference swapping pipelines)."""
        old = self.view_configs[view_id]
        new = dataclasses.replace(old, **changes)
        self.view_configs[view_id] = new
        structural = {"tree_size", "grid_size", "tile_capacity"} & set(changes)
        tree = self.tile_trees[view_id]
        if structural:
            held = tree._collect(tree.tile_requested, tree.tile_xy)
            self.atlas.update(released_tiles=held)
            queue_capacity = self._static_cfgs[view_id].queue_capacity
            overrides = {
                f: getattr(self._static_cfgs[view_id], f)
                for f in ("morph", "blend", "tile_tree_lod", "sample_grad",
                          "culling", "high_precision")
            }
            self.add_view(view_id, new, queue_capacity=queue_capacity,
                          **overrides)
        else:
            scale = self.config.model.scale
            tree.view_config = new
            tree.morph_distance = new.morph_distance * scale
            tree.blend_distance = new.blend_distance * scale
            tree.load_distance = new.load_distance * scale
            tree.subdivision_distance = (
                new.morph_distance * scale * (1.0 + new.subdivision_tolerance)
            )
            tree.morph_range = new.morph_range
            tree.blend_range = new.blend_range
        self._frozen_tiles.pop(view_id, None)

    def enable_adaptive_capacity(self, view_id, ladder=None,
                                 headroom: float = 2.0) -> None:
        """Adapt the frame step's tile_capacity to the live tile count.

        The frame step's cost is proportional to tile_capacity, not to the
        tiles actually emitted. This respecializes the jitted step over a capacity ladder, choosing the
        smallest rung >= headroom x the PREVIOUS frame's tile count. The
        count reads back asynchronously (copy_to_host_async at dispatch,
        harvested next frame) so no device sync stalls the loop. Each rung
        compiles once (like the reference's pipeline specialization).
        A sudden tile-count spike (teleport, fast cut) is caught the SAME
        frame: a host-side spike heuristic (camera jump vs height above
        terrain, request-scan burst — see _spike_suspected) triggers a
        synchronous overflow check and the frame re-dispatches at the
        next rung until clean (_overflow_guard), so no frame ever drops
        geometry; the sync cost is paid only on suspect frames. Disabled
        while freeze debugging pins a tile list (shapes must match the
        frozen tensors).
        """
        cap = self.view_configs[view_id].tile_capacity
        if ladder is None:
            ladder, c = [], cap
            while c >= 1024:
                ladder.append(c)
                c //= 2
        ladder = sorted({min(int(c), cap) for c in ladder} | {cap})
        self._adaptive[view_id] = {
            "ladder": ladder, "headroom": float(headroom),
            "pending": None, "last_count": cap, "capacity": cap,
        }

    def disable_adaptive_capacity(self, view_id) -> None:
        self._adaptive.pop(view_id, None)

    def _adapted_cfg(self, view_id, frozen: bool) -> StaticTerrainConfig:
        """The frame's static config: the capacity-ladder rung when
        adaptive capacity is on (see enable_adaptive_capacity), else the
        view's full config. Frozen frames pin the full capacity (the
        frozen tile tensors' shapes must match)."""
        cfg_s = self._static_cfgs[view_id]
        ad = self._adaptive.get(view_id)
        if ad is None or frozen:
            return cfg_s
        if ad["pending"] is not None:
            ad["last_count"] = int(np.asarray(ad["pending"]))
            ad["pending"] = None
        want = ad["last_count"] * ad["headroom"]
        cap = next((c for c in ad["ladder"] if c >= want), ad["ladder"][-1])
        ad["capacity"] = cap
        if cap != cfg_s.tile_capacity:
            cfg_s = dataclasses.replace(cfg_s, tile_capacity=cap)
        return cfg_s

    def _spike_suspected(self, view_id, pos, n_requested: int) -> bool:
        """Host-side tile-count-spike heuristic for the overflow guard.

        The refined tile count is a function of the camera relative to
        the surface; it can only jump when the camera moves a distance
        comparable to its height above the terrain (deepest-lod
        subdivision radii are O(height)) or when the request scan bursts
        (new area streaming in). Both signals are free on the host, so
        the guard's device sync is paid only on suspect frames — the
        steady state stays sync-free."""
        tree = self.tile_trees[view_id]
        pos = np.asarray(pos, np.float64).reshape(3)
        surf = np.asarray(
            self.config.model.surface_position(
                pos, float(tree.approximate_height)
            ),
            np.float64,
        )
        h = float(np.linalg.norm(pos - surf))
        prev = self._last_view_pos.get(view_id)
        self._last_view_pos[view_id] = (pos, h)
        if prev is None:
            return True  # first frame
        ppos, ph = prev
        if float(np.linalg.norm(pos - ppos)) > 0.3 * max(min(ph, h), 1e-9):
            return True
        cap = self._adaptive[view_id]["capacity"]
        return n_requested > max(16, cap // 16)

    def _overflow_guard(self, view_id, pos, n_requested, cfg_s, tiles, mesh,
                        colors, dispatch):
        """Same-frame adaptive-capacity overflow guard: when a tile-count
        spike is suspected (see _spike_suspected), synchronously read the
        frame's overflow counter and re-dispatch the SAME frame at the
        next capacity rung until clean (the re-dispatch reuses the packed
        uniforms already on device). Closes the one-frame dropped-geometry
        window of enable_adaptive_capacity on teleports/fast cuts."""
        ad = self._adaptive.get(view_id)
        if ad is None:
            return cfg_s, tiles, mesh, colors
        if not self._spike_suspected(view_id, pos, n_requested):
            return cfg_s, tiles, mesh, colors
        ladder = ad["ladder"]
        while cfg_s.tile_capacity < ladder[-1]:
            self.overflow_checks += 1
            if int(np.asarray(tiles.overflow)) == 0:
                break
            nxt = next(c for c in ladder if c > cfg_s.tile_capacity)
            cfg_s = dataclasses.replace(
                self._static_cfgs[view_id], tile_capacity=nxt
            )
            ad["capacity"] = nxt
            self.overflow_redispatches += 1
            out = dispatch(cfg_s)
            tiles, mesh, colors = out if len(out) == 3 else (*out, colors)
        return cfg_s, tiles, mesh, colors

    def remove_view(self, view_id) -> None:
        """Release every tile the view still holds, then drop it."""
        tree = self.tile_trees.pop(view_id)
        self.view_configs.pop(view_id)
        self._static_cfgs.pop(view_id)
        self._adaptive.pop(view_id, None)
        self._last_cfgs.pop(view_id, None)
        held = tree._collect(tree.tile_requested, tree.tile_xy)
        self.atlas.update(released_tiles=held)

    # -- device step --

    @staticmethod
    def _frame_step(height_slab, uniforms: FrameUniforms, cfg: StaticTerrainConfig,
                    attachment_scale: float, attachment_offset: float):
        tiles = refinement.refine_tiles(uniforms, cfg)
        mesh = meshgen.generate_mesh(
            tiles, height_slab, uniforms, cfg, attachment_scale, attachment_offset
        )
        return tiles, mesh

    @staticmethod
    def _frame_step_grid(block_array, uniform_blob,
                         cfg: StaticTerrainConfig, plan, max_value: float,
                         shade_opts=None, material=None,
                         extra_blocks=(), extra_meta=()):
        # single packed host->device transfer per frame
        uniforms = unpack_frame_uniforms(
            uniform_blob, cfg.side_count, cfg.lod_count, cfg.tree_size
        )
        tiles = refinement.refine_tiles(uniforms, cfg)
        # generate_mesh_grid reorders the tile list by atlas quad id; the
        # returned tiles are the frame's canonical list, row-paired with
        # the mesh
        mesh, tiles = meshgen.generate_mesh_grid(
            tiles, block_array, uniforms, cfg, plan, max_value
        )
        colors = Terrain._maybe_shade(
            mesh, tiles, uniforms, cfg, shade_opts, material,
            extra_blocks, extra_meta,
        )
        return tiles, mesh, colors

    @staticmethod
    def _maybe_shade(mesh, tiles, uniforms, cfg, shade_opts, material,
                     extra_blocks=(), extra_meta=()):
        if shade_opts is None:
            return None
        from bevy_terrain_tpu.ops.patch_sampling import sample_attachment_vertices
        from bevy_terrain_tpu.render.material import shade

        lighting, debug_view, texture_size, wireframe, *_ = shade_opts
        # in-jit attachment fetches for the material (planar.wgsl's
        # sample_albedo): one sampler pass per named attachment
        attachment_samples = None
        if extra_meta:
            attachment_samples = {}
            for blocks_i, (idx, plan_i, maxv_i, pc_i, pb_i) in zip(
                extra_blocks, extra_meta
            ):
                attachment_samples[idx] = sample_attachment_vertices(
                    list(blocks_i), tiles, mesh.uvs, uniforms, cfg,
                    plan_i, maxv_i, packed_channels=pc_i, packed_bits=pb_i,
                )
        return shade(
            mesh, tiles, uniforms, cfg,
            material=material, lighting=lighting, debug_view=debug_view,
            texture_size=texture_size, wireframe=wireframe,
            attachment_samples=attachment_samples,
        )

    @staticmethod
    def _frame_step_grid_frozen(block_array, uniform_blob, tiles,
                                cfg: StaticTerrainConfig, plan, max_value: float,
                                shade_opts=None, material=None,
                                extra_blocks=(), extra_meta=()):
        """Frozen-prepass frame (debug freeze, debug/mod.rs:186-192): mesh
        the GIVEN tile list from the new camera instead of refining."""
        uniforms = unpack_frame_uniforms(
            uniform_blob, cfg.side_count, cfg.lod_count, cfg.tree_size
        )
        mesh, tiles = meshgen.generate_mesh_grid(
            tiles, block_array, uniforms, cfg, plan, max_value
        )
        colors = Terrain._maybe_shade(
            mesh, tiles, uniforms, cfg, shade_opts, material,
            extra_blocks, extra_meta,
        )
        return tiles, mesh, colors

    # -- per-frame orchestration (reference plugin.rs:46-56 Last schedule) --

    def update(self, view_positions: dict,
               view_projections: dict | None = None) -> dict[object, TerrainFrameOutput]:
        """Run one frame for every view.

        ``view_projections`` (optional): per-view 4x4 view-projection
        matrices (math/frustum.py helpers). Needed for views whose static
        config enables ``culling`` — without one the frustum test accepts
        everything (the reference's unpopulated-planes state).
        """
        view_projections = view_projections or {}
        # 1. request scans (TileTree::compute_requests, plugin.rs:47)
        released, requested = [], []
        req_counts = {}
        for view_id, pos in view_positions.items():
            tree = self.tile_trees[view_id]
            tree.compute_requests(pos)
            released.extend(tree.released_tiles)
            requested.extend(tree.requested_tiles)
            req_counts[view_id] = len(tree.requested_tiles)

        # 2. atlas residency + IO (TileAtlas::update, plugin.rs:49)
        self.atlas.update(released, requested)
        self.atlas.flush_uploads()

        # 3.-5. per view: adjust entries, height probe, approximation,
        # device step (plugin.rs:50-55 + render schedule)
        outputs = {}
        for view_id, pos in view_positions.items():
            tree = self.tile_trees[view_id]
            tree.adjust_to_tile_atlas(self.atlas)
            tree.update_approximate_height(self.atlas)
            approx = TerrainModelApproximation.compute(
                self.config.model, pos, tree.origin_lod, tree.approximate_height
            )
            height = self.atlas.attachments[0]
            colors = None
            if self.use_grid_mesh:
                blob = pack_frame_uniforms(
                    self.config.model, pos, approx, tree.origins, tree.entries,
                    tree.view_tile_int, tree.view_tile_frac,
                    self.view_configs[view_id],
                    view_proj=view_projections.get(view_id),
                )
                cfg_s = self._adapted_cfg(view_id, frozen=(
                    self.debug is not None and self.debug.freeze
                    and view_id in self._frozen_tiles
                ))
                blob_dev = jax.numpy.asarray(blob)  # ONE transfer per frame
                frozen = (
                    self.debug is not None and self.debug.freeze
                    and view_id in self._frozen_tiles
                )
                # material attachments sampled inside the frame step
                # (set_shading(sample_attachments=...)); meta is static
                extra_blocks, extra_meta = (), ()
                if self._shade_opts is not None and self._shade_opts[4]:
                    eb, em = [], []
                    for idx in self._shade_opts[4]:
                        att = self.atlas.attachments[idx]
                        eb.append(tuple(att.block_arrays))
                        em.append((
                            idx, att.patch_plan,
                            att.config.format.max_value,
                            att.config.format.channels if att.block_packed
                            else 0,
                            att.packed_bits,
                        ))
                    extra_blocks, extra_meta = tuple(eb), tuple(em)
                if frozen:
                    tiles, mesh, colors = self._step_grid_frozen(
                        height.block_array,
                        blob_dev,
                        self._frozen_tiles[view_id],
                        cfg_s,
                        height.patch_plan,
                        height.config.format.max_value,
                        self._shade_opts,
                        self.shading_fn,
                        extra_blocks,
                        extra_meta,
                    )
                else:
                    def _dispatch(cfg_x):
                        return self._step_grid(
                            height.block_array,
                            blob_dev,
                            cfg_x,
                            height.patch_plan,
                            height.config.format.max_value,
                            self._shade_opts,
                            self.shading_fn,
                            extra_blocks,
                            extra_meta,
                        )

                    tiles, mesh, colors = _dispatch(cfg_s)
                    cfg_s, tiles, mesh, colors = self._overflow_guard(
                        view_id, pos, req_counts.get(view_id, 0), cfg_s,
                        tiles, mesh, colors, _dispatch,
                    )
                    if self.debug is not None and self.debug.freeze:
                        self._frozen_tiles[view_id] = tiles
                self._last_cfgs[view_id] = cfg_s
                uniforms = blob_dev  # packed; unpacked inside jits
            else:
                uniforms = make_frame_uniforms(
                    self.config.model,
                    pos,
                    approx,
                    tree.origins,
                    tree.entries,
                    tree.view_tile_int,
                    tree.view_tile_frac,
                    self.view_configs[view_id],
                    view_proj=view_projections.get(view_id),
                )
            if not self.use_grid_mesh:
                cfg_s = self._adapted_cfg(view_id, frozen=False)

                def _dispatch_plain(cfg_x):
                    return self._step(
                        height.slabs[0],
                        uniforms,
                        cfg=cfg_x,
                        attachment_scale=height.config.scale,
                        attachment_offset=height.config.offset,
                    )

                tiles, mesh = _dispatch_plain(cfg_s)
                cfg_s, tiles, mesh, colors = self._overflow_guard(
                    view_id, pos, req_counts.get(view_id, 0), cfg_s,
                    tiles, mesh, colors, _dispatch_plain,
                )
                self._last_cfgs[view_id] = cfg_s
            ad = self._adaptive.get(view_id)
            if ad is not None:
                count = tiles.tile_count
                count.copy_to_host_async()
                ad["pending"] = count
            outputs[view_id] = TerrainFrameOutput(
                tiles=tiles, mesh=mesh, colors=colors)
            self._last_uniforms[view_id] = uniforms
            self._last_frame_cfgs[view_id] = cfg_s
        self.frame_index += 1
        return outputs

    def render_image(self, view_id, out, view_proj, width, height,
                     pixel_texturing=None, **kw):
        """Rasterize a frame output to an (H, W, 4) image — the per-pixel
        fragment stage (render/raster.py) wired from this terrain's
        state: the view's last uniforms/config, the current shading
        material and debug view, and (optionally) TRUE per-pixel
        deferred texturing.

        ``pixel_texturing``: attachment index to sample per pixel with
        analytic screen-derivative mip selection (the reference's
        textureSampleGrad path, fragment.wgsl:35-49). Defaults to the
        material's albedo attachment when the current shading samples
        exactly one; pass ``False`` to force interpolated vertex colors.

        Returns ``(image, RasterOutput)``.
        """
        from bevy_terrain_tpu.render.raster import render_view

        uniforms, cfg = self.frame_inputs(view_id)
        material = self.shading_fn
        lighting, debug_view = True, None
        if self._shade_opts is not None:
            lighting, debug_view = self._shade_opts[0], self._shade_opts[1]
        if pixel_texturing is None:
            idx = getattr(
                getattr(material, "base_color", None), "attachment_index",
                None,
            )
            if (idx is not None and self._shade_opts is not None
                    and self._shade_opts[4] == (idx,)):
                pixel_texturing = idx
        if pixel_texturing not in (None, False):
            att = self.atlas.attachments[pixel_texturing]
            kw.setdefault(
                "pixel_attachment",
                (
                    tuple(att.slabs), att.config.scale, att.config.offset,
                    att.config.format.max_value, att.config.texture_size,
                ),
            )
        kw.setdefault("material", material)
        kw.setdefault("lighting", lighting)
        kw.setdefault("debug_view", debug_view)
        # vertex-sampled attachments for paths that evaluate the material
        # per vertex (vertex shade mode / debug views / no per-pixel tex)
        needs = getattr(
            getattr(material, "base_color", None), "attachment_index", None
        )
        vertex_path = (
            kw.get("debug_view") is not None
            or kw.get("shade_mode", "pixel") == "vertex"
            or "pixel_attachment" not in kw
        )
        if needs is not None and vertex_path and "attachment_samples" not in kw:
            kw["attachment_samples"] = {
                needs: self.sample_attachment_grid(
                    view_id, out, attachment_index=needs
                )
            }
        return render_view(
            out.mesh, out.tiles, uniforms, cfg, view_proj, width, height,
            **kw,
        )

    def frame_inputs(self, view_id):
        """(FrameUniforms, StaticTerrainConfig) of the view's last frame.

        The inputs an out-of-pipeline consumer needs alongside the frame
        output — e.g. the rasterizer (``render.raster.render_view``),
        custom shading, or debug tooling. The config is the one the frame
        actually ran with (adaptive-capacity rungs included), so its
        ``tile_capacity`` matches the output tensors' leading dim. Call
        after ``update()``."""
        u = self._last_uniforms[view_id]
        cfg = self._last_frame_cfgs[view_id]
        if hasattr(u, "ndim"):  # grid path stores the packed blob
            u = unpack_frame_uniforms(
                u, cfg.side_count, cfg.lod_count, cfg.tree_size
            )
        return u, cfg

    def query_heights(self, view_id, positions):
        """Batched DEVICE-side terrain height queries (collision/physics/
        placement): the CPU sampling API's exact chain as one jitted op
        over (N, 3) world positions (ops/sampling.query_heights). Uses the
        view's last-frame uniforms; call after update(). Returns (N,) f32.
        """
        from bevy_terrain_tpu.ops.sampling import query_heights as _qh

        height = self.atlas.attachments[0]
        u = self._last_uniforms[view_id]
        pts = jax.numpy.asarray(np.asarray(positions, np.float32))
        if hasattr(u, "ndim"):  # grid path stores the packed blob
            return self._query_heights_blob_jit(
                height.slabs[0], u, self._static_cfgs[view_id], pts,
                height.config.scale, height.config.offset,
            )
        return self._query_heights_jit(
            height.slabs[0], u, self._static_cfgs[view_id], pts,
            height.config.scale, height.config.offset,
        )

    def query_attachment(self, view_id, positions, attachment_index: int):
        """Batched DEVICE-side attachment queries at (N, 3) world positions
        (the CPU sample_attachment as one jitted op,
        ops/sampling.query_attachment). Returns (N, C) values in [0, 1]."""
        att = self.atlas.attachments[attachment_index]
        u = self._last_uniforms[view_id]
        pts = jax.numpy.asarray(np.asarray(positions, np.float32))
        blob = hasattr(u, "ndim")
        return self._query_attachment_jit(
            att.slabs[0], u, self._static_cfgs[view_id], pts,
            att.config.scale, att.config.offset,
            att.config.format.max_value, blob,
        )

    @staticmethod
    @partial(jax.jit, static_argnums=(2, 4, 5, 6, 7))
    def _query_attachment_jit(slab, uniforms, cfg, positions, scale, offset,
                              max_value, packed):
        from bevy_terrain_tpu.ops.sampling import query_attachment as _qa

        if packed:
            uniforms = unpack_frame_uniforms(
                uniforms, cfg.side_count, cfg.lod_count, cfg.tree_size
            )
        return _qa(slab, uniforms, cfg, positions, scale, offset, max_value)

    @staticmethod
    @partial(jax.jit, static_argnums=(2, 4, 5))
    def _query_heights_blob_jit(slab, uniform_blob, cfg, positions, scale, offset):
        from bevy_terrain_tpu.ops.sampling import query_heights as _qh

        uniforms = unpack_frame_uniforms(
            uniform_blob, cfg.side_count, cfg.lod_count, cfg.tree_size
        )
        return _qh(slab, uniforms, cfg, positions, scale, offset)

    @staticmethod
    @partial(jax.jit, static_argnums=(2, 4, 5))
    def _query_heights_jit(slab, uniforms, cfg, positions, scale, offset):
        from bevy_terrain_tpu.ops.sampling import query_heights as _qh

        return _qh(slab, uniforms, cfg, positions, scale, offset)

    def sample_attachment_grid(self, view_id, frame_output: TerrainFrameOutput,
                               attachment_index: int, grad_taps: int = 1):
        """Sample an attachment (albedo, splat, ...) at the frame's morphed
        vertex uvs — the fragment-stage attachment fetch for custom
        materials (attachments.wgsl:12-43). Grid path only; returns
        (F, G+1, G+1, C) f32 in [0, 1].

        ``grad_taps > 1`` enables the anisotropic multi-tap option — the
        SAMPLE_GRAD equivalent for color under grazing angles (reference
        attachments.wgsl:12-24 textureSampleGrad anisotropy-16); cost is
        ``grad_taps`` sampler passes (ops/patch_sampling.py
        sample_attachment_vertices_grad)."""
        if not self.use_grid_mesh:
            raise RuntimeError("sample_attachment_grid requires the grid mesh path")
        attachment = self.atlas.attachments[attachment_index]
        blob_dev = self._last_uniforms[view_id]
        return self._sample_grid(
            tuple(attachment.block_arrays),
            frame_output.tiles,
            frame_output.mesh,
            blob_dev,
            self._last_cfgs.get(view_id, self._static_cfgs[view_id]),
            attachment.patch_plan,
            attachment.config.format.max_value,
            grad_taps,
            (attachment.config.format.channels
             if attachment.block_packed else 0),
            attachment.packed_bits,
        )

    @staticmethod
    @partial(jax.jit, static_argnums=(4, 5, 6, 7, 8, 9))
    def _sample_grid(block_arrays, tiles, mesh, uniform_blob, cfg, plan,
                     max_value, grad_taps, packed_channels, packed_bits):
        from bevy_terrain_tpu.ops.patch_sampling import (
            sample_attachment_vertices, sample_attachment_vertices_grad,
        )

        uniforms = unpack_frame_uniforms(
            uniform_blob, cfg.side_count, cfg.lod_count, cfg.tree_size
        )
        if grad_taps > 1:
            return sample_attachment_vertices_grad(
                list(block_arrays), tiles, mesh.uvs, mesh, uniforms, cfg,
                plan, max_value, taps=grad_taps,
                packed_channels=packed_channels, packed_bits=packed_bits,
            )
        return sample_attachment_vertices(
            list(block_arrays), tiles, mesh.uvs, uniforms, cfg, plan,
            max_value, packed_channels=packed_channels, packed_bits=packed_bits,
        )
