"""Multi-device parallelism over jax.sharding Mesh + shard_map.

The reference is single-process/single-GPU (SURVEY.md section 2.2); its only
"multi" dimension is N views sharing one TileAtlas via request counting
(terrain_view.rs:6-7). This build makes that dimension — and the atlas —
shardable over a device mesh:

* :mod:`multi_view` — data-parallel views: each device owns a subset of the
  per-view uniforms and produces that view's tile list + mesh against a
  replicated atlas slab.
* :mod:`sharded_atlas` — tensor-parallel atlas: the slab's atlas-slot axis
  sharded across devices with all_gather on demand (large-atlas scaling).
"""

from bevy_terrain_tpu.parallel.multi_view import (
    MultiViewTerrain,
    multi_view_frame_step,
)
from bevy_terrain_tpu.parallel.sharded_atlas import fetch_patches_sharded, shard_blocks

__all__ = [
    "MultiViewTerrain",
    "fetch_patches_sharded",
    "multi_view_frame_step",
    "shard_blocks",
]
