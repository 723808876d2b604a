"""Tensor-parallel tile atlas: block storage sharded over a device mesh.

A planetary-scale atlas (tens of thousands of resident 512^2
multi-attachment tiles, each ~340 KB of block quads per 16-bit channel)
can outgrow one device's memory. This module shards the unified block
array over the mesh's ``atlas`` axis and serves per-tile patch fetches
with one ``psum`` over the interconnect:

* every device stores ``N/n`` consecutive blocks (slot-major layout keeps a
  tile's blocks on one device),
* a fetch shard_map lets each device gather the requested blocks it owns
  (out-of-range requests contribute zeros) and combines them with ``psum``
  — each block has exactly one owner, so the sum reconstructs the patches
  on every device.

This is the scale-out path SURVEY.md section 2.2 marks as beyond the
reference (which is single-GPU); the single-chip pipeline does not pay for
it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def shard_blocks(mesh: Mesh, block_array, axis: str = "atlas"):
    """Place a (N, 32, 128) row-interleaved quad array sharded on its slot axis."""
    n = mesh.shape[axis]
    N = block_array.shape[0]
    if N % n:
        pad = (-N) % n
        block_array = jnp.pad(
            block_array, ((0, pad),) + ((0, 0),) * (block_array.ndim - 1)
        )
    return jax.device_put(block_array, NamedSharding(mesh, P(axis)))


def fetch_patches_sharded(mesh: Mesh, sharded_blocks, ids, axis: str = "atlas"):
    """Assemble (F, 64, 64) patches from blocks owned by any device.

    ``ids``: (F, 4) i32 global block indices (tl, tr, bl, br). Returns the
    patches replicated on every device.
    """
    n = mesh.shape[axis]
    per_device = sharded_blocks.shape[0] // n

    def local_fetch(blocks, ids_rep):
        # blocks: (per_device, 32, 32) local shard; ids replicated
        rank = jax.lax.axis_index(axis)
        base = rank * per_device
        local = ids_rep - base
        in_range = (local >= 0) & (local < per_device)
        safe = jnp.clip(local, 0, per_device - 1)

        v = jnp.take(blocks, safe[:, 0], axis=0).astype(jnp.float32)  # (F, 32, 128)
        v = v * in_range[:, 0, None, None]
        patch = jnp.concatenate([v[:, :, :64], v[:, :, 64:]], axis=-2)  # (F, 64, 64)
        # one owner per block -> psum reconstructs every patch everywhere
        return jax.lax.psum(patch, axis)

    fetch = jax.jit(
        jax.shard_map(
            local_fetch,
            mesh=mesh,
            in_specs=(P(axis), P()),
            out_specs=P(),
            check_vma=False,
        )
    )
    return fetch(sharded_blocks, ids)
