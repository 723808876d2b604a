"""Preprocess COMPUTE throughput: device stack ops vs host numpy.

Isolates the split/downsample/stitch/mip math from file IO and from
device->host readback — the anchor for BASELINE.md's ">10x the CPU
reference" preprocess target (512^2 R16 tiles, 2048^2 source, 4 lods).
Device rows are host-clock times of work that ends in
``block_until_ready``. Needs a GPU.

    python tools/preprocess_compute_bench.py
"""
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from bevy_terrain_tpu.utils.device import card_info, require_gpu  # noqa: E402

require_gpu()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bevy_terrain_tpu.math.coordinate import TileCoordinate  # noqa: E402
from bevy_terrain_tpu.ops import preprocess as pph  # noqa: E402
from bevy_terrain_tpu.ops import preprocess_device as ppd  # noqa: E402
from bevy_terrain_tpu.ops.preprocess import _tent_matrix  # noqa: E402
from bevy_terrain_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
print(card_info())
TS, B = 512, 2
CS = TS - 2 * B
LODS = 4
rng = np.random.default_rng(0)

# --- workload: 64 finest tiles (lod 3) + parents + stitching + mips ---
n_f = 64
finest = rng.uniform(1, 65535, (n_f, TS, TS, 1)).astype(np.float32)

# source for the split: 2048^2
H = W = 2048
source = rng.uniform(0.01, 1.0, (H, W, 1)).astype(np.float32)


def device_compute():
    # split: per tile-row bands at the finest lod (8x8 = 64 tiles)
    count = 8
    P = count * CS
    uv = (np.arange(P) + 0.5) / P
    px = uv * W - 0.5
    py = uv * H - 0.5
    mx = jnp.asarray(_tent_matrix(px, W))
    src = jnp.asarray(source)
    rows_out = []
    for ty in range(count):
        my = jnp.asarray(_tent_matrix(py[ty * CS:(ty + 1) * CS], H))
        band = ppd.resize_cols(ppd.resize_rows(my, src), mx)
        rows_out.append(band)
    stack = jnp.stack([r for r in rows_out])  # (count, CS, P, 1)
    # downsample chain over the finest stack
    st = jnp.asarray(finest)
    coords = [TileCoordinate(0, 3, x, y) for x in range(8) for y in range(8)]
    idx_map = {c: i for i, c in enumerate(coords)}
    stacks = {3: st}
    for lod in (2, 1, 0):
        pc = [TileCoordinate(0, lod, x, y) for x in range(1 << lod) for y in range(1 << lod)]
        child_index = {c: i for i, c in enumerate(coords)}
        idx = np.array([[child_index.get(ch, -1) for ch in c.children()] for c in pc], np.int32)
        stacks[lod] = ppd.downsample_stack(stacks[lod + 1], jnp.asarray(idx), TS, B)
        coords, child_index = pc, None
    # stitch every lod + mips for the finest
    total = 0
    for lod, st_l in stacks.items():
        cl = [TileCoordinate(0, lod, x, y) for x in range(1 << lod) for y in range(1 << lod)]
        io = {c: i for i, c in enumerate(cl)}
        nbr_idx, nbr_side = ppd.stitch_plan(cl, io, False)
        stitched = ppd.stitch_stack(
            st_l, np.zeros(len(cl), np.int64), jnp.asarray(nbr_idx), nbr_side, B, False)
        total += stitched.shape[0]
    mips = ppd.mip_stack(stacks[3], 4, True)
    jax.block_until_ready((stack, stitched, mips))
    return total + 64


def host_compute():
    mosaic, valid = pph.split_mosaic(source, 3, CS, (0, 0), (1, 1))
    tiles = {}
    for x in range(8):
        for y in range(8):
            tiles[(3, x, y)] = pph.extract_tile_from_mosaic(
                mosaic, valid, x, y, TS, B, np.uint16, 65535.0)
    for lod in (2, 1, 0):
        for x in range(1 << lod):
            for y in range(1 << lod):
                kids = [tiles.get((lod + 1, 2 * x + dx, 2 * y + dy))
                        for dy in (0, 1) for dx in (0, 1)]
                tiles[(lod, x, y)] = pph.downsample_tile(kids, TS, B)
    n = 0
    for (lod, x, y), t in list(tiles.items()):
        nbrs = []
        c = TileCoordinate(0, lod, x, y)
        for nb in c.neighbours(False):
            key = (nb.lod, nb.x, nb.y)
            nbrs.append((0, tiles.get(key)) if nb.is_valid else (0, None))
        pph.stitch_tile(t, 0, nbrs, B)
        n += 1
    from bevy_terrain_tpu.terrain_data.attachment import generate_mipmaps
    for x in range(8):
        for y in range(8):
            generate_mipmaps(tiles[(3, x, y)].astype(np.uint16), 4)
    return n


n_dev = device_compute()  # warm/compile
t0 = time.time(); n_dev = device_compute(); dt_dev = time.time() - t0
t0 = time.time(); n_host = host_compute(); dt_host = time.time() - t0
print(f"device compute: {n_dev} tiles in {dt_dev:.3f}s = {n_dev/dt_dev:.1f} tiles/s")
print(f"host compute:   {n_host} tiles in {dt_host:.3f}s = {n_host/dt_host:.1f} tiles/s")
print(f"ratio: {dt_host / dt_dev * (n_dev / n_host):.1f}x")
