"""Offline dataset preprocessing: source imagery -> streamed tile store.

Behavioral twin of the reference's preprocess task graph
(/root/reference/src/preprocess/preprocessor.rs): per dataset, SPLIT all
tiles of the finest lod from the source image, then DOWNSAMPLE coarser lods
(children -> parent), then per lod STITCH borders from the 8 neighbours and
SAVE to disk; the spherical variant runs per cube face with cross-face
stitching (preprocessor.rs:234-343). Barriers separate the phases.

Differences: tasks are processed in whole-lod batches instead of
32-GPU-write-slot chunks (SURVEY.md section 2.2), split and downsample run
on the host over the full lod mosaic (ops/preprocess.py), the stitch runs
as one device op per lod stack (ops/preprocess_device.py) of which only
the border strips come back, and results are host arrays that enter the
atlas's normal save path (bounded save slots, async writes,
tile_atlas.rs:318-345 semantics).
"""

from __future__ import annotations

import dataclasses
import shutil
import time
from pathlib import Path
from typing import Optional

import numpy as np

from bevy_terrain_tpu.math.coordinate import TileCoordinate
from bevy_terrain_tpu.ops.preprocess import (
    downsample_tile,
    extract_tile_from_mosaic,
    split_mosaic,
    stitch_tile,
)
from bevy_terrain_tpu.terrain_data.tile_atlas import AtlasTileAttachment, TileAtlas


def reset_directory(directory) -> None:
    """Clear an attachment's data directory + the config.tc manifest
    (reference preprocessor.rs:18-22)."""
    directory = Path(directory)
    tc = directory.parent.parent / "config.tc"
    tc.unlink(missing_ok=True)
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True, exist_ok=True)


@dataclasses.dataclass
class PreprocessDataset:
    """One planar source image covering a uv region of one cube side
    (reference preprocessor.rs:35-55)."""

    attachment_index: int = 0
    path: str = ""
    side: int = 0
    top_left: tuple[float, float] = (0.0, 0.0)
    bottom_right: tuple[float, float] = (1.0, 1.0)
    lod_range: range = dataclasses.field(default_factory=lambda: range(0, 1))

    def overlapping_tiles(self, lod: int):
        """Tiles of a lod intersecting the dataset region
        (reference preprocessor.rs:58-67)."""
        count = TileCoordinate.count(lod)
        lx = int(self.top_left[0] * count)
        ly = int(self.top_left[1] * count)
        ux = int(np.ceil(self.bottom_right[0] * count))
        uy = int(np.ceil(self.bottom_right[1] * count))
        for x in range(lx, ux):
            for y in range(ly, uy):
                yield TileCoordinate(self.side, lod, x, y)


@dataclasses.dataclass
class SphericalDataset:
    """Six per-face source images (reference preprocessor.rs:29-33)."""

    attachment_index: int
    paths: list[str]
    lod_range: range


class Preprocessor:
    """Builds and runs the preprocess task graph for one terrain
    (reference preprocessor.rs:213-343 + select_ready_tasks :346-399).

    Usage mirrors the reference examples (examples/preprocess_planar.rs)::

        Preprocessor(atlas).clear_attachment(0).preprocess_tile(dataset).run()
    """

    def __init__(self, tile_atlas: TileAtlas, loader=None,
                 device: Optional[bool] = None, naive: bool = False):
        """Split and downsample always run on the host (the C++ path).
        ``device=True`` stitches each lod stack as one jitted device op
        (ops/preprocess_device.stitch_stack — SURVEY section 2.3's
        device-code commitment) and pulls ONLY the stitched border strips
        back (~1.5% of the bytes: stitch never writes interiors,
        stitch.wgsl:58-67); ``device=False`` keeps the per-tile host
        stitch. Both write byte-identical .bin artifacts (stitch is a
        texel permutation; tests/test_preprocess_device.py). Default
        (None): the device path on an accelerator backend, the host path
        on the CPU backend, where the jitted stack op is host compute.

        ``naive=True`` pins the single-thread numpy CPU-reference oracle
        (dense tent-matmul split, numpy downsample, no native helpers) —
        the baseline the BASELINE.md >10x preprocess target is measured
        against. Output stays byte-identical to every other path."""
        if naive:
            device = False
        if device is None:
            import jax

            device = jax.default_backend() != "cpu"
        self.atlas = tile_atlas
        self.loader = loader or _default_loader
        self.device = device
        self.naive = naive
        self._jobs: list = []
        self.start_time: Optional[float] = None

    # -- graph construction --

    def clear_attachment(self, attachment_index: int) -> "Preprocessor":
        """Reference preprocessor.rs:290-296."""
        attachment = self.atlas.attachments[attachment_index]
        self.atlas.state.existing_tiles.clear()
        reset_directory(attachment.path)
        return self

    def preprocess_tile(self, dataset: PreprocessDataset) -> "Preprocessor":
        """Queue split+downsample then per-lod stitch+save
        (reference preprocessor.rs:298-312)."""
        self._jobs.append(("planar", dataset))
        return self

    def preprocess_spherical(self, dataset: SphericalDataset) -> "Preprocessor":
        """Reference preprocessor.rs:314-343: six per-side datasets, split+
        downsample all sides first, then stitch+save lod by lod (cross-face
        borders need all sides split)."""
        self._jobs.append(("spherical", dataset))
        return self

    # -- execution --

    def run(self, verbose: bool = True) -> None:
        self.start_time = time.time()
        for kind, dataset in self._jobs:
            if kind == "planar":
                self._split_and_downsample(dataset)
                for lod in dataset.lod_range:
                    self._stitch_and_save_layer(dataset, lod)
            else:
                sides = [
                    PreprocessDataset(
                        attachment_index=dataset.attachment_index,
                        path=dataset.paths[side],
                        side=side,
                        lod_range=dataset.lod_range,
                    )
                    for side in range(6)
                ]
                for side_dataset in sides:
                    self._split_and_downsample(side_dataset)
                for lod in dataset.lod_range:
                    for side_dataset in sides:
                        self._stitch_and_save_layer(side_dataset, lod)
        self._drain_saves()
        self.atlas.save_tile_config()
        if verbose:
            import sys

            print(
                f"Preprocessing took {time.time() - self.start_time:.2f}s",
                file=sys.stderr,
            )
        self._jobs.clear()

    # -- phases (reference preprocessor.rs:234-288) --

    def _attachment(self, dataset):
        return self.atlas.attachments[dataset.attachment_index]

    def _data(self, attachment, coordinate) -> Optional[np.ndarray]:
        index = self.atlas.state.tile_states.get(coordinate)
        return attachment.data[index.atlas_index] if index is not None else None

    def _split_and_downsample(self, dataset: PreprocessDataset) -> None:
        attachment = self._attachment(dataset)
        cfg = attachment.config
        source = self.loader(dataset.path, cfg)

        lods = list(dataset.lod_range)[::-1]
        finest = lods[0]
        mosaic, valid = split_mosaic(
            source, finest, cfg.center_size, dataset.top_left,
            dataset.bottom_right, naive=self.naive,
        )
        # quantize the whole mosaic once (bit-identical to the per-tile
        # formula; C++ single pass) so extraction is a plain slice copy
        quantized = None
        dtype = np.dtype(cfg.format.dtype)
        if not self.naive and dtype in (np.uint8, np.uint16):
            from bevy_terrain_tpu import native as _native

            if _native.available():
                quantized = _native.quantize(mosaic, cfg.format.max_value, dtype)
        for c in dataset.overlapping_tiles(finest):
            atlas_index = self.atlas.state.get_or_allocate_tile(c)
            existing = attachment.data[atlas_index]
            tile = extract_tile_from_mosaic(
                mosaic, valid, c.x, c.y, cfg.texture_size, cfg.border_size,
                cfg.format.dtype, cfg.format.max_value, existing,
                quantized=quantized,
            )
            attachment.data[atlas_index] = tile

        from bevy_terrain_tpu.ops.preprocess import downsample_tile_numpy

        downsample = downsample_tile_numpy if self.naive else downsample_tile
        for lod in lods[1:]:
            for c in dataset.overlapping_tiles(lod):
                children = [
                    self._data(attachment, child) for child in c.children()
                ]
                atlas_index = self.atlas.state.get_or_allocate_tile(c)
                attachment.data[atlas_index] = downsample(
                    children, cfg.texture_size, cfg.border_size
                )

    # -- device stitch (jitted lod-stack op, ops/preprocess_device.py) --

    def _stitch_and_save_layer_device(self, dataset: PreprocessDataset,
                                      lod: int) -> None:
        """Device stitch with border-strip readback: upload the lod's
        pre-stitch tiles, stitch on device, pull ONLY the border strips
        and splice them into the host-known interiors. Byte-identical to
        the host stitch (parity-tested)."""
        import jax
        import jax.numpy as jnp

        from bevy_terrain_tpu.ops import preprocess_device as ppd

        attachment = self._attachment(dataset)
        cfg = attachment.config
        spherical = self.atlas.model.is_spherical
        ai = dataset.attachment_index
        coords = [
            c for c in dataset.overlapping_tiles(lod)
            if self._data(attachment, c) is not None
        ]
        if not coords:
            return
        index_of = {c: i for i, c in enumerate(coords)}
        rows = [self._data(attachment, c) for c in coords]
        extra = []
        for c in coords:
            for n in c.neighbours(spherical):
                if (not n.is_valid or n in index_of
                        or n not in self.atlas.state.existing_tiles):
                    continue
                d = self._data(attachment, n)
                if d is None:
                    continue
                index_of[n] = len(coords) + len(extra)
                extra.append(d)
        full = jnp.asarray(np.stack(rows + extra).astype(np.float32))
        nbr_idx, nbr_side = ppd.stitch_plan(coords, index_of, spherical)
        stitched = ppd.stitch_stack(
            full, np.array([c.side for c in coords]),
            jnp.asarray(nbr_idx), nbr_side, cfg.border_size, spherical,
        )
        strips = ppd.extract_borders(
            stitched.astype(cfg.format.dtype), cfg.border_size
        )
        host_strips = np.asarray(jax.device_get(strips))  # ~1.5% of bytes
        for i, c in enumerate(coords):
            state = self.atlas.state.tile_states[c]
            tile = attachment.data[state.atlas_index].copy()
            ppd.composite_borders(tile, host_strips[i], cfg.border_size)
            attachment.data[state.atlas_index] = tile
            self.atlas.state.to_save.append(
                AtlasTileAttachment(c, state.atlas_index, ai)
            )
        self._pump_saves()

    def _stitch_and_save_layer(self, dataset: PreprocessDataset, lod: int) -> None:
        if self.device:
            return self._stitch_and_save_layer_device(dataset, lod)
        attachment = self._attachment(dataset)
        spherical = self.atlas.model.is_spherical
        stitched = {}
        for c in dataset.overlapping_tiles(lod):
            tile = self._data(attachment, c)
            if tile is None:
                continue
            neighbours = []
            for n in c.neighbours(spherical):
                if not n.is_valid or n not in self.atlas.state.existing_tiles:
                    neighbours.append((0, None))
                else:
                    neighbours.append((n.side, self._data(attachment, n)))
            stitched[c] = stitch_tile(tile, c.side, neighbours, attachment.config.border_size)
        # write back after the whole layer is stitched (the reference's
        # barrier between stitch and save, preprocessor.rs:282) then save
        for c, tile in stitched.items():
            state = self.atlas.state.tile_states[c]
            attachment.data[state.atlas_index] = tile
            self.atlas.state.to_save.append(
                AtlasTileAttachment(c, state.atlas_index, dataset.attachment_index)
            )
        self._pump_saves()

    def _pump_saves(self) -> None:
        state = self.atlas.state
        while state.save_slots > 0 and state.to_save:
            tile = state.to_save.popleft()
            self.atlas.attachments[tile.attachment_index].start_saving(
                self.atlas.io_pool, tile
            )
            state.save_slots -= 1

    def _drain_saves(self) -> None:
        while True:
            self._pump_saves()
            pending = any(a.saving for a in self.atlas.attachments)
            for a in self.atlas.attachments:
                a.update(self.atlas.state)
            if not pending and not self.atlas.state.to_save:
                break
            time.sleep(0.005)


def _default_loader(path: str, attachment_config) -> np.ndarray:
    """Load a source image as (H, W, C) float32 in [0, 1] (0 == nodata)."""
    from bevy_terrain_tpu.formats.tiff import load_source_image

    return load_source_image(path, attachment_config)
