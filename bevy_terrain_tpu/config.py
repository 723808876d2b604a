"""Terrain / view / attachment configuration.

Mirrors the reference's three config structs:
* ``TerrainConfig``     — reference src/terrain.rs:27-49
* ``TerrainViewConfig`` — reference src/terrain_view.rs:19-64
* ``AttachmentConfig``  — reference src/terrain_data/mod.rs:88-109
* ``AttachmentFormat``  — reference src/terrain_data/mod.rs:38-84

These are plain dataclasses; every field that reaches a device kernel is
staged into jit as a static argument (the flag-combination == recompile model
mirrors the reference's pipeline specialization, src/render/terrain_material.rs:174-227).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from bevy_terrain_tpu.math.terrain_model import TerrainModel


class AttachmentFormat(enum.Enum):
    """Data format of an attachment (reference src/terrain_data/mod.rs:38-84)."""

    RGB8 = "Rgb8"
    RGBA8 = "Rgba8"
    R16 = "R16"
    RG16 = "Rg16"

    @property
    def id(self) -> int:
        # shader format ids, reference src/terrain_data/mod.rs:50-57
        return {"Rgb8": 5, "Rgba8": 0, "R16": 1, "Rg16": 3}[self.value]

    @property
    def channels(self) -> int:
        return {"Rgb8": 3, "Rgba8": 4, "R16": 1, "Rg16": 2}[self.value]

    @property
    def dtype(self) -> np.dtype:
        """Storage dtype of one channel."""
        return np.dtype(
            {"Rgb8": np.uint8, "Rgba8": np.uint8, "R16": np.uint16, "Rg16": np.uint16}[
                self.value
            ]
        )

    @property
    def pixel_size(self) -> int:
        """Bytes per pixel on disk (reference src/terrain_data/mod.rs:76-83)."""
        return {"Rgb8": 3, "Rgba8": 4, "R16": 2, "Rg16": 4}[self.value]

    @property
    def max_value(self) -> float:
        """Normalization divisor (unorm semantics of the reference's texture formats)."""
        return float(np.iinfo(self.dtype).max)


@dataclasses.dataclass(frozen=True)
class AttachmentConfig:
    """Configures one attachment of a terrain (reference src/terrain_data/mod.rs:88-109).

    ``center_size = texture_size - 2 * border_size`` (reference src/terrain_data/tile_atlas.rs:174).
    """

    name: str = ""
    texture_size: int = 512
    border_size: int = 1
    mip_level_count: int = 1
    format: AttachmentFormat = AttachmentFormat.R16

    @property
    def center_size(self) -> int:
        return self.texture_size - 2 * self.border_size

    @property
    def scale(self) -> float:
        # border-inset uv scale (reference src/terrain_data/tile_atlas.rs:183)
        return self.center_size / self.texture_size

    @property
    def offset(self) -> float:
        # border-inset uv offset (reference src/terrain_data/tile_atlas.rs:184)
        return self.border_size / self.texture_size

    def mip_size(self, mip: int) -> int:
        return self.texture_size >> mip


@dataclasses.dataclass(frozen=True)
class TerrainConfig:
    """Fundamental parameters of a terrain (reference src/terrain.rs:27-49)."""

    lod_count: int = 1
    model: "TerrainModel | None" = None
    atlas_size: int = 1024
    path: str = ""
    attachments: tuple[AttachmentConfig, ...] = ()
    # Root directory for terrain data; the reference hardcodes bevy's
    # "assets/" convention (tile_atlas.rs:174, :610).
    assets_root: str = "assets"

    def add_attachment(self, attachment: AttachmentConfig) -> "TerrainConfig":
        return dataclasses.replace(self, attachments=self.attachments + (attachment,))


@dataclasses.dataclass(frozen=True)
class TerrainViewConfig:
    """Quality settings of a terrain view (reference src/terrain_view.rs:19-64).

    Distances are measured in multiples of the terrain scale and converted to
    world units at ``TileTree`` creation (reference src/terrain_data/tile_tree.rs:139-153).

    Additions of this design:
    * ``tile_capacity``: static bound for the refinement work queue / final
      tile list. The reference uses ``geometry_tile_count`` (default 1e6) as a
      hard buffer cap (src/terrain_view.rs:23-25); jitted shapes are static
      so this directly sizes the compacted tile tensors. Overflow is masked,
      never reallocated.
    """

    tree_size: int = 8
    geometry_tile_count: int = 1_000_000
    refinement_count: int = 30
    grid_size: int = 16
    subdivision_tolerance: float = 0.1
    load_distance: float = 2.5
    morph_distance: float = 16.0
    blend_distance: float = 2.0
    morph_range: float = 0.2
    blend_range: float = 0.2
    precision_threshold_distance: float = 0.001
    origin_lod: int = 10
    # static-shape bound for the refinement queue / final tile list.
    tile_capacity: int = 8192

    @property
    def vertices_per_row(self) -> int:
        # degenerate-strip row layout, reference src/render/terrain_view_bind_group.rs:84
        return 2 * (self.grid_size + 2)

    @property
    def vertices_per_tile(self) -> int:
        # reference src/render/terrain_view_bind_group.rs:85
        return self.grid_size * self.vertices_per_row
