"""bevy_terrain_tpu — a terrain engine in JAX / XLA.

A from-scratch re-design of the capabilities of ``kurtkuehnert/bevy_terrain``
(the reference; SURVEY.md maps it) as array programs for an accelerator
(today an NVIDIA GPU):

* the UDLOD geometry pipeline (GPU quadtree refinement -> compacted tile list
  -> CDLOD-morphed mesh generation, reference src/render/ + src/shaders/) runs
  as vectorized XLA programs inside one jitted per-frame step,
* the chunked-clipmap data layer (per-view wrapping TileTree + shared
  streaming TileAtlas, reference src/terrain_data/) becomes persistent device
  tensor slabs with host-side residency bookkeeping and async tile IO,
* planetary-scale precision comes from host f64 math plus a per-view
  second-order Taylor approximation evaluated in f32 on device
  (reference src/math/terrain_model.rs:222-360, src/shaders/functions.wgsl:98-115).

Public API mirrors the reference's prelude (reference src/lib.rs:61-90).
"""

from bevy_terrain_tpu.config import (
    AttachmentConfig,
    AttachmentFormat,
    TerrainConfig,
    TerrainViewConfig,
)
from bevy_terrain_tpu.math import (
    Coordinate,
    TerrainModel,
    TerrainModelApproximation,
    TileCoordinate,
)
# Filled in as layers land (see SURVEY.md section 7 build plan):
from bevy_terrain_tpu.terrain_data import TileAtlas, TileTree  # noqa: E402
from bevy_terrain_tpu.terrain_data.sampling_api import sample_attachment, sample_height  # noqa: E402
from bevy_terrain_tpu.render.pipeline import Terrain, TerrainFrameOutput  # noqa: E402
from bevy_terrain_tpu.render.material import (  # noqa: E402
    DirectionalLight,
    PointLight,
    SpotLight,
    StandardMaterial,
    albedo_material,
    gradient_material,
)
from bevy_terrain_tpu.render.raster import (  # noqa: E402
    RasterOutput,
    rasterize_grid,
    render_view,
)
from bevy_terrain_tpu.preprocess import PreprocessDataset, Preprocessor, SphericalDataset  # noqa: E402
from bevy_terrain_tpu.debug import DebugTerrain  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "AttachmentConfig",
    "AttachmentFormat",
    "Coordinate",
    "DebugTerrain",
    "DirectionalLight",
    "PointLight",
    "SpotLight",
    "StandardMaterial",
    "albedo_material",
    "gradient_material",
    "PreprocessDataset",
    "Preprocessor",
    "RasterOutput",
    "SphericalDataset",
    "Terrain",
    "rasterize_grid",
    "render_view",
    "TerrainConfig",
    "TerrainFrameOutput",
    "TerrainModel",
    "TerrainModelApproximation",
    "TerrainViewConfig",
    "TileAtlas",
    "TileCoordinate",
    "TileTree",
    "sample_attachment",
    "sample_height",
]
