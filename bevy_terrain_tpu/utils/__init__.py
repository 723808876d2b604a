"""Utilities: synthetic dataset generation, timing harness, compile cache."""

from bevy_terrain_tpu.utils.compile_cache import enable_compile_cache
from bevy_terrain_tpu.utils.synthetic import generate_planar_dataset
from bevy_terrain_tpu.utils.timing import Timer

__all__ = ["Timer", "enable_compile_cache", "generate_planar_dataset"]
