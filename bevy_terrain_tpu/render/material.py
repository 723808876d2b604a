"""Materials and shading: the fragment-stage equivalent as tensor ops.

The reference rasterizes and shades per pixel (fragment.wgsl:95-113 with a
user material composed via TerrainMaterialPlugin, terrain_material.rs:437-471).
We don't rasterize — the frame's products are vertex/attribute tensors —
so "shading" is a jittable function over the grid mesh producing per-vertex
colors, which a rasterizer (or a screen-space resampler) consumes
downstream. The pieces mirror the reference:

* :func:`surface_normals_from_heights` — central-difference normals with
  the per-face TBN (attachments.wgsl:51-107), computed gather-free from the
  tile height grids.
* :func:`default_color` — the reference's default material
  (attachments.wgsl:109-113: grey = height * 0.5).
* :func:`lambert_lighting` — a minimal directional-light stand-in for the
  bevy_pbr lighting stage (LIGHTING flag, fragment.wgsl:52-63).
* :func:`shade` — composes material + optional lighting + debug overlays
  (the pipeline-flag specialization of terrain_material.rs:174-227).

Custom materials are plain callables ``fn(ctx: ShadeContext) -> colors``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from bevy_terrain_tpu.ops.meshgen import GridMeshOutput
from bevy_terrain_tpu.ops.params import FrameUniforms, StaticTerrainConfig
from bevy_terrain_tpu.ops.refinement import RefinementOutput

# reference debug.wgsl:8-19
_INDEX_COLORS = np.array(
    [
        [1.0, 0.0, 0.0, 1.0],
        [0.0, 1.0, 0.0, 1.0],
        [0.0, 0.0, 1.0, 1.0],
        [1.0, 1.0, 0.0, 1.0],
        [1.0, 0.0, 1.0, 1.0],
        [0.0, 1.0, 1.0, 1.0],
    ],
    np.float32,
)

_FACE_UP = np.array(
    [
        [0.0, 1.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, 0.0, -1.0],
        [0.0, 0.0, -1.0],
        [-1.0, 0.0, 0.0],
        [-1.0, 0.0, 0.0],
    ],
    np.float32,
)


@dataclasses.dataclass
class ShadeContext:
    """Everything a material sees (the fragment stage's inputs)."""

    mesh: GridMeshOutput
    tiles: RefinementOutput
    normals: jax.Array  # (F, G+1, G+1, 3) shading normals
    uniforms: FrameUniforms
    cfg: StaticTerrainConfig
    # attachment 0's texture size (attachments[0].size in the reference's
    # show_pixels, debug.wgsl:111-119)
    texture_size: int = 512
    # extra attachments pre-sampled at the frame's morphed vertex uvs
    # (fragment.wgsl's sample_attachmentN / planar.wgsl sample_albedo):
    # {attachment_index: (F, G+1, G+1, C) f32 in [0, 1]}. Populated by the
    # frame step when set_shading(..., sample_attachments=(i, ...)) names
    # them.
    attachment_samples: Optional[dict] = None


def _vertex_lookup(ctx: ShadeContext):
    """Per-vertex blend + atlas-tile lookup (fragment_info, fragment.wgsl:
    35-49) — shared by the data-lod and pixel debug views. Returns
    (blend_lod, blend_ratio, a_lod, a_xy, a_uv)."""
    from bevy_terrain_tpu.ops import coords

    cfg = ctx.cfg
    F, G = cfg.tile_capacity, cfg.grid_size
    side = jnp.broadcast_to(ctx.tiles.tile_side[:F, None, None], (F, G + 1, G + 1))
    lod = jnp.broadcast_to(
        jnp.maximum(ctx.tiles.tile_lod[:F, None, None], 0), (F, G + 1, G + 1)
    )
    xy = jnp.broadcast_to(ctx.tiles.tile_xy[:F, None, None, :], (F, G + 1, G + 1, 2))
    view_distance = jnp.linalg.norm(
        ctx.mesh.positions - ctx.uniforms.view_world_position, axis=-1
    )
    blend_lod, blend_ratio = coords.compute_blend(view_distance, ctx.uniforms, cfg)
    if cfg.tile_tree_lod:
        _, a_lod, a_xy, a_uv = coords.lookup_best(
            ctx.uniforms.entries, ctx.uniforms.origins, side, lod, xy,
            ctx.mesh.uvs, cfg,
        )
    else:
        _, a_lod, a_xy, a_uv = coords.lookup_tile(
            ctx.uniforms.entries, side, lod, xy, ctx.mesh.uvs, blend_lod, cfg
        )
    return blend_lod, blend_ratio, a_lod, a_xy, a_uv


def index_color(index):
    """debug.wgsl:8-19: palette color mixed 20% toward grey."""
    c = jnp.asarray(_INDEX_COLORS)[index % 6]
    return c + (jnp.full_like(c, 0.6) - c) * 0.2


def surface_normals_from_heights(
    mesh: GridMeshOutput,
    tiles: RefinementOutput,
    uniforms: FrameUniforms,
    cfg: StaticTerrainConfig,
):
    """Central-difference surface normals on the vertex grid with the
    per-face TBN (attachments.wgsl:51-107), gather-free.

    The reference taps 4 extra texels per fragment; on the grid layout the
    height differences come from the neighbouring vertices (spacing =
    tile_size / grid_size), clamped at tile edges.
    """
    F = cfg.tile_capacity
    G = cfg.grid_size
    h = mesh.heights  # (F, G+1, G+1)

    def diff(axis):
        lo = jnp.concatenate(
            [
                jax.lax.slice_in_dim(h, 0, 1, axis=axis),
                jax.lax.slice_in_dim(h, 0, -1, axis=axis),
            ],
            axis=axis,
        )
        hi = jnp.concatenate(
            [
                jax.lax.slice_in_dim(h, 1, None, axis=axis),
                jax.lax.slice_in_dim(h, -1, None, axis=axis),
            ],
            axis=axis,
        )
        return hi - lo

    # world-space spacing between adjacent grid vertices
    lod = jnp.maximum(tiles.tile_lod[:F], 0).astype(jnp.float32)
    if cfg.spherical:
        side_length = jnp.float32(np.pi / 4.0) * uniforms.terrain_scale
    else:
        side_length = 2.0 * uniforms.terrain_scale
    spacing = (side_length / jnp.exp2(lod) / G)[:, None, None]

    dh_du = diff(2) / (2.0 * spacing)
    dh_dv = diff(1) / (2.0 * spacing)

    if cfg.spherical:
        normal = mesh.normals
        face_up = jnp.asarray(_FACE_UP)[tiles.tile_side[:F]][:, None, None, :]
        tangent = jnp.cross(jnp.broadcast_to(face_up, normal.shape), normal)
        tangent = tangent / jnp.maximum(
            jnp.linalg.norm(tangent, axis=-1, keepdims=True), 1e-8
        )
        bitangent = jnp.cross(normal, tangent)
    else:
        shape = mesh.normals.shape
        tangent = jnp.broadcast_to(jnp.asarray(np.array([1, 0, 0], np.float32)), shape)
        bitangent = jnp.broadcast_to(jnp.asarray(np.array([0, 0, 1], np.float32)), shape)
        normal = jnp.broadcast_to(jnp.asarray(np.array([0, 1, 0], np.float32)), shape)

    n = (
        -dh_du[..., None] * tangent
        - dh_dv[..., None] * bitangent
        + normal
    )
    return n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-8)


def default_color(ctx: ShadeContext):
    """Reference default material: grey from height (attachments.wgsl:109-113)."""
    hn = (ctx.mesh.heights - ctx.uniforms.min_height) / jnp.maximum(
        ctx.uniforms.max_height - ctx.uniforms.min_height, 1e-8
    )
    g = hn * 0.5
    return jnp.stack([g, g, g, jnp.ones_like(g)], axis=-1)


def lambert_lighting(colors, normals, light_direction=(0.4, 0.8, 0.45)):
    """Directional diffuse (kept for API compatibility; the default
    lighting stage is :func:`pbr_lighting` since round 3)."""
    light = np.asarray(light_direction, np.float32)
    light = light / np.linalg.norm(light)
    ndotl = jnp.clip(jnp.sum(normals * jnp.asarray(light), axis=-1), 0.0, 1.0)
    lit = colors[..., :3] * (0.15 + 0.85 * ndotl[..., None])
    return jnp.concatenate([lit, colors[..., 3:]], axis=-1)


# -- PBR lighting stage ------------------------------------------------------
#
# The reference composes bevy_pbr per pixel: fragment.wgsl:52-63 fills a
# PbrInput (base_color, perceptual_roughness = 1.0, reflectance = 0.0, N,
# V) and calls apply_pbr_lighting. bevy_pbr's direct-light model is the
# Filament metallic/roughness BRDF (bevy_pbr/src/render/pbr_lighting.wgsl:
# D_GGX, V_SmithGGXCorrelated, F_Schlick, Fd_Burley); the functions below
# are that model as batched tensor ops over the vertex grid. Tone mapping /
# camera exposure stay with the consuming rasterizer.


@dataclasses.dataclass(frozen=True)
class DirectionalLight:
    """A bevy DirectionalLight equivalent (direction TOWARD the scene;
    ``illuminance`` folds the light color to linear [0, 1] scale).

    ``shadow`` is the slot where bevy_pbr multiplies in its shadow-map
    term (pbr_functions.wgsl: ``shadow = fetch_directional_shadow(...)``
    before the light contribution is accumulated): a callable
    ``fn(positions) -> (..., 1)`` factor in [0, 1] over world positions.
    A buffer-producing engine has no shadow atlas; the consuming
    rasterizer (or a height-field ray-march) supplies the factor here.
    """

    direction: tuple = (-0.4, -0.8, -0.45)
    color: tuple = (1.0, 1.0, 1.0)
    illuminance: float = 1.0
    shadow: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class PointLight:
    """bevy PointLight equivalent: omni light at ``position`` with
    Filament inverse-square distance attenuation windowed by ``range``
    (bevy_pbr pbr_lighting.wgsl ``getDistanceAttenuation``:
    ``saturate(1 - (d^2/range^2)^2)^2 / max(d^2, 1e-4)``).
    ``intensity`` is pre-folded to linear [0, 1] scale like
    DirectionalLight.illuminance."""

    position: tuple = (0.0, 0.0, 0.0)
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    range: float = 20.0
    shadow: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class SpotLight:
    """bevy SpotLight equivalent: a PointLight restricted to a cone.
    The cone window follows bevy_pbr's ``spot_light``: the cosine of the
    angle to ``direction`` remapped by ``1/(cos_inner - cos_outer)``,
    saturated, then squared (smooth falloff between the inner and outer
    angles, radians)."""

    position: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (0.0, -1.0, 0.0)
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    range: float = 20.0
    inner_angle: float = 0.4
    outer_angle: float = 0.6
    shadow: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class StandardMaterial:
    """bevy_pbr StandardMaterial equivalent: a metallic/roughness surface
    over any base-color source (terrain_material.rs:437-471 is generic
    over Material; here the material is this hashable config + an optional
    ``base_color`` callable ``fn(ctx) -> (F, G+1, G+1, 4)``).

    Defaults match the reference terrain fragment's PbrInput
    (fragment.wgsl:54-56: perceptual_roughness 1.0, reflectance 0.0).
    Pass as ``Terrain.set_shading(material=StandardMaterial(...))`` — the
    frame step applies :func:`pbr_lighting` with these parameters.
    """

    base_color: Optional[Callable] = None  # default: reference grey-height
    perceptual_roughness: float = 1.0
    metallic: float = 0.0
    reflectance: float = 0.0
    emissive: tuple = (0.0, 0.0, 0.0)
    lights: tuple = (DirectionalLight(),)
    ambient: tuple = (0.05, 0.05, 0.05)

    def __call__(self, ctx: ShadeContext):
        return (self.base_color or default_color)(ctx)


def _f_schlick(f0, f90, voh):
    return f0 + (f90 - f0) * jnp.power(1.0 - voh, 5.0)


def pbr_lighting(
    colors,
    normals,
    positions,
    view_world_position,
    perceptual_roughness: float = 1.0,
    metallic: float = 0.0,
    reflectance: float = 0.0,
    emissive=(0.0, 0.0, 0.0),
    lights=(DirectionalLight(),),
    ambient=(0.05, 0.05, 0.05),
):
    """Filament/bevy_pbr direct lighting for N lights (directional,
    point, spot — any mix; ``lights`` is a tuple of DirectionalLight /
    PointLight / SpotLight).

    Mirrors bevy_pbr's apply_pbr_lighting structure for the light loops
    (pbr_lighting.wgsl): GGX specular (D_GGX * V_SmithGGXCorrelated *
    F_Schlick) + Burley diffuse per light, Filament inverse-square
    windowed attenuation for point/spot, each light's optional ``shadow``
    hook multiplying its contribution (the shadow-map term's slot in
    pbr_functions.wgsl), plus a flat ambient term on the diffuse color
    (bevy's environment/irradiance stage is the consuming renderer's
    concern). All colors linear [0, 1].
    """
    base = colors[..., :3]
    alpha = colors[..., 3:]
    # pbr_functions.wgsl: calculate_diffuse_color / calculate_F0
    diffuse_color = base * (1.0 - metallic)
    f0 = 0.16 * reflectance * reflectance * (1.0 - metallic) + base * metallic
    # roughness.wgsl: clamp + perceptual -> alpha
    pr = float(np.clip(perceptual_roughness, 0.089, 1.0))
    roughness = pr * pr

    n = normals
    v = view_world_position - positions
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-8)
    nov = jnp.maximum(jnp.sum(n * v, axis=-1, keepdims=True), 1e-4)

    out = jnp.asarray(np.asarray(emissive, np.float32)) * jnp.ones_like(base)
    for light in lights:
        # per-light direction-to-light l and radiance scale (bevy_pbr
        # pbr_lighting.wgsl: directional_light / point_light / spot_light)
        if isinstance(light, (PointLight, SpotLight)):
            light_pos = jnp.asarray(np.asarray(light.position, np.float32))
            to_light = light_pos - positions
            dist_sq = jnp.maximum(
                jnp.sum(to_light * to_light, axis=-1, keepdims=True), 1e-4
            )
            l = to_light / jnp.sqrt(dist_sq)
            inv_range_sq = np.float32(1.0 / (light.range * light.range))
            window = jnp.clip(1.0 - jnp.square(dist_sq * inv_range_sq), 0.0, 1.0)
            atten = jnp.square(window) / dist_sq
            if isinstance(light, SpotLight):
                sd = np.asarray(light.direction, np.float32)
                sd = sd / np.linalg.norm(sd)
                cos_outer = np.float32(np.cos(light.outer_angle))
                spot_scale = np.float32(
                    1.0
                    / max(np.cos(light.inner_angle) - np.cos(light.outer_angle),
                          1e-4)
                )
                cos_angle = jnp.sum(-l * jnp.asarray(sd), axis=-1, keepdims=True)
                spot = jnp.clip((cos_angle - cos_outer) * spot_scale, 0.0, 1.0)
                atten = atten * jnp.square(spot)
            lc = (
                np.asarray(light.color, np.float32)
                * np.float32(light.intensity)
            )
            radiance = jnp.asarray(lc) * atten
        else:
            d = np.asarray(light.direction, np.float32)
            l = jnp.asarray(-d / np.linalg.norm(d))  # direction_to_light
            lc = (
                np.asarray(light.color, np.float32)
                * np.float32(light.illuminance)
            )
            radiance = jnp.asarray(lc)
        h = l + v
        h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-8)
        nol = jnp.clip(jnp.sum(n * l, axis=-1, keepdims=True), 0.0, 1.0)
        noh = jnp.clip(jnp.sum(n * h, axis=-1, keepdims=True), 0.0, 1.0)
        loh = jnp.clip(jnp.sum(h * l, axis=-1, keepdims=True), 0.0, 1.0)

        # D_GGX (pbr_lighting.wgsl)
        a2 = roughness * roughness
        f = noh * noh * (a2 - 1.0) + 1.0
        d_ggx = a2 / jnp.maximum(np.float32(np.pi) * f * f, 1e-8)
        # V_SmithGGXCorrelated
        lambda_v = nol * jnp.sqrt((nov - a2 * nov) * nov + a2)
        lambda_l = nov * jnp.sqrt((nol - a2 * nol) * nol + a2)
        v_smith = 0.5 / jnp.maximum(lambda_v + lambda_l, 1e-8)
        # F_Schlick with bevy's f90 = saturate(50 * f0.g-ish dot)
        f90 = jnp.clip(
            jnp.sum(f0 * np.float32(50.0 * 0.33), axis=-1, keepdims=True),
            0.0, 1.0,
        )
        fresnel = _f_schlick(f0, f90, loh)
        specular = d_ggx * v_smith * fresnel
        # Fd_Burley
        fd90 = 0.5 + 2.0 * roughness * loh * loh
        light_scatter = _f_schlick(1.0, fd90, nol)
        view_scatter = _f_schlick(1.0, fd90, nov)
        fd = light_scatter * view_scatter * np.float32(1.0 / np.pi)
        diffuse = diffuse_color * fd

        contrib = (diffuse + specular) * radiance * nol
        if getattr(light, "shadow", None) is not None:
            # bevy_pbr pbr_functions.wgsl: the fetched shadow factor
            # multiplies the whole light contribution
            contrib = contrib * jnp.clip(light.shadow(positions), 0.0, 1.0)
        out = out + contrib
    out = out + diffuse_color * jnp.asarray(np.asarray(ambient, np.float32))
    return jnp.concatenate([out, alpha], axis=-1)


# the planar example's gradient2.png equivalent: a deep-water ->
# shallows -> grass -> rock -> snow ramp (an original colormap; the
# reference ships a PNG asset we don't copy)
DEFAULT_GRADIENT = np.array(
    [
        [0.02, 0.09, 0.28, 1.0],
        [0.05, 0.24, 0.45, 1.0],
        [0.22, 0.48, 0.35, 1.0],
        [0.38, 0.52, 0.26, 1.0],
        [0.52, 0.47, 0.30, 1.0],
        [0.55, 0.42, 0.32, 1.0],
        [0.58, 0.55, 0.52, 1.0],
        [0.78, 0.78, 0.80, 1.0],
        [0.95, 0.95, 0.97, 1.0],
    ],
    np.float32,
)


def gradient_material(gradient=None, exponent: float = 0.9):
    """The planar example's default material: a 1-D gradient texture
    sampled at ``pow(height, 0.9)`` (reference assets/shaders/planar.wgsl
    sample_color, non-ALBEDO branch; examples/planar.rs loads
    textures/gradient2.png as a D1 texture).

    ``gradient``: (N, 4) float32 LUT in [0, 1]; linear-filtered,
    clamp-to-edge — textureSampleLevel's semantics for a D1 texture.
    """
    lut = np.asarray(
        DEFAULT_GRADIENT if gradient is None else gradient, np.float32
    )

    def material(ctx: ShadeContext):
        hn = jnp.clip(
            (ctx.mesh.heights - ctx.uniforms.min_height)
            / jnp.maximum(ctx.uniforms.max_height - ctx.uniforms.min_height, 1e-8),
            0.0, 1.0,
        )
        x = jnp.power(hn, exponent) * (lut.shape[0] - 1)
        i0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, lut.shape[0] - 2)
        t = (x - i0.astype(jnp.float32))[..., None]
        table = jnp.asarray(lut)
        return table[i0] * (1.0 - t) + table[i0 + 1] * t

    return material


class _AlbedoMaterial:
    """Callable base-color source reading a sampled attachment (see
    :func:`albedo_material`). Carries ``attachment_index`` so the
    rasterizer can texture the same attachment per pixel."""

    def __init__(self, attachment_index: int):
        self.attachment_index = attachment_index

    def __call__(self, ctx: ShadeContext):
        idx = self.attachment_index
        if not ctx.attachment_samples or idx not in ctx.attachment_samples:
            raise ValueError(
                f"albedo_material needs set_shading(sample_attachments="
                f"({idx},)) so the frame step samples it"
            )
        c = ctx.attachment_samples[idx]
        if c.shape[-1] >= 4:
            return c[..., :4]
        pad = jnp.ones(c.shape[:-1] + (4 - c.shape[-1],), c.dtype)
        return jnp.concatenate([c, pad], axis=-1)

    def __hash__(self):  # jit-static argument
        return hash(("_AlbedoMaterial", self.attachment_index))

    def __eq__(self, other):
        return (isinstance(other, _AlbedoMaterial)
                and other.attachment_index == self.attachment_index)


def albedo_material(attachment_index: int = 1):
    """The planar example's ALBEDO branch: color straight from the albedo
    attachment sampled at the morphed vertex uvs (planar.wgsl
    sample_albedo = sample_attachment1; attachments.wgsl:26-43).

    Requires ``Terrain.set_shading(material=albedo_material(),
    sample_attachments=(attachment_index,))`` so the frame step samples
    the attachment in-jit.
    """
    return _AlbedoMaterial(attachment_index)


def show_geometry_lod(ctx: ShadeContext):
    """LOD checkerboard debug view with the reference's two red/green
    invariant checks (debug.wgsl:27-34, 56-94)."""
    cfg = ctx.cfg
    F, G = cfg.tile_capacity, cfg.grid_size
    lod = jnp.maximum(ctx.tiles.tile_lod[:F], 0)
    xy = ctx.tiles.tile_xy[:F]
    color = index_color(lod)
    dark = ((xy[:, 0] + xy[:, 1]) % 2) == 0
    color = jnp.where(dark[:, None], color * 0.5, color)
    if cfg.spherical:
        side_c = index_color(ctx.tiles.tile_side[:F])
        color = color + (side_c - color) * 0.3
    colors = jnp.broadcast_to(color[:, None, None, :], (F, G + 1, G + 1, 4))

    # invariant overlays (debug.wgsl:80-92): per-vertex morph target lod
    view_distance = jnp.linalg.norm(
        ctx.mesh.positions - ctx.uniforms.view_world_position, axis=-1
    )
    target_lod = jnp.log2(
        2.0 * ctx.uniforms.morph_distance / jnp.maximum(view_distance, 1e-6)
    )
    lod_f = lod.astype(jnp.float32)[:, None, None]
    # "same tile overlaps two morph zones -> increase morph distance" (red)
    red = jnp.maximum(target_lod, 0.0) < lod_f - 1.0 + ctx.uniforms.morph_range
    # "tile has insufficient LOD -> increase morph tolerance" (green)
    green = jnp.floor(target_lod) > lod_f
    red_c = jnp.asarray(np.array([1, 0, 0, 1], np.float32))
    green_c = jnp.asarray(np.array([0, 1, 0, 1], np.float32))
    colors = jnp.where(red[..., None], red_c, colors)
    colors = jnp.where(green[..., None], green_c, colors)
    return colors


def show_uv(ctx: ShadeContext):
    """SHOW_UV debug view (fragment.wgsl:82-84)."""
    uv = ctx.mesh.uvs
    return jnp.concatenate(
        [uv, jnp.zeros_like(uv[..., :1]), jnp.ones_like(uv[..., :1])], axis=-1
    )


def show_normals(ctx: ShadeContext):
    """SHOW_NORMALS debug view (fragment.wgsl:85-87)."""
    return jnp.concatenate(
        [ctx.normals * 0.5 + 0.5, jnp.ones_like(ctx.normals[..., :1])], axis=-1
    )


def show_tile_tree(ctx: ShadeContext):
    """Tile-tree debug view (debug.wgsl:95-109): checkerboard of the
    best-loaded lookup + window outlines from the tree uv."""
    from bevy_terrain_tpu.ops import coords

    cfg = ctx.cfg
    F, G = cfg.tile_capacity, cfg.grid_size
    side = jnp.broadcast_to(ctx.tiles.tile_side[:F, None, None], (F, G + 1, G + 1))
    lod = jnp.broadcast_to(
        jnp.maximum(ctx.tiles.tile_lod[:F, None, None], 0), (F, G + 1, G + 1)
    )
    xy = jnp.broadcast_to(ctx.tiles.tile_xy[:F, None, None, :], (F, G + 1, G + 1, 2))
    uv = ctx.mesh.uvs
    a_idx, a_lod, a_xy, a_uv = coords.lookup_best(
        ctx.uniforms.entries, ctx.uniforms.origins, side, lod, xy, uv, cfg
    )
    color = index_color(jnp.maximum(a_lod, 0))
    dark = ((a_xy[..., 0] + a_xy[..., 1]) % 2) == 0
    color = jnp.where(dark[..., None], color * 0.5, color)
    # window outlines (debug.wgsl:21-25) on the best lookup's uv
    thickness = 0.015
    inside = jnp.all((a_uv > thickness) & (a_uv < 1.0 - thickness), axis=-1)
    grey = jnp.full_like(color, 0.1)
    return jnp.where(inside[..., None], color, grey)


def show_data_lod(ctx: ShadeContext):
    """SHOW_DATA_LOD view (debug.wgsl:37-54): checkerboard of the DATA lod
    actually sampled, crossfaded toward the parent by the blend ratio,
    darkened near the transition, side-tinted on spheres."""
    blend_lod, blend_ratio, a_lod, a_xy, _ = _vertex_lookup(ctx)
    a_lod = jnp.maximum(a_lod, 0)
    if ctx.cfg.tile_tree_lod:  # debug.wgsl:38-42 #ifdef TILE_TREE_LOD
        ratio = jnp.zeros_like(blend_ratio)
    else:
        ratio = jnp.where(blend_lod == a_lod, blend_ratio, 0.0)
    # checker_color (debug.wgsl:27-34)
    color = index_color(a_lod)
    parent_color = index_color(jnp.maximum(a_lod - 1, 0))
    dark = ((a_xy[..., 0] + a_xy[..., 1]) % 2) == 0
    pdark = (((a_xy[..., 0] >> 1) + (a_xy[..., 1] >> 1)) % 2) == 0
    color = jnp.where(dark[..., None], color * 0.5, color)
    parent_color = jnp.where(pdark[..., None], parent_color * 0.5, parent_color)
    color = color + (parent_color - color) * ratio[..., None]
    near = (ratio > 0.95) & (blend_lod == a_lod)
    color = jnp.where(near[..., None], color * 0.2, color)
    if ctx.cfg.spherical:
        F, G = ctx.cfg.tile_capacity, ctx.cfg.grid_size
        side_c = index_color(ctx.tiles.tile_side[:F])[:, None, None, :]
        color = color + (jnp.broadcast_to(side_c, color.shape) - color) * 0.3
    return color


def show_pixels(ctx: ShadeContext):
    """SHOW_PIXELS checkerboard of 4x4 atlas texel blocks
    (debug.wgsl:111-119); composed as a 50% overlay (fragment.wgsl:79-81)."""
    _, _, _, _, a_uv = _vertex_lookup(ctx)
    pixel = a_uv * (ctx.texture_size / 4.0)
    is_even = ((pixel[..., 0].astype(jnp.int32) + pixel[..., 1].astype(jnp.int32)) % 2) == 0
    grey = jnp.where(is_even, 0.5, 0.1)[..., None]
    return jnp.concatenate(
        [jnp.repeat(grey, 3, axis=-1), jnp.ones_like(grey)], axis=-1
    )


def wireframe_overlay(ctx: ShadeContext, colors):
    """Wireframe stand-in for the reference's polygon-mode toggle
    (terrain_material.rs:299-303). A buffer-producing engine has no
    rasterizer line mode; every vertex already sits on the triangle
    lattice, so the overlay darkens TILE-BORDER vertices strongly and
    every other vertex lightly — the tile lattice and grid density read
    directly in the shaded output."""
    G = ctx.cfg.grid_size
    i = np.arange(G + 1)
    edge_axis = ((i == 0) | (i == G)).astype(np.float32)
    edge = np.maximum.outer(edge_axis, edge_axis)  # tile border mask
    w = jnp.asarray(0.25 + 0.75 * edge, np.float32)[None, :, :, None]
    return jnp.concatenate(
        [colors[..., :3] * (1.0 - 0.55 * w), colors[..., 3:]], axis=-1
    )


DEBUG_VIEWS = {
    "geometry_lod": show_geometry_lod,
    "data_lod": show_data_lod,
    "uv": show_uv,
    "normals": show_normals,
    "tile_tree": show_tile_tree,
    "pixels": show_pixels,  # composed as a 50% overlay in shade()
}


def shade(
    mesh: GridMeshOutput,
    tiles: RefinementOutput,
    uniforms: FrameUniforms,
    cfg: StaticTerrainConfig,
    material: Optional[Callable] = None,
    lighting: bool = True,
    debug_view: Optional[str] = None,
    texture_size: int = 512,
    wireframe: bool = False,
    attachment_samples: Optional[dict] = None,
):
    """Fragment-stage composition (fragment.wgsl:95-113): material color,
    PBR lighting, optional debug overlay. Returns (F, G+1, G+1, 4).

    ``lighting=True`` applies :func:`pbr_lighting` — with the material's
    metallic/roughness parameters when ``material`` is a
    :class:`StandardMaterial`, else with the reference fragment's default
    PbrInput (roughness 1.0, reflectance 0.0; fragment.wgsl:54-56).

    ``debug_view="pixels"`` (or any other view with show_pixels active via
    Terrain.set_debug) composes the texel checkerboard as a 50% overlay on
    the current color, after the replacing views — fragment_debug's
    ordering (fragment.wgsl:69-81).
    """
    normals = surface_normals_from_heights(mesh, tiles, uniforms, cfg)
    ctx = ShadeContext(
        mesh=mesh, tiles=tiles, normals=normals, uniforms=uniforms, cfg=cfg,
        texture_size=texture_size, attachment_samples=attachment_samples,
    )
    colors = (material or default_color)(ctx)
    if lighting:
        if isinstance(material, StandardMaterial):
            colors = pbr_lighting(
                colors, normals, mesh.positions, uniforms.view_world_position,
                perceptual_roughness=material.perceptual_roughness,
                metallic=material.metallic,
                reflectance=material.reflectance,
                emissive=material.emissive,
                lights=material.lights,
                ambient=material.ambient,
            )
        else:
            colors = pbr_lighting(
                colors, normals, mesh.positions, uniforms.view_world_position
            )
    views = (debug_view,) if isinstance(debug_view, (str, type(None))) else debug_view
    for view in views:
        if view == "pixels":
            colors = colors + (show_pixels(ctx) - colors) * 0.5
        elif view is not None:
            colors = DEBUG_VIEWS[view](ctx)
    if wireframe:
        colors = wireframe_overlay(ctx, colors)
    mask = mesh.tile_mask[:, None, None, None]
    return jnp.where(mask, colors, 0.0)
