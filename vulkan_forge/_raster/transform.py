"""Vertex stages ("vertex shaders") as batched jnp math.

Replaces the reference WGSL vertex shaders:
  - terrain_vs: src/shaders/terrain.wgsl:44-66 (height sample + analytic
    fallback + world/clip transform).
  - triangle_vs: src/shaders/triangle.wgsl:6-16 (passthrough, z=0 w=1).

Matrix convention: ``view``/``proj`` are row-major math-convention (4,4)
float32; clip = proj @ (view @ world), matching the shader's
``proj * (view * vec4(world, 1))`` evaluation order.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# The vertex products run at full float32 precision: on a GPU an f32
# matmul may otherwise run in TF32 (about 3 decimal digits), which would
# move vertices by up to ~1e-3 relative and break per-device goldens.
_HIGHEST = jax.lax.Precision.HIGHEST


def sample_height_nearest(heights: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Nearest, clamp-to-edge sampling of an R32Float texture at uv.

    Matches the NonFiltering sampler the reference binds for the height
    texture (src/terrain/pipeline.rs:39-59; nearest+clamp samplers at
    src/lib.rs:519-528). ``heights``: (Ht, Wt) f32; ``uv``: (N, 2) in [0,1].
    """
    ht, wt = heights.shape
    tx = jnp.clip(jnp.floor(uv[:, 0] * wt), 0, wt - 1).astype(jnp.int32)
    ty = jnp.clip(jnp.floor(uv[:, 1] * ht), 0, ht - 1).astype(jnp.int32)
    return heights[ty, tx]


def analytic_height(x: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    """Deterministic analytic fallback relief (src/shaders/terrain.wgsl:39-41)."""
    return jnp.sin(x * 1.3) * 0.25 + jnp.cos(z * 1.1) * 0.25


def world_to_clip(world: jnp.ndarray, view: jnp.ndarray,
                  proj: jnp.ndarray) -> jnp.ndarray:
    """(N, 4) world positions -> clip space, ``proj * (view * world)``."""
    view_pos = jnp.matmul(world, view.T.astype(jnp.float32), precision=_HIGHEST)
    return jnp.matmul(view_pos, proj.T.astype(jnp.float32), precision=_HIGHEST)


def terrain_vs(xyuv: jnp.ndarray, heights: jnp.ndarray, view: jnp.ndarray,
               proj: jnp.ndarray, spacing: jnp.ndarray, exaggeration: jnp.ndarray):
    """Terrain vertex stage.

    xyuv: (N, 4) [x, z, u, v] plane vertices. Returns (clip (N,4),
    varyings (N,3) = [height, x, z]) -- exactly the interpolants the
    fragment stage consumes (src/shaders/terrain.wgsl:30-36; uv is unused
    by the fragment shader).
    """
    x = xyuv[:, 0]
    z = xyuv[:, 1]
    uv = xyuv[:, 2:4]
    spacing = jnp.maximum(spacing, 1e-8)  # shader guard (terrain.wgsl:46)

    h_tex = sample_height_nearest(heights, uv)
    h = h_tex + analytic_height(x, z)

    wx = x * spacing
    wy = h * exaggeration
    wz = z * spacing
    world = jnp.stack([wx, wy, wz, jnp.ones_like(wx)], axis=-1)  # (N, 4)

    clip = world_to_clip(world, view, proj)
    varyings = jnp.stack([h, x, z], axis=-1)
    return clip, varyings


def terrain_vs_extended(xyuv: jnp.ndarray, heights: jnp.ndarray,
                        view: jnp.ndarray, proj: jnp.ndarray,
                        spacing: jnp.ndarray, exaggeration: jnp.ndarray):
    """Vertex stage of the extended pipeline (``Renderer.render_rgba``):
    the real DEM height with no analytic fallback relief, and varyings
    (height, u, v) for the fragment stage's height-texture normals."""
    x = xyuv[:, 0]
    z = xyuv[:, 1]
    sp = jnp.maximum(spacing, 1e-8)
    h = sample_height_nearest(heights, xyuv[:, 2:4])
    world = jnp.stack([x * sp, h * exaggeration, z * sp,
                       jnp.ones_like(x)], axis=-1)
    clip = world_to_clip(world, view, proj)
    varyings = jnp.stack([h, xyuv[:, 2], xyuv[:, 3]], axis=-1)
    return clip, varyings


def triangle_vs(pos2: jnp.ndarray, color3: jnp.ndarray):
    """Gradient-triangle vertex stage (passthrough; z=0, w=1)."""
    n = pos2.shape[0]
    clip = jnp.concatenate(
        [pos2.astype(jnp.float32),
         jnp.zeros((n, 1), jnp.float32),
         jnp.ones((n, 1), jnp.float32)], axis=-1)
    return clip, color3.astype(jnp.float32)
