"""Fragment stages ("fragment shaders") as XLA-fused jnp epilogues.

Two terrain fragment pipelines exist, both documented in the reference:

  - ``terrain_fs``: the SHIPPED shader (src/shaders/terrain.wgsl:68-91):
    analytic-derivative normals, ambient-floor Lambert, rgb*exposure*shade,
    NO tonemap. Used by TerrainSpike/Scene for golden parity.
  - ``terrain_fs_extended``: the DOCUMENTED pipeline (README "Lighting &
    Tonemap", ROADMAP T3.2): forward-difference normals from the height
    texture, Lambert, Reinhard tonemap in linear, hardware sRGB encode.
    Used by Renderer.render_rgba() (the planned API the gated
    tests/test_terrain_fs.py exercises).

The LUT is filtered bilinearly along x with clamp-to-edge at the row center,
matching the Filtering sampler on the 256x1 texture
(src/terrain/mod.rs:98-107); sRGB texel decode happens BEFORE filtering, so
``lut`` here is the pre-decoded linear (256, 4) float32 table.
"""
from __future__ import annotations

import jax.numpy as jnp

from .._formats import pack_rgba_u32, srgb_encode


def sample_lut_bilinear(lut: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Bilinear, clamp-to-edge sample of the 256-entry LUT at coordinate t.

    Hardware linear filtering on a 256x1 texture: texel space x = t*256-0.5,
    blend the two nearest texels. Returns (..., 4) linear RGBA.
    """
    xf = t * 256.0 - 0.5
    x0 = jnp.floor(xf)
    frac = (xf - x0)[..., None]
    i0 = jnp.clip(x0, 0, 255).astype(jnp.int32)
    i1 = jnp.clip(x0 + 1.0, 0, 255).astype(jnp.int32)
    c0 = lut[i0]          # (..., 4) gather
    c1 = lut[i1]
    return c0 * (1.0 - frac) + c1 * frac


def terrain_fs(h, x, z, mask, lut, h_range, exposure, sun_dir):
    """Shipped terrain fragment shader (src/shaders/terrain.wgsl:68-91).

    h, x, z: (H, W) interpolated varyings; mask: (H, W) coverage.
    Returns (H, W) uint32 packed RGBA (sRGB-encoded, background = clear
    color (0.02, 0.02, 0.03, 1.0), src/terrain/mod.rs:420 / scene/mod.rs:286).
    """
    h_range = jnp.maximum(h_range, 1e-8)
    t = jnp.clip(0.5 + h / (2.0 * h_range), 0.0, 1.0)
    lut_rgb = sample_lut_bilinear(lut, t)[..., :3]

    # Analytic-derivative normal (terrain.wgsl:79-81): the shipped shader
    # derives the normal from the fallback function, not the height texture.
    dhdx = 1.3 * jnp.cos(x * 1.3) * 0.25
    dhdz = -1.1 * jnp.sin(z * 1.1) * 0.25
    inv_len = 1.0 / jnp.sqrt(dhdx * dhdx + 1.0 + dhdz * dhdz)
    l = sun_dir / jnp.sqrt(jnp.sum(sun_dir * sun_dir))
    lambert = jnp.clip((-dhdx * l[0] + l[1] - dhdz * l[2]) * inv_len, 0.0, 1.0)
    shade = 0.15 + 0.85 * lambert  # mix(0.15, 1.0, lambert)

    rgb = lut_rgb * exposure * shade[..., None]

    clear = jnp.array([0.02, 0.02, 0.03], jnp.float32)
    rgb = jnp.where(mask[..., None], rgb, clear)
    srgb = srgb_encode(rgb)
    one = jnp.ones_like(srgb[..., 0])
    return pack_rgba_u32(srgb[..., 0], srgb[..., 1], srgb[..., 2], one)


def terrain_fs_extended(h, u, v, mask, lut, heights, h_min, h_max, exposure,
                        sun_dir, spacing, exaggeration):
    """Documented T3.2 pipeline: fwd-diff normals + Reinhard tonemap.

    Varyings here are (height, u, v). Normals come from forward differences
    of the height texture (ROADMAP.md:422-440), scaled by spacing and
    exaggeration; tonemap is Reinhard in linear (README "Lighting & Tonemap")
    followed by the target's hardware sRGB encode. Heights normalize into
    [0,1] via the stored [h_min, h_max] range (README T02 doc:
    "set_height_range overrides the auto-computed [h_min, h_max] used to
    normalize heights into [0, 1] for colormap & lighting").
    """
    ht, wt = heights.shape
    t = jnp.clip((h - h_min) / jnp.maximum(h_max - h_min, 1e-8), 0.0, 1.0)
    lut_rgb = sample_lut_bilinear(lut, t)[..., :3]

    # Finite-difference normals from the height texture at the pixel's uv.
    # Central differences instead of the ROADMAP's forward differences: a
    # forward difference biases the normal by half a texel, which shows up
    # as a static brightness gradient across symmetric terrain larger than
    # the directional-lighting signal itself; central differences are
    # unbiased at interior texels (and clamp to one-sided at the borders).
    tx = jnp.clip(jnp.floor(u * wt), 0, wt - 1).astype(jnp.int32)
    ty = jnp.clip(jnp.floor(v * ht), 0, ht - 1).astype(jnp.int32)
    txm = jnp.maximum(tx - 1, 0)
    txp = jnp.minimum(tx + 1, wt - 1)
    tym = jnp.maximum(ty - 1, 0)
    typ = jnp.minimum(ty + 1, ht - 1)
    step_x = (txp - txm).astype(jnp.float32)
    step_z = (typ - tym).astype(jnp.float32)
    sp = jnp.maximum(spacing, 1e-8)
    dhdx = ((heights[ty, txp] - heights[ty, txm]) * exaggeration
            / (jnp.maximum(step_x, 1.0) * sp))
    dhdz = ((heights[typ, tx] - heights[tym, tx]) * exaggeration
            / (jnp.maximum(step_z, 1.0) * sp))
    inv_len = 1.0 / jnp.sqrt(dhdx * dhdx + 1.0 + dhdz * dhdz)
    l = sun_dir / jnp.sqrt(jnp.sum(sun_dir * sun_dir))
    lambert = jnp.clip((-dhdx * l[0] + l[1] - dhdz * l[2]) * inv_len, 0.0, 1.0)
    shade = 0.15 + 0.85 * lambert

    rgb = lut_rgb * shade[..., None]
    # Reinhard tonemap in linear; hardware sRGB encode on store.
    rgb = rgb * exposure
    rgb = rgb / (1.0 + rgb)

    clear = jnp.array([0.02, 0.02, 0.03], jnp.float32)
    rgb = jnp.where(mask[..., None], rgb, clear)
    srgb = srgb_encode(rgb)
    one = jnp.ones_like(srgb[..., 0])
    return pack_rgba_u32(srgb[..., 0], srgb[..., 1], srgb[..., 2], one)


def triangle_fs(r, g, b, mask):
    """Gradient-triangle fragment shader (src/shaders/triangle.wgsl:18-24).

    Varyings are the interpolated linear vertex colors; clear color is white
    (src/lib.rs:19). Hardware sRGB encode on store.
    """
    rgb = jnp.stack([r, g, b], axis=-1)
    white = jnp.ones(3, jnp.float32)
    rgb = jnp.where(mask[..., None], rgb, white)
    srgb = srgb_encode(rgb)
    one = jnp.ones_like(srgb[..., 0])
    return pack_rgba_u32(srgb[..., 0], srgb[..., 1], srgb[..., 2], one)
