"""End-to-end jitted render pipelines (the list path).

The reference's encoder/submit/poll/readback dance (src/lib.rs:685-721,
src/terrain/mod.rs:409-491) collapses to ONE jitted function per pipeline:
``u32_image = render(scene arrays)``; "readback" is ``jax.device_get``.

Every render is a tiled sort-middle raster: vertex stage (transform.py),
triangle setup and per-tile binning (setup.py), the list raster to a
g-buffer, and an XLA-fused fragment epilogue (fragment.py). The raster
stage is the Triton list kernel (pallas_backend.py) on a GPU and the
plain jnp reference (tiles.py) elsewhere; both give the same pixels.

Per-tile triangle capacity is data-dependent (it is the only dynamic
quantity in the whole pipeline), so rendering is two-phase:
  1. a tiny jitted pass computes exact per-tile counts; the host rounds the
     max up to a power of two (few distinct values => few recompiles);
  2. the raster pass runs with that static capacity. Because counts are
     exact, overflow is impossible by construction.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import _formats
from . import fragment, pallas_backend, tiles, transform
from .setup import (TILE_H, TILE_W, bin_triangles, clip_to_fb, tile_counts,
                    tile_span_max, triangle_setup)


def backend_name() -> str:
    """Raster stage: VF_BACKEND in {auto, jnp, pallas}.

    auto => "pallas" (the Triton list kernel) when JAX's default device is
    a GPU, "jnp" (the plain reference) otherwise. "pallas" elsewhere than
    on a GPU raises: the kernel is compiled by Triton and is never run
    through the Pallas interpreter behind the caller's back.
    """
    from .._device import default_platform
    b = os.environ.get("VF_BACKEND", "auto").lower()
    if b not in ("auto", "jnp", "pallas"):
        b = "auto"
    platform = default_platform()
    if b == "auto":
        return "pallas" if platform == "gpu" else "jnp"
    if b == "pallas" and platform != "gpu":
        raise RuntimeError(
            f"VF_BACKEND=pallas needs a GPU (the list raster kernel is "
            f"compiled by Triton); JAX's default platform is {platform!r}")
    return b


def fill_rule_name() -> str:
    """VF_FILL_RULE in {inclusive, hw}: the shipped all-edges-inclusive
    rule, or the hardware 8.8-snap top-left rule (setup.py)."""
    rule = os.environ.get("VF_FILL_RULE", "inclusive")
    return rule if rule in ("inclusive", "hw") else "inclusive"


def _round_capacity(n: int) -> int:
    c = 8
    while c < n:
        c *= 2
    return c


def _round_span(n: int) -> int:
    c = 1
    while c < n:
        c *= 2
    return c


def _raster(records, tile_lists, counts, width, height, use_pallas,
            fill_rule, tile_h=TILE_H, tile_w=TILE_W):
    """The raster stage of one frame: (var0, var1, var2, mask) planes."""
    if use_pallas:
        return pallas_backend.render_gbuffer(
            records, tile_lists, counts, width, height, tile_h, tile_w,
            fill_rule=fill_rule)
    return tiles.render_gbuffer(records, tile_lists, width, height, tile_h,
                                tile_w, fill_rule=fill_rule)


@functools.partial(jax.jit, static_argnames=("width", "height", "tile_h", "tile_w"))
def _bin_stats(bbox, width, height, tile_h=TILE_H, tile_w=TILE_W):
    counts = tile_counts(bbox, width, height, tile_h, tile_w)
    sx, sy = tile_span_max(bbox, width, height, tile_h, tile_w)
    return counts.max(), sx, sy


# Ratchet cache for the list path's static binning parameters: capacities
# only ever grow per (T, W, H), so a camera orbit reuses one compiled
# executable instead of recompiling every time the per-tile max crosses a
# pow2 bucket (rendering with a larger-than-needed capacity is correct --
# lists pad with the sentinel id and the raster loops by actual counts).
_BIN_PARAM_RATCHET: dict = {}


def _static_bin_params(bbox, width, height):
    cmax, sx, sy = jax.device_get(_bin_stats(bbox, width, height))
    key = (int(bbox.shape[0]), width, height)
    cap = _round_capacity(int(cmax))
    spx = _round_span(int(sx))
    spy = _round_span(int(sy))
    prev = _BIN_PARAM_RATCHET.get(key)
    if prev is not None:
        cap = max(cap, prev[0])
        spx = max(spx, prev[1])
        spy = max(spy, prev[2])
    _BIN_PARAM_RATCHET[key] = (cap, spx, spy)
    return cap, spx, spy


# ---------------- terrain ----------------

def _terrain_vertex_stage(xyuv, heights, view, proj, spacing, exaggeration,
                          fs_mode):
    if fs_mode == "shipped":
        return transform.terrain_vs(xyuv, heights, view, proj, spacing,
                                    exaggeration)
    return transform.terrain_vs_extended(xyuv, heights, view, proj, spacing,
                                         exaggeration)


def _terrain_fs(v0, v1, v2, mask, heights, lut, h_min, h_max, exposure,
                sun_dir, nspacing, exaggeration, fs_mode):
    if fs_mode == "shipped":
        return fragment.terrain_fs(v0, v1, v2, mask, lut, h_max - h_min,
                                   exposure, sun_dir)
    return fragment.terrain_fs_extended(v0, v1, v2, mask, lut, heights,
                                        h_min, h_max, exposure, sun_dir,
                                        nspacing, exaggeration)


@functools.partial(jax.jit, static_argnames=("width", "height", "fs_mode",
                                             "fill_rule"))
def _terrain_records(xyuv, indices, heights, view, proj, spacing, exaggeration,
                     width, height, fs_mode="shipped", fill_rule="inclusive"):
    clip, varyings = _terrain_vertex_stage(xyuv, heights, view, proj, spacing,
                                           exaggeration, fs_mode)
    x, y, z, w = clip_to_fb(clip, width, height)
    return triangle_setup(x, y, z, w, varyings, indices, width, height,
                          fill_rule=fill_rule)


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "capacity", "span_x", "span_y", "tile_h", "tile_w",
    "fs_mode", "use_pallas", "fill_rule"))
def _terrain_render_from_records(records, bbox, heights, lut, h_min, h_max,
                                 exposure, sun_dir, spacing, exaggeration,
                                 width, height, capacity, span_x=4, span_y=4,
                                 tile_h=TILE_H, tile_w=TILE_W,
                                 fs_mode="shipped", use_pallas=False,
                                 fill_rule="inclusive"):
    binning = bin_triangles(bbox, width, height, capacity, tile_h, tile_w,
                            span_x=span_x, span_y=span_y)
    v0, v1, v2, mask = _raster(records, binning.tile_lists, binning.counts,
                               width, height, use_pallas, fill_rule,
                               tile_h, tile_w)
    return _terrain_fs(v0, v1, v2, mask, heights, lut, h_min, h_max, exposure,
                       sun_dir, spacing, exaggeration, fs_mode)


class TerrainPlan(NamedTuple):
    """The two executables of one terrain render, with their arguments:
    ``_terrain_records(*records_args, **records_static)`` then
    ``_terrain_render_from_records(*args, **static)``."""
    records_args: tuple
    records_static: dict
    args: tuple
    static: dict


def plan_terrain(xyuv, indices, heights, view, proj, *, spacing, exaggeration,
                 h_min, h_max, exposure, sun_dir, lut, width: int, height: int,
                 fs_mode: str = "shipped", normal_spacing=None,
                 backend: Optional[str] = None) -> TerrainPlan:
    """Stage 1 of ``render_terrain_u8``: upload the inputs, run triangle
    setup, and size the binning on the host (one device_get)."""
    be = backend or backend_name()
    xyuv = jnp.asarray(xyuv, jnp.float32)
    indices = jnp.asarray(np.asarray(indices).reshape(-1, 3), jnp.int32)
    heights = jnp.asarray(heights, jnp.float32)
    spacing = jnp.float32(spacing)
    exaggeration = jnp.float32(exaggeration)
    # Texel world step used only for the extended FS's fwd-diff normals; the
    # mesh may already be in world units (spacing=1) while normals still
    # need the true DEM spacing.
    nsp = jnp.float32(spacing if normal_spacing is None else normal_spacing)
    fill_rule = fill_rule_name()

    records_args = (xyuv, indices, heights, jnp.asarray(view, jnp.float32),
                    jnp.asarray(proj, jnp.float32), spacing, exaggeration,
                    width, height)
    records_static = dict(fs_mode=fs_mode, fill_rule=fill_rule)
    records, bbox = _terrain_records(*records_args, **records_static)
    capacity, span_x, span_y = _static_bin_params(bbox, width, height)
    args = (records, bbox, heights, jnp.asarray(lut, jnp.float32),
            jnp.float32(h_min), jnp.float32(h_max), jnp.float32(exposure),
            jnp.asarray(sun_dir, jnp.float32), nsp, exaggeration)
    static = dict(width=width, height=height, capacity=capacity,
                  span_x=span_x, span_y=span_y, fs_mode=fs_mode,
                  use_pallas=(be == "pallas"), fill_rule=fill_rule)
    return TerrainPlan(records_args, records_static, args, static)


def render_terrain_u8(*args, as_device: bool = False, **kwargs) -> np.ndarray:
    """Render the terrain pipeline to an (H, W, 4) uint8 numpy array.

    Arguments are ``plan_terrain``'s. fs_mode "shipped" reproduces
    src/shaders/terrain.wgsl exactly (incl. the analytic fallback relief
    added to sampled heights); "extended" is the documented fwd-diff +
    Reinhard pipeline used by Renderer.render_rgba() (no analytic
    fallback: it renders the real DEM). ``backend`` overrides
    ``backend_name()``. ``as_device`` returns the packed u32 image still
    on the device.
    """
    plan = plan_terrain(*args, **kwargs)
    img_u32 = _terrain_render_from_records(*plan.args, **plan.static)
    if as_device:
        return img_u32
    return _formats.u32_image_to_rgba_u8(jax.device_get(img_u32))


# ---------------- batched terrain (throughput path) ----------------

@functools.partial(jax.jit, static_argnames=(
    "width", "height", "capacity", "span_x", "span_y", "fs_mode",
    "use_pallas", "fill_rule"))
def _terrain_render_batch(xyuv, indices, heights, views, projs, lut,
                          h_min, h_max, exposure, sun_dir, spacing,
                          exaggeration, width, height, capacity,
                          span_x=4, span_y=4,
                          fs_mode="shipped", use_pallas=False,
                          fill_rule="inclusive"):
    """Render B frames (one camera each) of one scene in a single dispatch.

    views/projs: (B, 4, 4). The raster kernel takes all B frames in one
    launch (frames ride its first grid axis); binning capacity and spans
    are shared (``_terrain_batch_counts``).
    """
    def prep(view, proj):
        records, bbox = _terrain_records.__wrapped__(
            xyuv, indices, heights, view, proj, spacing, exaggeration,
            width, height, fs_mode=fs_mode, fill_rule=fill_rule)
        binning = bin_triangles(bbox, width, height, capacity,
                                span_x=span_x, span_y=span_y)
        return records, binning.tile_lists, binning.counts

    records_b, lists_b, counts_b = jax.vmap(prep)(views, projs)

    if use_pallas:
        v0, v1, v2, mask = pallas_backend.render_gbuffer_batch(
            records_b, lists_b, counts_b, width, height, fill_rule=fill_rule)
    else:
        v0, v1, v2, mask = jax.vmap(
            lambda r, tl: tiles.render_gbuffer(r, tl, width, height,
                                               fill_rule=fill_rule)
        )(records_b, lists_b)

    return jax.vmap(
        lambda a, b, c, m: _terrain_fs(a, b, c, m, heights, lut, h_min, h_max,
                                       exposure, sun_dir, spacing,
                                       exaggeration, fs_mode)
    )(v0, v1, v2, mask)


@functools.partial(jax.jit, static_argnames=("width", "height", "fs_mode",
                                             "fill_rule"))
def _terrain_batch_counts(xyuv, indices, heights, views, projs,
                          spacing, exaggeration, width, height,
                          fs_mode="shipped", fill_rule="inclusive"):
    """Shared static binning parameters for a camera batch: max per-tile
    count and max tile spans over all frames."""
    def one(view, proj):
        _, bbox = _terrain_records.__wrapped__(
            xyuv, indices, heights, view, proj, spacing, exaggeration,
            width, height, fs_mode=fs_mode, fill_rule=fill_rule)
        counts = tile_counts(bbox, width, height)
        sx, sy = tile_span_max(bbox, width, height)
        return counts.max(), sx, sy
    cm, sx, sy = jax.vmap(one)(views, projs)
    return cm.max(), sx.max(), sy.max()


def batch_bin_params(xyuv, indices, heights, views, projs, spacing,
                     exaggeration, width, height, fs_mode="shipped",
                     fill_rule="inclusive"):
    """Host-rounded (capacity, span_x, span_y) for ``_terrain_render_batch``."""
    cmax, sx, sy = jax.device_get(_terrain_batch_counts(
        xyuv, indices, heights, views, projs, spacing, exaggeration,
        width, height, fs_mode=fs_mode, fill_rule=fill_rule))
    return _round_capacity(int(cmax)), _round_span(int(sx)), _round_span(int(sy))


# ---------------- gradient triangle ----------------

# Fixed geometry (src/lib.rs:73-78): CCW, u16 indices [0,1,2].
_TRI_POS = np.array([[-0.8, -0.8], [0.8, -0.8], [0.0, 0.8]], dtype=np.float32)
_TRI_COLOR = np.array([[1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.2, 0.2, 1.0]],
                      dtype=np.float32)


@functools.partial(jax.jit, static_argnames=("width", "height", "use_pallas",
                                             "fill_rule"))
def _triangle_render(width, height, use_pallas=False, fill_rule="inclusive"):
    clip, colors = transform.triangle_vs(jnp.asarray(_TRI_POS), jnp.asarray(_TRI_COLOR))
    x, y, _z, w = clip_to_fb(clip, width, height)
    indices = jnp.array([[0, 1, 2]], jnp.int32)
    records, bbox = triangle_setup(x, y, _z, w, colors, indices, width, height,
                                   fill_rule=fill_rule)
    # One triangle spanning the whole screen: span covers every tile.
    binning = bin_triangles(bbox, width, height, capacity=8,
                            span_x=-(-width // TILE_W),
                            span_y=-(-height // TILE_H))
    v0, v1, v2, mask = _raster(records, binning.tile_lists, binning.counts,
                               width, height, use_pallas, fill_rule)
    return fragment.triangle_fs(v0, v1, v2, mask)


def render_triangle_u8(width: int, height: int,
                       backend: Optional[str] = None,
                       as_device: bool = False) -> np.ndarray:
    """Deterministic gradient triangle -> (H, W, 4) uint8."""
    be = backend or backend_name()
    img_u32 = _triangle_render(width, height, use_pallas=(be == "pallas"),
                               fill_rule=fill_rule_name())
    if as_device:
        return img_u32
    return _formats.u32_image_to_rgba_u8(jax.device_get(img_u32))
