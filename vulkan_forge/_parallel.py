"""Multi-device rendering: data parallelism over the frame/camera axis.

The reference has no distributed code (SURVEY.md 2.4); its "backend
parallelism" is alternative graphics APIs. A renderer scales over devices
by embarrassingly parallel frames: shard a camera batch over a 1-D device
mesh with shard_map -- each device rasterizes its own frames through the
batched list path; the only cross-device traffic is the gather of results.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def render_spike_frames(width: int, height: int, grid: int,
                        eyes: Sequence, *, colormap: str = "viridis",
                        fovy_deg: float = 45.0, znear: float = 0.1,
                        zfar: float = 100.0,
                        devices: Optional[Sequence] = None) -> np.ndarray:
    """Render B spike-terrain frames (one camera per frame) sharded over
    devices. Returns (B, H, W, 4) uint8.

    ``eyes``: sequence of (x, y, z) camera positions (target=origin, up=Y).
    ``devices``: jax devices to shard over (default: all). Any frame count
    works on any mesh: the camera batch is padded internally to a multiple
    of the device count (repeating the last camera) and the pad frames are
    sliced off the result.
    """
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from . import _colormap, _formats, _mesh
    from ._camera import look_at_rh, perspective_wgpu
    from ._raster import pipeline as pipe
    from ._uniforms import Globals, _normalize
    from ._validate import size_wh, grid as vgrid

    width, height = size_wh(width, height)
    grid = vgrid(grid)
    if colormap not in _colormap.SUPPORTED:
        raise _colormap.unknown_colormap_error(colormap)

    devs = list(devices) if devices is not None else jax.devices()
    B = len(eyes)
    n = len(devs)
    if B == 0:
        raise ValueError("need at least one camera")

    xyuv_np, idx_np = _mesh.build_grid_xyuv(grid)
    xyuv = jnp.asarray(xyuv_np)
    indices = jnp.asarray(idx_np.astype(np.int32).reshape(-1, 3))
    heights = jnp.zeros((1, 1), jnp.float32)
    lut = jnp.asarray(_colormap.build_lut(colormap)[0])
    g = Globals()
    sun = jnp.asarray(_normalize(np.array([0.5, 1.0, 0.3], np.float32)))

    aspect = np.float32(width) / np.float32(height)
    proj = perspective_wgpu(np.float32(math.radians(float(fovy_deg))), aspect,
                            np.float32(znear), np.float32(zfar))
    views = np.stack([look_at_rh(e, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
                      for e in eyes])
    # Pad to a multiple of the device count (repeat the last camera); the
    # pad frames are rendered and discarded -- shard_map needs equal shards.
    pad = (-B) % n
    if pad:
        views = np.concatenate([views, np.repeat(views[-1:], pad, axis=0)])
    projs = np.broadcast_to(proj, (B + pad, 4, 4)).copy()

    mesh = Mesh(np.array(devs), ("frames",))
    use_pallas = (pipe.backend_name() == "pallas"
                  and devs[0].platform == "gpu")
    fill_rule = pipe.fill_rule_name()
    views_j = jnp.asarray(views)
    projs_j = jnp.asarray(projs)
    # Shared static binning parameters from a prepass over all cameras.
    capacity, span_x, span_y = pipe.batch_bin_params(
        xyuv, indices, heights, views_j, projs_j, jnp.float32(g.spacing),
        jnp.float32(g.exaggeration), width, height, fill_rule=fill_rule)

    def shard_fn(views_s, projs_s):
        return pipe._terrain_render_batch.__wrapped__(
            xyuv, indices, heights, views_s, projs_s, lut,
            jnp.float32(g.h_min), jnp.float32(g.h_max),
            jnp.float32(g.exposure), sun,
            jnp.float32(g.spacing), jnp.float32(g.exaggeration),
            width, height, capacity, span_x, span_y,
            fs_mode="shipped", use_pallas=use_pallas, fill_rule=fill_rule)

    sharded = shard_map(shard_fn, mesh=mesh,
                        in_specs=(P("frames"), P("frames")),
                        out_specs=P("frames"), check_vma=False)
    with mesh:
        imgs_u32 = jax.jit(sharded)(views_j, projs_j)
        imgs_u32 = jax.device_get(imgs_u32)
    return np.stack([_formats.u32_image_to_rgba_u8(f)
                     for f in imgs_u32[:B]])
