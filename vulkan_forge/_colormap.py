"""Central colormap registry and LUT preparation.

Parity targets:
  - ``SUPPORTED`` names and the exact "Unknown colormap ..." error message
    (src/colormap/mod.rs:7-17).
  - ``to_linear_u8_rgba``: CPU sRGB->linear with the exact 2.4-gamma piecewise
    curve and +0.5 rounding (src/colormap/mod.rs:59-79).
  - LUT format selection: sRGB unless VF_FORCE_LUT_UNORM is set, mirroring
    ColormapLUT::new (src/terrain/mod.rs:44-61). Here the "adapter" always
    supports sRGB sampling, so only the env var drives the fallback.

The GPU 256x1 texture becomes a (256, 4) float32 *linear-space* table: the
fragment kernel filters it bilinearly along x with clamp-to-edge, matching
the Filtering sampler (src/terrain/pipeline.rs:62-82) which decodes sRGB
texels to linear BEFORE filtering.
"""
from __future__ import annotations

import os

import numpy as np

from ._formats import srgb_decode_np
from ._palettes import palette_srgb_rgba8

SUPPORTED = ["viridis", "magma", "terrain"]


def unknown_colormap_error(name: str) -> RuntimeError:
    return RuntimeError(
        f"Unknown colormap '{name}'. Supported: {', '.join(SUPPORTED)}"
    )


def colormap_supported():
    """Supported colormap names (parity: src/colormap/mod.rs:44-47)."""
    return list(SUPPORTED)


def decode_rgba8(name: str) -> np.ndarray:
    """(256,4) uint8 sRGB-encoded palette bytes for ``name``."""
    if name not in SUPPORTED:
        raise unknown_colormap_error(name)
    return palette_srgb_rgba8(name)


def to_linear_u8_rgba(src_srgb_rgba8: np.ndarray) -> np.ndarray:
    """sRGB RGBA8 -> linear RGBA8 (RGB channels only; alpha unchanged).

    Exact parity with src/colormap/mod.rs:59-79 (including clamp and
    +0.5 rounding).
    """
    src = np.asarray(src_srgb_rgba8, dtype=np.uint8).reshape(-1, 4)
    rgb = src[:, :3].astype(np.float32) / np.float32(255.0)
    lin = srgb_decode_np(rgb)
    out = np.empty_like(src)
    out[:, :3] = (np.clip(lin, 0.0, 1.0) * np.float32(255.0) + np.float32(0.5)).astype(np.uint8)
    out[:, 3] = src[:, 3]
    return out.reshape(np.asarray(src_srgb_rgba8).shape)


def lut_force_unorm() -> bool:
    """VF_FORCE_LUT_UNORM semantics: set (to anything) => UNORM fallback."""
    return os.environ.get("VF_FORCE_LUT_UNORM") is not None


def build_lut(name: str):
    """Build the linear-space LUT table for the fragment shader.

    Returns ``(lut_linear_f32 (256,4), format_name)`` where format_name is
    "Rgba8UnormSrgb" or "Rgba8Unorm" (parity: src/terrain/mod.rs:44-61 and
    debug_lut_format, src/terrain/mod.rs:493-496).

    - sRGB path: texels decode sRGB->linear in full float precision at sample
      time; we precompute the decoded table.
    - UNORM path: texels were CPU-linearized to u8 (quantized!) and sampled
      as UNORM; the table is that quantized linear u8 / 255.
    Alpha is never gamma-coded: a = byte/255 in both paths.
    """
    srgb_bytes = decode_rgba8(name)
    if lut_force_unorm():
        lin_u8 = to_linear_u8_rgba(srgb_bytes)
        table = lin_u8.astype(np.float32) / np.float32(255.0)
        return table, "Rgba8Unorm"
    table = np.empty((256, 4), dtype=np.float32)
    table[:, :3] = srgb_decode_np(srgb_bytes[:, :3].astype(np.float32) / np.float32(255.0))
    table[:, 3] = srgb_bytes[:, 3].astype(np.float32) / np.float32(255.0)
    return table, "Rgba8UnormSrgb"
