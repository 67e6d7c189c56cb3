"""Compatibility shim mirroring the compiled ``_vulkan_forge`` extension.

The reference exposes its PyO3 module as ``vulkan_forge._vulkan_forge`` (or
top-level ``_vulkan_forge``); tests import it directly
(e.g. tests/test_t31_integration.py, tests/test_camera.py). This rebuild is
pure Python + JAX + a C++ runtime core, but keeps this module path so those
imports keep working. Registration parity: src/lib.rs:962-976.
"""
from __future__ import annotations

from ._camera import camera_look_at, camera_perspective, camera_view_proj
from ._colormap import colormap_supported
from ._device import device_probe, enumerate_adapters
from ._mesh import grid_generate
from ._renderer import Renderer
from ._scene import Scene, TerrainSpike

__all__ = [
    "Renderer", "TerrainSpike", "Scene",
    "enumerate_adapters", "device_probe", "grid_generate",
    "colormap_supported",
    "camera_look_at", "camera_perspective", "camera_view_proj",
]
