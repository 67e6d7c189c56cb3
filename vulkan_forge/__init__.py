"""vulkan-forge, rebuilt in JAX.

A headless, deterministic offscreen renderer with the same Python API as
milos-agathon/vulkan-forge (python/vulkan_forge/__init__.py): the wgpu/WGSL
render pipelines become a tile-binned software rasterizer in JAX (with a
Pallas/Triton list-raster kernel on the GPU), the Rust runtime becomes a
C++ core + NumPy host layer, and "readback" is jax.device_get of a
device-resident framebuffer.

Public API (parity: python/vulkan_forge/__init__.py:107-114,145-178):
- Renderer(width, height), TerrainSpike, Scene
- render_triangle_rgba / render_triangle_png / make_terrain
- camera_look_at / camera_perspective / camera_view_proj
- colormap_supported, dem_stats, dem_normalize
- grid_generate (+ legacy alias generate_grid)
"""
from __future__ import annotations

import os as _os


def _machine_fingerprint() -> str:
    """Short host-ISA fingerprint used to key the persistent compile cache.

    XLA:CPU AOT executables are machine-feature-specific: reusing a cache
    directory across machine types triggers loader warnings and can SIGILL.
    Keying the cache subdirectory
    by (arch, CPU feature flags) keeps each machine type's executables
    separate while still sharing across processes on the same host type.
    """
    import hashlib
    import platform
    bits = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith(("flags", "features")):
                    bits.append(line.split(":", 1)[1].strip())
                    break
    except OSError:
        pass
    return platform.machine() + "-" + hashlib.sha1(
        "|".join(bits).encode()).hexdigest()[:10]


def _compilation_cache_dir() -> "str | None":
    """Where this package points JAX's persistent compilation cache.

    None when VF_NO_CACHE is set, and when JAX_COMPILATION_CACHE_DIR is set
    (JAX reads that variable itself). Otherwise a fixed directory inside
    the checkout, keyed by the host's machine fingerprint -- a fixed path,
    because the path is part of the cache key.
    """
    if _os.environ.get("VF_NO_CACHE") or _os.environ.get(
            "JAX_COMPILATION_CACHE_DIR"):
        return None
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(root, ".jax_cache", _machine_fingerprint())


def _init_compilation_cache() -> None:
    """Enable JAX's persistent compilation cache.

    Renders are jitted pipelines; caching compiled executables across
    processes turns the reference's "cold init" (wgpu device + shader
    compile, ~100ms) analog -- XLA and Triton compilation, seconds -- into
    a one-time cost per (shape, capacity) config. Disable with
    VF_NO_CACHE=1.
    """
    cache_dir = _compilation_cache_dir()
    if cache_dir is None:
        return
    import jax
    _os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_init_compilation_cache()

from ._validate import size_wh, png_path, grid as _grid

from ._renderer import Renderer
from ._scene import Scene, TerrainSpike
from ._camera import camera_look_at, camera_perspective, camera_view_proj
from ._colormap import colormap_supported
from ._device import device_probe, enumerate_adapters
from ._dem import dem_normalize, dem_stats
from ._mesh import grid_generate
from ._parallel import render_spike_frames


def render_triangle_rgba(width: int, height: int):
    """Render a deterministic triangle and return (H, W, 4) uint8."""
    w, h = size_wh(width, height)
    r = Renderer(w, h)
    return r.render_triangle_rgba()


def render_triangle_png(path: str, width: int, height: int) -> None:
    """Render a deterministic triangle and write it as a PNG file to `path`."""
    w, h = size_wh(width, height)
    r = Renderer(w, h)
    r.render_triangle_png(png_path(path))


def make_terrain(width: int, height: int, grid: int = 128):
    """Helper constructor for TerrainSpike."""
    if "TerrainSpike" not in globals():
        raise RuntimeError(
            "TerrainSpike unavailable; build crate with --features terrain_spike")
    w, h = size_wh(width, height)
    g = _grid(grid)
    return TerrainSpike(w, h, g)


# Version metadata (best-effort, parity: python/vulkan_forge/__init__.py:77-85)
try:
    from importlib.metadata import version
    __version__ = version("vulkan-forge")
except Exception:
    try:
        __version__ = version("vulkan_forge")
    except Exception:
        __version__ = "0.2.0"

# Legacy alias for T11 compatibility
generate_grid = grid_generate

__all__ = [
    "Renderer", "render_triangle_rgba", "render_triangle_png", "make_terrain",
    "colormap_supported", "camera_look_at", "camera_perspective",
    "camera_view_proj", "__version__",
    "TerrainSpike", "Scene",
    "dem_stats", "dem_normalize",
    "grid_generate", "generate_grid",
    "enumerate_adapters", "device_probe",
    "render_spike_frames",
]

# Static-typing surface (PEP 561: see py.typed). The reference ships editor
# signatures the same way (python/vulkan_forge/__init__.py:182-197); these
# annotate the runtime functions above for type checkers only.
from typing import TYPE_CHECKING as _TYPE_CHECKING

if _TYPE_CHECKING:
    from typing import Tuple as _Tuple

    import numpy as _np

    def grid_generate(  # noqa: F811 (typing overlay of the runtime fn)
        nx: int,
        nz: int,
        spacing: "_Tuple[float, float]" = (1.0, 1.0),
        origin: str = "center",
    ) -> "_Tuple[_np.ndarray, _np.ndarray, _np.ndarray]": ...

    generate_grid = grid_generate

    def render_triangle_rgba(width: int, height: int) -> "_np.ndarray": ...
    def render_triangle_png(path: str, width: int, height: int) -> None: ...
    def make_terrain(width: int, height: int, grid: int = 128) -> "TerrainSpike": ...
