"""The ``Renderer`` API object.

Behavior parity with the reference Renderer pyclass (src/lib.rs:220-722):
same methods, defaults, and error strings. Differences by design:

  - The wgpu device/queue/encoder/readback machinery becomes jitted JAX
    pipelines (vulkan_forge._raster); "readback" is ``jax.device_get``.
  - ``render_rgba()`` / ``render_png()`` ARE implemented (the reference only
    planned them: ROADMAP.md:1367-1383, exercised by the env-gated
    tests/test_terrain_fs.py): they draw the uploaded terrain with the
    documented T3.2 pipeline (forward-difference normals, Reinhard tonemap,
    sRGB target), consuming set_sun/set_exposure -- which the reference
    Renderer stores but never consumes (src/lib.rs:440-475).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from . import _colormap, _dem, _mesh
from ._io import save_png_rgba
from ._uniforms import Globals, sun_dir_spherical, _normalize
from ._raster import pipeline as _pipeline

TEXTURE_FORMAT = "Rgba8UnormSrgb"


@dataclass
class TerrainData:
    """Parity: the TerrainData struct (src/lib.rs:870-879)."""
    width: int
    height: int
    spacing: Tuple[float, float]
    exaggeration: float
    colormap: str
    heights: np.ndarray  # row-major (height, width) f32, already * exaggeration


class Renderer:
    """Headless deterministic renderer (parity: src/lib.rs:220-722)."""

    def __init__(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        self._terrain: Optional[TerrainData] = None
        self._terrain_meta = _dem.TerrainMeta()
        self._height_tex: Optional[np.ndarray] = None  # device-side analog
        self._globals = Globals()
        self._globals_dirty = True
        self._last_metrics: Optional[dict] = None

    def render_metrics(self) -> dict:
        """Timing/size metrics of the last render (the reference planned
        this API but never shipped it, ROADMAP.md:504).

        Keys: render_ms (device compute incl. dispatch), readback_ms
        (device->host copy), total_ms, bytes (framebuffer readback size),
        width, height. None values if nothing rendered yet.
        """
        if self._last_metrics is None:
            return {"render_ms": None, "readback_ms": None, "total_ms": None,
                    "bytes": 0, "width": self.width, "height": self.height}
        return dict(self._last_metrics)

    def _record_metrics(self, render_ms: float, readback_ms: float) -> None:
        self._last_metrics = {
            "render_ms": render_ms,
            "readback_ms": readback_ms,
            "total_ms": render_ms + readback_ms,
            "bytes": self.width * self.height * 4,
            "width": self.width,
            "height": self.height,
        }
        # VF_TRACE=1 streams per-render stage metrics to stderr; any other
        # value is treated as a path to append JSON lines to (the tools'
        # JSON-artifact observability pattern, applied per frame).
        trace = os.environ.get("VF_TRACE")
        if trace:
            import json
            import sys
            line = json.dumps(self._last_metrics)
            if trace == "1":
                print(f"[vf-trace] {line}", file=sys.stderr)
            else:
                with open(trace, "a") as f:
                    f.write(line + "\n")

    # ---------------- triangle path ----------------

    def info(self) -> str:
        return f"Renderer {self.width}x{self.height}, format={TEXTURE_FORMAT}"

    def render_triangle_rgba(self) -> np.ndarray:
        """Render the fixed gradient triangle -> (H, W, 4) uint8."""
        import time
        import jax
        from . import _formats
        t0 = time.perf_counter()
        dev = _pipeline.render_triangle_u8(self.width, self.height,
                                           as_device=True)
        jax.block_until_ready(dev)
        t1 = time.perf_counter()
        img = _formats.u32_image_to_rgba_u8(jax.device_get(dev))
        t2 = time.perf_counter()
        self._record_metrics((t1 - t0) * 1e3, (t2 - t1) * 1e3)
        return img

    def render_triangle_png(self, path: str) -> None:
        save_png_rgba(str(path), self.render_triangle_rgba())

    # ---------------- terrain state ----------------

    def add_terrain(self, heightmap, spacing, exaggeration=1.0,
                    colormap="viridis") -> None:
        """Store a DEM (heights are multiplied by exaggeration at ingest,
        src/lib.rs:361-385); computes the percentile-clamped height range."""
        sx, sy = float(spacing[0]), float(spacing[1])
        if sx <= 0.0 or sy <= 0.0:
            raise RuntimeError("spacing components must be > 0")
        exaggeration = float(exaggeration)
        if exaggeration <= 0.0:
            raise RuntimeError("exaggeration must be > 0")

        a = heightmap
        if not (isinstance(a, np.ndarray) and a.ndim == 2
                and a.dtype in (np.float32, np.float64)):
            raise RuntimeError(
                "heightmap must be a 2-D NumPy array of dtype float32 or float64")
        if not a.flags["C_CONTIGUOUS"]:
            raise RuntimeError("heightmap must be C-contiguous (row-major)")
        h, w = a.shape
        if w == 0 or h == 0:
            raise RuntimeError("heightmap cannot be empty")

        heights = (a.astype(np.float32) * np.float32(exaggeration))

        self._terrain_meta.compute_and_store_h_range(heights.reshape(-1))

        if colormap not in _colormap.SUPPORTED:
            raise _colormap.unknown_colormap_error(colormap)

        self._terrain = TerrainData(
            width=w, height=h, spacing=(sx, sy), exaggeration=exaggeration,
            colormap=str(colormap), heights=heights)

    def _require_terrain(self) -> TerrainData:
        if self._terrain is None:
            raise RuntimeError("no terrain uploaded; call add_terrain() first")
        return self._terrain

    def terrain_stats(self):
        """(min, max, mean, std) of stored (exaggerated) heights."""
        terr = self._require_terrain()
        return _dem.dem_stats_from_slice(terr.heights)

    def set_height_range(self, min: float, max: float) -> None:
        self._terrain_meta.set_height_range(min, max)

    def set_sun(self, elevation_deg: float, azimuth_deg: float) -> None:
        """Sun by spherical degrees (parity: src/lib.rs:455-463)."""
        if not (math.isfinite(float(elevation_deg)) and math.isfinite(float(azimuth_deg))):
            raise ValueError("angles must be finite")
        self._globals.sun_dir = sun_dir_spherical(elevation_deg, azimuth_deg)
        self._globals_dirty = True

    def set_exposure(self, exposure: float) -> None:
        e = float(exposure)
        if not math.isfinite(e) or e <= 0.0:
            raise ValueError("exposure must be > 0")
        self._globals.exposure = e
        self._globals_dirty = True

    def normalize_terrain(self, mode: str, range=None, eps=None) -> None:
        terr = self._require_terrain()
        mode_l = str(mode).lower()
        if mode_l not in ("minmax", "zscore"):
            raise RuntimeError("mode must be 'minmax' or 'zscore'")
        eps = 1e-8 if eps is None else float(eps)
        range = (0.0, 1.0) if range is None else (float(range[0]), float(range[1]))
        stats = _dem.dem_stats_from_slice(terr.heights)
        terr.heights = _dem.normalize_in_place(terr.heights, mode_l, eps, range, stats)

    # ---------------- height texture path ----------------

    def upload_height_r32f(self) -> None:
        """Upload the stored heights as the device height texture.

        The R32Float texture (src/lib.rs:495-571) is just an (H, W)
        float32 device array; 256-byte row padding is unnecessary, and the
        roundtrip is exact by construction.
        """
        terr = self._require_terrain()
        if terr.width == 0 or terr.height == 0:
            raise RuntimeError("terrain dimensions are zero")
        import jax
        self._height_tex = jax.device_put(
            np.ascontiguousarray(terr.heights.reshape(terr.height, terr.width)))

    def debug_read_height_patch(self, x: int, y: int, w: int, h: int) -> np.ndarray:
        """Read back an (h, w) float32 patch (parity: src/lib.rs:573-666)."""
        x, y, w, h = int(x), int(y), int(w), int(h)
        if w == 0 or h == 0:
            raise RuntimeError("patch dimensions must be > 0")
        if self._height_tex is None:
            return np.zeros((h, w), dtype=np.float32)
        th, tw = self._height_tex.shape
        if x + w > tw:
            raise RuntimeError(
                f"requested patch exceeds texture bounds in x: x+w ({x + w}) > width ({tw})")
        if y + h > th:
            raise RuntimeError(
                f"requested patch exceeds texture bounds in y: y+h ({y + h}) > height ({th})")
        import jax
        return np.asarray(jax.device_get(self._height_tex[y:y + h, x:x + w]),
                          dtype=np.float32)

    def read_full_height_texture(self) -> np.ndarray:
        terr = self._require_terrain()
        if self._height_tex is None:
            raise RuntimeError(
                "no height texture uploaded; call upload_height_r32f() first")
        return self.debug_read_height_patch(0, 0, terr.width, terr.height)

    # ---------------- terrain draw (documented T3.2/T4.x pipeline) ----------------

    def _default_terrain_camera(self, terr: TerrainData):
        """Symmetric framing camera for render_rgba().

        The reference never shipped a Renderer camera API; the documented
        plan draws the DEM with sun/exposure globals (ROADMAP.md:1352-1383).
        We frame the centered grid from the -X side at 45deg elevation: with
        look_at_rh the camera-right axis is then +Z, which is the sun's
        azimuth-90 direction (azimuth 0 = +X, CCW toward +Z,
        src/lib.rs:443-450) -- so "east" sun lights screen-right slopes, the
        semantics the directional-lighting test pins (tests/test_terrain_fs.py).
        """
        from ._camera import look_at_rh, perspective_wgpu
        extent_x = (terr.width - 1) * terr.spacing[0]
        extent_z = (terr.height - 1) * terr.spacing[1]
        extent = max(extent_x, extent_z, 1e-3)
        eye = (-0.9 * extent, 0.9 * extent, 0.0)
        view = look_at_rh(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
        aspect = np.float32(self.width) / np.float32(self.height)
        dist = math.sqrt(2.0) * 0.9 * extent
        proj = perspective_wgpu(np.float32(math.radians(45.0)), aspect,
                                np.float32(max(dist * 1e-3, 1e-3)),
                                np.float32(dist * 10.0 + 10.0))
        # Pan by half a pixel in NDC so the terrain center projects to the
        # CENTER of pixel (W//2, H//2) instead of the corner between pixels;
        # otherwise probes at cx+/-dx straddle the scene center asymmetrically
        # by a full pixel and a static color gradient swamps directional
        # lighting comparisons.
        shift = np.eye(4, dtype=np.float32)
        shift[0, 3] = 1.0 / np.float32(self.width)
        shift[1, 3] = -1.0 / np.float32(self.height)
        proj = (shift @ proj).astype(np.float32)
        return view, proj

    def _draw_args(self):
        """(args, kwargs) of the ``render_terrain_u8`` call render_rgba makes."""
        terr = self._require_terrain()
        xy, uv, idx = _mesh.make_grid(terr.width, terr.height,
                                      terr.spacing[0], terr.spacing[1])
        xyuv = np.concatenate([xy, uv], axis=1).astype(np.float32)
        # make_grid winds CCW in plane-XY (src/terrain/mesh.rs:71), but the
        # terrain world mapping (x, h, y_plane->z) mirrors orientation, so
        # flip to front-facing for the CCW+backcull pipeline (the analytic
        # spike grid bakes this flip into its own index order,
        # src/terrain/mod.rs:582 [a,c,b] vs mesh.rs [i0,i1,i2]).
        tris = np.asarray(idx, dtype=np.int32).reshape(-1, 3)[:, [0, 2, 1]]
        view, proj = self._default_terrain_camera(terr)
        lut, _fmt = _colormap.build_lut(terr.colormap)
        heights = (self._height_tex if self._height_tex is not None
                   else terr.heights.reshape(terr.height, terr.width))
        # Heights were pre-multiplied by exaggeration at ingest and the mesh
        # is already in world units, so spacing/exaggeration enter the vertex
        # stage as 1; the true DEM spacing only scales the normals' slope.
        return ((xyuv, tris, heights, view, proj),
                dict(spacing=1.0, exaggeration=1.0,
                     normal_spacing=float(terr.spacing[0]),
                     h_min=self._terrain_meta.h_min,
                     h_max=self._terrain_meta.h_max,
                     exposure=self._globals.exposure,
                     sun_dir=self._globals.sun_dir,
                     lut=lut, width=self.width, height=self.height,
                     fs_mode="extended"))

    def render_rgba(self) -> np.ndarray:
        """Draw the uploaded terrain -> (H, W, 4) uint8.

        Implements the documented pipeline the reference left as T3.2/C6
        future work: grid mesh from the DEM, forward-difference normals,
        Lambert + ambient floor, Reinhard tonemap in linear, sRGB encode.
        """
        import time
        import jax
        from . import _formats
        args, kwargs = self._draw_args()
        t0 = time.perf_counter()
        dev = _pipeline.render_terrain_u8(*args, as_device=True, **kwargs)
        jax.block_until_ready(dev)
        t1 = time.perf_counter()
        img = _formats.u32_image_to_rgba_u8(jax.device_get(dev))
        t2 = time.perf_counter()
        self._record_metrics((t1 - t0) * 1e3, (t2 - t1) * 1e3)
        return img

    def render_png(self, path: str) -> None:
        save_png_rgba(str(path), self.render_rgba())
