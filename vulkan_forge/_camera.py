"""Camera math: right-handed, Y-up, -Z forward view/projection matrices.

Semantics parity with the reference camera module (src/camera.rs:14-240):
  - ``camera_look_at`` is glam's ``Mat4::look_at_rh``.
  - ``camera_perspective`` starts from glam's ``perspective_rh_gl`` ([-1,1] Z)
    and, for clip_space='wgpu', pre-multiplies the GL->WGPU depth remap that
    maps Z from [-1,1] to [0,1] (src/camera.rs:14-21).
  - All validators raise RuntimeError with the exact reference strings
    (src/camera.rs:24-30).

All math is float32 (the reference uses glam's f32 vectors/matrices) and all
returned matrices are C-contiguous (4,4) float32 in row-major mathematical
convention (src/camera.rs:94-112 converts glam's column-major storage the
same way).

This module is pure host math: it never touches the device. The renderer
consumes these matrices inside its jitted pipeline.
"""
from __future__ import annotations

import math

import numpy as np

# Exact reference error strings (src/camera.rs:24-30).
ERROR_FOVY = "fovy_deg must be finite and in (0, 180)"
ERROR_NEAR = "znear must be finite and > 0"
ERROR_FAR = "zfar must be finite and > znear"
ERROR_ASPECT = "aspect must be finite and > 0"
ERROR_VECFINITE = "eye/target/up components must be finite"
ERROR_UPCOLINEAR = "up vector must not be colinear with view direction"
ERROR_CLIP = "clip_space must be 'wgpu' or 'gl'"

_f32 = np.float32


def _vec3(v) -> np.ndarray:
    a = np.asarray(v, dtype=np.float32).reshape(3)
    return a


def _validate_vec3_finite(v: np.ndarray) -> None:
    if not np.all(np.isfinite(v)):
        raise RuntimeError(ERROR_VECFINITE)


def _validate_fovy(fovy_deg: float) -> None:
    f = float(fovy_deg)
    if not math.isfinite(f) or f <= 0.0 or f >= 180.0:
        raise RuntimeError(ERROR_FOVY)


def _validate_near(znear: float) -> None:
    z = float(znear)
    if not math.isfinite(z) or z <= 0.0:
        raise RuntimeError(ERROR_NEAR)


def _validate_far(zfar: float, znear: float) -> None:
    z = float(zfar)
    if not math.isfinite(z) or z <= float(znear):
        raise RuntimeError(ERROR_FAR)


def _validate_aspect(aspect: float) -> None:
    a = float(aspect)
    if not math.isfinite(a) or a <= 0.0:
        raise RuntimeError(ERROR_ASPECT)


def _validate_clip_space(clip_space: str) -> None:
    if clip_space not in ("wgpu", "gl"):
        raise RuntimeError(ERROR_CLIP)


def _normalize_or_zero(v: np.ndarray) -> np.ndarray:
    n = np.sqrt(np.sum(v.astype(np.float32) * v, dtype=np.float32))
    if n <= 0.0 or not np.isfinite(n):
        return np.zeros(3, dtype=np.float32)
    return (v / n).astype(np.float32)


def _validate_up_not_colinear(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> None:
    view_dir = _normalize_or_zero(target - eye)
    up_norm = _normalize_or_zero(up)
    cross = np.cross(view_dir, up_norm).astype(np.float32)
    if float(np.dot(cross, cross)) < 1e-6:
        raise RuntimeError(ERROR_UPCOLINEAR)


def validate_camera_params(eye, target, up, fovy_deg, znear, zfar) -> None:
    """Shared validator (parity: src/camera.rs:224-240, same check order)."""
    e, t, u = _vec3(eye), _vec3(target), _vec3(up)
    _validate_vec3_finite(e)
    _validate_vec3_finite(t)
    _validate_vec3_finite(u)
    _validate_up_not_colinear(e, t, u)
    _validate_fovy(fovy_deg)
    _validate_near(znear)
    _validate_far(zfar, znear)


def look_at_rh(eye, target, up) -> np.ndarray:
    """glam Mat4::look_at_rh, row-major (4,4) float32 (unvalidated core)."""
    e, t, u = _vec3(eye), _vec3(target), _vec3(up)
    f = _normalize_or_zero(t - e)           # forward
    s = _normalize_or_zero(np.cross(f, u).astype(np.float32))  # side
    uu = np.cross(s, f).astype(np.float32)  # true up
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = uu
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, e)
    m[1, 3] = -np.dot(uu, e)
    m[2, 3] = np.dot(f, e)
    m[3, 3] = 1.0
    return np.ascontiguousarray(m, dtype=np.float32)


def perspective_rh_gl(fovy_rad: float, aspect: float, znear: float, zfar: float) -> np.ndarray:
    """glam Mat4::perspective_rh_gl ([-1,1] Z), row-major float32."""
    fovy_rad = _f32(fovy_rad)
    aspect = _f32(aspect)
    znear = _f32(znear)
    zfar = _f32(zfar)
    inv_length = _f32(1.0) / (znear - zfar)
    f = _f32(1.0) / _f32(math.tan(float(_f32(0.5) * fovy_rad)))
    a = f / aspect
    b = (znear + zfar) * inv_length
    c = (_f32(2.0) * znear * zfar) * inv_length
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = a
    m[1, 1] = f
    m[2, 2] = b
    m[2, 3] = c
    m[3, 2] = _f32(-1.0)
    return m


def gl_to_wgpu() -> np.ndarray:
    """GL->WGPU depth remap: Z [-1,1] -> [0,1] (src/camera.rs:14-21)."""
    m = np.eye(4, dtype=np.float32)
    m[2, 2] = 0.5
    m[2, 3] = 0.5
    return m


def perspective_wgpu(fovy_rad: float, aspect: float, znear: float, zfar: float) -> np.ndarray:
    """WGPU-clip-space perspective (src/camera.rs:218-221)."""
    return (gl_to_wgpu() @ perspective_rh_gl(fovy_rad, aspect, znear, zfar)).astype(np.float32)


# ---------------- Public API functions ----------------

def camera_look_at(eye, target, up) -> np.ndarray:
    """View matrix using RH, Y-up, -Z forward (parity: src/camera.rs:117-135)."""
    e, t, u = _vec3(eye), _vec3(target), _vec3(up)
    _validate_vec3_finite(e)
    _validate_vec3_finite(t)
    _validate_vec3_finite(u)
    _validate_up_not_colinear(e, t, u)
    return look_at_rh(e, t, u)


def camera_perspective(fovy_deg, aspect, znear, zfar, clip_space: "str | None" = "wgpu") -> np.ndarray:
    """Perspective projection matrix (parity: src/camera.rs:140-169)."""
    clip_space = "wgpu" if clip_space is None else clip_space
    _validate_fovy(fovy_deg)
    _validate_aspect(aspect)
    _validate_near(znear)
    _validate_far(zfar, znear)
    _validate_clip_space(clip_space)
    fovy_rad = _f32(math.radians(float(fovy_deg)))
    proj_gl = perspective_rh_gl(fovy_rad, aspect, znear, zfar)
    if clip_space == "gl":
        return np.ascontiguousarray(proj_gl)
    return np.ascontiguousarray((gl_to_wgpu() @ proj_gl).astype(np.float32))


def camera_view_proj(eye, target, up, fovy_deg, aspect, znear, zfar,
                     clip_space: "str | None" = "wgpu") -> np.ndarray:
    """Combined projection @ view (parity: src/camera.rs:174-215)."""
    clip_space = "wgpu" if clip_space is None else clip_space
    e, t, u = _vec3(eye), _vec3(target), _vec3(up)
    _validate_vec3_finite(e)
    _validate_vec3_finite(t)
    _validate_vec3_finite(u)
    _validate_up_not_colinear(e, t, u)
    _validate_fovy(fovy_deg)
    _validate_aspect(aspect)
    _validate_near(znear)
    _validate_far(zfar, znear)
    _validate_clip_space(clip_space)
    view = look_at_rh(e, t, u)
    fovy_rad = _f32(math.radians(float(fovy_deg)))
    proj_gl = perspective_rh_gl(fovy_rad, aspect, znear, zfar)
    proj = proj_gl if clip_space == "gl" else (gl_to_wgpu() @ proj_gl).astype(np.float32)
    return np.ascontiguousarray((proj @ view).astype(np.float32))
