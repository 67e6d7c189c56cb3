"""Pinned golden-image hashes.

The analog of the reference's goldens-in-tests/golden plan
(python/CLAUDE.md "Testing"): SHA-256 of raw RGBA bytes for fixed scenes,
identical across runs, processes, raster stages (the Triton list kernel
and the jnp reference are byte-identical) and code changes on the SAME
device class. Hashes are pinned PER DEVICE where they differ: the
terrain pipelines contain transcendentals (the shipped FS's analytic
sin/cos normals, the extended FS's rsqrt-fusable normalize) whose
implementations legitimately differ between XLA:GPU and XLA:CPU --
exactly as the reference's image differs across GPU vendors (its own
goldens are device-pinned too). "any" marks a scene whose bytes agree on
every device class measured. Any intentional change to the shading/raster
math must update these hashes explicitly (regenerate with
`python tests/test_goldens.py` ON EACH device class; on the GPU,
chip_smoke.py prints them).
"""
import hashlib

import numpy as np
import pytest

import jax

import vulkan_forge as vf

# name -> {device_class: sha256}; "any" = device-independent scene
GOLDEN = {
    "triangle_64x64": {
        "any": "17b914e0b79230e3ae5af70e3531cf1cec7ca7b66039b5ca68cc7b6adb0e3b96"},
    "triangle_97x61": {
        "any": "3c6acfe5a502df35a7b2a3485ef9a89302af7d8df9ef37db2c8c8553af827653"},
    "scene_magma_160x120_g32": {
        "any": "d83c1fb300de7c421569932a0cb20dd61f38f04a4a6143a31165928aa6c354db"},
    "spike_terrain_128x96_g16_cam": {
        "any": "fd0bab706d6f3e780385290a56006b9fe46d8fb35245b6852804ae541f01b333"},
    "renderer_extended_96x96": {
        "gpu": "7e727154697d0fd496d321479721bc8888b9e96150f595cdc93951a5bc974845",
        "cpu": "e6be6cf78b5231cdaa7ce8d521e2468fae85cede2f386dd515e8e7bcac4394e7"},
}


def _device_class() -> str:
    return "gpu" if jax.devices()[0].platform == "gpu" else "cpu"


import functools


@functools.lru_cache(maxsize=1)
def _render_all():
    h = (np.outer(np.sin(np.linspace(0, 3, 33)),
                  np.cos(np.linspace(0, 2, 45))) * 0.3).astype(np.float32)
    out = {}
    out["triangle_64x64"] = vf.render_triangle_rgba(64, 64)
    out["triangle_97x61"] = vf.render_triangle_rgba(97, 61)
    s = vf.Scene(160, 120, 32, "magma")
    s.set_height_from_r32f(h)
    out["scene_magma_160x120_g32"] = s.render_rgba()
    t = vf.TerrainSpike(128, 96, 16, "terrain")
    t.set_camera_look_at((2.0, 1.5, 2.5), (0, 0, 0), (0, 1, 0), 50.0, 0.1, 50.0)
    out["spike_terrain_128x96_g16_cam"] = t.render_rgba()
    r = vf.Renderer(96, 96)
    dem = (np.outer(np.linspace(0, 1, 32), np.linspace(0, 1, 48)) * 40).astype(np.float32)
    r.add_terrain(dem, (10.0, 12.0), 1.5, "viridis")
    r.set_sun(40.0, 135.0)
    r.set_exposure(1.2)
    out["renderer_extended_96x96"] = r.render_rgba()
    return out


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_hash(name):
    img = _render_all()[name]
    pins = GOLDEN[name]
    want = pins.get("any") or pins[_device_class()]
    assert hashlib.sha256(img.tobytes()).hexdigest() == want


if __name__ == "__main__":
    print(f"device class: {_device_class()}")
    for k, img in _render_all().items():
        print(f'    "{k}": "{hashlib.sha256(img.tobytes()).hexdigest()}",')
