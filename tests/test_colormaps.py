"""Colormap registry, LUT format selection, palette data (contract:
reference tests/test_colormap.py + src/colormap/mod.rs)."""
import os

import numpy as np
import pytest

import vulkan_forge as vf
from vulkan_forge import _colormap
from vulkan_forge._palettes import palette_srgb_rgba8


def test_supported_names():
    assert vf.colormap_supported() == ["viridis", "magma", "terrain"]


@pytest.mark.parametrize("name", ["viridis", "magma", "terrain", None])
def test_spike_accepts_each_colormap(name):
    if name is None:
        t = vf.TerrainSpike(64, 64, grid=8)
    else:
        t = vf.TerrainSpike(64, 64, grid=8, colormap=name)
    assert t is not None


@pytest.mark.parametrize("bad", ["invalid_colormap", "VIRIDIS", "MAGMA", "TERRAIN"])
def test_case_sensitive_and_unknown_rejected(bad):
    with pytest.raises(RuntimeError, match="Unknown colormap"):
        vf.TerrainSpike(64, 64, grid=8, colormap=bad)
    with pytest.raises(RuntimeError, match="Unknown colormap"):
        vf.Scene(64, 64, grid=8, colormap=bad)


def test_unknown_colormap_message_lists_supported():
    with pytest.raises(RuntimeError,
                       match="Unknown colormap 'nope'. Supported: viridis, magma, terrain"):
        vf.TerrainSpike(64, 64, grid=8, colormap="nope")


def test_renderer_add_terrain_colormap_validation():
    r = vf.Renderer(64, 64)
    hm = np.random.RandomState(0).rand(16, 16).astype(np.float32)
    for cm in ["viridis", "magma", "terrain"]:
        r.add_terrain(hm, (1.0, 1.0), 1.0, cm)
        assert len(r.terrain_stats()) == 4
    with pytest.raises(RuntimeError, match="Unknown colormap"):
        r.add_terrain(hm, (1.0, 1.0), 1.0, "invalid_colormap")


def test_lut_format_selection_env(monkeypatch):
    monkeypatch.delenv("VF_FORCE_LUT_UNORM", raising=False)
    t = vf.TerrainSpike(64, 64, grid=8)
    assert t.debug_lut_format() in ("Rgba8UnormSrgb", "Rgba8Unorm")
    assert t.debug_lut_format() == "Rgba8UnormSrgb"  # the device path supports sRGB
    monkeypatch.setenv("VF_FORCE_LUT_UNORM", "1")
    t2 = vf.TerrainSpike(64, 64, grid=8)
    assert t2.debug_lut_format() == "Rgba8Unorm"


def test_unorm_fallback_renders(tmp_path, monkeypatch):
    monkeypatch.setenv("VF_FORCE_LUT_UNORM", "1")
    t = vf.TerrainSpike(128, 128, grid=32)
    out = tmp_path / "unorm.png"
    t.render_png(str(out))
    assert out.stat().st_size > 1000


def test_unorm_quantization_changes_pixels(monkeypatch):
    monkeypatch.delenv("VF_FORCE_LUT_UNORM", raising=False)
    a = vf.TerrainSpike(160, 120, grid=32).render_rgba()
    monkeypatch.setenv("VF_FORCE_LUT_UNORM", "1")
    b = vf.TerrainSpike(160, 120, grid=32).render_rgba()
    # Linearized-u8 LUT is quantized; images are close but not identical.
    assert not np.array_equal(a, b)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 8


def test_palette_tables_shape_and_endpoints():
    for name in ["viridis", "magma", "terrain"]:
        p = palette_srgb_rgba8(name)
        assert p.shape == (256, 4) and p.dtype == np.uint8
        assert np.all(p[:, 3] == 255)
    terr = palette_srgb_rgba8("terrain")
    # custom ramp: deep blue -> white (data/generate_palettes.py)
    assert terr[0, 2] > terr[0, 0]      # blue at the bottom
    assert np.all(terr[255, :3] == 255)  # snow at the top


def test_to_linear_u8_roundtrip_properties():
    src = np.arange(256, dtype=np.uint8).repeat(4).reshape(256, 4)
    lin = _colormap.to_linear_u8_rgba(src)
    assert lin.shape == src.shape
    assert np.all(lin[:, 3] == src[:, 3])        # alpha untouched
    assert np.all(lin[:, 0] <= src[:, 0])        # decode darkens midtones
    assert lin[0, 0] == 0 and lin[255, 0] == 255
