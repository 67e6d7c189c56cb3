"""Height texture upload/readback (contract: reference
tests/test_height_upload.py -- exact f32 roundtrips incl. widths whose
row bytes are not 256-aligned, patch semantics, OOB errors)."""
import numpy as np
import pytest

import vulkan_forge as vf


def _ramp(shape, dtype=np.float32):
    h, w = shape
    return np.linspace(0.0, 1.0, num=h * w, dtype=dtype).reshape(h, w)


def test_full_and_patch_roundtrip():
    r = vf.Renderer(32, 32)
    hm = _ramp((5, 5))
    r.add_terrain(hm, (1.0, 1.0), 1.0, colormap="terrain")

    with pytest.raises(RuntimeError, match="no height texture uploaded"):
        r.read_full_height_texture()

    r.upload_height_r32f()
    full = r.read_full_height_texture()
    assert full.shape == (5, 5)
    patch = r.debug_read_height_patch(1, 1, 3, 3)
    assert patch.shape == (3, 3)
    np.testing.assert_allclose(full[1:4, 1:4], patch, atol=1e-6)

    r.upload_height_r32f()  # idempotent
    np.testing.assert_allclose(full, r.read_full_height_texture(), atol=0.0)


def test_patch_before_upload_returns_zeros():
    r = vf.Renderer(8, 8)
    z = r.debug_read_height_patch(0, 0, 4, 2)
    assert z.shape == (2, 4) and z.dtype == np.float32
    assert np.all(z == 0.0)


def test_patch_validation():
    r = vf.Renderer(8, 8)
    hm = _ramp((4, 4))
    r.add_terrain(hm, (1.0, 1.0), 1.0, "viridis")
    r.upload_height_r32f()
    with pytest.raises(RuntimeError, match="patch dimensions must be > 0"):
        r.debug_read_height_patch(0, 0, 0, 2)
    with pytest.raises(RuntimeError, match=r"x\+w \(5\) > width \(4\)"):
        r.debug_read_height_patch(2, 0, 3, 4)
    with pytest.raises(RuntimeError, match=r"y\+h \(5\) > height \(4\)"):
        r.debug_read_height_patch(0, 2, 4, 3)


def test_upload_requires_terrain():
    r = vf.Renderer(32, 32)
    with pytest.raises(RuntimeError, match=r"no terrain uploaded; call add_terrain\(\) first"):
        r.upload_height_r32f()


@pytest.mark.parametrize("shape", [(5, 7), (48, 64), (3, 255), (33, 33), (17, 61)])
def test_roundtrip_various_sizes_exact(shape):
    h, w = shape
    r = vf.Renderer(max(w, 16), max(h, 16))
    hm = (np.arange(w * h, dtype=np.float32).reshape(h, w) / (w * h))
    r.add_terrain(hm, (1.0, 1.0), 1.0, "viridis")
    r.upload_height_r32f()
    back = r.read_full_height_texture()
    assert back.shape == (h, w)
    np.testing.assert_array_equal(back, hm)  # bit-exact on the device path


def test_add_terrain_validation_messages():
    r = vf.Renderer(8, 8)
    ok = _ramp((4, 4))
    with pytest.raises(RuntimeError, match="spacing components must be > 0"):
        r.add_terrain(ok, (0.0, 1.0), 1.0, "viridis")
    with pytest.raises(RuntimeError, match="exaggeration must be > 0"):
        r.add_terrain(ok, (1.0, 1.0), 0.0, "viridis")
    with pytest.raises(RuntimeError, match="float32 or float64"):
        r.add_terrain(ok.astype(np.int32), (1.0, 1.0), 1.0, "viridis")
    with pytest.raises(RuntimeError, match="float32 or float64"):
        r.add_terrain(np.zeros(5, np.float32), (1.0, 1.0), 1.0, "viridis")
    with pytest.raises(RuntimeError, match="C-contiguous"):
        r.add_terrain(np.asfortranarray(_ramp((4, 5))), (1.0, 1.0), 1.0, "viridis")
    with pytest.raises(RuntimeError, match="Unknown colormap"):
        r.add_terrain(ok, (1.0, 1.0), 1.0, "plasma")


def test_float64_accepted_and_exaggeration_applied_at_ingest():
    r = vf.Renderer(8, 8)
    hm = _ramp((3, 3), np.float64)
    r.add_terrain(hm, (1.0, 1.0), 3.0, "viridis")
    mn, mx, _, _ = r.terrain_stats()
    assert mn == pytest.approx(0.0) and mx == pytest.approx(3.0)


def test_dirty_flag_normalize_then_reupload():
    """Reference tests/test_height_upload.py::test_dirty_flag_behavior:
    re-upload without changes is a no-op; normalize_terrain invalidates the
    stored heights so the next upload reflects the new values."""
    r = vf.Renderer(16, 16)
    hm = _ramp((4, 4))
    r.add_terrain(hm, (1.0, 1.0), 1.0, colormap="viridis")
    r.upload_height_r32f()
    before = r.read_full_height_texture().copy()

    r.upload_height_r32f()
    np.testing.assert_allclose(before, r.read_full_height_texture(), atol=0.0)

    r.normalize_terrain("minmax", range=(10.0, 20.0), eps=None)
    r.upload_height_r32f()
    after = r.read_full_height_texture()
    assert after.shape == before.shape
    assert after.min() >= 9.99 and after.max() <= 20.01
    assert not np.allclose(before, after)
