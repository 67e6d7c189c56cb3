"""Raster core unit tests: the Triton list kernel agrees byte-exactly with
the jnp reference raster (tiles.py), winding/cull rules, binning
determinism, sRGB curves. These are the analog of the reference's
cross-backend identity checks (python/tools/backends_runner.py).

Without a GPU the kernel runs through the Pallas interpreter (the
``interpret_kernel`` fixture); ``test_list_kernel_compiled_matches_reference``
runs it as Triton compiles it, on the card (``gpu`` marker).
"""
import numpy as np
import pytest

import vulkan_forge as vf
from vulkan_forge._raster import pipeline


def _render(obj, backend):
    """obj.render_rgba() with the raster stage forced: "jnp" (reference)
    or "pallas" (the Triton kernel; through the Pallas interpreter under
    the ``interpret_kernel`` fixture)."""
    args, kwargs = obj._draw_args()
    return pipeline.render_terrain_u8(*args, backend=backend, **kwargs)


def test_triangle_backends_identical(interpret_kernel):
    a = pipeline.render_triangle_u8(96, 64, backend="jnp")
    b = pipeline.render_triangle_u8(96, 64, backend="pallas")
    np.testing.assert_array_equal(a, b)


def test_terrain_backends_identical(interpret_kernel):
    h = (np.outer(np.linspace(0, 1, 32), np.linspace(0, 1, 32))).astype(np.float32)
    s = vf.Scene(160, 120, 32, "terrain")
    s.set_height_from_r32f(h)
    np.testing.assert_array_equal(_render(s, "jnp"), _render(s, "pallas"))


def test_hw_fill_rule_backends_identical(monkeypatch, interpret_kernel):
    # VF_FILL_RULE=hw must produce identical pixels on the list kernel
    # (records carry the bias columns) and the jnp oracle.
    h = (np.outer(np.sin(np.linspace(0, 2, 32)),
                  np.cos(np.linspace(0, 3, 32)))).astype(np.float32)
    s = vf.Scene(160, 120, 32, "viridis")
    s.set_height_from_r32f(h)
    monkeypatch.setenv("VF_FILL_RULE", "hw")
    ref = _render(s, "jnp")
    np.testing.assert_array_equal(ref, _render(s, "pallas"))
    # and the rule actually differs from the shipped inclusive rule
    monkeypatch.setenv("VF_FILL_RULE", "inclusive")
    assert not np.array_equal(ref, _render(s, "jnp"))


def test_triangle_golden_properties():
    img = pipeline.render_triangle_u8(256, 256)
    # Clear is white (src/lib.rs:19) and the sRGB encode of 1.0 is 255.
    assert np.all(img[0, :] == 255)
    assert np.all(img[:, 0] == 255)
    # Alpha is 1 everywhere.
    assert np.all(img[..., 3] == 255)
    # Vertex colors: v0 red at bottom-left, v1 green at bottom-right,
    # v2 blue at top-center (NDC y up => framebuffer y down).
    h, w = 256, 256
    bl = img[int(0.9 * h) - 3, int(0.1 * w) + 3]
    br = img[int(0.9 * h) - 3, int(0.9 * w) - 3]
    tc = img[int(0.1 * h) + 3, w // 2]
    assert bl[0] > bl[1] and bl[0] > bl[2]   # red corner
    assert br[1] > br[0] and br[1] > br[2]   # green corner
    assert tc[2] > tc[0] and tc[2] > tc[1]   # blue apex
    # Roughly symmetric in x (red/green corners mirror).
    mid = img[h // 2]
    np.testing.assert_allclose(mid[:, 0].astype(int),
                               mid[::-1, 1].astype(int), atol=2)


def test_backface_culling():
    # Reversing the winding of the fixed triangle must cull it entirely:
    # front_face=CCW + cull_mode=Back (src/lib.rs:120-121).
    import jax.numpy as jnp
    from vulkan_forge._raster import fragment, tiles, transform
    from vulkan_forge._raster.setup import bin_triangles, clip_to_fb, triangle_setup

    pos = jnp.asarray(pipeline._TRI_POS)
    col = jnp.asarray(pipeline._TRI_COLOR)
    clip, colors = transform.triangle_vs(pos, col)
    x, y, _z, w = clip_to_fb(clip, 64, 64)
    rev = jnp.array([[0, 2, 1]], jnp.int32)  # flipped winding
    records, bbox = triangle_setup(x, y, _z, w, colors, rev, 64, 64)
    binning = bin_triangles(bbox, 64, 64, capacity=8)
    v0, v1, v2, mask = tiles.render_gbuffer(records, binning.tile_lists, 64, 64)
    assert not bool(np.asarray(mask).any())


@pytest.mark.gpu
def test_adjacent_triangles_no_cracks_no_overdraw_gaps():
    # Two triangles sharing a diagonal must cover every pixel of the quad
    # interior with no holes (watertightness along the shared edge).
    # Device-dependent: the inclusive f32 rule evaluates the shared edge
    # from a different anchor vertex in each triangle, so its rounding
    # can leave both sides slightly negative. XLA:CPU cracks 38 diagonal
    # pixels here; the exact top-left rule (VF_FILL_RULE=hw) is the
    # watertight one on every device (test_fillrule.py).
    import jax.numpy as jnp
    from vulkan_forge._raster import tiles, transform
    from vulkan_forge._raster.setup import bin_triangles, clip_to_fb, triangle_setup

    quad = jnp.array([[-0.9, -0.9], [0.9, -0.9], [-0.9, 0.9], [0.9, 0.9]],
                     jnp.float32)
    cols = jnp.ones((4, 3), jnp.float32)
    clip, colors = transform.triangle_vs(quad, cols)
    x, y, _z, w = clip_to_fb(clip, 128, 128)
    # CCW in NDC: (0,1,2) and (2,1,3)
    idx = jnp.array([[0, 1, 2], [2, 1, 3]], jnp.int32)
    records, bbox = triangle_setup(x, y, _z, w, colors, idx, 128, 128)
    # Screen-sized triangles: span must cover the whole tile grid (the
    # production paths size spans from tile_span_max).
    binning = bin_triangles(bbox, 128, 128, capacity=8, span_x=1, span_y=16)
    _, _, _, mask = tiles.render_gbuffer(records, binning.tile_lists, 128, 128)
    m = np.asarray(mask)
    # interior of the quad: fb x in [~6.4, ~121.6] -> rows/cols 7..121
    assert m[7:121, 7:121].all()
    assert not m[0:5, :].any() and not m[:, 0:5].any()


def test_binning_counts_and_order():
    import jax.numpy as jnp
    from vulkan_forge._raster.setup import bin_triangles, tile_counts

    # Three bboxes: one in tile (0,0), one spanning two x-tiles, one invalid.
    bbox = jnp.array([
        [0, 10, 0, 3],        # tile (0,0) only
        [120, 140, 0, 3],     # tiles (0,0) and (0,1) with tile_w=128
        [256, -1, 8, -1],     # empty (culled) encoding
    ], jnp.int32)
    counts = tile_counts(bbox, width=256, height=16)
    b = bin_triangles(bbox, width=256, height=16, capacity=8)
    counts = np.asarray(counts)
    lists = np.asarray(b.tile_lists)
    assert counts[0] == 2 and counts[1] == 1
    assert lists[0, 0] == 0 and lists[0, 1] == 1   # ascending ids
    assert lists[1, 0] == 1
    assert np.all(lists[0, 2:] == 3)               # sentinel = T


def test_srgb_curves_match_reference_constants():
    from vulkan_forge._formats import srgb_decode_np, srgb_encode_np, to_u8_np
    x = np.linspace(0, 1, 1024, dtype=np.float32)
    # decode(encode(x)) == x to fp precision
    np.testing.assert_allclose(srgb_decode_np(srgb_encode_np(x)), x, atol=2e-6)
    # Known anchor: linear 0.5 encodes to ~188/255
    assert to_u8_np(srgb_encode_np(np.float32(0.5))) == 188
    # Clear colors as stored by the sRGB target
    assert to_u8_np(srgb_encode_np(np.float32(0.02))) == 39
    assert to_u8_np(srgb_encode_np(np.float32(0.03))) == 48


def test_clear_color_pixels_exact():
    s = vf.Scene(64, 48, grid=4)
    img = s.render_rgba()
    # Top rows are background: sRGB-encoded (0.02, 0.02, 0.03, 1).
    assert tuple(img[0, 0]) == (39, 39, 48, 255)


def test_lut_bilinear_vs_cpu_reference():
    import jax.numpy as jnp
    from vulkan_forge._colormap import build_lut
    from vulkan_forge._raster.fragment import sample_lut_bilinear

    lut, _ = build_lut("viridis")
    t = np.linspace(0, 1, 97, dtype=np.float32)
    got = np.asarray(sample_lut_bilinear(jnp.asarray(lut), jnp.asarray(t)))

    # CPU reference of clamp-to-edge bilinear filtering on a 256x1 texture.
    xf = t * 256.0 - 0.5
    x0 = np.floor(xf)
    frac = (xf - x0)[:, None]
    i0 = np.clip(x0, 0, 255).astype(int)
    i1 = np.clip(x0 + 1, 0, 255).astype(int)
    ref = lut[i0] * (1 - frac) + lut[i1] * frac
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_extended_fs_list_kernel_matches_oracle(interpret_kernel):
    """The extended fragment pipeline (Renderer.render_rgba's mode) on the
    list kernel byte-matches the jnp oracle route."""
    h = (np.outer(np.linspace(0, 1, 24), np.linspace(1, 0, 24)) * 30
         ).astype(np.float32)
    r = vf.Renderer(160, 120)
    r.add_terrain(h, (5.0, 5.0), 1.0, "magma")
    r.set_sun(40.0, 210.0)
    np.testing.assert_array_equal(_render(r, "pallas"), _render(r, "jnp"))


@pytest.mark.parametrize("wh", [(130, 57), (64, 100), (257, 9)])
def test_raster_odd_shapes_vs_bruteforce(wh):
    """Odd framebuffer shapes (partial tiles on both axes) vs a
    brute-force per-pixel evaluator: crop/padding edge cases."""
    import jax
    import jax.numpy as jnp
    from vulkan_forge._raster import tiles
    from vulkan_forge._raster.setup import (bin_triangles, clip_to_fb,
                                            tile_counts, tile_span_max,
                                            triangle_setup)
    W, H = wh
    rng = np.random.default_rng(W * 1000 + H)
    n = 12
    v = rng.uniform(-1.1, 1.1, (n * 3, 2))
    clip = np.concatenate([v, np.full((n * 3, 1), 0.5),
                           np.ones((n * 3, 1))], 1).astype(np.float32)
    attrs = rng.uniform(-2, 2, (n * 3, 3)).astype(np.float32)
    indices = np.arange(n * 3, dtype=np.int32).reshape(-1, 3)

    with jax.default_device(jax.devices("cpu")[0]):
        x, y, z, w = clip_to_fb(jnp.asarray(clip), W, H)
        records, bbox = triangle_setup(x, y, z, w, jnp.asarray(attrs),
                                       jnp.asarray(indices), W, H)
        cmax = int(tile_counts(bbox, W, H).max())
        sx, sy = tile_span_max(bbox, W, H)
        binning = bin_triangles(bbox, W, H, max(cmax, 8),
                                span_x=pipeline._round_span(int(sx)),
                                span_y=pipeline._round_span(int(sy)))
        v0, v1, v2, mask = tiles.render_gbuffer(
            records, binning.tile_lists, W, H)

        # brute force: every pixel against every record, same f32 math
        rec = np.asarray(records)
        xs = (np.arange(W, dtype=np.float32) + 0.5)[None, :]
        ys = (np.arange(H, dtype=np.float32) + 0.5)[:, None]
        bid = np.full((H, W), -1, np.int32)
        bv0 = np.zeros((H, W), np.float32)
        for t in range(n):
            r = rec[t]
            f0 = np.float32(r[2]) * (xs - np.float32(r[0])) - np.float32(r[3]) * (ys - np.float32(r[1]))
            f1 = np.float32(r[6]) * (xs - np.float32(r[4])) - np.float32(r[7]) * (ys - np.float32(r[5]))
            f2 = np.float32(r[10]) * (xs - np.float32(r[8])) - np.float32(r[11]) * (ys - np.float32(r[9]))
            aw = f0 * r[21] + f1 * r[22] + f2 * r[23]
            az = f0 * r[25] + f1 * r[26] + f2 * r[27]
            asum = f0 * r[28] + f1 * r[29] + f2 * r[30]
            cov = ((f0 >= 0) & (f1 >= 0) & (f2 >= 0) & (r[24] > 0)
                   & (az >= 0) & (aw > 0) & (asum - az >= 0))
            a0 = f0 * r[12] + f1 * r[13] + f2 * r[14]
            val = np.where(np.abs(aw) < 1e-20, a0, a0 / np.where(
                np.abs(aw) < 1e-20, 1.0, aw))
            bid[cov] = t
            bv0[cov] = val[cov].astype(np.float32)

        np.testing.assert_array_equal(np.asarray(mask), bid >= 0)
        both = bid >= 0
        np.testing.assert_allclose(np.where(both, np.asarray(v0), 0),
                                   np.where(both, bv0, 0), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_terrain_backends_identical_random_cameras(seed, interpret_kernel):
    """Backend byte-identity under randomized cameras (fixed-camera tests
    can hide angle-dependent kernel bugs)."""
    rng = np.random.default_rng(seed)
    eye = rng.uniform([-4, 0.5, -4], [4, 3.5, 4])
    tgt = rng.uniform([-0.4, -0.3, -0.4], [0.4, 0.3, 0.4])
    h = rng.standard_normal((32, 32)).astype(np.float32) * 0.2
    s = vf.Scene(160, 120, 32, "magma")
    s.set_height_from_r32f(h)
    s.set_camera_look_at(tuple(eye), tuple(tgt), (0, 1, 0), 50.0, 0.1, 100.0)
    np.testing.assert_array_equal(_render(s, "jnp"), _render(s, "pallas"))
