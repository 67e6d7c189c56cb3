"""Near/far-plane clipping vs an independent f64 Sutherland-Hodgman oracle.

The renderer rasterizes the clipped region of each triangle directly from
the original triangle's records (setup.py "Near-plane clipping"); the
hardware it models clips geometry against the WebGPU clip volume
(0 <= z <= w) before rasterization (wgpu fixed function, implied by
src/terrain/pipeline.rs:107-140). This oracle takes the hardware route
instead -- homogeneous Sutherland-Hodgman clipping, fan triangulation, and
plain all-w-positive rasterization in float64 -- so agreement is evidence
the record-based formulation is right, not a self-comparison.

Comparison is exact away from region boundaries; pixels whose 3x3
neighborhood touches an oracle coverage/winner change are excluded (f32 vs
f64 boundary rounding), as hardware itself only promises watertightness,
not a particular side, there.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

W, H = 160, 120
EPS_W = 1e-8


def _perspective(fovy_deg=60.0, aspect=W / H, near=0.3, far=20.0):
    f = 1.0 / np.tan(np.radians(fovy_deg) / 2)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far / (near - far)
    m[2, 3] = near * far / (near - far)
    m[3, 2] = -1.0
    return m


def _gen_scene(seed, n_tris=50):
    """Random view-space triangles straddling the camera/near plane."""
    rng = np.random.default_rng(seed)
    proj = _perspective()
    v = np.empty((n_tris * 3, 3))
    # Cluster triangles so many cross z_view = -near or the camera plane.
    centers = rng.uniform([-2.0, -2.0, -4.0], [2.0, 2.0, 0.8], (n_tris, 3))
    spread = rng.uniform(0.3, 1.6, (n_tris, 1, 1))
    offs = rng.standard_normal((n_tris, 3, 3)) * spread
    v = (centers[:, None, :] + offs).reshape(-1, 3)
    hom = np.concatenate([v, np.ones((len(v), 1))], axis=1)
    clip = hom @ proj.T                          # (N, 4)
    tri_ids = np.arange(n_tris)
    attrs = np.stack([
        np.repeat(tri_ids, 3).astype(np.float64),          # winner id probe
        rng.uniform(-5, 5, n_tris * 3),
        rng.uniform(-5, 5, n_tris * 3),
    ], axis=1)                                   # (N, 3)
    indices = np.arange(n_tris * 3, dtype=np.int32).reshape(-1, 3)
    return clip, attrs, indices


# ---------------- f64 hardware-route oracle ----------------

def _clip_poly(verts, plane):
    """One S-H pass. verts: list of (clip4, attr3) f64; plane(v) >= 0 kept."""
    out = []
    n = len(verts)
    for i in range(n):
        a, aa = verts[i]
        b, ab = verts[(i + 1) % n]
        ha, hb = plane(a), plane(b)
        if ha >= 0:
            out.append((a, aa))
        if (ha >= 0) != (hb >= 0):
            t = ha / (ha - hb)
            out.append((a + t * (b - a), aa + t * (ab - aa)))
    return out


def _oracle_render(clip, attrs, indices):
    id_img = np.full((H, W), -1.0)
    a1_img = np.zeros((H, W))
    a2_img = np.zeros((H, W))
    xs = (np.arange(W) + 0.5)[None, :]
    ys = (np.arange(H) + 0.5)[:, None]
    for t, (i0, i1, i2) in enumerate(indices):
        poly = [(clip[i].astype(np.float64), attrs[i].astype(np.float64))
                for i in (i0, i1, i2)]
        for plane in (lambda v: v[2],              # z >= 0
                      lambda v: v[3] - v[2],       # z <= w
                      lambda v: v[3] - EPS_W):     # w > 0
            poly = _clip_poly(poly, plane)
            if len(poly) < 3:
                break
        if len(poly) < 3:
            continue
        # project
        pts = []
        for c, a in poly:
            x = (c[0] / c[3] * 0.5 + 0.5) * W
            y = (0.5 - c[1] / c[3] * 0.5) * H
            pts.append((x, y, 1.0 / c[3], a / c[3]))
        # clipped-poly orientation (hardware culls post-clip): front is CCW
        # in wgpu terms == negative shoelace area in y-down fb coords.
        area = 0.0
        for i in range(len(pts)):
            x0, y0 = pts[i][0], pts[i][1]
            x1, y1 = pts[(i + 1) % len(pts)][0], pts[(i + 1) % len(pts)][1]
            area += x0 * y1 - x1 * y0
        if area >= 0:
            continue
        for k in range(1, len(pts) - 1):
            for (xa, ya, rwa, aa), (xb, yb, rwb, ab), (xc, yc, rwc, ac) in [
                    (pts[0], pts[k], pts[k + 1])]:
                # Same negated-edge convention as setup.py: for front
                # (area2 < 0 in y-down coords) triangles the interior has
                # all three F >= 0 directly.
                f0 = ((yc - yb) * (xs - xb) - (xc - xb) * (ys - yb))
                f1 = ((ya - yc) * (xs - xc) - (xa - xc) * (ys - yc))
                f2 = ((yb - ya) * (xs - xa) - (xb - xa) * (ys - ya))
                cov = (f0 >= 0) & (f1 >= 0) & (f2 >= 0)
                if not cov.any():
                    continue
                aw = f0 * rwa + f1 * rwb + f2 * rwc
                with np.errstate(divide="ignore", invalid="ignore"):
                    v1 = (f0 * aa[1] + f1 * ab[1] + f2 * ac[1]) / aw
                    v2 = (f0 * aa[2] + f1 * ab[2] + f2 * ac[2]) / aw
                upd = cov & (aw > 0)
                id_img[upd] = t
                a1_img[upd] = v1[upd]
                a2_img[upd] = v2[upd]
    return id_img, a1_img, a2_img


# ---------------- renderer route ----------------

def _render(clip, attrs, indices):
    from vulkan_forge._raster import tiles
    from vulkan_forge._raster.setup import (bin_triangles, clip_to_fb,
                                            tile_counts, tile_span_max,
                                            triangle_setup)
    with jax.default_device(jax.devices("cpu")[0]):
        clip_j = jnp.asarray(clip, jnp.float32)
        x, y, z, w = clip_to_fb(clip_j, W, H)
        records, bbox = triangle_setup(
            x, y, z, w, jnp.asarray(attrs, jnp.float32),
            jnp.asarray(indices), W, H)
        cmax = int(tile_counts(bbox, W, H).max())
        sx, sy = tile_span_max(bbox, W, H)
        binning = bin_triangles(bbox, W, H, max(int(cmax), 8),
                                span_x=int(sx), span_y=int(sy))
        v0, v1, v2, mask = tiles.render_gbuffer(
            records, binning.tile_lists, W, H)
        return (np.asarray(v0), np.asarray(v1), np.asarray(v2),
                np.asarray(mask))


def _boundary_mask(id_img):
    """Pixels whose 3x3 neighborhood is not a uniform winner."""
    p = np.pad(id_img, 1, mode="edge")
    m = np.zeros(id_img.shape, bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            m |= p[1 + dy:H + 1 + dy, 1 + dx:W + 1 + dx] != id_img
    return m


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_clipped_raster_matches_sh_oracle(seed):
    clip, attrs, indices = _gen_scene(seed)
    oid, oa1, oa2 = _oracle_render(clip, attrs, indices)
    v0, v1, v2, mask = _render(clip, attrs, indices)

    rid = np.where(mask, np.rint(v0), -1.0)
    interior = ~_boundary_mask(oid)
    covered = oid >= 0

    # Winner agreement away from boundaries.
    sel = interior & covered
    assert sel.sum() > 400, "scene too degenerate to be meaningful"
    mism = sel & (rid != oid)
    assert mism.sum() == 0, (
        f"{mism.sum()} interior winner mismatches at {np.argwhere(mism)[:5]}")
    # No spurious coverage in the interior of uncovered space.
    ghost = interior & ~covered & mask
    assert ghost.sum() == 0, f"{ghost.sum()} ghost pixels"
    # Interpolated attributes agree (f32 vs f64 tolerance).
    np.testing.assert_allclose(v1[sel], oa1[sel], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(v2[sel], oa2[sel], rtol=2e-3, atol=2e-3)


def test_camera_inside_terrain_no_holes():
    """A camera flying into the terrain must not punch holes where the
    near plane slices geometry (the reference GPU clips and keeps drawing;
    the old w<=eps whole-triangle discard left background pixels)."""
    from vulkan_forge import _mesh
    from vulkan_forge._camera import look_at_rh, perspective_wgpu
    from vulkan_forge._raster import pipeline as P

    grid = 48
    xyuv, idx = _mesh.build_grid_xyuv(grid)
    lut = np.zeros((256, 4), np.float32)
    lut[:, :3] = np.linspace(0, 1, 256)[:, None]
    eye = (0.15, 0.18, 0.1)       # just above the spike surface
    view = look_at_rh(eye, (1.5, -0.2, 1.5), (0, 1, 0))
    proj = perspective_wgpu(np.float32(np.radians(60.0)),
                            np.float32(W / H), np.float32(0.1),
                            np.float32(100.0))
    with jax.default_device(jax.devices("cpu")[0]):
        img = P.render_terrain_u8(
            xyuv, idx, np.zeros((1, 1), np.float32), view, proj,
            spacing=1.0, exaggeration=1.0, h_min=-0.5, h_max=0.5,
            exposure=1.0, sun_dir=np.array([0.5, 1.0, 0.3]) / 1.166,
            lut=lut, width=W, height=H, backend="jnp")
    # The lower half of the frame looks down into terrain sliced by the
    # near plane: every pixel there must be geometry, not clear color.
    clear = np.array([5, 5, 8, 255], np.uint8)   # 0.02,0.02,0.03 sRGB-encoded
    lower = img[H // 2:, :, :]
    holes = np.all(lower == clear[None, None, :], axis=-1)
    assert holes.sum() == 0, f"{holes.sum()} near-plane holes"


def test_clipped_scene_pallas_backends_byte_identical():
    """Near/far-crossing geometry through the list kernel: the clip
    functional tests (az/aw/asum) inside the kernel must byte-match the
    jnp oracle on a dirty scene, not just on clean ones (where the tests
    are provably redundant), in both fill rules."""
    from vulkan_forge._raster import pallas_backend, tiles
    from vulkan_forge._raster.setup import (bin_triangles, clip_to_fb,
                                            tile_counts, tile_span_max,
                                            triangle_setup)

    clip, attrs, indices = _gen_scene(5, n_tris=40)
    for rule in ("inclusive", "hw"):
        x, y, z, w = clip_to_fb(jnp.asarray(clip, jnp.float32), W, H)
        records, bbox = triangle_setup(x, y, z, w,
                                       jnp.asarray(attrs, jnp.float32),
                                       jnp.asarray(indices), W, H,
                                       fill_rule=rule)
        cmax = int(tile_counts(bbox, W, H).max())
        sx, sy = tile_span_max(bbox, W, H)
        binning = bin_triangles(bbox, W, H, max(-(-cmax // 8) * 8, 8),
                                span_x=int(sx), span_y=int(sy))
        o0, o1, o2, om = tiles.render_gbuffer(records, binning.tile_lists,
                                              W, H, fill_rule=rule)
        p0, p1, p2, pm = pallas_backend.render_gbuffer(
            records, binning.tile_lists, binning.counts, W, H,
            fill_rule=rule, interpret=True)

        om_ = np.asarray(om)
        np.testing.assert_array_equal(np.asarray(pm), om_, err_msg=rule)
        for ch, ref in ((p0, o0), (p1, o1), (p2, o2)):
            np.testing.assert_array_equal(
                np.where(om_, np.asarray(ch), 0),
                np.where(om_, np.asarray(ref), 0), err_msg=rule)
        assert om_.sum() > 1000
