"""Hardware fill-rule oracle (fixed-point, top-left) vs the shipped
all-edges-inclusive f32 rule: watertightness of the oracle itself, and a
quantified bound on the delta (SURVEY.md section 7 "+-1 LSB parity" /
VERDICT round-1 item 8).

The shipped rule is deterministic (max-id painter) but can cover a
shared-edge pixel from both triangles where hardware picks exactly one;
these tests pin that (a) every such difference lies ON a coverage/winner
boundary, and (b) interior pixels agree bit-for-bit in coverage and to
float tolerance in attributes.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vulkan_forge._raster import hw_oracle, tiles
from vulkan_forge._raster.setup import (bin_triangles, clip_to_fb,
                                        tile_counts, tile_span_max,
                                        triangle_setup)

W, H = 128, 96


def _render_ours(clip, attrs, indices):
    with jax.default_device(jax.devices("cpu")[0]):
        x, y, z, w = clip_to_fb(jnp.asarray(clip, jnp.float32), W, H)
        records, bbox = triangle_setup(
            x, y, z, w, jnp.asarray(attrs, jnp.float32),
            jnp.asarray(indices, jnp.int32), W, H)
        cmax = int(tile_counts(bbox, W, H).max())
        sx, sy = tile_span_max(bbox, W, H)
        binning = bin_triangles(bbox, W, H, max(cmax, 8),
                                span_x=int(sx), span_y=int(sy))
        v0, v1, v2, mask = tiles.render_gbuffer(
            records, binning.tile_lists, W, H)
        return (np.asarray(v0), np.asarray(v1), np.asarray(v2),
                np.asarray(mask))


def _boundary(img):
    p = np.pad(img, 1, mode="edge")
    m = np.zeros(img.shape, bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            m |= p[1 + dy:H + 1 + dy, 1 + dx:W + 1 + dx] != img
    return m


def test_hw_oracle_watertight_quad():
    """Two triangles tiling a quad: every interior pixel covered EXACTLY
    once -- the defining property of the top-left rule. The shared
    diagonal passes exactly through pixel centers (45 degrees through
    integer+0.5 corners) to force ties."""
    # quad corners in NDC hitting exact pixel centers
    def ndc(px, py):
        return (2 * (px + 0.5) / W - 1, 1 - 2 * (py + 0.5) / H)

    quad = [ndc(10, 10), ndc(70, 10), ndc(70, 70), ndc(10, 70)]
    clip = np.array([[x, y, 0.5, 1.0] for x, y in quad])
    attrs = np.ones((4, 3))
    # CCW in wgpu terms (front): note y-down flip
    indices = np.array([[0, 2, 1], [0, 3, 2]], np.int32)

    cover_count = np.zeros((H, W), np.int32)
    for tri in indices:
        wid1, _ = hw_oracle.rasterize_hw(clip, attrs, tri[None], W, H)
        cover_count += (wid1 >= 0).astype(np.int32)

    assert cover_count.max() <= 1, "double coverage: fill rule not watertight"
    # interior must be exactly 1 (no cracks along the shared diagonal)
    interior = np.zeros((H, W), bool)
    interior[12:69, 12:69] = True
    # pixels strictly inside the quad
    assert (cover_count[interior] == 1).all(), "crack inside the quad"
    # and the shared diagonal must not be double-painted
    wid_all, _ = hw_oracle.rasterize_hw(clip, attrs, indices, W, H)
    assert ((wid_all >= 0) == (cover_count == 1)).all()


def test_hw_oracle_watertight_fan():
    """A randomized fan of triangles tiling a convex polygon: no pixel
    covered twice, none missed strictly inside."""
    rng = np.random.default_rng(7)
    n = 7
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(0.4, 0.9, n)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], 1)
    clip = np.concatenate(
        [np.zeros((1, 2)), pts]).astype(np.float64)
    clip = np.concatenate(
        [clip, np.full((n + 1, 1), 0.3), np.ones((n + 1, 1))], axis=1)
    attrs = np.ones((n + 1, 3))
    tris = []
    for i in range(n):
        # center, k+1, k: y-down flip makes this the front winding
        tris.append([0, 1 + (i + 1) % n, 1 + i])
    indices = np.array(tris, np.int32)

    count = np.zeros((H, W), np.int32)
    for tri in indices:
        wid1, _ = hw_oracle.rasterize_hw(clip, attrs, tri[None], W, H)
        count += (wid1 >= 0).astype(np.int32)
    assert count.max() <= 1, "fan edges double-covered"


@pytest.mark.parametrize("seed", [0, 1])
def test_shipped_rule_delta_vs_hw_is_boundary_only(seed):
    """Random small-triangle soup: coverage/winner may differ from the
    hardware rule only ON boundaries (shared edges, silhouette); interior
    agreement is exact and attributes match to f32 tolerance."""
    rng = np.random.default_rng(seed)
    n = 40
    centers = rng.uniform([-0.9, -0.9], [0.9, 0.9], (n, 2))
    offs = rng.standard_normal((n, 3, 2)) * 0.25
    v = (centers[:, None, :] + offs).reshape(-1, 2)
    z = rng.uniform(0.1, 0.9, (n * 3, 1))
    wc = np.ones((n * 3, 1))
    clip = np.concatenate([v * wc, z * wc, wc], axis=1)
    attrs = np.stack([
        np.repeat(np.arange(n), 3).astype(np.float64),
        rng.uniform(-3, 3, n * 3),
        rng.uniform(-3, 3, n * 3)], axis=1)
    indices = np.arange(n * 3, dtype=np.int32).reshape(-1, 3)

    hw_id, hw_attr = hw_oracle.rasterize_hw(clip, attrs, indices, W, H)
    v0, v1, v2, mask = _render_ours(clip, attrs, indices)
    our_id = np.where(mask, np.rint(v0), -1).astype(np.int32)

    diff = our_id != hw_id
    onb = _boundary(hw_id) | _boundary(our_id)
    off_boundary = diff & ~onb
    assert off_boundary.sum() == 0, (
        f"{off_boundary.sum()} non-boundary fill-rule mismatches")

    agree = (our_id == hw_id) & (hw_id >= 0) & ~onb
    assert agree.sum() > 200
    # attribute sanity: the oracle interpolates from 1/256-SNAPPED vertex
    # positions (as hardware does), ours from unsnapped f32 -- a real,
    # bounded difference, not a rounding bug.
    np.testing.assert_allclose(v1[agree], hw_attr[agree][:, 1],
                               rtol=3e-2, atol=5e-3)
    np.testing.assert_allclose(v2[agree], hw_attr[agree][:, 2],
                               rtol=3e-2, atol=5e-3)
    # Quantified delta: the boundary disagreement is a tiny fraction of
    # covered area (documented bound for the "+-1 LSB" story).
    covered = (hw_id >= 0).sum()
    assert diff.sum() <= 0.06 * covered, (
        f"fill-rule delta too large: {diff.sum()}/{covered}")


def _gbuffer(x, y, z, w, vary, indices, W, H, fill_rule="inclusive"):
    records, bbox = triangle_setup(x, y, z, w, vary, indices, W, H,
                                   fill_rule=fill_rule)
    cap = int(tile_counts(bbox, W, H).max())
    sx, sy = tile_span_max(bbox, W, H)
    binning = bin_triangles(bbox, W, H, max(cap, 8),
                            span_x=int(sx), span_y=int(sy))
    return tiles.render_gbuffer(records, binning.tile_lists, W, H,
                                fill_rule=fill_rule)


def test_hw_fill_rule_matches_fixed_point_oracle():
    # VF_FILL_RULE=hw coverage must equal the int64 top-left oracle exactly
    # (shared mesh edges covered by exactly one triangle).
    import math
    from vulkan_forge import _mesh
    from vulkan_forge._camera import look_at_rh, perspective_wgpu

    grid, W, H = 16, 160, 120
    with jax.default_device(jax.devices("cpu")[0]):
        xyuv, idx = _mesh.build_grid_xyuv(grid)
        x = xyuv[:, 0]
        z = xyuv[:, 1]
        h = np.sin(x * 1.3) * 0.25 + np.cos(z * 1.1) * 0.25
        view = look_at_rh((3.0, 2.0, 3.0), (0, 0, 0), (0, 1, 0))
        proj = perspective_wgpu(np.float32(math.radians(45.0)),
                                np.float32(W / H), np.float32(0.1),
                                np.float32(100.0))
        world = np.stack([x, h, z, np.ones_like(x)], axis=-1)
        clip = (world @ view.T) @ proj.T
        vary = np.stack([h, x, z], axis=-1)
        indices = idx.astype(np.int32).reshape(-1, 3)

        hw_id, _ = hw_oracle.rasterize_hw(clip, vary, indices, W, H)

        xf, yf, zf, wf = clip_to_fb(jnp.asarray(clip, jnp.float32), W, H)
        _, _, _, mask = _gbuffer(xf, yf, zf, wf,
                                 jnp.asarray(vary, jnp.float32),
                                 jnp.asarray(indices), W, H, fill_rule="hw")
        np.testing.assert_array_equal(np.asarray(mask), hw_id >= 0)


def test_hw_fill_rule_shared_edges_single_owner():
    # Two triangles sharing a diagonal: under the hw rule no pixel may be
    # double-covered along the shared edge, and the union must equal the
    # inclusive union (no dropped interior pixels).
    W, H = 64, 64
    with jax.default_device(jax.devices("cpu")[0]):
        # unit quad split along the diagonal, axis-aligned in clip space
        pos = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]],
                       np.float32)
        clip = np.concatenate([pos, np.zeros((4, 1), np.float32),
                               np.ones((4, 1), np.float32)], axis=1)
        vary = np.eye(4, 3, dtype=np.float32)
        indices = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        x, y, z, w = clip_to_fb(jnp.asarray(clip), W, H)

        masks = {}
        for rule in ("inclusive", "hw"):
            records, bbox = triangle_setup(
                x, y, z, w, jnp.asarray(vary), jnp.asarray(indices), W, H,
                fill_rule=rule)
            binning = bin_triangles(bbox, W, H, 8, span_x=1, span_y=8)
            v0, v1, v2, mask = tiles.render_gbuffer(
                records, binning.tile_lists, W, H, fill_rule=rule)
            masks[rule] = np.asarray(mask)
        # same union coverage; the rules differ only in shared-edge OWNERSHIP
        np.testing.assert_array_equal(masks["hw"], masks["inclusive"])


def test_hw_fill_rule_dense_mesh_list_kernel(monkeypatch, interpret_kernel):
    """VF_FILL_RULE=hw on a dense grid mesh (sub-pixel cells) renders
    through the list path -- the records carry the 8.8 top-left bias
    columns -- and the list kernel byte-matches the jnp oracle there.

    Match: /root/reference/src/terrain/pipeline.rs:107-140 (the
    fixed-function rule is unconditional on the GPU; here it is a mode
    every render must honor).
    """
    import math

    from vulkan_forge import _colormap, _mesh
    from vulkan_forge._camera import look_at_rh, perspective_wgpu
    from vulkan_forge._raster import pipeline as P

    grid = 104                                  # T = 21218, sub-pixel cells
    xyuv, idx = _mesh.build_grid_xyuv(grid)
    lut, _ = _colormap.build_lut("terrain")
    kw = dict(spacing=1.0, exaggeration=1.0, h_min=0.0, h_max=1.0,
              exposure=1.0, sun_dir=(0.3, 0.9, 0.3), lut=lut,
              width=160, height=120)
    view = look_at_rh((3, 2, 3), (0, 0, 0), (0, 1, 0))
    proj = perspective_wgpu(np.float32(math.radians(45)),
                            np.float32(160 / 120), np.float32(0.1),
                            np.float32(100))
    args = (xyuv, idx.reshape(-1, 3), np.zeros((1, 1), np.float32), view,
            proj)

    monkeypatch.setenv("VF_FILL_RULE", "hw")
    plan = P.plan_terrain(*args, backend="jnp", **kw)
    assert plan.static["fill_rule"] == "hw"
    assert plan.args[0].shape[0] == idx.size // 3 + 1
    ref = P.render_terrain_u8(*args, backend="jnp", **kw)
    got = P.render_terrain_u8(*args, backend="pallas", **kw)
    assert ref.shape == (120, 160, 4)
    np.testing.assert_array_equal(ref, got)
    monkeypatch.setenv("VF_FILL_RULE", "inclusive")
    assert not np.array_equal(ref, P.render_terrain_u8(*args, backend="jnp",
                                                       **kw))
