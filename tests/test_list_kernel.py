"""The Triton list-raster kernel (pallas_backend.py) against the plain jnp
reference (tiles.py): same g-buffers bit for bit, wrapper shapes, padding,
batch offsets, loop bounds, and the pipeline's choice of raster stage.

Without a GPU the kernel runs through the Pallas interpreter
(``interpret=True``); the ``gpu``-marked test runs it as Triton compiles it.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vulkan_forge._raster import pallas_backend, pipeline, tiles
from vulkan_forge._raster.setup import (bin_triangles, clip_to_fb,
                                        tile_counts, tile_span_max,
                                        triangle_setup)


def _soup(seed, W, H, n=60, fill_rule="inclusive"):
    """Random triangles, some crossing the near plane: (records, binning)."""
    from test_clipping import _gen_scene
    clip, attrs, idx = _gen_scene(seed, n_tris=n)
    x, y, z, w = clip_to_fb(jnp.asarray(clip, jnp.float32), W, H)
    records, bbox = triangle_setup(x, y, z, w, jnp.asarray(attrs, jnp.float32),
                                   jnp.asarray(idx), W, H, fill_rule=fill_rule)
    cmax = int(tile_counts(bbox, W, H).max())
    sx, sy = tile_span_max(bbox, W, H)
    binning = bin_triangles(bbox, W, H, pipeline._round_capacity(cmax),
                            span_x=pipeline._round_span(int(sx)),
                            span_y=pipeline._round_span(int(sy)))
    return records, binning


def _assert_same(ref, got):
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fill_rule", ["inclusive", "hw"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_list_kernel_matches_reference(seed, fill_rule):
    W, H = 160, 120
    records, b = _soup(seed, W, H, fill_rule=fill_rule)
    ref = tiles.render_gbuffer(records, b.tile_lists, W, H,
                               fill_rule=fill_rule)
    got = pallas_backend.render_gbuffer(records, b.tile_lists, b.counts, W, H,
                                        fill_rule=fill_rule, interpret=True)
    assert np.asarray(ref[3]).sum() > 1000
    _assert_same(ref, got)


@pytest.mark.parametrize("wh", [(130, 57), (64, 100), (257, 9)])
def test_list_kernel_odd_shapes(wh):
    # Partial tiles on both axes: the padded output is cropped to (H, W).
    W, H = wh
    records, b = _soup(7, W, H, n=30)
    ref = tiles.render_gbuffer(records, b.tile_lists, W, H)
    got = pallas_backend.render_gbuffer(records, b.tile_lists, b.counts, W, H,
                                        interpret=True)
    for a in got:
        assert a.shape == (H, W)
    assert got[3].dtype == jnp.bool_ and got[0].dtype == jnp.float32
    _assert_same(ref, got)


def test_list_kernel_batch_frame_offsets():
    # Frames ride the grid's first axis and index their own records: each
    # frame of the batch equals that frame rendered alone.
    W, H = 160, 120
    frames = [_soup(s, W, H) for s in (3, 4, 5)]
    cap = max(b.tile_lists.shape[1] for _, b in frames)
    trec = max(r.shape[0] for r, _ in frames)

    def pad(records, b):
        # Pad every frame to a common record count and capacity; padded
        # list slots hold the frame's own sentinel id (an all-zero row).
        t = records.shape[0] - 1
        rec = jnp.concatenate(
            [records, jnp.zeros((trec - records.shape[0], records.shape[1]),
                                jnp.float32)])
        lists = jnp.pad(b.tile_lists, ((0, 0), (0, cap - b.tile_lists.shape[1])),
                        constant_values=t)
        return rec, lists, b.counts

    recs, lists, counts = zip(*(pad(r, b) for r, b in frames))
    got = pallas_backend.render_gbuffer_batch(
        jnp.stack(recs), jnp.stack(lists), jnp.stack(counts), W, H,
        interpret=True)
    for i, (records, b) in enumerate(frames):
        ref = tiles.render_gbuffer(records, b.tile_lists, W, H)
        _assert_same(ref, [a[i] for a in got])


def test_list_kernel_loop_stops_at_counts():
    # The loop runs to counts[tile], not to the capacity: zero counts
    # leave every pixel uncovered even though the lists hold triangles.
    W, H = 160, 120
    records, b = _soup(0, W, H)
    got = pallas_backend.render_gbuffer(records, b.tile_lists,
                                        jnp.zeros_like(b.counts), W, H,
                                        interpret=True)
    assert not np.asarray(got[3]).any()
    np.testing.assert_array_equal(np.asarray(got[0]), 0.0)


def test_list_kernel_counts_clamped_to_capacity():
    # A count above the list capacity (binning counts every overlap, even
    # ones it had no slot for) must not read past the list row.
    W, H = 160, 120
    records, b = _soup(1, W, H)
    cap = b.tile_lists.shape[1]
    ref = tiles.render_gbuffer(records, b.tile_lists, W, H)
    got = pallas_backend.render_gbuffer(
        records, b.tile_lists, jnp.full_like(b.counts, cap + 5), W, H,
        interpret=True)
    _assert_same(ref, got)


@pytest.mark.gpu
def test_list_kernel_compiled_matches_reference():
    for fill_rule in ("inclusive", "hw"):
        records, b = _soup(5, 800, 600, n=2000, fill_rule=fill_rule)
        ref = jax.jit(tiles.render_gbuffer, static_argnums=(2, 3),
                      static_argnames="fill_rule")(
            records, b.tile_lists, 800, 600, fill_rule=fill_rule)
        got = jax.jit(pallas_backend.render_gbuffer, static_argnums=(3, 4),
                      static_argnames="fill_rule")(
            records, b.tile_lists, b.counts, 800, 600, fill_rule=fill_rule)
        _assert_same(ref, got)


@pytest.mark.parametrize("fill_rule", ["inclusive", "hw"])
def test_batched_path_kernel_matches_reference(interpret_kernel, fill_rule):
    # The batched list path with the kernel raster stage equals the same
    # path with the jnp reference, in both fill rules.
    from vulkan_forge import _colormap, _mesh
    from vulkan_forge._camera import look_at_rh, perspective_wgpu
    W, H = 160, 120
    xyuv, idx = _mesh.build_grid_xyuv(40)
    xyuv = jnp.asarray(xyuv)
    idx = jnp.asarray(idx.astype(np.int32).reshape(-1, 3))
    heights = jnp.zeros((1, 1), jnp.float32)
    proj = perspective_wgpu(np.float32(math.radians(45)), np.float32(W / H),
                            np.float32(0.1), np.float32(100))
    views = jnp.asarray(np.stack([look_at_rh(e, (0, 0, 0), (0, 1, 0))
                                  for e in ((3, 2, 3), (-2.5, 1.5, 3.5))]))
    projs = jnp.asarray(np.stack([proj, proj]))
    one = jnp.float32(1.0)
    cap = pipeline.batch_bin_params(xyuv, idx, heights, views, projs, one,
                                    one, W, H, fill_rule=fill_rule)
    args = (xyuv, idx, heights, views, projs,
            jnp.asarray(_colormap.build_lut("terrain")[0]),
            jnp.float32(-0.5), jnp.float32(0.5), one,
            jnp.asarray([0.3, 0.9, 0.3], jnp.float32), one, one, W, H, *cap)
    ref = pipeline._terrain_render_batch(*args, fill_rule=fill_rule)
    got = pipeline._terrain_render_batch(*args, use_pallas=True,
                                         fill_rule=fill_rule)
    assert ref.shape == (2, H, W)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


# ---------------- choice of raster stage ----------------

@pytest.mark.parametrize("env,platform,want", [
    ("auto", "cpu", "jnp"),
    ("auto", "gpu", "pallas"),
    ("jnp", "gpu", "jnp"),
    ("pallas", "gpu", "pallas"),
])
def test_backend_routing(monkeypatch, env, platform, want):
    from vulkan_forge import _device
    monkeypatch.setattr(_device, "default_platform", lambda: platform)
    monkeypatch.setenv("VF_BACKEND", env)
    assert pipeline.backend_name() == want


def test_pallas_backend_on_cpu_raises(monkeypatch):
    # VF_BACKEND=pallas never falls back to the Pallas interpreter.
    monkeypatch.setenv("VF_BACKEND", "pallas")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        pipeline.render_triangle_u8(64, 64)


def test_plan_terrain_static_args():
    # The plan carries pow2 binning parameters that cover every tile's
    # exact count, and the raster choice the caller asked for.
    from vulkan_forge import _mesh
    from vulkan_forge._camera import look_at_rh, perspective_wgpu
    xyuv, idx = _mesh.build_grid_xyuv(24)
    view = look_at_rh((3.0, 2.0, 3.0), (0, 0, 0), (0, 1, 0))
    proj = perspective_wgpu(np.float32(math.radians(45)), np.float32(4 / 3),
                            np.float32(0.1), np.float32(100))
    plan = pipeline.plan_terrain(
        xyuv, idx, np.zeros((1, 1), np.float32), view, proj, spacing=1.0,
        exaggeration=1.0, h_min=-0.5, h_max=0.5, exposure=1.0,
        sun_dir=(0.3, 0.9, 0.3), lut=np.zeros((256, 4), np.float32),
        width=160, height=120, backend="pallas")
    st = plan.static
    assert st["use_pallas"] and "interpret" not in st
    assert st["fill_rule"] == "inclusive" and st["fs_mode"] == "shipped"
    bbox = plan.args[1]
    cmax = int(tile_counts(bbox, 160, 120).max())
    cap = st["capacity"]
    assert cap >= cmax and cap & (cap - 1) == 0
    sx, sy = tile_span_max(bbox, 160, 120)
    assert st["span_x"] >= int(sx) and st["span_y"] >= int(sy)
    assert plan.args[0].shape == (bbox.shape[0] + 1, 40)
