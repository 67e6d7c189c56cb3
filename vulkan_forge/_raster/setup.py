"""Triangle setup and framebuffer-tile binning (all jnp, jit-friendly).

This replaces the fixed-function rasterizer stages the reference gets
from the GPU graphics pipeline (primitive assembly, culling, binning).

Geometry conventions (pinned by the reference pipelines):
  - Framebuffer coordinates: x right, y down, pixel centers at +0.5
    (Vulkan/WebGPU rule).
  - Front face = CCW with back-face culling (src/lib.rs:120-121,
    src/terrain/pipeline.rs:126-129). In math shoelace terms a front-facing
    triangle has NEGATIVE area in y-down framebuffer coords, so we use the
    negated edge function F(a,b,p) = dy*(p.x-a.x) - dx*(p.y-a.y); a pixel is
    covered iff all three F >= 0 and the barycentric weights are
    (F0, F1, F2) / (F0+F1+F2) with F_i taken on the edge opposite vertex i.
  - No depth buffer (depth_stencil: None, src/terrain/pipeline.rs:133):
    painter's order means the LAST drawn triangle wins, which for a single
    indexed draw equals "maximum triangle index wins" -- an order-independent
    reduction, which is what makes the whole pipeline deterministic and
    data-parallel.

Triangle records are (T+1, REC_WIDTH) f32 rows (row T is an always-invalid
sentinel used to pad per-tile lists). Layout:

  [0:4]   edge opp v0: (a.x, a.y, s0*dy, s0*dx) with a=v1, d=v2-v1
  [4:8]   edge opp v1: a=v2, d=v0-v2 (scaled by s1)
  [8:12]  edge opp v2: a=v0, d=v1-v0 (scaled by s2)
  [12:15] varying0/w at (v0, v1, v2), each scaled by s_i*tau
  [15:18] varying1/w   (scaled s_i*tau)
  [18:21] varying2/w   (scaled s_i*tau)
  [21:24] 1/w at (v0, v1, v2) (SIGNED, scaled s_i*tau)
  [24]    valid flag (1.0 front-facing & clip-volume-nonempty & covers
          >= 1 pixel center)
  [25:28] z_ndc at (v0, v1, v2) (scaled s_i*tau) -- near-clip functional:
          az = F0*c25 + F1*c26 + F2*c27 interpolates (pos scale)*z/w
  [28:31] s_i*tau (the constant-1 attribute): S = F0*c28 + F1*c29 + F2*c30
          interpolates (same pos scale)*1, so FAR (z <= w) is S - az >= 0
  [31:34] hw fill rule only: per-edge coverage thresholds (BIAS*_COL)
  [34:40] zero padding

Edges are evaluated relative to their own vertex (F = dy*(px-ax) - dx*(py-ay))
so products stay small for small triangles -- the f32 analog of the hardware's
fixed-point watertight rasterization.

Near-plane clipping without geometry amplification:
the reference GPU clips primitives against the clip volume (z >= 0, z <= w
in WebGPU clip space) in fixed function before rasterization
(src/terrain/pipeline.rs:107-140 -- wgpu default, no unclipped_depth).
Emitting clipped sub-triangles is hostile to static shapes, so instead we
rasterize the clipped region DIRECTLY with the original triangle's records:

  - The screen-space edge lines of a triangle with mixed-sign w are still
    the correct projective lines; only their orientation flips, by exactly
    sign(w_j * w_k) for the edge joining vertices j,k. We bake that sign
    s_i into the edge (dy, dx) columns, so kernels keep testing F >= 0.
    f32 negation commutes bitwise through *,-, so clean triangles
    (all w > 0, s_i = 1) produce byte-identical records and coverage.
  - Perspective-correct interpolation functionals (attr/w and 1/w as
    screen-affine functions) remain EXACT on the visible region when built
    from the projected vertices with SIGNED 1/w -- projective algebra does
    not care that a vertex projected through negative w. The interpolation
    columns absorb s_i (and a whole-triangle sign tau = -sign(area2), which
    restores the orientation of the barycentric sum when an odd number of
    w's are negative), keeping a0/aw ratios bit-identical for clean tris.
  - The clip volume itself becomes two extra screen-linear tests evaluated
    from existing machinery: az = F0*znw0 + F1*znw1 + F2*znw2 interpolates
    z_ndc * (positive scale), so NEAR is az >= 0, FAR is aw - az >= 0, and
    w > 0 (front of camera) is aw > 0. For clean triangles each sum has
    all-nonnegative terms at covered pixels, so the tests can never flip a
    previously-covered pixel: parity configs are byte-identical.

Kernels therefore add ~7 ops per visit total; there is no second geometry
pass, no dynamic triangle count, and the painter id space is unchanged.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

REC_WIDTH = 40

# Default tile shape: 8 x 128 = 1024 pixels, one raster program per tile
# (pallas_backend.py: 4 warps, 8 pixels per thread).
TILE_H = 8
TILE_W = 128


def clip_to_fb(clip: jnp.ndarray, width: int, height: int):
    """Clip space -> framebuffer coords (WebGPU viewport transform).

    clip: (..., 4). Returns (x_fb, y_fb, z_ndc, w_clip), each (...,).
    NDC y-up flips to framebuffer y-down.
    """
    w = clip[..., 3]
    # Guard: w <= 0 vertices are marked invalid downstream; avoid inf/nan here.
    safe_w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    ndc_x = clip[..., 0] / safe_w
    ndc_y = clip[..., 1] / safe_w
    ndc_z = clip[..., 2] / safe_w
    x_fb = (ndc_x * 0.5 + 0.5) * width
    y_fb = (0.5 - ndc_y * 0.5) * height
    return x_fb, y_fb, ndc_z, w


_W_EPS = 1e-8   # "in front of camera" threshold on clip w (hardware: w > 0)


# Number of live record columns (0..30) under the inclusive rule. Column
# layout in the docstring above; the hw rule adds three (31..33).
NUM_COLS = 31

# Hardware fill-rule mode (fill_rule="hw"): vertices snap to the 8.8
# subpixel grid and records carry three per-edge coverage thresholds at
# columns 31..33 -- 0.0 for top-left edges (e == 0 covered) and _HW_BIAS
# for the rest (e == 0 excluded), reproducing Vulkan's fixed-point
# top-left rule (spec 25.8; the reference inherits it via wgpu fixed
# function, src/terrain/pipeline.rs:107-140). Snapped edge functions are
# lattice-valued (multiples of 2^-16), so "e > 0" == "e >= 2^-16" exactly;
# coverage is bit-identical to the int64 oracle (hw_oracle.py) whenever
# the f32 edge products stay exact (|dy*(px-ax)| < 256 px^2 -- all dense/
# moderate terrain meshes; quantified for large triangles by
# python/tools/parity_report.py).
BIAS0_COL, BIAS1_COL, BIAS2_COL = 31, 32, 33
_HW_SNAP = 256.0          # 8.8 fixed point (Vulkan minimum subpixel bits)
_HW_BIAS = 2.0 ** -16     # one lattice step of the snapped edge function


def _setup_fields(c0, c1, c2, width: int, height: int,
                  fill_rule: str = "inclusive"):
    """Triangle setup from per-corner per-FIELD (T,) vectors (field order:
    x_fb, y_fb, w_clip, var0, var1, var2, z_ndc). Coordinates must
    already be snapped when fill_rule == "hw".

    Returns (cols, bbox): the NUM_COLS record column vectors (plus the
    three bias columns under the hw rule) and the (T, 4) int32 pixel-center
    bbox with the invalid encoding (x1 < x0) binning keys on."""
    x0, y0, w0, zn0 = c0[0], c0[1], c0[2], c0[6]
    x1, y1, w1, zn1 = c1[0], c1[1], c1[2], c1[6]
    x2, y2, w2, zn2 = c2[0], c2[1], c2[2], c2[6]

    # Signed double area, math shoelace in framebuffer (y-down) coords.
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    # Front faces (CCW in wgpu terms) have area2 < 0 here when all w > 0;
    # with an odd number of negative w's the projected orientation flips
    # relative to the clip-space (post-clipping) orientation the GPU culls
    # by, so the test flips with it (cull_mode=Back,
    # src/terrain/pipeline.rs:128).
    neg0, neg1_, neg2 = w0 < 0.0, w1 < 0.0, w2 < 0.0
    odd_neg = neg0 ^ neg1_ ^ neg2
    # where(odd_neg, area2, -area2) > 0 is exactly
    # where(odd_neg, area2 > 0, area2 < 0) -- the sign flip is exact.
    front = jnp.where(odd_neg, area2, -area2) > 0.0
    finite = (jnp.isfinite(x0) & jnp.isfinite(x1) & jnp.isfinite(x2)
              & jnp.isfinite(y0) & jnp.isfinite(y1) & jnp.isfinite(y2))

    # Clip-volume-nonempty tests (z and w are linear on the triangle in
    # clip space, so vertex extrema are exact):
    zc0, zc1, zc2 = zn0 * w0, zn1 * w1, zn2 * w2      # clip z
    any_near = jnp.maximum(jnp.maximum(zc0, zc1), zc2) >= 0.0
    any_w = jnp.maximum(jnp.maximum(w0, w1), w2) > _W_EPS
    any_far = jnp.minimum(jnp.minimum(zc0 - w0, zc1 - w1), zc2 - w2) <= 0.0

    clean = (w0 > _W_EPS) & (w1 > _W_EPS) & (w2 > _W_EPS)

    # ---- pixel-center bbox (centers at integer+0.5) ----
    # Candidates: vertices on the visible side of the near plane, plus the
    # near-plane crossing points of each edge (exact convex hull of the
    # near-clipped triangle when all w > 0). Triangles crossing w ~ 0 get a
    # conservative full-screen bbox (rare: camera plane slicing geometry).
    big = jnp.float32(3.4e37)

    def crossing(xa, ya, wa, za, xb, yb, wb, zb):
        """Near-plane (z_clip = 0) crossing of edge a->b in homogeneous
        framebuffer coords; returns (x_fb, y_fb, valid)."""
        denom = za - zb
        safe = jnp.where(jnp.abs(denom) < 1e-30,
                         jnp.float32(1e-30), denom)
        t = za / safe
        crosses = (za < 0.0) != (zb < 0.0)
        wx = wa + t * (wb - wa)
        Xa, Ya = xa * wa, ya * wa
        Xb, Yb = xb * wb, yb * wb
        X = Xa + t * (Xb - Xa)
        Y = Ya + t * (Yb - Ya)
        ok = crosses & (wx > _W_EPS)
        rw = 1.0 / jnp.where(jnp.abs(wx) < 1e-30, jnp.float32(1e-30), wx)
        return X * rw, Y * rw, ok

    cx01, cy01, ok01 = crossing(x0, y0, w0, zc0, x1, y1, w1, zc1)
    cx12, cy12, ok12 = crossing(x1, y1, w1, zc1, x2, y2, w2, zc2)
    cx20, cy20, ok20 = crossing(x2, y2, w2, zc2, x0, y0, w0, zc0)
    vok0 = zc0 >= 0.0
    vok1 = zc1 >= 0.0
    vok2 = zc2 >= 0.0

    def mm(sel, vals, init, op):
        out = init
        for s, v in zip(sel, vals):
            out = op(out, jnp.where(s, v, init))
        return out

    sels = [vok0, vok1, vok2, ok01, ok12, ok20]
    xs = [x0, x1, x2, cx01, cx12, cx20]
    ys = [y0, y1, y2, cy01, cy12, cy20]
    xmin = mm(sels, xs, big, jnp.minimum)
    xmax = mm(sels, xs, -big, jnp.maximum)
    ymin = mm(sels, ys, big, jnp.minimum)
    ymax = mm(sels, ys, -big, jnp.maximum)
    # w-crossing triangles: conservative full screen.
    xmin = jnp.where(clean, xmin, 0.0)
    xmax = jnp.where(clean, xmax, jnp.float32(width))
    ymin = jnp.where(clean, ymin, 0.0)
    ymax = jnp.where(clean, ymax, jnp.float32(height))

    px0 = jnp.ceil(jnp.clip(xmin, -1e9, 1e9) - 0.5).astype(jnp.int32)
    px1 = jnp.floor(jnp.clip(xmax, -1e9, 1e9) - 0.5).astype(jnp.int32)
    py0 = jnp.ceil(jnp.clip(ymin, -1e9, 1e9) - 0.5).astype(jnp.int32)
    py1 = jnp.floor(jnp.clip(ymax, -1e9, 1e9) - 0.5).astype(jnp.int32)
    px0 = jnp.maximum(px0, 0)
    py0 = jnp.maximum(py0, 0)
    px1 = jnp.minimum(px1, width - 1)
    py1 = jnp.minimum(py1, height - 1)
    # Covers at least one pixel center inside the framebuffer.
    covers = (px0 <= px1) & (py0 <= py1)

    valid = front & finite & any_near & any_w & any_far & covers

    # SIGNED reciprocals: negative-w vertices keep their sign so the
    # projective interpolation functionals stay exact on the clipped region.
    def srw(w):
        safe = jnp.where(jnp.abs(w) < 1e-12,
                         jnp.where(w < 0.0, jnp.float32(-1e-12),
                                   jnp.float32(1e-12)), w)
        return 1.0 / safe

    rw0, rw1, rw2 = srw(w0), srw(w1), srw(w2)

    # Per-edge orientation fix s_i = sign(w_j * w_k) for the edge OPPOSITE
    # vertex i, and whole-triangle tau = -sign(area2) restoring the
    # barycentric-sum orientation. All are +-1: multiplications are exact
    # bitwise sign flips, so clean triangles are byte-identical to the
    # unclipped record format.
    one = jnp.ones_like(x0)
    s0 = jnp.where(neg1_ ^ neg2, -one, one)
    s1 = jnp.where(neg2 ^ neg0, -one, one)
    s2 = jnp.where(neg0 ^ neg1_, -one, one)
    tau = jnp.where(area2 > 0.0, -one, one)
    t0, t1, t2 = s0 * tau, s1 * tau, s2 * tau

    cols = [
        x1, y1, (y2 - y1) * s0, (x2 - x1) * s0,    # edge opp v0
        x2, y2, (y0 - y2) * s1, (x0 - x2) * s1,    # edge opp v1
        x0, y0, (y1 - y0) * s2, (x1 - x0) * s2,    # edge opp v2
    ]
    for k in range(3):
        cols += [c0[3 + k] * rw0 * t0, c1[3 + k] * rw1 * t1,
                 c2[3 + k] * rw2 * t2]
    cols += [rw0 * t0, rw1 * t1, rw2 * t2, valid.astype(jnp.float32)]
    cols += [zn0 * t0, zn1 * t1, zn2 * t2]         # near-clip functional
    cols += [t0, t1, t2]                           # constant-1 (far clip)

    if fill_rule == "hw":
        # Top-left classification per directed edge of the front-facing
        # triangle (hw_oracle._is_top_left semantics, on snapped coords):
        # horizontal edges are "top" iff they run rightward, others are
        # "left" iff they run upward (y-down coords). Non-top-left edges
        # get bias 2^-16 (exclude e == 0). w-crossing triangles keep the
        # inclusive rule (bias 0): hardware clips them into sub-polygons
        # whose shared diagonals never tie anyway.
        bias = jnp.float32(_HW_BIAS)
        zerob = jnp.zeros_like(x0)

        def edge_bias(ax, ay, bx, by):
            horiz = ay == by
            topleft = (horiz & (bx > ax)) | (~horiz & (by < ay))
            return jnp.where(topleft | ~clean, zerob, bias)

        cols += [edge_bias(x1, y1, x2, y2),        # edge opp v0
                 edge_bias(x2, y2, x0, y0),        # edge opp v1
                 edge_bias(x0, y0, x1, y1)]        # edge opp v2

    bbox = jnp.stack([jnp.where(valid, px0, width), jnp.where(valid, px1, -1),
                      jnp.where(valid, py0, height), jnp.where(valid, py1, -1)], axis=-1)
    return cols, bbox


def triangle_setup(x_fb, y_fb, z_ndc, w_clip, varyings, indices,
                   width: int, height: int, fill_rule: str = "inclusive"):
    """Build (T+1, REC_WIDTH) triangle records (near/far clipping baked in).

    x_fb, y_fb, z_ndc, w_clip: (N,) per-vertex framebuffer coords, NDC z
    (z/w as produced by clip_to_fb) and clip w.
    varyings: (N, 3) per-vertex attributes (perspective-interpolated).
    indices: (T, 3) int32 vertex indices (triangle list order == draw order).
    fill_rule "hw" adds the snapped top-left coverage biases at columns
    31..33 (see BIAS0_COL).
    """
    if fill_rule == "hw":
        # Snap to the subpixel grid with round-half-even (matches the
        # oracle's int(round(x * 256))). 1/256 is a power of two: the snap
        # is exact in f32 for |x| < 2^15 px.
        x_fb = jnp.round(x_fb * _HW_SNAP) * jnp.float32(1.0 / _HW_SNAP)
        y_fb = jnp.round(y_fb * _HW_SNAP) * jnp.float32(1.0 / _HW_SNAP)

    # Pack all per-vertex data into one matrix and gather ROWS per corner:
    # three (T, 7) row gathers instead of twenty-one 1-D element gathers.
    vmat = jnp.stack([x_fb, y_fb, w_clip,
                      varyings[:, 0], varyings[:, 1], varyings[:, 2],
                      z_ndc], axis=-1)
    corners = [vmat[indices[:, k]] for k in range(3)]     # (T, 7) each
    cols, bbox = _setup_fields(
        *(tuple(c[:, j] for j in range(7)) for c in corners),
        width, height, fill_rule=fill_rule)
    zero_col = jnp.zeros_like(cols[0])
    cols += [zero_col] * (REC_WIDTH - len(cols))
    rec = jnp.stack(cols, axis=-1)  # (T, REC_WIDTH), one fused assembly

    # Sentinel row T: all zeros => valid flag 0 => never covers.
    records = jnp.concatenate([rec, jnp.zeros((1, REC_WIDTH), jnp.float32)], axis=0)
    return records, bbox


class Binning(NamedTuple):
    tile_lists: jnp.ndarray   # (NTY*NTX, C) int32 triangle ids (sentinel=T)
    counts: jnp.ndarray       # (NTY*NTX,) int32 per-tile triangle count


def tile_counts(bbox, width: int, height: int,
                tile_h: int = TILE_H, tile_w: int = TILE_W) -> jnp.ndarray:
    """Per-tile overlapping-triangle counts (for host capacity selection)."""
    nty = -(-height // tile_h)
    ntx = -(-width // tile_w)
    tx0 = bbox[:, 0] // tile_w
    tx1 = bbox[:, 1] // tile_w
    ty0 = bbox[:, 2] // tile_h
    ty1 = bbox[:, 3] // tile_h
    txs = jnp.arange(ntx, dtype=jnp.int32)
    tys = jnp.arange(nty, dtype=jnp.int32)
    ovx = (tx0[:, None] <= txs[None, :]) & (txs[None, :] <= tx1[:, None])  # (T, NTX)
    ovy = (ty0[:, None] <= tys[None, :]) & (tys[None, :] <= ty1[:, None])  # (T, NTY)
    # counts[tile_y, tile_x] = sum_t ovy[t, ty] * ovx[t, tx] -- a matmul.
    # Exact at any matmul precision, TF32 included: the operands are 0/1
    # (exact in every float format) and the f32 accumulator holds integer
    # sums exactly below 2^24 triangles.
    counts = jnp.einsum("ty,tx->yx", ovy.astype(jnp.float32), ovx.astype(jnp.float32),
                        preferred_element_type=jnp.float32)
    return counts.astype(jnp.int32).reshape(-1)


def tile_span_max(bbox, width: int, height: int,
                  tile_h: int = TILE_H, tile_w: int = TILE_W):
    """Max per-triangle tile-span (sx, sy) -- picks the static scatter K."""
    tx0 = bbox[:, 0] // tile_w
    tx1 = bbox[:, 1] // tile_w
    ty0 = bbox[:, 2] // tile_h
    ty1 = bbox[:, 3] // tile_h
    sx = jnp.maximum(tx1 - tx0 + 1, 0)
    sy = jnp.maximum(ty1 - ty0 + 1, 0)
    return jnp.maximum(sx.max(), 1), jnp.maximum(sy.max(), 1)


def bin_triangles(bbox, width: int, height: int, capacity: int,
                  tile_h: int = TILE_H, tile_w: int = TILE_W,
                  span_x: int = 4, span_y: int = 4,
                  tri_chunk: int = 65536) -> Binning:
    """Bin triangles into per-tile lists of ascending triangle id.

    Deterministic, sort-free scatter binning: each triangle writes its id
    into the (tile, rank) slots of the tiles its bbox spans (at most
    span_x * span_y static slots -- the host sizes these from
    ``tile_span_max``, so nothing can overflow). The rank (position within
    the tile's ascending-id list) comes from a cumulative count over the
    triangle axis; ranks are gathered chunk-locally so memory stays bounded
    for large meshes. Sentinel id T pads unused slots.
    """
    T = bbox.shape[0]
    nty = -(-height // tile_h)
    ntx = -(-width // tile_w)
    ntiles = nty * ntx

    tx0 = bbox[:, 0] // tile_w
    tx1 = bbox[:, 1] // tile_w
    ty0 = bbox[:, 2] // tile_h
    ty1 = bbox[:, 3] // tile_h
    valid = bbox[:, 1] >= bbox[:, 0]

    tile_ids = jnp.arange(ntiles, dtype=jnp.int32)
    ty_of = tile_ids // ntx
    tx_of = tile_ids % ntx

    K = span_x * span_y
    dx = jnp.arange(span_x, dtype=jnp.int32)
    dy = jnp.arange(span_y, dtype=jnp.int32)

    # Output: flat (NT*C + 1) slots, last = dump; init = sentinel id T.
    lists_flat = jnp.full((ntiles * capacity + 1,), T, jnp.int32)
    dump = ntiles * capacity

    n_chunks = -(-T // tri_chunk)
    running = jnp.zeros((ntiles,), jnp.int32)

    for c in range(n_chunks):
        s = c * tri_chunk
        tc = min(tri_chunk, T - s)
        sl = slice(s, s + tc)
        ctx0, ctx1 = tx0[sl], tx1[sl]
        cty0, cty1 = ty0[sl], ty1[sl]
        cvalid = valid[sl]

        # (NT, Tc) chunk overlap + cumulative count along triangles.
        ov = ((ctx0[None, :] <= tx_of[:, None]) & (tx_of[:, None] <= ctx1[None, :])
              & (cty0[None, :] <= ty_of[:, None]) & (ty_of[:, None] <= cty1[None, :])
              & cvalid[None, :])
        csum = running[:, None] + jnp.cumsum(ov.astype(jnp.int32), axis=1)
        running = csum[:, -1]

        # Enumerate each triangle's span slots: tile id + chunk-local rank.
        styx = cty0[:, None] + dy[None, :]                     # (Tc, SY)
        stxx = ctx0[:, None] + dx[None, :]                     # (Tc, SX)
        tile = (styx[:, :, None] * ntx + stxx[:, None, :]).reshape(tc, K)
        ok = ((styx[:, :, None] <= cty1[:, None, None])
              & (stxx[:, None, :] <= ctx1[:, None, None])).reshape(tc, K)
        ok = ok & cvalid[:, None]

        safe_tile = jnp.where(ok, tile, 0)
        t_local = jnp.arange(tc, dtype=jnp.int32)
        flat_idx = safe_tile * tc + t_local[:, None]           # into (NT, Tc)
        rank = csum.reshape(-1)[flat_idx.reshape(-1)].reshape(tc, K) - 1

        slot = jnp.where(ok & (rank < capacity),
                         safe_tile * capacity + rank, dump)
        vals = jnp.broadcast_to((t_local + s)[:, None], (tc, K)).reshape(-1)
        lists_flat = lists_flat.at[slot.reshape(-1)].set(
            vals, mode="drop", indices_are_sorted=False, unique_indices=False)

    lists = lists_flat[:-1].reshape(ntiles, capacity)
    return Binning(tile_lists=lists, counts=running)
