"""List-raster kernel: Pallas through Triton, for the GPU.

The GPU form of a tiled sort-middle software rasterizer (Laine & Karras,
HPG 2011): triangles are binned per screen tile (``setup.bin_triangles``),
and one program per tile walks its id-sorted list.

- Grid (B * NTY, NTX): one program per (TILE_H, TILE_W) = (8, 128) tile of
  one frame, 1024 pixels on 4 warps, 8 pixels per thread. Frames ride the
  first grid axis (frame = program_id(0) // NTY).
- The loop runs to the tile's exact binned count, not to the list
  capacity.
- Records are read by id straight from ``records``: one scalar load per
  live column of the (REC_WIDTH,)-float row (31 columns, 34 under the hw
  fill rule). Every thread of the program reads the same 136-byte span,
  so the loads are broadcasts served by L1. No (tiles, capacity,
  REC_WIDTH) gather is materialized, and the record layout is the one
  ``setup.triangle_setup`` writes.
- Painter's order: lists are id-ascending, so "last (= max id) wins" is an
  in-order overwrite of the per-pixel accumulators held in registers.

The arithmetic is ``tiles._raster_tile``'s, op for op: ``tiles`` is the
plain reference. ``interpret=True`` runs the kernel through the Pallas
interpreter for tests on a machine without a GPU; nothing else selects it.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .setup import BIAS2_COL, NUM_COLS, REC_WIDTH, TILE_H, TILE_W

_NUM_WARPS = 4


def _kernel(counts_ref, lists_ref, recs_ref, v0_ref, v1_ref, v2_ref, mask_ref,
            *, tile_h, tile_w, nty, ntx, trec, capacity, fill_rule):
    ty = pl.program_id(0)
    tx = pl.program_id(1)
    frame = ty // nty
    ty_local = ty - frame * nty
    tile = ty * ntx + tx               # flat (frame, tile_y, tile_x) index
    count = jnp.minimum(counts_ref[tile], capacity)
    row0 = frame * trec                # this frame's first record row

    px = (jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1)
          + tx * tile_w).astype(jnp.float32) + 0.5
    py = (jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0)
          + ty_local * tile_h).astype(jnp.float32) + 0.5
    ncols = BIAS2_COL + 1 if fill_rule == "hw" else NUM_COLS

    def body(i, state):
        acc0, acc1, acc2, accw, covered = state
        row = row0 + lists_ref[tile, i]
        r = [recs_ref[row, k] for k in range(ncols)]
        f0 = r[2] * (px - r[0]) - r[3] * (py - r[1])
        f1 = r[6] * (px - r[4]) - r[7] * (py - r[5])
        f2 = r[10] * (px - r[8]) - r[11] * (py - r[9])
        a0 = f0 * r[12] + f1 * r[13] + f2 * r[14]
        a1 = f0 * r[15] + f1 * r[16] + f2 * r[17]
        a2 = f0 * r[18] + f1 * r[19] + f2 * r[20]
        aw = f0 * r[21] + f1 * r[22] + f2 * r[23]
        # Clip-volume tests (setup.py "Near-plane clipping").
        az = f0 * r[25] + f1 * r[26] + f2 * r[27]
        asum = f0 * r[28] + f1 * r[29] + f2 * r[30]
        if fill_rule == "hw":
            # Top-left rule: per-edge thresholds (setup.py BIAS*_COL).
            edges = (f0 >= r[31]) & (f1 >= r[32]) & (f2 >= r[33])
        else:
            edges = (f0 >= 0.0) & (f1 >= 0.0) & (f2 >= 0.0)
        cov = (edges & (r[24] > 0.0)
               & (az >= 0.0) & (aw > 0.0) & (asum - az >= 0.0))
        return (jnp.where(cov, a0, acc0), jnp.where(cov, a1, acc1),
                jnp.where(cov, a2, acc2), jnp.where(cov, aw, accw),
                covered | cov)

    zero = jnp.zeros((tile_h, tile_w), jnp.float32)
    init = (zero, zero, zero, jnp.ones((tile_h, tile_w), jnp.float32),
            jnp.zeros((tile_h, tile_w), jnp.bool_))
    acc0, acc1, acc2, accw, covered = jax.lax.fori_loop(0, count, body, init)

    rcp = 1.0 / jnp.where(jnp.abs(accw) < 1e-20, 1.0, accw)
    v0_ref[...] = acc0 * rcp
    v1_ref[...] = acc1 * rcp
    v2_ref[...] = acc2 * rcp
    mask_ref[...] = covered.astype(jnp.float32)


def render_gbuffer_batch(records_b: jnp.ndarray, tile_lists_b: jnp.ndarray,
                         counts_b: jnp.ndarray, width: int, height: int,
                         tile_h: int = TILE_H, tile_w: int = TILE_W,
                         fill_rule: str = "inclusive",
                         interpret: bool = False):
    """B frames in one kernel launch.

    records_b: (B, T+1, REC_WIDTH); tile_lists_b: (B, NT, C) frame-local
    ids; counts_b: (B, NT) exact per-tile counts. Returns (var0, var1,
    var2, mask), each (B, H, W), with ``tiles.render_gbuffer``'s contract.
    """
    B, trec, rec_width = records_b.shape
    assert rec_width == REC_WIDTH
    nty = -(-height // tile_h)
    ntx = -(-width // tile_w)
    capacity = tile_lists_b.shape[2]

    kernel = functools.partial(
        _kernel, tile_h=tile_h, tile_w=tile_w, nty=nty, ntx=ntx, trec=trec,
        capacity=capacity, fill_rule=fill_rule)
    out_shape = jax.ShapeDtypeStruct((B * nty * tile_h, ntx * tile_w),
                                     jnp.float32)
    out_spec = pl.BlockSpec((tile_h, tile_w), lambda i, j: (i, j))
    v0, v1, v2, mask = pl.pallas_call(
        kernel,
        out_shape=(out_shape,) * 4,
        grid=(B * nty, ntx),
        out_specs=(out_spec,) * 4,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="list_raster",
    )(counts_b.astype(jnp.int32).reshape(B * nty * ntx),
      tile_lists_b.astype(jnp.int32).reshape(B * nty * ntx, capacity),
      records_b.reshape(B * trec, REC_WIDTH))

    def crop(a):
        return a.reshape(B, nty * tile_h, ntx * tile_w)[:, :height, :width]

    return crop(v0), crop(v1), crop(v2), crop(mask) > 0.5


def render_gbuffer(records: jnp.ndarray, tile_lists: jnp.ndarray,
                   counts: jnp.ndarray, width: int, height: int,
                   tile_h: int = TILE_H, tile_w: int = TILE_W,
                   fill_rule: str = "inclusive", interpret: bool = False):
    """One frame; same contract as ``tiles.render_gbuffer`` plus the exact
    per-tile ``counts`` from ``setup.bin_triangles``."""
    out = render_gbuffer_batch(records[None], tile_lists[None], counts[None],
                               width, height, tile_h, tile_w,
                               fill_rule=fill_rule, interpret=interpret)
    return tuple(a[0] for a in out)
