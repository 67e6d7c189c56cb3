#!/usr/bin/env python3
"""Headline benchmark: shaded-terrain throughput on one GPU.

Scene: the north-star config from BASELINE.json -- grid=1024 analytic
terrain (2 * 1023^2 = 2,093,058 triangles) shaded at 800x600 with the
shipped terrain pipeline (height sample, LUT color, Lambert, sRGB encode),
rendered as batches of frames through the batched list path
(``pipeline._terrain_render_batch``), with a distinct camera per frame and
a distinct camera set per repetition. Each timed repetition ends in a full
``device_get`` readback of the batch.

Baseline: the reference's own budget for a 1024^2 DEM render is <= 50 ms
(ROADMAP.md:280 of the reference) ~= 21 Mpix/s. vs_baseline is measured
Mpix/s / 21.

Aggregation: the headline ``value`` is the MEDIAN of VF_BENCH_REPS
(default 5) per-rep timings; best/mean/reps ride along in
``ms_per_batch``.

Prints ONE JSON line with the device it ran on (platform, device_kind,
count) and the card's name and power limit. With no GPU it exits 1 with
a "no GPU" message and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

WIDTH = int(os.environ.get("VF_BENCH_W", "800"))
HEIGHT = int(os.environ.get("VF_BENCH_H", "600"))
# North-star scene: grid=1024 (BASELINE.json). VF_BENCH_GRID=128 measures
# the reference's default TerrainSpike grid (src/terrain/mod.rs:258).
GRID = int(os.environ.get("VF_BENCH_GRID", "1024"))
BATCH = int(os.environ.get("VF_BENCH_BATCH", "4"))
REPS = int(os.environ.get("VF_BENCH_REPS", "5"))


def orbit_cameras(n: int, phase: float = 0.0):
    """n cameras orbiting the spike terrain (distinct view/proj per frame)."""
    from vulkan_forge._camera import look_at_rh, perspective_wgpu
    views = []
    projs = []
    aspect = np.float32(WIDTH) / np.float32(HEIGHT)
    for i in range(n):
        ang = 2.0 * math.pi * i / max(n, 1) + phase
        eye = (3.0 * math.cos(ang), 2.0 + 0.1 * math.sin(phase), 3.0 * math.sin(ang))
        views.append(look_at_rh(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)))
        projs.append(perspective_wgpu(np.float32(math.radians(45.0)), aspect,
                                      np.float32(0.1), np.float32(100.0)))
    return np.stack(views), np.stack(projs)


def main() -> int:
    import jax
    import jax.numpy as jnp
    from chip_smoke import gpu_name_power_limit, require_gpu
    from vulkan_forge import _colormap, _mesh
    from vulkan_forge._raster import pipeline as P

    try:
        devices = require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    card = gpu_name_power_limit()

    xyuv_np, idx_np = _mesh.build_grid_xyuv(GRID)
    xyuv = jnp.asarray(xyuv_np)
    indices = jnp.asarray(idx_np.astype(np.int32).reshape(-1, 3))
    heights = jnp.zeros((1, 1), jnp.float32)  # analytic relief only
    lut = jnp.asarray(_colormap.build_lut("viridis")[0])
    sun = jnp.asarray(np.array([0.5, 1.0, 0.3], np.float32)
                      / np.linalg.norm([0.5, 1.0, 0.3]))
    scal = (jnp.float32(-0.5), jnp.float32(0.5), jnp.float32(1.0), sun,
            jnp.float32(1.0), jnp.float32(1.0))
    use_pallas = P.backend_name() == "pallas"
    fill_rule = P.fill_rule_name()

    # One distinct camera set per rep; the last set is the warm-up, never
    # timed. Binning capacity is sized once over every set (outside the
    # timed window), so no rep can overflow or recompile.
    cam_sets = [tuple(jnp.asarray(a) for a in orbit_cameras(BATCH, 0.31 * r))
                for r in range(REPS + 1)]
    all_views = jnp.concatenate([v for v, _ in cam_sets])
    all_projs = jnp.concatenate([p for _, p in cam_sets])
    capacity, span_x, span_y = P.batch_bin_params(
        xyuv, indices, heights, all_views, all_projs, scal[4], scal[5],
        WIDTH, HEIGHT, fill_rule=fill_rule)

    def run(views, projs):
        imgs = P._terrain_render_batch(
            xyuv, indices, heights, views, projs, lut, *scal, WIDTH, HEIGHT,
            capacity, span_x, span_y, use_pallas=use_pallas,
            fill_rule=fill_rule)
        return jax.device_get(imgs)

    run(*cam_sets[-1])  # compile + warm
    times = []
    for rep in range(REPS):
        t1 = time.perf_counter()
        run(*cam_sets[rep])
        times.append(time.perf_counter() - t1)

    times_sorted = sorted(times)
    n = len(times_sorted)
    dt = (times_sorted[n // 2] if n % 2
          else 0.5 * (times_sorted[n // 2 - 1] + times_sorted[n // 2]))
    mpix = (WIDTH * HEIGHT * BATCH) / dt / 1e6
    baseline_mpix = 21.0  # reference budget: 1024^2 in 50 ms
    print(json.dumps({
        "metric": f"terrain_throughput_grid{GRID}_{WIDTH}x{HEIGHT}_b{BATCH}",
        "value": mpix,
        "unit": "Mpix/s",
        "vs_baseline": mpix / baseline_mpix,
        "path": "list:" + ("pallas-triton" if use_pallas else "jnp"),
        "ms_per_batch": {
            "median": dt * 1e3,
            "best": times_sorted[0] * 1e3,
            "mean": sum(times) / n * 1e3,
            "reps": n,
        },
        "capacity": capacity,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind,
                   "count": len(devices)},
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
