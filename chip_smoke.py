#!/usr/bin/env python3
"""Smoke test of the renderer on one NVIDIA GPU, through the public API.

    python chip_smoke.py          # one card: phases 1-5 below
    python chip_smoke.py --four   # four cards: render_spike_frames sharded
                                  # over 4 devices vs the same frames on one

Phases, each printing JSON lines:
  1. device  -- JAX must see a GPU; the card's name and power limit.
  2. memory  -- compiled.memory_analysis() of each cell's executables.
  3. timing  -- each cell end to end (full readback) with the raster stage
                as the Triton list kernel and as the jnp reference compiled
                by XLA, interleaved, warm-up outside the window.
  4. parity  -- kernel vs reference g-buffers on the card at real widths
                (cells a-c and a near/far-clipped scene in both fill
                rules), GPU vs CPU on small scenes, golden-scene hashes.
  5. api     -- every public entry point end to end.

Cells: (a) TerrainSpike(800, 600, 128).render_rgba(); (b) the batched
list path at grid=1024, 800x600, B=4; (c) Renderer(800, 600).add_terrain
of a seeded 2048^2 DEM -> render_rgba().

Any failure raises and exits non-zero; the last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import vulkan_forge as vf  # noqa: E402
from vulkan_forge import _mesh  # noqa: E402
from vulkan_forge._raster import pipeline as P  # noqa: E402
from vulkan_forge._raster.setup import (bin_triangles, clip_to_fb,  # noqa: E402
                                        triangle_setup)

W, H = 800, 600
SPIKE_GRID = 128          # cell (a): the reference's default TerrainSpike grid
BATCH_GRID = 1024         # cell (b) and the render_spike_frames phases
DEM_N = 2048              # cell (c)
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
VARIANTS = ("pallas", "jnp")      # Triton list kernel, XLA-compiled reference
SEED = 0


def gpu_name_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the visible cards,
    one line each (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"). A card can be
    set below its maximum power limit and then runs slower under load, so
    every timing is reported beside this line. Raises if nvidia-smi is
    missing or fails."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def require_gpu() -> list:
    """The visible GPU devices; raises with a clear message if JAX found
    none (measurement scripts never fall back to the CPU)."""
    devices = jax.devices()
    if not devices or devices[0].platform != "gpu":
        kinds = sorted({d.platform for d in devices})
        raise RuntimeError(f"no GPU: JAX found only {kinds} devices")
    return devices


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def orbit_eyes(n: int, radius: float, height: float, phase: float = 0.3):
    return [(radius * math.cos(2 * math.pi * k / n + phase),
             height + 0.25 * math.sin(1.7 * k),
             radius * math.sin(2 * math.pi * k / n + phase))
            for k in range(n)]


def seeded_dem(n: int, seed: int = SEED) -> np.ndarray:
    """An n x n height field in metres: low-passed Gaussian noise."""
    rng = np.random.default_rng(seed)
    f = np.fft.rfft2(rng.standard_normal((n, n)))
    ky = np.fft.fftfreq(n)[:, None]
    kx = np.fft.rfftfreq(n)[None, :]
    f /= 1.0 + ((kx * kx + ky * ky) * (n / 8.0) ** 2) ** 1.5
    dem = np.fft.irfft2(f, s=(n, n))
    dem = (dem - dem.min()) / (dem.max() - dem.min()) * 900.0
    return dem.astype(np.float32)


def set_backend(variant: str) -> None:
    os.environ["VF_BACKEND"] = variant


# ---------------- cells ----------------

class SpikeCell:
    """(a) TerrainSpike(800, 600, 128).render_rgba(), one camera per call."""
    name = f"a_spike_g{SPIKE_GRID}_single"

    def __init__(self):
        self.obj = vf.TerrainSpike(W, H, SPIKE_GRID)
        self.eyes = orbit_eyes(6, math.sqrt(18.0), 2.0)
        self.n = len(self.eyes)

    def _look(self, i):
        self.obj.set_camera_look_at(self.eyes[i], (0, 0, 0), (0, 1, 0),
                                    45.0, 0.1, 100.0)

    def render(self, variant, i):
        set_backend(variant)
        self._look(i)
        return self.obj.render_rgba()

    def plan(self, variant):
        self._look(0)
        args, kwargs = self.obj._draw_args()
        return P.plan_terrain(*args, backend=variant, **kwargs)


class BatchCell:
    """(b) pipeline._terrain_render_batch at grid=1024, 800x600, B=4."""
    name = f"b_batch_g{BATCH_GRID}_b4"
    grid, batch = BATCH_GRID, 4

    def __init__(self):
        from vulkan_forge import _colormap
        from vulkan_forge._camera import look_at_rh, perspective_wgpu
        xyuv, idx = _mesh.build_grid_xyuv(self.grid)
        self.xyuv = jnp.asarray(xyuv)
        self.indices = jnp.asarray(idx.astype(np.int32).reshape(-1, 3))
        self.heights = jnp.zeros((1, 1), jnp.float32)
        self.lut = jnp.asarray(_colormap.build_lut("viridis")[0])
        sun = np.array([0.5, 1.0, 0.3], np.float32)
        self.scal = (jnp.float32(-0.5), jnp.float32(0.5), jnp.float32(1.0),
                     jnp.asarray(sun / np.linalg.norm(sun)),
                     jnp.float32(1.0), jnp.float32(1.0))
        proj = perspective_wgpu(np.float32(math.radians(45.0)),
                                np.float32(W / H), np.float32(0.1),
                                np.float32(100.0))
        self.sets = []
        for s in range(4):
            eyes = orbit_eyes(self.batch, math.sqrt(18.0), 2.0, 0.3 + 0.41 * s)
            views = np.stack([look_at_rh(e, (0, 0, 0), (0, 1, 0))
                              for e in eyes])
            projs = np.broadcast_to(proj, (self.batch, 4, 4)).copy()
            self.sets.append((jnp.asarray(views), jnp.asarray(projs)))
        self.n = len(self.sets)
        self.cap = P.batch_bin_params(
            self.xyuv, self.indices, self.heights,
            jnp.concatenate([v for v, _ in self.sets]),
            jnp.concatenate([p for _, p in self.sets]),
            self.scal[4], self.scal[5], W, H)

    def _args(self, i):
        views, projs = self.sets[i]
        return (self.xyuv, self.indices, self.heights, views, projs, self.lut,
                *self.scal, W, H, *self.cap)

    def render(self, variant, i):
        return jax.device_get(P._terrain_render_batch(
            *self._args(i), use_pallas=(variant == "pallas")))

    def lowered(self, variant):
        return P._terrain_render_batch.lower(
            *self._args(0), use_pallas=(variant == "pallas"))

    def plan(self, variant):
        """Frame 0 of the first set as a single-frame plan (g-buffer
        parity)."""
        views, projs = self.sets[0]
        return P.plan_terrain(
            self.xyuv, self.indices, self.heights, views[0], projs[0],
            spacing=1.0, exaggeration=1.0, h_min=-0.5, h_max=0.5,
            exposure=1.0, sun_dir=self.scal[3], lut=self.lut, width=W,
            height=H, backend=variant)


class DemCell:
    """(c) Renderer(800, 600).add_terrain(seeded DEM) -> render_rgba()."""
    def __init__(self):
        self.name = f"c_renderer_dem{DEM_N}_extended"
        self.obj = vf.Renderer(W, H)
        self.obj.add_terrain(seeded_dem(DEM_N), (30.0, 30.0), 1.0, "terrain")
        self.obj.set_sun(35.0, 120.0)
        self.n = 3

    def render(self, variant, i):
        set_backend(variant)
        return self.obj.render_rgba()

    def plan(self, variant):
        args, kwargs = self.obj._draw_args()
        return P.plan_terrain(*args, backend=variant, **kwargs)


# ---------------- phases ----------------

def phase_device():
    devices = require_gpu()
    say("device", devices=[str(d) for d in devices],
        kind=devices[0].device_kind, count=len(devices),
        jax=jax.__version__)
    card = gpu_name_power_limit()
    print(card, flush=True)
    return devices, card


def _mem(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: getattr(m, k, None) for k in keys}


def phase_memory(cells):
    for cell in cells:
        for variant in VARIANTS:
            t0 = time.perf_counter()
            if isinstance(cell, BatchCell):
                stats = {"batch": _mem(cell.lowered(variant).compile()),
                         "capacity": cell.cap}
            else:
                plan = cell.plan(variant)
                stats = {
                    "records": _mem(P._terrain_records.lower(
                        *plan.records_args, **plan.records_static).compile()),
                    "raster_fs": _mem(P._terrain_render_from_records.lower(
                        *plan.args, **plan.static).compile()),
                    "capacity": plan.static["capacity"],
                    "triangles": int(plan.args[1].shape[0])}
            say("memory", cell=cell.name, variant=variant,
                compile_s=time.perf_counter() - t0, **stats)


def phase_timing(cells, card):
    """Both variants of each cell, interleaved (ABAB...); every timed call
    ends in a full device_get readback. Returns the last images."""
    results, images = {}, {}
    for cell in cells:
        t0 = time.perf_counter()
        for variant in VARIANTS:              # warm-up: every camera, both
            for i in range(cell.n):
                images[(cell.name, variant)] = cell.render(variant, i)
        warm_s = time.perf_counter() - t0
        times = {v: [] for v in VARIANTS}
        for i in range(cell.n):
            order = VARIANTS if i % 2 == 0 else VARIANTS[::-1]
            for variant in order:
                t1 = time.perf_counter()
                cell.render(variant, i)
                times[variant].append((time.perf_counter() - t1) * 1e3)
        med = {v: statistics.median(t) for v, t in times.items()}
        results[cell.name] = med
        say("timing", cell=cell.name, card=card, warmup_s=warm_s,
            ms=times, median_ms=med,
            kernel_over_xla=med["pallas"] / med["jnp"])
    faster = (results[cells[0].name]["pallas"] < results[cells[0].name]["jnp"]
              and results[cells[1].name]["pallas"]
              < results[cells[1].name]["jnp"]
              and results[cells[2].name]["pallas"]
              <= results[cells[2].name]["jnp"])
    say("timing", decision=("kernel faster in (a) and (b), no slower in (c)"
                            if faster else "kernel does not win"))
    return images


def _compare_gbuffers(label, ref, got):
    """Coverage must match exactly. Varyings where both cover are reported
    (differing count, max abs difference); the image check bounds them."""
    rm, gm = np.asarray(ref[3]), np.asarray(got[3])
    flips = int((rm != gm).sum())
    covered = int(rm.sum())
    both = rm & gm
    diffs = []
    for a, b in zip(ref[:3], got[:3]):
        a = np.where(both, np.asarray(a), 0)
        b = np.where(both, np.asarray(b), 0)
        diffs.append({"ne": int((a != b).sum()),
                      "max_abs": float(np.abs(a - b).max())})
    say("parity", what=label, covered=covered, coverage_flips=flips,
        varyings=diffs)
    assert covered > 0, label
    assert flips == 0, f"{label}: {flips} coverage flips of {covered}"


def _image_lsb(label, ref, got, bound=1):
    d = np.abs(np.asarray(ref, np.int16) - np.asarray(got, np.int16))
    over = int((d > bound).sum())
    say("parity", what=label, max_lsb=int(d.max()), bytes_over_bound=over,
        bytes_differing=int((d > 0).sum()))
    assert over == 0, f"{label}: {over} bytes differ by more than {bound}"


_bin = jax.jit(bin_triangles, static_argnums=(1, 2, 3),
               static_argnames=("span_x", "span_y"))
_raster = jax.jit(P._raster, static_argnums=(3, 4, 5, 6))


def _gbuffers_from_plan(plan, variants=(False, True)):
    """G-buffers of a plan's records: the jnp reference (False) and the
    Triton kernel (True), in that order, on the current default device."""
    records, bbox = plan.args[0], plan.args[1]
    st = plan.static
    binning = _bin(bbox, st["width"], st["height"], st["capacity"],
                   span_x=st["span_x"], span_y=st["span_y"])
    return [jax.device_get(_raster(
        records, binning.tile_lists, binning.counts, st["width"],
        st["height"], use_pallas, st["fill_rule"]))
        for use_pallas in variants]


def _clipped_plan(fill_rule, width, height, n_tris, seed=5):
    """Records of tests/test_clipping._gen_scene rasterized at width x
    height (its projection's aspect is 4:3, as 800x600 is)."""
    from test_clipping import _gen_scene
    clip, attrs, idx = _gen_scene(seed, n_tris=n_tris)
    x, y, z, w = clip_to_fb(jnp.asarray(clip, jnp.float32), width, height)
    records, bbox = triangle_setup(x, y, z, w, jnp.asarray(attrs, jnp.float32),
                                   jnp.asarray(idx), width, height,
                                   fill_rule=fill_rule)
    cap, sx, sy = P._static_bin_params(bbox, width, height)
    return P.TerrainPlan((), {}, (records, bbox),
                         dict(width=width, height=height, capacity=cap,
                              span_x=sx, span_y=sy, fill_rule=fill_rule))


def phase_parity(cells, images):
    # Kernel vs reference on the card, real widths.
    for cell in cells:
        ref, got = _gbuffers_from_plan(cell.plan("pallas"))
        _compare_gbuffers(f"gpu kernel vs gpu xla gbuffer {cell.name}",
                          ref, got)
        _image_lsb(f"gpu kernel vs gpu xla image {cell.name}",
                   images[(cell.name, "jnp")], images[(cell.name, "pallas")])
    for rule in ("inclusive", "hw"):
        ref, got = _gbuffers_from_plan(_clipped_plan(rule, W, H, 2000))
        _compare_gbuffers(f"gpu kernel vs gpu xla gbuffer clipped_{rule}",
                          ref, got)

    # GPU (kernel) vs CPU (reference) at a smaller size.
    cpu = jax.devices("cpu")[0]
    for rule in ("inclusive", "hw"):
        (got,) = _gbuffers_from_plan(_clipped_plan(rule, 160, 120, 50),
                                     variants=(True,))
        with jax.default_device(cpu):
            (ref,) = _gbuffers_from_plan(_clipped_plan(rule, 160, 120, 50),
                                         variants=(False,))
        _cross_device(f"clipped_{rule}_160x120", ref, got)
    _gpu_vs_cpu_images()

    # Golden-scene hashes on this device class.
    import test_goldens
    set_backend("pallas")
    hashes = {k: hashlib.sha256(img.tobytes()).hexdigest()
              for k, img in test_goldens._render_all().items()}
    say("goldens", device_class=test_goldens._device_class(), sha256=hashes)


def _cross_device(label, ref, got, max_flip_frac=1e-3):
    """GPU vs CPU g-buffers: records are set up on each device, and
    FMA contraction differs between Triton, XLA:GPU and XLA:CPU, so a
    pixel centre lying exactly on an edge can flip. Bound: flips <= 0.1%
    of covered pixels."""
    rm, gm = np.asarray(ref[3]), np.asarray(got[3])
    flips = int((rm != gm).sum())
    covered = int(rm.sum())
    both = rm & gm
    rel = [float(np.max(np.abs(np.where(both, np.asarray(a) - np.asarray(b),
                                        0)))) for a, b in zip(ref[:3], got[:3])]
    say("parity", what=f"gpu kernel vs cpu reference gbuffer {label}",
        covered=covered, coverage_flips=flips, flip_frac=flips / covered,
        max_abs_varying_diff=rel)
    assert flips <= max_flip_frac * covered, label


def _gpu_vs_cpu_images():
    """Public API scenes rendered on the GPU (kernel) and on the CPU
    (reference): image bytes within 1 LSB outside coverage flips."""
    h = (np.outer(np.sin(np.linspace(0, 3, 33)),
                  np.cos(np.linspace(0, 2, 45))) * 0.3).astype(np.float32)

    def scenes():
        s = vf.Scene(160, 120, 32, "magma")
        s.set_height_from_r32f(h)
        t = vf.TerrainSpike(160, 120, 48, "terrain")
        t.set_camera_look_at((2.0, 1.5, 2.5), (0, 0, 0), (0, 1, 0),
                             50.0, 0.1, 50.0)
        r = vf.Renderer(128, 96)
        r.add_terrain(seeded_dem(64), (10.0, 10.0), 1.0, "viridis")
        return {"scene_160x120": s.render_rgba,
                "spike_160x120_g48": t.render_rgba,
                "renderer_128x96_dem64": r.render_rgba,
                "triangle_97x61": lambda: vf.render_triangle_rgba(97, 61)}

    set_backend("pallas")
    gpu = {k: f() for k, f in scenes().items()}
    set_backend("jnp")
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = {k: f() for k, f in scenes().items()}
    set_backend("pallas")
    for k in gpu:
        d = np.abs(gpu[k].astype(np.int16) - cpu[k].astype(np.int16))
        px_over = int((d.max(axis=-1) > 1).sum())
        covered = int((cpu[k][..., :3] != cpu[k][0, 0, :3]).any(-1).sum())
        say("parity", what=f"gpu kernel vs cpu reference image {k}",
            max_lsb=int(d.max()), pixels_over_1lsb=px_over,
            covered_estimate=covered)
        assert px_over <= max(1, 1e-3 * covered), k


def _check_png(path, w, h):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", path
    assert int.from_bytes(data[16:20], "big") == w, path
    assert int.from_bytes(data[20:24], "big") == h, path


def _check_img(img, w, h):
    assert img.shape == (h, w, 4) and img.dtype == np.uint8
    assert (img[..., 3] == 255).all()


def phase_api(dem_cell):
    os.makedirs(OUT_DIR, exist_ok=True)
    set_backend("auto")
    assert P.backend_name() == "pallas"
    t0 = time.perf_counter()
    img = vf.render_triangle_rgba(W, H)
    _check_img(img, W, H)
    png = os.path.join(OUT_DIR, "triangle.png")
    vf.render_triangle_png(png, W, H)
    _check_png(png, W, H)

    t = vf.make_terrain(W, H, SPIKE_GRID)
    png = os.path.join(OUT_DIR, "spike.png")
    t.render_png(png)
    _check_png(png, W, H)

    s = vf.Scene(W, H, 256, "magma")
    s.set_height_from_r32f(seeded_dem(512) / 900.0)
    img = s.render_rgba()
    _check_img(img, W, H)
    assert len(np.unique(img.reshape(-1, 4), axis=0)) > 100

    r = dem_cell.obj
    img = r.render_rgba()
    _check_img(img, W, H)
    png = os.path.join(OUT_DIR, "dem.png")
    r.render_png(png)
    _check_png(png, W, H)

    eyes = orbit_eyes(4, math.sqrt(18.0), 2.0)
    frames = vf.render_spike_frames(W, H, BATCH_GRID, eyes,
                                    devices=jax.devices()[:1])
    assert frames.shape == (4, H, W, 4)
    assert not np.array_equal(frames[0], frames[1])
    say("api", ok=True, seconds=time.perf_counter() - t0,
        metrics=r.render_metrics())


def phase_four(card):
    devices = require_gpu()
    assert len(devices) >= 4, f"--four needs 4 GPUs, found {len(devices)}"
    eyes = orbit_eyes(8, math.sqrt(18.0), 2.0)
    times = {}
    out = {}
    for label, devs in (("four", devices[:4]), ("one", devices[:1])):
        vf.render_spike_frames(W, H, BATCH_GRID, eyes, devices=devs)  # warm
        t0 = time.perf_counter()
        out[label] = vf.render_spike_frames(W, H, BATCH_GRID, eyes,
                                            devices=devs)
        times[label] = (time.perf_counter() - t0) * 1e3
    equal = bool(np.array_equal(out["four"], out["one"]))
    say("four", frames=len(eyes), grid=BATCH_GRID, card=card, ms=times,
        byte_equal=equal)
    assert out["four"].shape == (8, H, W, 4)
    assert equal, "4-device frames differ from the one-device frames"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only render_spike_frames over 4 GPUs vs one GPU")
    args = ap.parse_args(argv)

    devices, card = phase_device()
    if args.four:
        phase_four(card)
    else:
        cells = [SpikeCell(), BatchCell(), DemCell()]
        phase_memory(cells)
        images = phase_timing(cells, card)
        phase_parity(cells, images)
        phase_api(cells[2])
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
