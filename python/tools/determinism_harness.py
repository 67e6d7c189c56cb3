#!/usr/bin/env python3
"""Determinism harness for the vulkan-forge JAX rebuild.

Renders a scene N times (optionally across processes) and asserts the raw
RGBA bytes hash identically; writes a JSON report with the same keys as the
reference tool (python/tools/determinism_harness.py:80-111: width/height/
runs/processes/hashes/unique/all_equal/avg_ms, optional png/png_error).

Extension over the reference: --scene terrain hashes the full terrain
pipeline (both raster kernels + backend selection) instead of only the
gradient triangle.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from dataclasses import dataclass

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, os.pardir))

try:
    from vulkan_forge import Renderer
except Exception as e:  # pragma: no cover
    raise SystemExit(f"Failed to import vulkan_forge.Renderer: {e}")


@dataclass
class RunResult:
    sha256: str
    millis: float


def render_bytes(w: int, h: int, scene: str = "triangle") -> bytes:
    if scene == "terrain":
        import numpy as np
        from vulkan_forge import Scene
        s = Scene(w, h, 32, "viridis")
        hm = np.outer(np.sin(np.linspace(0, 3, 64)),
                      np.cos(np.linspace(0, 2, 64))).astype(np.float32)
        s.set_height_from_r32f(hm)
        return s.render_rgba().tobytes()
    r = Renderer(w, h)
    return r.render_triangle_rgba().tobytes()


def run_sequential(w: int, h: int, runs: int, scene: str) -> "list[RunResult]":
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        b = render_bytes(w, h, scene)
        dt = (time.perf_counter() - t0) * 1000.0
        out.append(RunResult(hashlib.sha256(b).hexdigest(), dt))
    return out


def _mp_worker(q, w, h, scene):
    b = render_bytes(w, h, scene)
    q.put((hashlib.sha256(b).hexdigest(), len(b)))


def run_multiprocess(w: int, h: int, runs: int, procs: int,
                     scene: str) -> "list[RunResult]":
    import multiprocessing as mp
    ctx = mp.get_context("spawn")  # fresh JAX runtime per child
    results = []
    for _ in range(runs):
        q = ctx.Queue()
        ps = [ctx.Process(target=_mp_worker, args=(q, w, h, scene))
              for _ in range(max(1, procs))]
        t0 = time.perf_counter()
        # One child at a time: a JAX process reserves most of a GPU's
        # memory when it first uses the card, so a second would fail.
        # Each child's result is drained before it is joined.
        shas = []
        for p in ps:
            p.start()
            shas.append(q.get(timeout=600)[0])
            p.join()
        dt = (time.perf_counter() - t0) * 1000.0
        if len(set(shas)) != 1:
            raise AssertionError(f"Non-deterministic across processes: {shas}")
        results.append(RunResult(shas[0], dt))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--processes", type=int, default=0,
                    help=">0 enables multi-process check")
    ap.add_argument("--png", action="store_true", help="also write PNG to --out-dir")
    ap.add_argument("--out-dir", default="determinism_artifacts")
    ap.add_argument("--scene", choices=("triangle", "terrain"),
                    default="triangle",
                    help="what to hash (terrain covers the full DEM pipeline)")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)

    if args.processes > 0:
        results = run_multiprocess(args.width, args.height, args.runs,
                                   args.processes, args.scene)
    else:
        results = run_sequential(args.width, args.height, args.runs, args.scene)

    shas = [r.sha256 for r in results]
    unique = sorted(set(shas))
    report = {
        "width": args.width,
        "height": args.height,
        "runs": args.runs,
        "processes": args.processes,
        "hashes": shas,
        "unique": unique,
        "all_equal": len(unique) == 1,
        "avg_ms": sum(r.millis for r in results) / max(1, len(results)),
    }
    if args.scene != "triangle":
        report["scene"] = args.scene

    if args.png:
        try:
            r = Renderer(args.width, args.height)
            r.render_triangle_png(os.path.join(args.out_dir, "triangle.png"))
            report["png"] = "triangle.png"
        except Exception as e:  # pragma: no cover
            report["png_error"] = str(e)

    rep_path = os.path.join(args.out_dir, "determinism_report.json")
    with open(rep_path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))

    if not report["all_equal"]:
        raise SystemExit("Determinism check FAILED: differing hashes")
    print("Determinism check OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
