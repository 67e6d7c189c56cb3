#!/usr/bin/env python3
"""Cross-backend identity runner.

The reference proves output identity across graphics backends
(Vulkan/DX12/Metal/GL) with one subprocess per backend
(python/tools/backends_runner.py). This rebuild's backend matrix is
{GPU+Pallas (the Triton list kernel), GPU+jnp, CPU+jnp}: the same raster
math through different compilation paths. Each backend runs in a fresh
subprocess (fresh JAX runtime, the analog of not reusing the wgpu OnceCell
context) with VF_BACKEND / JAX_PLATFORMS set, one after another (a JAX
process reserves most of a GPU's memory); the report has the same JSON
shape and the same ok/unsupported/error classification.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Optional

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir)

BACKENDS = ["GPU_PALLAS", "GPU_JNP", "CPU_JNP"]

CHILD_SNIPPET = r"""
import os, sys, time, hashlib
sys.path.insert(0, os.environ["VF_REPO"])
import numpy as np
be = os.environ["VF_CHILD_BACKEND"]
import jax
want = "cpu" if be.startswith("CPU") else "gpu"
if jax.devices()[0].platform != want:
    print(f"UNSUPPORTED: no {want} device"); raise SystemExit(3)
os.environ["VF_BACKEND"] = "pallas" if be.endswith("PALLAS") else "jnp"
from vulkan_forge import Renderer
w = int(os.environ.get("VF_WIDTH", "128"))
h = int(os.environ.get("VF_HEIGHT", "128"))
png = os.environ.get("VF_WRITE_PNG", "0") == "1"
t0 = time.perf_counter()
r = Renderer(w, h)
arr = r.render_triangle_rgba()
dt = (time.perf_counter() - t0) * 1000.0
sha = hashlib.sha256(arr.tobytes()).hexdigest()
if png:
    r.render_triangle_png(os.environ["VF_PNG_PATH"])
print(sha, f"{dt:.3f}")
"""


@dataclass
class BackendResult:
    backend: str
    status: str  # ok | unsupported | error
    sha256: Optional[str]
    millis: Optional[float]
    message: Optional[str]
    png: Optional[str]


def run_once(backend: str, width: int, height: int, write_png: bool,
             out_dir: str) -> BackendResult:
    env = os.environ.copy()
    env["PYTHONUNBUFFERED"] = "1"
    env["VF_REPO"] = os.path.abspath(REPO)
    env["VF_CHILD_BACKEND"] = backend
    if backend.startswith("CPU"):
        env["JAX_PLATFORMS"] = "cpu"
    env["VF_WIDTH"] = str(width)
    env["VF_HEIGHT"] = str(height)
    if write_png:
        os.makedirs(out_dir, exist_ok=True)
        env["VF_WRITE_PNG"] = "1"
        env["VF_PNG_PATH"] = os.path.join(out_dir, f"triangle_{backend.lower()}.png")
    else:
        env["VF_WRITE_PNG"] = "0"

    cmd = [sys.executable, "-c", CHILD_SNIPPET]
    try:
        out = subprocess.check_output(cmd, env=env, stderr=subprocess.STDOUT,
                                      text=True, timeout=600)
        line = out.strip().splitlines()[-1]
        sha, millis = line.split()
        return BackendResult(backend, "ok", sha, float(millis), None,
                             os.path.basename(env.get("VF_PNG_PATH", "")) or None)
    except subprocess.CalledProcessError as e:
        msg = e.output.strip() if isinstance(e.output, str) else str(e)
        if e.returncode == 3 or "unsupported" in msg.lower():
            return BackendResult(backend, "unsupported", None, None, msg, None)
        return BackendResult(backend, "error", None, None, msg, None)
    except Exception as e:  # pragma: no cover
        return BackendResult(backend, "error", None, None, str(e), None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backends", nargs="*", default=None,
                    help=f"Override backend list (default: {' '.join(BACKENDS)})")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--png", action="store_true")
    ap.add_argument("--out-dir", default="backends_artifacts")
    ap.add_argument("--require-same", action="store_true",
                    help="require identical RAW bytes across successful backends")
    args = ap.parse_args(argv)

    bk_list = [b.upper() for b in (args.backends or BACKENDS)]
    os.makedirs(args.out_dir, exist_ok=True)

    per_backend = {}
    for bk in bk_list:
        shas, times = [], []
        last_png = None
        status, message = "ok", None
        for i in range(args.runs):
            res = run_once(bk, args.width, args.height, args.png and i == 0,
                           args.out_dir)
            if res.status != "ok":
                status, message = res.status, res.message
                break
            shas.append(res.sha256)
            times.append(res.millis or 0.0)
            last_png = res.png
        if status == "ok":
            if len(set(shas)) != 1:
                status, message = "error", f"non-deterministic across runs: {shas}"
        per_backend[bk] = {
            "status": status,
            "message": message,
            "runs": args.runs if status == "ok" else 1,
            "sha256": (shas[0] if shas else None),
            "avg_ms": (sum(times) / max(1, len(times))) if times else None,
            "png": last_png,
        }

    ok_hashes = [d["sha256"] for d in per_backend.values()
                 if d["status"] == "ok" and d["sha256"]]
    report = {
        "width": args.width, "height": args.height, "runs": args.runs,
        "backends": bk_list,
        "require_same": args.require_same,
        "per_backend": per_backend,
        "at_least_one_ok": any(d["status"] == "ok" for d in per_backend.values()),
        "cross_backend_equal": (len(set(ok_hashes)) == 1) if ok_hashes else False,
    }
    with open(os.path.join(args.out_dir, "backends_report.json"), "w",
              encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))

    if not report["at_least_one_ok"]:
        raise SystemExit("All requested backends failed or unsupported.")
    if args.require_same and not report["cross_backend_equal"]:
        raise SystemExit("Cross-backend hashes differ and --require-same was set.")
    print("Cross-backend check OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
