"""CLI tools (contract: reference tests/test_diagnostics.py,
tests/test_backends.py, tests/test_perf.py -- same env gates)."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=2400):
    # Generous timeout: child processes compile cold (a fresh checkout has
    # an empty compilation cache).
    return subprocess.run([sys.executable] + args, cwd=REPO, timeout=timeout,
                          capture_output=True, text=True)


def test_device_diagnostics_cli(tmp_path):
    out = tmp_path / "diag.json"
    r = _run(["python/tools/device_diagnostics.py", "--json", str(out)])
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads(out.read_text())
    assert "adapters" in rep and "probes" in rep
    assert all(p["status"] in ("ok", "unsupported", "error") for p in rep["probes"])
    assert any(p["status"] == "ok" for p in rep["probes"])


def test_determinism_harness_cli(tmp_path):
    r = _run(["python/tools/determinism_harness.py", "--width", "48",
              "--height", "32", "--runs", "2", "--out-dir", str(tmp_path)])
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads((tmp_path / "determinism_report.json").read_text())
    # Field-for-field parity with the reference report schema
    # (reference determinism_harness.py:82-91).
    assert {"width", "height", "runs", "processes", "hashes", "unique",
            "all_equal", "avg_ms"} <= set(rep)
    assert rep["all_equal"] is True
    assert len(rep["hashes"]) == 2 and len(rep["unique"]) == 1


def test_determinism_harness_terrain_mode(tmp_path):
    # Extension: hash the full terrain pipeline (two kernels + backend
    # selection), not just the triangle.
    r = _run(["python/tools/determinism_harness.py", "--width", "96",
              "--height", "72", "--runs", "2", "--scene", "terrain",
              "--out-dir", str(tmp_path)])
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads((tmp_path / "determinism_report.json").read_text())
    assert rep["all_equal"] is True and rep["scene"] == "terrain"


def test_perf_sanity_failure_exits_2(tmp_path):
    # Reference parity: enforcement failures exit with code 2.
    out = tmp_path / "perf.json"
    env = dict(os.environ, VF_ENFORCE_PERF="1")
    r = subprocess.run(
        [sys.executable, "python/tools/perf_sanity.py", "--width", "64",
         "--height", "64", "--runs", "2", "--warmups", "0",
         "--budget-mult", "1e-9", "--json", str(out)],
        cwd=REPO, timeout=1100, capture_output=True, text=True, env=env)
    assert r.returncode == 2, r.stdout + r.stderr
    assert "FAIL" in r.stdout


@pytest.mark.skipif(os.environ.get("VF_TEST_PERF") != "1",
                    reason="enable with VF_TEST_PERF=1")
def test_perf_sanity_cli(tmp_path):
    out = tmp_path / "perf.json"
    r = _run(["python/tools/perf_sanity.py", "--width", "64", "--height", "64",
              "--runs", "5", "--warmups", "1", "--json", str(out)])
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads(out.read_text())
    assert {"width", "height", "init_ms", "steady"} <= set(rep)
    assert {"mean_ms", "median_ms", "p95_ms"} <= set(rep["steady"])


@pytest.mark.skipif(os.environ.get("VF_TEST_BACKENDS") != "1",
                    reason="enable with VF_TEST_BACKENDS=1")
def test_backends_runner_cli(tmp_path):
    r = _run(["python/tools/backends_runner.py", "--width", "48", "--height",
              "32", "--runs", "1", "--require-same", "--out-dir", str(tmp_path)],
             timeout=580)
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads((tmp_path / "backends_report.json").read_text())
    assert rep["at_least_one_ok"]
    assert rep["cross_backend_equal"]


def test_vf_trace_appends_json_lines(tmp_path, monkeypatch):
    """VF_TRACE=<path> streams per-render stage metrics as JSON lines
    (observability; reference pattern: JSON artifacts)."""
    import json

    import vulkan_forge as vf
    trace = tmp_path / "trace.jsonl"
    monkeypatch.setenv("VF_TRACE", str(trace))
    r = vf.Renderer(32, 32)
    r.render_triangle_rgba()
    r.render_triangle_rgba()
    lines = trace.read_text().strip().splitlines()
    assert len(lines) == 2
    rec = json.loads(lines[0])
    assert rec["width"] == 32 and rec["bytes"] == 32 * 32 * 4
    assert rec["render_ms"] >= 0.0 and rec["total_ms"] >= rec["render_ms"]
