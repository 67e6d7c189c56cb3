"""Device probe taxonomy and identity, including the hung-init watchdog.

A device whose init hangs must turn into an honest {status: error,
message: timed out} instead of hanging the diagnostics CLI. Parity anchor
for the taxonomy: src/lib.rs:779-845; for the adapter dump:
src/lib.rs:755-776.
"""
from __future__ import annotations

import time

import vulkan_forge as vf
from vulkan_forge import _device


def test_probe_legacy_backends_unsupported():
    for b in ("VULKAN", "DX12", "METAL", "GL"):
        r = vf.device_probe(b)
        assert r["status"] == "unsupported"
        assert "millis" in r


def test_probe_current_platform_ok():
    r = vf.device_probe()
    assert r["status"] == "ok", r
    assert r["millis"] > 0
    assert r["device_type"] in ("DiscreteGpu", "Cpu")


def test_probe_times_out_instead_of_hanging(monkeypatch):
    import jax
    monkeypatch.setattr(_device, "_PROBE_TIMEOUT_S", 2.0)
    monkeypatch.setattr(jax, "devices", lambda *a: time.sleep(3600))
    t0 = time.perf_counter()
    r = _device.device_probe("AUTO")
    took = time.perf_counter() - t0
    assert r["status"] == "error"
    assert "timed out" in r["message"]
    assert took < 10.0


def test_adapter_dicts_carry_real_capabilities():
    # VERDICT r4 item 7: features/limits must be real device info, not
    # placeholders (parity: src/lib.rs:755-776 dumps the actual wgpu
    # feature set and limits).
    adapters = _device.enumerate_adapters()
    assert adapters, "at least one JAX device is always visible"
    for a in adapters:
        assert a["name"] and a["name"] != "unknown"
        assert "platform=" in a["features"]
        assert "kind=" in a["features"]
        assert "process_index=" in a["features"]
        assert "max_framebuffer_dim=8192" in a["limits"]
        assert "memory_stats=" not in a["limits"]  # the old placeholder
        if a["device_type"] == "DiscreteGpu":
            assert a["vendor_id"] == 0x10DE
    # When the backing device exposes memory_stats, its byte budgets must
    # surface in limits (the analog of the reference's real limit dump).
    import jax
    for d, a in zip(jax.devices(), adapters):
        try:
            ms = d.memory_stats() or {}
        except Exception:
            ms = {}
        if "bytes_limit" in ms:
            assert f"bytes_limit={int(ms['bytes_limit'])}" in a["limits"]


def test_enumerate_adapters_times_out_empty(monkeypatch):
    import jax
    monkeypatch.setattr(_device, "_PROBE_TIMEOUT_S", 2.0)
    monkeypatch.setattr(jax, "devices", lambda *a: time.sleep(3600))
    assert _device.enumerate_adapters() == []


class _FakeCudaDevice:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"
    id = 0
    process_index = 0

    def memory_stats(self):
        return {"bytes_limit": 80 * 2**30}


def test_cuda_device_reports_as_discrete_nvidia_gpu():
    # Reference src/lib.rs:755-776 dumps a real GPU adapter: DiscreteGpu,
    # PCI vendor 0x10DE for NVIDIA.
    a = _device._device_dict(_FakeCudaDevice())
    assert a["device_type"] == "DiscreteGpu"
    assert a["vendor_id"] == 0x10DE
    assert a["backend"] == "GPU"
    assert a["name"] == "NVIDIA H100 80GB HBM3"
    assert "bytes_limit=85899345920" in a["limits"]


def test_legacy_backend_message_names_gpu_cpu_auto():
    r = vf.device_probe("VULKAN")
    assert r["message"].endswith("use GPU/CPU/AUTO")
    assert _device._KNOWN_BACKENDS == ("GPU", "CPU", "AUTO")


def test_probe_absent_gpu_is_unsupported():
    # On a machine without a GPU the GPU probe classifies, never errors.
    import jax
    if jax.devices()[0].platform == "gpu":
        assert vf.device_probe("GPU")["status"] == "ok"
    else:
        assert vf.device_probe("GPU")["status"] == "unsupported"


def test_default_platform_and_require_gpu_on_cpu(monkeypatch):
    import os
    import sys

    import jax
    import pytest
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert _device.default_platform() == "cpu"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _device.default_platform() == "gpu"

    class Cpu:
        platform = "cpu"
    monkeypatch.setattr(jax, "devices", lambda *a: [Cpu()])
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu()


def _run_without_gpu(script):
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, os.path.join(root, script)],
                          env=env, cwd=root, capture_output=True, text=True,
                          timeout=300)


def test_bench_fails_without_gpu():
    # A measurement path never falls back to the CPU: no GPU, no result.
    proc = _run_without_gpu("bench.py")
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert proc.stdout.strip() == ""


def test_chip_smoke_fails_without_gpu():
    proc = _run_without_gpu("chip_smoke.py")
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok": true' not in proc.stdout
