"""Host runtime: compile-cache placement, the PNG writer, native-core
build failures, and chip_smoke.py's phase wiring (device check stubbed)."""
import json
import os
import struct
import zlib

import numpy as np

import vulkan_forge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------- compile cache ----------------

def test_cache_dir_defaults_inside_checkout(monkeypatch):
    monkeypatch.delenv("VF_NO_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = vulkan_forge._compilation_cache_dir()
    assert d == os.path.join(REPO, ".jax_cache",
                             vulkan_forge._machine_fingerprint())


def test_cache_dir_left_to_jax_when_env_set(monkeypatch, tmp_path):
    # JAX reads JAX_COMPILATION_CACHE_DIR itself; the package sets no
    # other directory in code.
    monkeypatch.delenv("VF_NO_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert vulkan_forge._compilation_cache_dir() is None
    import jax
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    vulkan_forge._init_compilation_cache()
    assert calls == []


def test_cache_disabled_by_vf_no_cache(monkeypatch):
    monkeypatch.setenv("VF_NO_CACHE", "1")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert vulkan_forge._compilation_cache_dir() is None


# ---------------- PNG ----------------

def _decode_png_rgba(data):
    """Minimal decoder for the stdlib writer's output (filter 0 rows)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert (depth, ctype) == (8, 6)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 4)


def test_stdlib_png_writer_roundtrip():
    from vulkan_forge._io import png_bytes_rgba
    img = np.random.default_rng(3).integers(0, 256, (7, 13, 4), np.uint8)
    np.testing.assert_array_equal(_decode_png_rgba(png_bytes_rgba(img)), img)


def test_save_png_without_native_core(monkeypatch, tmp_path):
    # PNGs never need the native core or a third-party imaging package:
    # the standard-library writer encodes every one.
    from vulkan_forge import _io, _native
    monkeypatch.setattr(_native, "_build_and_load", lambda: None)
    assert not hasattr(_native, "png_encode_rgba")
    img = np.zeros((5, 6, 4), np.uint8)
    img[..., 1] = 200
    img[..., 3] = 255
    path = tmp_path / "x.png"
    _io.save_png_rgba(str(path), img)
    np.testing.assert_array_equal(_decode_png_rgba(path.read_bytes()), img)


def test_native_build_failure_is_reported(monkeypatch, capsys):
    import ctypes

    from vulkan_forge import _native
    monkeypatch.setattr(_native, "_TRIED", False)
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.delenv("VF_NO_NATIVE", raising=False)

    def boom(path):
        raise OSError("cannot load " + path)
    monkeypatch.setattr(ctypes, "CDLL", boom)
    assert _native._build_and_load() is None
    err = capsys.readouterr().err
    assert "native core unavailable" in err and "OSError" in err


# ---------------- chip_smoke.py wiring ----------------

class _FakeGpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def _stub_smoke(monkeypatch, n_devices):
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import jax
    calls = []
    devs = [_FakeGpu() for _ in range(n_devices)]
    monkeypatch.setattr(cs, "require_gpu", lambda: devs)
    monkeypatch.setattr(cs, "gpu_name_power_limit",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(jax, "devices", lambda *a: devs)

    class Cell:
        def __init__(self, *a):
            self.name = type(self).__name__

    for name in ("SpikeCell", "BatchCell", "DemCell"):
        monkeypatch.setattr(cs, name, type(name, (Cell,), {}))
    monkeypatch.setattr(cs, "phase_memory",
                        lambda cells: calls.append(
                            ("memory", [c.name for c in cells])))
    monkeypatch.setattr(cs, "phase_timing",
                        lambda cells, card: calls.append(("timing", card))
                        or {})
    monkeypatch.setattr(cs, "phase_parity",
                        lambda cells, images: calls.append(("parity",)))
    monkeypatch.setattr(cs, "phase_api",
                        lambda cell: calls.append(("api", cell.name)))
    monkeypatch.setattr(cs, "phase_four",
                        lambda card: calls.append(("four",)))
    return cs, calls


def test_chip_smoke_one_card_phases(monkeypatch, capsys):
    cs, calls = _stub_smoke(monkeypatch, 1)
    assert cs.main([]) == 0
    assert calls == [
        ("memory", ["SpikeCell", "BatchCell", "DemCell"]),
        ("timing", "NVIDIA H100 80GB HBM3, 700.00 W"),
        ("parity",), ("api", "DemCell")]
    out = capsys.readouterr().out.strip().splitlines()
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in out[:-1]
    assert json.loads(out[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_chip_smoke_four_runs_only_the_sharded_path(monkeypatch, capsys):
    cs, calls = _stub_smoke(monkeypatch, 4)
    assert cs.main(["--four"]) == 0
    assert calls == [("four",)]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"]["count"] == 4 and last["ok"] is True
