"""Device discovery and probing on top of JAX.

The analog of the reference's adapter diagnostics (src/lib.rs:744-845):
the wgpu backend matrix (VULKAN/DX12/METAL/GL) collapses to JAX platforms
(GPU through the CUDA plugin, and CPU). The status taxonomy {ok,
unsupported, error} and the ``millis`` timing field are kept so the
diagnostics CLI emits the same JSON shape.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

_KNOWN_BACKENDS = ("GPU", "CPU", "AUTO")
# Graphics backends from the reference CLI surface; reported as unsupported.
_LEGACY_BACKENDS = ("VULKAN", "DX12", "METAL", "GL")

# A hung device init (a wedged driver, a device held by another process)
# would turn "failure detection" into a hang. Probes run the first device
# touch on a daemon thread with a deadline so the taxonomy gains an honest
# "error: timed out" instead (reference: src/lib.rs:779-845). 0 disables
# the watchdog.
_PROBE_TIMEOUT_S = float(os.environ.get("VF_PROBE_TIMEOUT", "120"))


def _with_deadline(fn: Callable[[], Any], timeout_s: float):
    """Run fn() on a daemon thread; (ok, value_or_exc, timed_out).

    Never raises: exceptions come back as (False, exc, False) on both the
    watchdog and the VF_PROBE_TIMEOUT=0 (disabled) paths, so callers like
    enumerate_adapters keep their never-raises contract either way.
    """
    if not timeout_s or timeout_s <= 0:
        try:
            return True, fn(), False
        except Exception as e:
            return False, e, False
    q: "queue.Queue" = queue.Queue(maxsize=1)

    def run():
        try:
            q.put((True, fn()))
        except Exception as e:                     # propagate as value
            q.put((False, e))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        ok, val = q.get(timeout=timeout_s)
        return ok, val, False
    except queue.Empty:
        return False, None, True


def _device_dict(d) -> Dict[str, Any]:
    """Adapter dict with REAL device capabilities (parity:
    src/lib.rs:755-776, which dumps the wgpu adapter's actual feature set
    and limits). The JAX analogs: topology/core attributes and the
    runtime's platform version as *features*; memory_stats byte budgets
    and the validators' framebuffer guardrail as *limits*. Every probe is
    defensive -- enumerate_adapters must never raise."""
    kind = getattr(d, "device_kind", "unknown")
    platform = getattr(d, "platform", "unknown")
    is_gpu = str(platform).lower() == "gpu"

    feats = [f"platform={platform}", f"kind={kind}"]
    for attr in ("process_index", "coords", "core_on_chip",
                 "num_cores", "slice_index"):
        try:
            v = getattr(d, attr, None)
        except Exception:
            v = None
        if v is not None:
            feats.append(f"{attr}={v}")
    try:
        pv = d.client.platform_version
        if pv:
            feats.append(f"platform_version={pv}")
    except Exception:
        pass
    try:
        mems = ",".join(m.kind for m in d.addressable_memories())
        if mems:
            feats.append(f"memory_spaces={mems}")
    except Exception:
        pass

    limits = []
    try:
        ms = d.memory_stats() or {}
        for k in ("bytes_limit", "bytes_in_use", "peak_bytes_in_use",
                  "largest_alloc_size"):
            if k in ms:
                limits.append(f"{k}={int(ms[k])}")
    except Exception:
        pass
    # The framebuffer guardrail _validate.py enforces -- the analog of
    # wgpu's max_texture_dimension_2d in the reference's limit dump.
    limits.append("max_framebuffer_dim=8192")

    return {
        "name": str(kind),
        "backend": str(platform).upper(),
        # wgpu's DeviceType / PCI vendor id: JAX's GPU platform is CUDA, so
        # a discrete NVIDIA adapter; CPUs carry 0 like the reference's
        # software adapters.
        "device_type": "DiscreteGpu" if is_gpu else "Cpu",
        "vendor_id": 0x10DE if is_gpu else 0,
        "device_id": int(getattr(d, "id", 0)),
        "features": ", ".join(feats),
        "limits": ", ".join(limits),
    }


def enumerate_adapters() -> List[Dict[str, Any]]:
    """All visible JAX devices as adapter dicts (parity: src/lib.rs:744-777)."""
    import jax
    ok, val, timed_out = _with_deadline(jax.devices, _PROBE_TIMEOUT_S)
    if timed_out or not ok:
        return []
    return [_device_dict(d) for d in val]


def device_probe(backend: Optional[str] = None) -> Dict[str, Any]:
    """Probe a backend; returns status in {ok, unsupported, error} + millis.

    Parity with src/lib.rs:779-845: unknown/absent backend means AUTO, a
    missing platform is "unsupported", unexpected failures are "error".
    """
    import jax

    b = (backend or "AUTO").upper()
    out: Dict[str, Any] = {"backend_request": b}
    t0 = time.perf_counter()

    if b in _LEGACY_BACKENDS:
        out["status"] = "unsupported"
        out["message"] = f"graphics backend '{b}' not available; use GPU/CPU/AUTO"
        out["millis"] = (time.perf_counter() - t0) * 1000.0
        return out

    try:
        getter = (jax.devices if b == "AUTO"
                  else (lambda: jax.devices(b.lower())))
        ok, val, timed_out = _with_deadline(getter, _PROBE_TIMEOUT_S)
        if timed_out:
            out["status"] = "error"
            out["message"] = (f"device discovery timed out after "
                              f"{_PROBE_TIMEOUT_S:.0f}s (hung device init?)")
            out["millis"] = (time.perf_counter() - t0) * 1000.0
            return out
        if not ok:
            if b != "AUTO" and isinstance(val, RuntimeError):
                out["status"] = "unsupported"
                out["message"] = str(val)
                out["millis"] = (time.perf_counter() - t0) * 1000.0
                return out
            raise val
        devices = val
        if not devices:
            out["status"] = "unsupported"
            out["message"] = "No suitable accelerator device"
            out["millis"] = (time.perf_counter() - t0) * 1000.0
            return out

        d = devices[0]
        info = _device_dict(d)
        out["adapter_name"] = info["name"]
        out["backend"] = info["backend"]
        out["device_type"] = info["device_type"]
        out["vendor_id"] = info["vendor_id"]
        out["device_id"] = info["device_id"]
        out["features"] = info["features"]
        out["limits"] = info["limits"]

        # The analog of request_device: run a trivial computation end to end
        # (deadline-guarded too: a wedged device hangs dispatch, not just
        # discovery).
        import jax.numpy as jnp

        def compute():
            x = jax.device_put(jnp.arange(8, dtype=jnp.float32), d)
            return float(jax.jit(lambda v: v.sum())(x))

        ok, val, timed_out = _with_deadline(compute, _PROBE_TIMEOUT_S)
        if timed_out:
            out["status"] = "error"
            out["message"] = (f"probe computation timed out after "
                              f"{_PROBE_TIMEOUT_S:.0f}s (wedged device?)")
            out["millis"] = (time.perf_counter() - t0) * 1000.0
            return out
        if not ok:
            raise val
        if val != 28.0:
            out["status"] = "error"
            out["message"] = f"probe computation returned {val}, expected 28.0"
        else:
            out["status"] = "ok"
    except Exception as e:  # pragma: no cover - defensive
        out["status"] = "error"
        out["message"] = f"device probe failed: {e}"

    out["millis"] = (time.perf_counter() - t0) * 1000.0
    return out


def default_platform() -> str:
    """JAX's default platform as this package routes on it: 'gpu' (the
    CUDA plugin) or 'cpu'."""
    import jax
    try:
        return "gpu" if jax.default_backend() == "gpu" else "cpu"
    except Exception:
        return "cpu"

