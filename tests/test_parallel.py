"""Multi-device frame-parallel rendering (single-device mesh in-process;
multi-device meshes self-host on virtual CPU devices in a subprocess, and
__graft_entry__.dryrun_multichip exercises the driver's dry run)."""
import numpy as np

import vulkan_forge as vf
from vulkan_forge._parallel import render_spike_frames


def test_render_spike_frames_single_device_mesh():
    import jax
    eyes = [(3.0, 2.0, 3.0), (-3.0, 2.0, 3.0)]
    imgs = render_spike_frames(160, 120, 16, eyes, devices=jax.devices()[:1])
    assert imgs.shape == (2, 120, 160, 4) and imgs.dtype == np.uint8
    # Different cameras produce different frames.
    assert not np.array_equal(imgs[0], imgs[1])
    # Matches the single-frame API for the same camera.
    t = vf.TerrainSpike(160, 120, 16)
    t.set_camera_look_at(eyes[0], (0, 0, 0), (0, 1, 0), 45.0, 0.1, 100.0)
    np.testing.assert_array_equal(imgs[0], t.render_rgba())


def test_dryrun_multichip_8_device_mesh():
    # The driver's multi-chip validation: with only 1 real chip available,
    # dryrun_multichip must self-host on an 8-device virtual CPU mesh
    # (re-exec'ing with --xla_force_host_platform_device_count since JAX is
    # already initialized in this process).
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)  # raises on failure


def test_render_spike_frames_dense_route():
    # A dense mesh (sub-pixel cells at this framebuffer) shards through the
    # same batched list path; it must produce the same frames as the
    # single-frame API.
    import jax
    eyes = [(3.0, 2.0, 3.0), (-3.0, 2.0, 3.0)]
    imgs = render_spike_frames(160, 120, 96, eyes, devices=jax.devices()[:1])
    assert imgs.shape == (2, 120, 160, 4)
    for eye, img in zip(eyes, imgs):
        t = vf.TerrainSpike(160, 120, 96)
        t.set_camera_look_at(eye, (0, 0, 0), (0, 1, 0), 45.0, 0.1, 100.0)
        np.testing.assert_array_equal(img, t.render_rgba())


def test_render_spike_frames_hw_fill_rule(monkeypatch):
    # VF_FILL_RULE=hw reaches the batched path: the sharded frames equal
    # the single-frame API's under the same rule, and differ from the
    # inclusive rule's frames.
    import jax
    eyes = [(3.0, 2.0, 3.0), (-3.0, 2.0, 3.0)]
    monkeypatch.setenv("VF_FILL_RULE", "hw")
    imgs = render_spike_frames(160, 120, 96, eyes, devices=jax.devices()[:1])
    for eye, img in zip(eyes, imgs):
        t = vf.TerrainSpike(160, 120, 96)
        t.set_camera_look_at(eye, (0, 0, 0), (0, 1, 0), 45.0, 0.1, 100.0)
        np.testing.assert_array_equal(img, t.render_rgba())
    monkeypatch.setenv("VF_FILL_RULE", "inclusive")
    incl = render_spike_frames(160, 120, 96, eyes[:1],
                               devices=jax.devices()[:1])
    assert not np.array_equal(imgs[0], incl[0])


def test_render_spike_frames_validation():
    import pytest
    with pytest.raises(ValueError, match="at least one camera"):
        render_spike_frames(64, 64, 8, [])
    with pytest.raises(RuntimeError, match="Unknown colormap"):
        render_spike_frames(64, 64, 8, [(3, 2, 3)], colormap="bad")


def test_render_spike_frames_autopads_to_device_count():
    # B=3 on a 2-device mesh: padded internally, pad frames sliced off.
    # Needs two REAL devices -> self-host on a virtual CPU mesh in a
    # subprocess (the host device count must be set before JAX inits).
    import os
    import subprocess
    import sys
    code = """
import numpy as np
import vulkan_forge as vf
from vulkan_forge._parallel import render_spike_frames
import jax
devs = jax.devices("cpu")[:2]
assert len(devs) == 2
eyes = [(3.0, 2.0, 3.0), (-3.0, 2.0, 3.0), (0.0, 2.5, 4.0)]
imgs = render_spike_frames(96, 64, 12, eyes, devices=devs)
assert imgs.shape == (3, 64, 96, 4), imgs.shape
for eye, img in zip(eyes, imgs):
    t = vf.TerrainSpike(96, 64, 12)
    t.set_camera_look_at(eye, (0, 0, 0), (0, 1, 0), 45.0, 0.1, 100.0)
    np.testing.assert_array_equal(img, t.render_rgba())
print("autopad ok")
"""
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": env.get("XLA_FLAGS", "") +
                " --xla_force_host_platform_device_count=2"})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "autopad ok" in proc.stdout


def _load_graft_entry():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dryrun_reexec_child_stays_off_the_gpu(monkeypatch):
    # The dry run's re-exec'd child builds its own virtual CPU mesh and
    # must never open the card its parent may hold.
    import subprocess
    mod = _load_graft_entry()
    captured = {}

    def fake_run(cmd, env=None, cwd=None, timeout=None):
        captured.update(cmd=cmd, env=env, timeout=timeout)

        class R:
            returncode = 0
        return R()

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert mod._reexec_dryrun(4) is None
    env = captured["env"]
    assert env["JAX_PLATFORMS"] == "cpu"
    assert env["VF_DRYRUN_REEXEC"] == "1"
    assert "--xla_force_host_platform_device_count=4" in env["XLA_FLAGS"]
    assert captured["cmd"][-2:] == ["--dryrun", "4"]
    assert captured["timeout"] is not None  # bounded, never rc-124


def test_pick_devices_after_reexec_raises(monkeypatch):
    # Inside the re-exec'd child a short device count is a clear error,
    # never another subprocess.
    import pytest
    mod = _load_graft_entry()
    monkeypatch.setenv("VF_DRYRUN_REEXEC", "1")
    with pytest.raises(RuntimeError, match="even after re-exec"):
        mod._pick_devices(64)


def test_multichip_dense_flagship_scale():
    # Prove the multi-device sharding story where capacity/recompile bugs
    # would actually bite -- a dense mesh (grid=512, T=522,242) over an
    # 8-device mesh with one frame per device and a psum checksum, plus a
    # shard-vs-unsharded byte-identity spot check. Self-hosts on a virtual
    # CPU mesh in a subprocess (the jnp reference raster; the kernel is
    # the same list path).
    import os
    import subprocess
    import sys
    code = """
import math
import numpy as np
import jax, jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P_
from vulkan_forge import _colormap, _mesh
from vulkan_forge._raster import pipeline as P
from vulkan_forge._camera import look_at_rh, perspective_wgpu

GRID, W, H, N = 512, 320, 240, 8
devs = jax.devices("cpu")[:N]
assert len(devs) == N
xyuv_np, idx_np = _mesh.build_grid_xyuv(GRID)
xyuv = jnp.asarray(xyuv_np)
indices = jnp.asarray(idx_np.astype(np.int32).reshape(-1, 3))
heights = jnp.zeros((1, 1), jnp.float32)
lut = jnp.asarray(_colormap.build_lut("viridis")[0])
sun = jnp.asarray(np.array([0.5, 1, 0.3], np.float32)
                  / np.linalg.norm([0.5, 1, 0.3]))
views, projs = [], []
for i in range(N):
    ang = 2.0 * math.pi * i / N
    views.append(look_at_rh((3 * math.cos(ang), 2.0, 3 * math.sin(ang)),
                            (0, 0, 0), (0, 1, 0)))
    projs.append(perspective_wgpu(np.float32(math.radians(45)),
                                  np.float32(W / H), np.float32(0.1),
                                  np.float32(100)))
views = jnp.asarray(np.stack(views))
projs = jnp.asarray(np.stack(projs))
cap = P.batch_bin_params(xyuv, indices, heights, views, projs,
                         jnp.float32(1.0), jnp.float32(1.0), W, H)

def render(views_s, projs_s):
    return P._terrain_render_batch.__wrapped__(
        xyuv, indices, heights, views_s, projs_s, lut,
        jnp.float32(-0.5), jnp.float32(0.5), jnp.float32(1.0), sun,
        jnp.float32(1.0), jnp.float32(1.0), W, H, *cap)

def step(views_s, projs_s):
    imgs = render(views_s, projs_s)
    checksum = jnp.sum(imgs.astype(jnp.uint32) & 0xFF).astype(jnp.float32)
    return imgs, jax.lax.psum(checksum, "frames")

mesh = Mesh(np.array(devs), ("frames",))
sharded = shard_map(step, mesh=mesh,
                    in_specs=(P_("frames"), P_("frames")),
                    out_specs=(P_("frames"), P_()), check_vma=False)
with mesh:
    imgs, total = jax.jit(sharded)(views, projs)
    imgs = jax.device_get(imgs)
assert imgs.shape == (N, H, W)
assert float(total) > 0
# Shard 0 must byte-equal the unsharded single-frame render.
solo = jax.device_get(jax.jit(render)(views[:1], projs[:1]))[0]
np.testing.assert_array_equal(imgs[0], solo)
print("dense multichip ok:", imgs.shape, float(total))
"""
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": env.get("XLA_FLAGS", "") +
                " --xla_force_host_platform_device_count=8"})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                          capture_output=True, text=True, timeout=560)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dense multichip ok" in proc.stdout
