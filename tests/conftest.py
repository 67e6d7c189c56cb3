"""Shared test helpers.

Tests that need a GPU carry the registered ``gpu`` marker (pytest.ini) and
run on the card with ``python -m pytest tests -m gpu``. Whether a GPU is
present is decided in the autouse fixture below, when a marked test runs
-- never while a module is imported, so every pytest-xdist worker
collects the same tests. Elsewhere the Triton list-raster kernel is tested
through the Pallas interpreter: ``interpret=True`` passed to the kernel
wrappers, or the ``interpret_kernel`` fixture for whole-pipeline renders.
"""
from __future__ import annotations

import functools

import pytest


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Run the pipeline's kernel raster stage (``backend="pallas"``)
    through the Pallas interpreter for this test. The pipeline's jitted
    renders are cleared before and after, so no interpreted trace outlives
    the test and no compiled one is reused inside it."""
    from vulkan_forge._raster import pallas_backend, pipeline
    renders = (pipeline._terrain_render_from_records,
               pipeline._terrain_render_batch, pipeline._triangle_render)
    for name in ("render_gbuffer", "render_gbuffer_batch"):
        monkeypatch.setattr(pallas_backend, name, functools.partial(
            getattr(pallas_backend, name), interpret=True))
    for f in renders:
        f.clear_cache()
    yield
    for f in renders:
        f.clear_cache()


@pytest.fixture(autouse=True)
def _skip_gpu_tests_without_gpu(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the list-raster kernel is compiled by "
                    "Triton, which has no CPU lowering")
