"""Rasterization core (a tiled sort-middle software rasterizer).

Replaces the reference's wgpu render pipelines + WGSL shaders
(src/terrain/pipeline.rs, src/shaders/*.wgsl) with a tile-binned,
data-parallel rasterizer:

  transform  -- vertex "shaders" as batched jnp math
  setup      -- triangle setup (edge equations, 1/w varyings) + tile binning
  tiles      -- pixel-vectorized per-tile raster loop (pure jnp; the oracle)
  pallas_backend -- the same loop as a Pallas kernel through Triton (GPU)
  fragment   -- fragment "shaders" as XLA-fused epilogues (LUT, Lambert, sRGB)
  pipeline   -- end-to-end jitted render entry points
"""
