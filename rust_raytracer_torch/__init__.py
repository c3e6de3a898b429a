"""rust_raytracer_torch — the path tracer on PyTorch and CUDA (Hopper).

A port of `rust_raytracer_tpu` (JAX/Pallas), which stays beside it as the
reference.  The layout mirrors the reference package so each module's
counterpart sits at the same path:

  core/    counter-based RNG (pcg4d, bit-exact) and batched vector math
  scene/   JAX-free scene compiler -> ScenePack of device tensors
  ops/     intersection, BVH8 traversal (hand-written CUDA kernel),
           textures, lights, shading, tonemapping
  render/  camera, integrator vertex, persistent ray pool, film, renderer
  csrc/    CUDA C++ sources, built with nvcc at first use into build/

Host-side scene description is shared with the reference package and
imported from it unchanged: `models`, `scene.graph`, `scene.bvh_builder`,
`scene.bvh8`, `scene.dsl`, `native`, `utils.procgen`, `utils.assets` and
`utils.config.merge_scene_config` / `RenderConfig`.  Nothing here imports
JAX.

Every public entry takes an explicit `device`; nothing picks one on its own.
"""

__version__ = "0.1.0"
