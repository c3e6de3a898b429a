"""rust_raytracer_torch — the path tracer on PyTorch and CUDA (Hopper).

A port of `rust_raytracer_tpu` (JAX/Pallas), which stays beside it as the
reference.  The layout mirrors the reference package so each module's
counterpart sits at the same path:

  core/    counter-based RNG (pcg4d, bit-exact) and batched vector math
  scene/   scene graph, BVH builder and BVH8 collapse, JAX-free scene
           compiler -> ScenePack of device tensors
  native/  the C++ BVH builder and OBJ parser, built with g++ at first use
  ops/     intersection, the traversals (BVH8 walk, threaded walk,
           wavefront pipeline; hand-written CUDA kernels), textures,
           lights, shading, tonemapping
  render/  camera, integrator (path vertex, batch and differentiable
           trace), persistent ray pool, checkpoint/resume, film, renderer
  models/  built-in scenes;  scene/dsl.py  the scene DSL
  utils/   config and CLI flags, the CLI (`python -m rust_raytracer_torch`),
           render metrics, procedural meshes, OBJ assets, the glTF / FBX /
           COLLADA importers
  csrc/    CUDA C++ sources, built with nvcc at first use into build/

The host-side modules (scene/graph.py, dsl.py, bvh_builder.py, bvh8.py,
native/, models/, utils/) are the port's own copies of the reference
package's, held equal to them by tests/test_torch_scene.py and
tests/test_torch_cli.py.  Nothing here imports JAX or the reference package.

Every public entry takes an explicit `device`; nothing picks one on its own.
The CLI renders on the card unless its caller passes device="cpu".
"""

__version__ = "0.1.0"
