"""Closest-hit triangle traversal of the BVH8: the CUDA kernel and its plain
PyTorch version.

`intersect_triangles_bvh8` replaces the reference's Pallas kernel
(rust_raytracer_tpu/ops/pallas_bvh8.py).  On a CUDA tensor it launches the
hand-written kernel in csrc/bvh8_traverse.cu (built with nvcc at first use
into build/rrt_torch/ by ops/_cuda.py); on a CPU tensor it runs
`traverse_plain`.  There is no fallback between the two: a CUDA input that
cannot launch raises.

Contract (the reference kernel's): rays org/dirn (N, 3) f32 and t_max (N,)
f32 in; (t, slot) out, where slot = cluster * 128 + lane indexes the padded
triangle table and t == t_max where nothing was hit.  t_min is fixed at
T_MIN_STATIC = 1e-3 (the caller's t_min is ignored, as in the reference).

Its plain version is `traverse_plain` of ops/threaded.py, the port's one
threaded-BVH walk (the reference's oracle, ops/intersect.py kernel="jnp"),
with the same contract: the BVH8 walk visits leaves in another order, so
only the slot of an equal-t tie may differ from it.
"""
from __future__ import annotations

import torch

from . import _cuda
from ._cuda import build_library  # noqa: F401 (re-exported: chip_smoke.py builds through it)
from .threaded import check_rays, traverse_plain

CLUSTER = 128
STACK = 160          # must match csrc/bvh8_traverse.cu

# Launch counters: `launches` counts CUDA kernel launches, `plain_calls`
# calls of the plain version through the wrapper.
launches = 0
plain_calls = 0


def fits(pack) -> bool:
    """Whether the BVH8 kernel can run this scene: it has a BVH8 and the
    walk's stack (at most 8 * depth + 1 entries) fits in STACK.  The
    counterpart of the reference's `_fits_vmem` (ops/intersect.py:350)."""
    return pack.bvh8_child.shape[0] > 0 and 8 * pack.bvh8_depth + 1 <= STACK


def _launch(pack, org, dirn, t_max):
    global launches
    if not fits(pack):
        raise ValueError(
            f"BVH8 depth {pack.bvh8_depth} needs a traversal stack of "
            f"{8 * pack.bvh8_depth + 1} entries; the kernel has {STACK}")
    tables = (pack.bvh8_box, pack.bvh8_child, pack.tri_rows)
    for a in (*tables, org, dirn, t_max):
        if not a.is_contiguous():
            raise ValueError("the BVH8 kernel takes contiguous tensors only")
        if a.device != org.device:
            raise ValueError(f"scene tables on {a.device}, rays on {org.device}")
    if pack.bvh8_child.dtype != torch.int32:
        raise TypeError("bvh8_child must be int32")
    n = org.shape[0]
    t_out = torch.empty((n,), dtype=torch.float32, device=org.device)
    slot = torch.empty((n,), dtype=torch.int32, device=org.device)
    if n == 0:
        return t_out, slot
    _cuda.launch("rrt_bvh8_traverse", (*tables, org, dirn, t_max, t_out, slot),
                 (n,), org.device)
    launches += 1
    return t_out, slot


def intersect_triangles_bvh8(pack, org, dirn, t_min, t_max):
    """Closest triangle hit through the BVH8 (see the module docstring).
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    global plain_calls
    del t_min  # static T_MIN_STATIC, as in the reference kernel
    check_rays(org, dirn, t_max)
    n = org.shape[0]
    if pack.bvh8_child.shape[0] == 0 or pack.tri_rows.shape[0] == 0:
        return t_max, torch.full((n,), -1, dtype=torch.int32, device=org.device)
    if org.device.type == "cuda":
        return _launch(pack, org, dirn, t_max)
    if org.device.type != "cpu":
        raise ValueError(f"no BVH8 traversal for device {org.device}")
    plain_calls += 1
    return traverse_plain(pack, org, dirn, t_max)
