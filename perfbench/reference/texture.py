"""Texture program evaluation of the benchmark's plain reference.

A frozen copy of the same-named plain module of rust_raytracer_torch, kept
here so the reference imports nothing of the program it judges.  Do not
change it to follow the program: a change of the program's arithmetic is
what the comparison exists to catch.

A scene's texture DAG is compiled host-side into a static, topologically
ordered program of `TexNode`s (scene/compiler.py).  `eval_program` evaluates
every node for all N shading points at once into a (num_nodes, N, 3) value
stack; per-ray lookups are then one gather over the node axis.

Scalar textures are carried as vec3 with the value broadcast; scalar
consumers read channel 0.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import vmath

# Node type ids (same values as the reference package)
CONSTANT = 0
CHECKER = 1          # UV-space checkerboard (texture/checkerboard.rs:34-44)


@dataclasses.dataclass(frozen=True)
class TexNode:
    """One static node of a compiled texture program.

    `children` index earlier nodes in the program.
    """
    kind: int
    value: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    children: Tuple[int, ...] = ()
    scale: float = 1.0
    is_scalar: bool = False


def eval_program(program, uv, pos, tex_const=None):
    """Evaluate all texture nodes for all shading points.

    program: tuple of TexNode; uv (N, 2); pos (N, 3); tex_const: optional (num_nodes, 3)
    CONSTANT values (row i = node i), else the static node values.
    Returns the (num_nodes, N, 3) value stack.
    """
    n = uv.shape[0]
    dtype, device = pos.dtype, pos.device
    values = []
    for i, node in enumerate(program):
        if node.kind == CONSTANT:
            if tex_const is not None:
                val = tex_const[i].to(dtype).expand(n, 3)
            else:
                val = vmath.const3(node.value, dtype, device).expand(n, 3)
        elif node.kind == CHECKER:
            # rust `as u32`: truncate toward 0, saturate negatives to 0
            iu = torch.clamp(uv[..., 0] * 2.0 / node.scale, 0.0, 2.0**31).to(torch.int64)
            iv = torch.clamp(uv[..., 1] * 2.0 / node.scale, 0.0, 2.0**31).to(torch.int64)
            even = ((iu + iv) % 2 == 0)[..., None]
            val = torch.where(even, values[node.children[0]], values[node.children[1]])
        else:
            raise ValueError(f"unknown texture node kind {node.kind}")
        values.append(val.to(dtype))
    if not values:
        return torch.zeros((1, n, 3), dtype=dtype, device=device)
    return torch.stack(values, dim=0)


def gather_values(value_stack, tex_ids):
    """Pick per-ray texture values: (T, N, 3)[tex_ids[n], n] -> (N, 3)."""
    idx = tex_ids.to(torch.int64)[None, :, None].expand(1, -1, 3)
    return torch.gather(value_stack, 0, idx)[0]
