"""Per-lane row gathers, `table[idx]`, whose backward on the card is a
hand-written kernel (csrc/row_gather.cu).

The differentiable trace gathers, each bounce and for every lane, a row of
the scene's tables by primitive or material id (ops/intersect.py:
hit_attributes, ops/shade.py:shade) and the lane state by the compaction
sort's permutation (render/integrator.py:_sort_lanes).  PyTorch's backward
of `table[idx]` (index_put_ with accumulate) gives one warp to each
distinct row and walks its lanes in series; here almost every id repeats
(dead lanes and misses clamp to row 0, a lane of one primitive kind clamps
its id into the other kinds' tables), so a few warps walk nearly all the
lanes.  `rows` gathers as `table[idx]` does and, where autograd records on
the card, takes `row_gather_bwd` as its backward: a stable sort of the ids
(torch.sort), then a segmented sum over fixed tiles of sorted positions and
a second pass over the runs the tiles cut (see the kernel's source).  Its
sum order is fixed by the ids alone, so it gives the same bits on every
run, in a CUDA graph as eagerly, and uses no atomics.

The route (`engages`): a CUDA table that requires grad, with grad enabled,
takes the kernel's backward (float32 or float64); anywhere else `rows` is
`table[idx]`, code path and bits, so the CPU, a call under no_grad and a
table that needs no grad are unchanged.  The engaged route checks its
inputs and raises on what the kernel does not take; nothing falls back.
`plain_row_gather_bwd` is what the kernel computes (up to the order of a
row's sum), for the tests.

`launches["row_gather_bwd"]` counts the kernel's backward calls that
launched (each its tile and carry kernels); `plain_calls[site]` counts
the calls that took `table[idx]`, by the gather's site (SITES).
"""
from __future__ import annotations

import math

import torch

from . import _cuda

SITES = ("sph_row", "pln_row", "tri_attr", "mrow", "lanes")
launches = {"row_gather_bwd": 0}
plain_calls = dict.fromkeys(SITES, 0)

TILE = 256   # sorted positions a block: csrc/row_gather.cu:TILE
DTYPES = (torch.float32, torch.float64)


def engages(table) -> bool:
    """Whether a gather of `table` takes the kernel's backward: a CUDA
    table that requires grad, with grad enabled."""
    return table.device.type == "cuda" and torch.is_grad_enabled() and table.requires_grad


def rows(table, idx, site: str):
    """`table[idx]` for a (n,) int64 `idx` of row ids; where `engages`, an
    autograd op whose backward is `row_gather_bwd`.  `site` names the
    gather for `plain_calls`."""
    if not engages(table):
        plain_calls[site] += 1
        return table[idx]
    if idx.device != table.device:
        raise ValueError(f"a row gather takes its ids on the table's device {table.device}, "
                         f"got {idx.device}")
    if not table.is_contiguous() or table.dtype not in DTYPES:
        raise ValueError(f"a row gather takes a contiguous float32 or float64 table, got "
                         f"{table.dtype} {tuple(table.shape)} strides {table.stride()}")
    if idx.dtype != torch.int64 or idx.dim() != 1:
        raise ValueError(f"a row gather takes (n,) int64 ids, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    return _Rows.apply(table, idx)


class _Rows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        shape = ctx.table_shape
        flat = grad.contiguous().view(grad.shape[0], math.prod(shape[1:]))
        out = row_gather_bwd(flat, idx, shape[0])
        # a (rows, C) table's gradient is returned as allocated, not as a
        # view: autograd then sums a table's gradients from several gathers
        # into the first in place, as it does PyTorch's own backward's
        return (out if out.shape == shape else out.view(shape)), None


def row_gather_bwd(grad, idx, n_rows: int):
    """(n_rows, C) of `grad`'s (n, C) rows summed by row id `idx` (ids in
    [-n_rows, n_rows), as `table[idx]` takes them), on the card: the stable
    sort of the ids, then csrc/row_gather.cu.  Raises on inputs it does not
    take: CUDA tensors on one device, `grad` contiguous float32 or float64,
    `idx` (n,) int64."""
    if idx.device != grad.device or grad.device.type != "cuda":
        raise ValueError(f"the row gather's backward takes CUDA tensors on one device, got "
                         f"{grad.device} and {idx.device}")
    n = idx.shape[0] if idx.dim() == 1 else -1
    if (grad.dim() != 2 or grad.shape[0] != n or not grad.is_contiguous()
            or grad.dtype not in DTYPES or idx.dtype != torch.int64):
        raise ValueError(f"the row gather's backward takes a contiguous (n, C) float32 or "
                         f"float64 gradient and (n,) int64 ids, got {grad.dtype} "
                         f"{tuple(grad.shape)} and {idx.dtype} {tuple(idx.shape)}")
    cols = grad.shape[1]
    if n >= 2**31 or n_rows >= 2**31:
        raise ValueError(f"the row gather's backward takes fewer than 2^31 lanes and rows, "
                         f"got {n} and {n_rows}")
    out = torch.zeros((n_rows, cols), dtype=grad.dtype, device=grad.device)
    if n and cols:
        keys, lanes = torch.sort(idx.remainder(n_rows).to(torch.int32), stable=True)
        tiles = (n + TILE - 1) // TILE
        carry = torch.empty((2 * tiles, cols), dtype=grad.dtype, device=grad.device)
        carry_id = torch.empty(2 * tiles, dtype=torch.int32, device=grad.device)
        _cuda.launch("rrt_row_gather_bwd", (keys, lanes, grad, out, carry, carry_id),
                     (n, cols, int(grad.dtype == torch.float64)), grad.device)
        launches["row_gather_bwd"] += 1
    return out


def plain_row_gather_bwd(grad, idx, n_rows: int):
    """What `row_gather_bwd` computes, in torch ops: `grad`'s rows added into
    zeros at the rows `idx` names."""
    return torch.zeros((n_rows, grad.shape[1]), dtype=grad.dtype,
                       device=grad.device).index_add_(0, idx.remainder(n_rows), grad)


def attributes() -> dict:
    """Registers, local and static shared bytes of the two kernels."""
    return {"row_gather_bwd_tile": _cuda.attributes("rrt_row_gather_bwd"),
            "row_gather_bwd_carry": _cuda.attributes("rrt_row_gather_bwd_carry")}
