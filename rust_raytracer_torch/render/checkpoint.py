"""Checkpoint / resume for long renders (port of
rust_raytracer_tpu/render/checkpoint.py).

The pool renderer's whole lane state, image accumulator and job cursor are
snapshotted to one .npz (written to a temporary file, then renamed); resuming
restores the exact PoolState.  The RNG is counter-based on (pixel, sample,
bounce) (core/rng.py), so no generator state is saved beyond what travels
in the lanes.

A resumed render's lane state is bit-identical to an uninterrupted run's on
the CPU and on the card.  Its image is bit-identical on the CPU; on the card
it equals the uninterrupted image up to the order of each pixel's sum,
because index_add on CUDA adds in no fixed order (render/pool.py).

The file's fields, meta keys and `params_hash` are the reference's, so
`load_pool_state` also reads a file the JAX package wrote, and the
reference reads a sharded file of the port.  A sharded state (render/pool.py
with a mesh: a ShardedState, one PoolState a shard on its device) is
written in the reference's stacked layout, with its shard axis (`accum`
(n_shards, n_pixels, 3), `next_flat` and `overflow` (n_shards,)), gathered
from the shards at the save; loaded with a mesh, a file gives back a
ShardedState, each shard's part on its device, and without one the stacked
state.  A file with one shard, as the reference writes every one-device
pool, loads without the axis, as the port's one-device state.  The
reference's uint32 ids widen to the port's int64.  `render_pool_resumable`
takes a mesh of one process (the reference's is one-device).
"""
from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np
import torch

from . import pool as poolmod

_FIELDS = ("org", "dirn", "throughput", "radiance", "pixel", "sample",
           "bounce", "active", "accum", "next_flat", "overflow")
_INT_FIELDS = ("pixel", "sample", "bounce", "next_flat", "overflow")
# fields with one row a shard in a sharded state
_SHARDED = ("accum", "next_flat", "overflow")


def save_pool_state(path: str, state: poolmod.PoolState, meta: dict = None):
    """Write the pool state (+ optional scalar metadata, saved as
    `meta_<key>`) atomically: a temporary file in the same directory, then
    a rename.  A ShardedState is gathered into the stacked layout."""
    if isinstance(state, poolmod.ShardedState):
        arrays = {f: poolmod.join_field(state, f, "cpu").numpy() for f in _FIELDS}
    else:
        arrays = {f: getattr(state, f).detach().cpu().numpy() for f in _FIELDS}
    for k, v in (meta or {}).items():
        arrays[f"meta_{k}"] = np.asarray(v)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load_pool_state(path: str, device, mesh=None):
    """Returns (PoolState on `device`, meta dict).  A file of the JAX
    package loads too; a file of n > 1 shards keeps its shard axis (module
    docstring).  With `mesh`, the state is a ShardedState of the mesh's
    local shards, each on its own device (ValueError if the file holds
    another number of shards)."""
    with np.load(path) as z:
        arrays = {f: z[f] for f in _FIELDS if f in z.files}
        meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
    # checkpoints written before the overflow counter existed load as 0
    if "overflow" not in arrays:
        arrays["overflow"] = np.zeros(arrays["next_flat"].shape, np.int64)
    if arrays["accum"].ndim == 3 and arrays["accum"].shape[0] == 1:
        for f in _SHARDED:
            arrays[f] = arrays[f][0]
    for f in _INT_FIELDS:
        arrays[f] = arrays[f].astype(np.int64)
    host = poolmod.PoolState(**{f: torch.from_numpy(np.array(arrays[f])) for f in _FIELDS})
    if mesh is not None:
        return poolmod.place_state(host, mesh), meta
    return poolmod.PoolState(*(t.to(device) for t in host)), meta


def params_hash(seed, spp, n_pixels, n_lanes, camera) -> np.uint64:
    """Fingerprint of the render parameters a checkpoint belongs to (the
    reference's, bit for bit): resuming under another seed, spp, pixel
    count, lane count, camera or depth would mix lane RNG ids and an
    accumulator that disagree with the step function."""
    params = {
        "seed": int(seed), "spp": int(spp), "n_pixels": int(n_pixels),
        "n_lanes": int(n_lanes), "max_depth": int(camera.max_depth),
        "cam": (camera.image_width, camera.image_height,
                tuple(np.asarray(camera.position, np.float64)),
                tuple(np.asarray(camera.look_at, np.float64)),
                float(camera.focal_length), float(camera.light_bias)),
    }
    digest = hashlib.sha256(repr(sorted(params.items())).encode()).digest()
    return np.frombuffer(digest[:8], np.uint64)[0]


def render_pool_resumable(pack, static, camera, n_pixels: int, spp: int,
                          n_lanes: int, device, seed=0,
                          steps_per_poll: int = poolmod.STEPS_PER_POLL,
                          kernel: str = "auto", checkpoint_path: str = None,
                          checkpoint_every_steps: int = 200, dtype=torch.float32,
                          mesh=None):
    """render_pool with periodic checkpoints and resume.

    If checkpoint_path exists, rendering continues from it (ValueError if
    it was written with other render parameters); otherwise a fresh pool
    starts.  A checkpoint is written every `checkpoint_every_steps` pool
    steps (at the poll that reaches it) and once at completion.  With a
    `mesh` of one process the pool is sharded as render_pool's, the state
    one PoolState a shard on its device, and the file holds every shard.
    Returns the (n_pixels, 3) radiance sum on `device`."""
    if mesh is not None and mesh.multiprocess:
        raise ValueError("render_pool_resumable takes a mesh of one process: its file holds "
                         "every shard")
    total = n_pixels * spp
    n_shards = 1 if mesh is None else mesh.n_shards
    step_count = 0
    phash = params_hash(seed, spp, n_pixels, n_lanes, camera)
    if checkpoint_path and os.path.exists(checkpoint_path):
        state, meta = load_pool_state(checkpoint_path, device, mesh)
        step_count = int(meta.get("step_count", 0))
        saved_hash = meta.get("params_hash")
        if saved_hash is not None and np.uint64(saved_hash) != phash:
            raise ValueError(
                f"checkpoint {checkpoint_path} was written with different "
                f"render parameters (seed/spp/pixels/camera/depth); refusing "
                f"to resume into an inconsistent state")
        lanes = sum(s.org.shape[0] for s in state) if mesh is not None else state.org.shape[0]
        if lanes != n_lanes:
            raise ValueError(f"checkpoint lane count {lanes} != {n_lanes}")
    elif mesh is not None:
        state = poolmod.init_shards(n_lanes, n_pixels, mesh, dtype)
    else:
        state = poolmod.init_state(n_lanes, n_pixels, device, dtype)
    step = poolmod.make_step(pack, static, camera, total, spp, seed, kernel=kernel, mesh=mesh)
    since = 0

    def on_poll(state, done_steps, issued, n_active, overflow):
        nonlocal since
        since += steps_per_poll
        if checkpoint_path and since >= checkpoint_every_steps:
            save_pool_state(checkpoint_path, state,
                            {"step_count": done_steps, "params_hash": phash})
            since = 0

    state, step_count = poolmod.poll_loop(
        pack, step, state, total,
        poolmod.max_pool_steps(total, n_lanes, camera.max_depth, n_shards),
        steps_per_poll, done_steps=step_count, on_poll=on_poll, mesh=mesh)
    if checkpoint_path:
        save_pool_state(checkpoint_path, state,
                        {"step_count": step_count, "params_hash": phash})
    return state.accum if mesh is None else poolmod.sum_planes(mesh, state, device)
