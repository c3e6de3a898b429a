"""Sharding of the lane axis over devices and processes (port of
rust_raytracer_tpu/parallel/mesh.py).

The reference shards the flattened (pixel, sample) lane axis over a 1-D
device mesh with shard_map, replicates the ScenePack on every device and
reduces with psum.  Here a `Mesh` lists the shards of this process (each a
device, which may repeat: two shards on one card, or n shards on the CPU)
and places them in a global order over the processes of a torch.distributed
group (`init_multihost`).  A sharded function issues its shards' work one
after another, each on its own device with a replica of the pack, and the
processes combine their results with all_gather / all_reduce.  The RNG is
keyed by (pixel, sample, bounce), so a lane's radiance does not depend on
the shard that traced it.

Shards on distinct cards of one process run at the same time where the
host issues their work without waiting in between: the sharded pool
(render/pool.py keeps each shard's state on its device and joins only at a
poll, at the end and at a checkpoint), the batch program a batch
(render/renderer.py:BatchRun) and `train_step_fn` (every shard's inputs
copied first, then every shard's step, then the sums).  `shard_batch_fn`,
the batch trace's eager plain version, reads the device back each bounce,
so its shards run one after another.  One process a card
(`init_multihost`) is the other way to run a mesh over several cards.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..render import graphs

# shards a process contributes, as init_multihost's local_device_count set it
_local_count: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The shards of this process in global order: `devices[i]` runs global
    shard `first + i` of `n_shards`."""
    devices: Tuple[torch.device, ...]
    n_shards: int
    first: int = 0

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def multiprocess(self) -> bool:
        return self.n_shards > self.n_local


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def init_multihost(coordinator_address: str, num_processes: int, process_id: int,
                   local_device_count: Optional[int] = None, device="cuda"):
    """Join the process group of `num_processes` processes over TCP at
    `coordinator_address` ("host:port"): nccl for a CUDA `device` (on the
    process's current CUDA device: torch.cuda.set_device first), gloo for
    the CPU.  `local_device_count` is the shards each process contributes to
    `make_mesh()` without a count.  Calling it again in the process is a
    no-op."""
    global _local_count
    if local_device_count is not None:
        _local_count = int(local_device_count)
    if dist.is_initialized():
        return
    if torch.device(device).type == "cuda":
        backend, extra = "nccl", {"device_id": torch.device("cuda", torch.cuda.current_device())}
    else:
        backend, extra = "gloo", {}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **extra)


def make_mesh(n_devices: Optional[int] = None,
              device: Union[str, torch.device, Sequence] = "cuda") -> Mesh:
    """A mesh of `n_devices` shards over every process of the group (one
    process without init_multihost), each process taking an equal share.

    device: "cuda" — the process's shards are CUDA devices, consecutive
    from rank * share (modulo the host's count); raises if CUDA is absent or
    the host has fewer devices than the share.  Nothing falls back to CPU
    devices.  "cpu" — the shards are all the one CPU device (the analog of
    the reference's --xla_force_host_platform_device_count).  A list of
    devices — this process's shards as given; a device may repeat, which
    puts several shards on one card.  Without `n_devices`, a process takes
    init_multihost's local_device_count shards, else one (the CPU) or every
    CUDA device."""
    world, rank = _world()
    if isinstance(device, (list, tuple)):
        devs = tuple(torch.device(d) for d in device)
        if n_devices is not None and n_devices != len(devs) * world:
            raise ValueError(f"{len(devs)} devices a process x {world} processes != "
                             f"{n_devices} shards")
    else:
        kind = torch.device(device).type
        if kind == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh was requested but torch.cuda.is_available() is "
                               "False; nothing falls back to the CPU")
        if n_devices is None:
            share = _local_count or (torch.cuda.device_count() if kind == "cuda" else 1)
        else:
            if n_devices % world:
                raise ValueError(f"{n_devices} shards do not divide over {world} processes")
            share = n_devices // world
        if share < 1:
            raise ValueError(f"a mesh needs at least one shard a process, got {share}")
        if kind == "cpu":
            devs = (torch.device("cpu"),) * share
        elif kind == "cuda":
            count = torch.cuda.device_count()
            if count < share:
                raise ValueError(f"need {share} CUDA devices a process, have {count}")
            devs = tuple(torch.device("cuda", (rank * share + i) % count)
                         for i in range(share))
        else:
            raise ValueError(f"no mesh for device {device!r}")
    return Mesh(devices=devs, n_shards=len(devs) * world, first=rank * len(devs))


def replicas(pack) -> Callable:
    """`replica(device)` -> the pack on that device, copied once a device
    (the pack itself on its own device)."""
    cache: Dict[torch.device, object] = {pack.device: pack}

    def replica(dev):
        if dev not in cache:
            cache[dev] = pack.to(dev)
        return cache[dev]

    return replica


def _comm_device(mesh: Mesh) -> torch.device:
    """The device a collective's tensors live on: the CPU for gloo, the
    process's first shard for nccl."""
    if dist.get_backend() == "nccl":
        return mesh.devices[0]
    return torch.device("cpu")


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the processes of the mesh (t itself in one
    process), on t's device."""
    if not mesh.multiprocess:
        return t
    buf = t.detach().to(_comm_device(mesh)).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(t.device)


def all_gather_cat(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The processes' `t` (equal shapes) concatenated along axis 0 in rank
    order (t itself in one process), on t's device."""
    if not mesh.multiprocess:
        return t
    buf = t.detach().to(_comm_device(mesh)).contiguous()
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, buf)
    return torch.cat(parts).to(t.device)


def lane_slices(mesh: Mesh, n: int):
    """The slices of an n-lane batch that this process's shards trace, in
    shard order (n a multiple of the shard count)."""
    if n % mesh.n_shards:
        raise ValueError(f"{n} lanes do not divide over {mesh.n_shards} shards")
    per = n // mesh.n_shards
    return [slice((mesh.first + i) * per, (mesh.first + i + 1) * per)
            for i in range(mesh.n_local)]


def shard_batch_fn(batch_fn, mesh: Mesh):
    """Wrap a per-lane batch function `(pack, px, py, sample, seed) -> rad`
    over the mesh: the lanes (global arrays, their count a multiple of the
    shard count) split evenly in shard order, each shard traced on its
    device with a replica of the pack.  Returns the whole (N, ...) lane
    array on px's device, gathered across processes."""

    def sharded(pack, px, py, sample, seed):
        replica = replicas(pack)
        outs = []
        for dev, sl in zip(mesh.devices, lane_slices(mesh, px.shape[0])):
            rad = batch_fn(replica(dev), px[sl].to(dev), py[sl].to(dev),
                           sample[sl].to(dev), seed)
            outs.append(rad.to(px.device))
        return all_gather_cat(mesh, torch.cat(outs))

    return sharded


def train_step_fn(batch_fn, loss_of_radiance, mesh: Mesh, kernel: str = "auto",
                  graph: bool = True):
    """A sharded differentiable step `(pack, px, py, sample, seed, target)
    -> (loss, grads)`: each shard's loss of its lanes' radiance, and its
    gradients with respect to the pack's float tables
    (ScenePack.float_fields(), in that order; zeros where a table takes no
    part), both SUMMED over the shards and the processes — the reference's
    psum, so a loss that is a mean over lanes comes out n_shards times the
    one-shard mean.  `target` is split over the lanes as px is; `seed` (an
    int or an integer tensor) reaches batch_fn as a 0-d int64 tensor on the
    shard's device.

    `kernel` is the walk batch_fn traces.  On a CUDA device (where
    render/graphs.applies for it) each shard's forward and backward pass is
    one replay of a graphs.GraphedGrad, captured at the first step on each
    device and replayed at every seed; graph=False keeps them eager, the
    reference the graphs are held against.  A pack on another device than
    a shard's is copied there once, and its float tables copied in again
    each step.  A step copies every shard's inputs first, then issues every
    shard's pass, then sums in shard order: a copy from the pack's device
    runs on that device's stream, so one queued behind a shard's pass
    there would hold the next shard's pass back until it ended.  The
    copies home, the sums and the all-reduce run eagerly."""
    def shard_loss(p, px, py, sample, seed, target):
        return loss_of_radiance(batch_fn(p, px, py, sample, seed), target)

    graphed = graphs.GraphedGrad(shard_loss)
    held: Dict[torch.device, tuple] = {}   # device -> (pack, its replica there)

    def replica(pack, dev):
        if dev == pack.device:
            return pack
        src, rep = held.get(dev, (None, None))
        if src is None or not graphs.same_pack(src, pack):
            rep = pack.to(dev)
            held[dev] = (pack, rep)
        else:
            for f in pack.float_fields():
                getattr(rep, f).copy_(getattr(pack, f))
        return rep

    def step(pack, px, py, sample, seed, target):
        fields = pack.float_fields()
        home = pack.device
        staged = [(dev, replica(pack, dev),
                   (px[sl].to(dev), py[sl].to(dev), sample[sl].to(dev),
                    torch.as_tensor(seed, dtype=torch.int64).to(dev), target[sl].to(dev)))
                  for dev, sl in zip(mesh.devices, lane_slices(mesh, px.shape[0]))]
        parts = [graphed(p, *lanes) if graph and graphs.applies(dev, kernel, p)
                 else graphs.value_and_grad(shard_loss, p.with_grad(), *lanes)
                 for dev, p, lanes in staged]
        loss = torch.zeros((), dtype=pack.dtype, device=home)
        grads = [torch.zeros_like(getattr(pack, f)) for f in fields]
        for part, part_grads in parts:
            loss = loss + part.to(home)
            grads = [acc + gi.to(home) for acc, gi in zip(grads, part_grads)]
        return (all_reduce_sum(mesh, loss),
                tuple(all_reduce_sum(mesh, gi) for gi in grads))

    return step
