"""The sharded pool state (rust_raytracer_torch/render/pool.py with a mesh):
one PoolState a shard, made on the shard's device and stepped there, the
port's counterpart of the reference's NamedSharding-placed state and its
donated shard_map step (rust_raytracer_tpu/render/pool.py:278-323).

- its image on CPU meshes of 2 and 8 shards against the unsharded pool and
  the stacked join of the same planes (test_pool_8_vs_1_shard's tolerance),
  and its planes shard for shard against the JAX package's sharded step
  (test_pool_8_shards_against_jax's);
- no join between polls: the joins are named functions of render/pool.py,
  counted here (none in a step, one count read a poll, with a mesh or
  without, one plane sum at the end), and a step dispatches exactly its
  shards' own step ops;
- the graphed sharded step (the capture replaced by a direct call of the
  captured body) against the eager one, shard for shard, its state the
  donated buffers, nothing dispatched outside its replays;
- a sharded checkpoint: the same arrays as the stacked layout, loaded back
  shard for shard on a mesh, and render_pool_resumable on a mesh;
- scripts/mesh_multi_gpu.py's CPU rehearsals, one process and gloo.
"""
import collections
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rust_raytracer_tpu import models as jmodels
from rust_raytracer_tpu.parallel import mesh as jmesh
from rust_raytracer_tpu.render import pool as jpool
from rust_raytracer_tpu.render.camera import Camera as JCamera
from rust_raytracer_tpu.scene import compiler as jcompiler
from rust_raytracer_torch import models as tmodels
from rust_raytracer_torch.ops import intersect as tisect
from rust_raytracer_torch.parallel import mesh as tmesh
from rust_raytracer_torch.render import checkpoint as tckpt
from rust_raytracer_torch.render import graphs as tgraphs
from rust_raytracer_torch.render import pool as tpool
from rust_raytracer_torch.render.camera import Camera as TCamera
from rust_raytracer_torch.scene import compiler as tcompiler
from rust_raytracer_torch.utils import metrics as tmetrics

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
# test_torch_sharding.py's pool: "test" scene, 32x32, 4 spp, depth 4, 1024 lanes, seed 3
POOL = dict(image_width=32, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
            position=(0, 0, 1), look_at=(0, 0, 0), focal_length=50.0)
LANES, SPP, SEED, STEPS = 1024, 4, 3, 6
JOINS = ("join_field", "place_state", "host_sums", "shard_sums", "sum_planes")


@pytest.fixture(scope="module")
def scene():
    pack, static = tcompiler.compile_scene(tmodels.build("test"), "cpu")
    cam = TCamera(**POOL)
    return pack, static, cam, cam.image_width * cam.image_height


@pytest.fixture(scope="module")
def unsharded(scene):
    pack, static, cam, n_pixels = scene
    return tpool.render_pool(pack, static, cam, n_pixels, SPP, LANES, "cpu", seed=SEED).numpy()


def _step(scene, n, **kw):
    pack, static, cam, n_pixels = scene
    mesh = tmesh.make_mesh(n, device="cpu")
    return mesh, tpool.make_step(pack, static, cam, n_pixels * SPP, SPP, SEED, mesh=mesh, **kw)


def _count_joins(monkeypatch):
    """Counts the calls of render/pool.py's joins by name."""
    calls = collections.Counter()
    for name in JOINS:
        real = getattr(tpool, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tpool, name, counted)
    return calls


def _assert_shards_equal(got, want, tag):
    assert isinstance(got, tpool.ShardedState) and len(got) == len(want), tag
    for i, (g, w) in enumerate(zip(got, want)):
        for f in tpool.PoolState._fields:
            assert torch.equal(getattr(g, f), getattr(w, f)), f"{tag}: shard {i}, {f}"


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_image_against_unsharded_and_stacked(scene, unsharded, n):
    """render_pool on n CPU shards: every shard's state is its own PoolState
    (n_lanes / n lanes, a plane, 0-d counters); the image is the planes'
    sum in shard order, equal to the stacked join's sum(0) and to the
    unsharded image within float sum order (rtol 2e-5, atol 1e-6), every
    job issued."""
    pack, static, cam, n_pixels = scene
    mesh, step = _step(scene, n)
    state = tpool.init_shards(LANES, n_pixels, mesh)
    assert isinstance(state, tpool.ShardedState) and len(state) == n
    for s in state:
        assert s.org.shape == (LANES // n, 3) and s.accum.shape == (n_pixels, 3)
        assert s.next_flat.shape == s.overflow.shape == ()
    total = n_pixels * SPP
    state, steps = tpool.poll_loop(pack, step, state, total,
                                   tpool.max_pool_steps(total, LANES, cam.max_depth, n),
                                   mesh=mesh)
    assert int(state.next_flat.sum()) == total and not bool(state.active.any())
    image = tpool.sum_planes(mesh, state, "cpu")
    m = tmetrics.RenderMetrics()
    got = tpool.render_pool(pack, static, cam, n_pixels, SPP, LANES, "cpu", seed=SEED,
                            mesh=mesh, metrics=m)
    assert torch.equal(got, image) and m.steps == steps and m.samples_issued == total
    np.testing.assert_allclose(image.numpy(), state.accum.sum(0).numpy(), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(image.numpy(), unsharded, rtol=2e-5, atol=1e-6)


def _jax_pool(n):
    """The JAX package's n-device pool step (kernel "jnp") after STEPS steps
    from its empty state: accum, next_flat and active as numpy."""
    pack, static = jcompiler.compile_scene(jmodels.build("test"))
    cam = JCamera(**POOL)
    n_pixels = cam.image_width * cam.image_height
    mesh = jmesh.make_mesh(n)
    step = jpool.make_step(pack, static, cam, n_pixels * SPP, SPP, SEED, kernel="jnp",
                           mesh=mesh)
    state = jpool.init_state(LANES, n_pixels, n_shards=n)
    state = jax.device_put(state, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("dp")))
    for _ in range(STEPS):
        state = step(pack, state)
    return {f: np.asarray(getattr(state, f)) for f in ("accum", "next_flat", "active")}


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_state_against_jax_shard_for_shard(scene, n):
    """The per-shard state of n CPU shards after STEPS steps against the JAX
    package's n-device state: next_flat and live lanes equal, shard for
    shard, each plane within rtol 1e-5, atol 1e-6."""
    want = _jax_pool(n)
    pack, _, _, n_pixels = scene
    mesh, step = _step(scene, n)
    state = tpool.init_shards(LANES, n_pixels, mesh)
    for _ in range(STEPS):
        state = step(pack, state)
    per = LANES // n
    for i, s in enumerate(state):
        assert int(s.next_flat) == int(want["next_flat"][i]), i
        assert int(s.active.sum()) == int(want["active"][i * per:(i + 1) * per].sum())
        np.testing.assert_allclose(s.accum.numpy(), want["accum"][i], rtol=1e-5, atol=1e-6,
                                   err_msg=f"shard {i}")


@pytest.mark.parametrize("n", [None, 2, 8])
def test_no_join_between_polls(scene, monkeypatch, n):
    """A render joins only where the reference joins: no join in a step, one
    count read a poll (shard_sums, the overflow with it; host_sums never),
    no placement of a state, and on a mesh one plane sum at the end.  n
    None is the pool without a mesh, the one-shard case of the same
    poll."""
    pack, static, cam, n_pixels = scene
    if n is None:
        mesh = None
        step = tpool.make_step(pack, static, cam, n_pixels * SPP, SPP, SEED)
    else:
        mesh, step = _step(scene, n)
    calls = _count_joins(monkeypatch)
    in_steps = []

    def watched(pack_, s):
        before = sum(calls.values())
        out = step(pack_, s)
        in_steps.append(sum(calls.values()) - before)
        return out

    m = tmetrics.RenderMetrics()
    tpool.render_pool(pack, static, cam, n_pixels, SPP, LANES, "cpu", seed=SEED, mesh=mesh,
                      metrics=m, step=watched)
    polls = m.steps // tpool.STEPS_PER_POLL
    assert len(in_steps) == m.steps > 0 and set(in_steps) == {0}
    assert calls == {"shard_sums": polls, **({} if n is None else {"sum_planes": 1})}, calls


class OpLog(TorchDispatchMode):
    """The aten ops dispatched while it is on and not paused, by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.paused = 0

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        if not self.paused:
            self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def test_sharded_step_dispatches_only_its_shards_steps(scene):
    """One eager sharded step dispatches the ops of its shards' own steps
    (render/pool.py:_local_step over each shard's state), and nothing else:
    no slice, concatenation, stack or copy around them."""
    pack, static, cam, n_pixels = scene
    mesh, step = _step(scene, 2, graph=False)
    state = step(pack, tpool.init_shards(LANES, n_pixels, mesh))
    with OpLog() as log:
        step(pack, state)
    want = collections.Counter()
    total = n_pixels * SPP
    for i, s in enumerate(state):
        local = tpool._local_step(static, cam, SPP, SEED, "auto",
                                  *tpool._shard_quota(i, 2, total))
        with OpLog() as one:
            local(pack, s)
        want.update(one.ops)
    assert log.ops == want


class PausedCapture:
    """Stands in for the CUDA capture: `replay` calls the captured body,
    with `log` paused, so what a graphed step dispatches outside its
    replays is what `log` records."""

    def __init__(self, log):
        self.log = log
        self.count = 0

    def __call__(self, body, device):
        self.count += 1

        def replay():
            self.log.paused += 1
            try:
                body()
            finally:
                self.log.paused -= 1

        return types.SimpleNamespace(replay=replay)


def test_graphed_sharded_step_equals_eager(scene, monkeypatch):
    """With the graphs on as on the card (the capture a direct call of the
    body), 2 shards over 12 steps: the graphed state equals the eager one
    bit for bit, shard for shard; each shard's state is its step's donated
    buffers (the same tensors every step); one capture a shard; and after
    the captures a step dispatches nothing outside its replays."""
    pack, _, _, n_pixels = scene
    log = OpLog()
    capture = PausedCapture(log)
    monkeypatch.setattr(tgraphs, "applies",
                        lambda device, kernel, pack: tisect.resolve_kernel(kernel, pack) != "jnp")
    monkeypatch.setattr(tgraphs, "cuda_capture", capture)
    mesh, graphed = _step(scene, 2)
    _, eager = _step(scene, 2, graph=False)
    g = e = tpool.init_shards(LANES, n_pixels, mesh)
    first = None
    for k in range(12):
        if k < 2:
            g = graphed(pack, g)
        else:
            with log:
                g = graphed(pack, g)
        e = eager(pack, e)
        _assert_shards_equal(g, e, f"step {k}")
        first = first or g
        assert all(a.org is b.org and a.accum is b.accum for a, b in zip(g, first))
    assert capture.count == 2
    assert not log.ops, log.ops


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_checkpoint_layout_and_resume(scene, tmp_path, n):
    """A per-shard state saved by save_pool_state writes the arrays of the
    stacked layout (the reference's), loads back with the mesh shard for
    shard and without it with the shard axis, and continues as the saved
    chain does; render_pool_resumable on the mesh, interrupted and resumed,
    gives render_pool's image bit for bit."""
    pack, static, cam, n_pixels = scene
    mesh, step = _step(scene, n)
    state = tpool.init_shards(LANES, n_pixels, mesh)
    for _ in range(STEPS):
        state = step(pack, state)
    path = tckpt.save_pool_state(str(tmp_path / "s.npz"), state, {"step_count": STEPS})
    stacked = tpool.PoolState(
        *(torch.cat([getattr(s, f) for s in state]) for f in tpool.LANE_FIELDS),
        *(torch.stack([getattr(s, f) for s in state]) for f in ("accum", "next_flat",
                                                                  "overflow")))
    ref = tckpt.save_pool_state(str(tmp_path / "ref.npz"), stacked, {"step_count": STEPS})
    with np.load(path) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["accum"].shape == (n, n_pixels, 3) and a["next_flat"].shape == (n,)
    loaded, meta = tckpt.load_pool_state(path, "cpu", mesh)
    _assert_shards_equal(loaded, state, "loaded")
    assert int(meta["step_count"]) == STEPS
    flat, _ = tckpt.load_pool_state(path, "cpu")
    for f in tpool.PoolState._fields:
        assert torch.equal(getattr(flat, f), getattr(stacked, f)), f
    _, again = _step(scene, n)
    a, b = state, loaded
    for _ in range(STEPS):
        a, b = step(pack, a), again(pack, b)
    _assert_shards_equal(b, a, "resumed")

    whole = tpool.render_pool(pack, static, cam, n_pixels, SPP, LANES, "cpu", seed=SEED,
                              mesh=mesh)
    ck = str(tmp_path / "r.npz")
    tckpt.save_pool_state(ck, loaded, {"step_count": STEPS, "params_hash": tckpt.params_hash(
        SEED, SPP, n_pixels, LANES, cam)})
    resumed = tckpt.render_pool_resumable(pack, static, cam, n_pixels, SPP, LANES, "cpu",
                                          seed=SEED, checkpoint_path=ck, mesh=mesh)
    assert torch.equal(resumed, whole)
    done, _ = tckpt.load_pool_state(ck, "cpu", mesh)
    assert len(done) == n and int(done.next_flat.sum()) == n_pixels * SPP


def test_placed_state_must_match_the_mesh(scene):
    """A stacked state of another shard count is refused, not spread."""
    _, _, _, n_pixels = scene
    mesh = tmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="shard"):
        tpool.place_state(tpool.init_state(LANES, n_pixels, "cpu", n_shards=4), mesh)
    one = tpool.place_state(tpool.init_state(LANES, n_pixels, "cpu"),
                            tmesh.make_mesh(1, device="cpu"))
    assert len(one) == 1 and one[0].accum.shape == (n_pixels, 3)


@pytest.mark.parametrize("mode,extra", [("process", []), ("nccl", ["--procs", "2"])])
def test_mesh_multi_gpu_rehearsal(mode, extra):
    """scripts/mesh_multi_gpu.py's CPU rehearsals: one process over CPU
    shards, and one gloo process a shard; each prints its JSON line with
    the mode, the shard counts and each rate beside one device's."""
    import json

    script = os.path.join(os.path.dirname(HERE), "scripts", "mesh_multi_gpu.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, script, "--mode", mode, "--device", "cpu", "--small"]
                         + extra, capture_output=True, text=True, timeout=600, env=env)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    lines = [json.loads(x) for x in run.stdout.splitlines() if x.startswith('{"mesh_multi_gpu"')]
    assert lines, run.stdout[-2000:]
    for line in lines:
        out = line["mesh_multi_gpu"]
        assert out["mode"] == mode and out["card"] == "cpu"
        assert out["pool"]["pixel_samples_per_s"] > 0 and out["pool"]["one_device"] > 0
        for part in ("batch", "train_step"):
            assert out[part]["ms"] > 0 and out[part]["one_device"] > 0
        assert out["batch"]["pixels_not_bit_equal"] == 0
    assert [line["mesh_multi_gpu"]["shards"] for line in lines] == (
        [1, 2, 4] if mode == "process" else [2])
