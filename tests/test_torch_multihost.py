"""The port's multi-process mesh: two processes, each with 2 CPU shards,
joined over gloo by parallel/mesh.py:init_multihost, against one process
with 4 CPU shards — the port analog of tests/test_multihost.py.

Each worker runs in its own subprocess (a torch.distributed process group is
per-process state) with one thread, on a port found by binding port 0; a
worker that hangs is killed at its timeout and fails the test.  Batch
radiance is bit-identical per lane, the pool image agrees within float sum
order with equal issued counts, train_step_fn's gradients within rtol
1e-6, and the batch render through its batch programs bit for bit."""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TIMEOUT = 300

# the work of one process: prints nothing, writes its results to argv[3]
_WORK = textwrap.dedent("""
    import sys
    import numpy as np, torch
    from rust_raytracer_torch import models
    from rust_raytracer_torch.core import rng as vrng
    from rust_raytracer_torch.parallel import mesh as pmesh
    from rust_raytracer_torch.render import graphs, integrator
    from rust_raytracer_torch.render import pool as poolmod
    from rust_raytracer_torch.render.camera import Camera
    from rust_raytracer_torch.render.renderer import BatchMetrics, Renderer
    from rust_raytracer_torch.scene import compiler
    from rust_raytracer_torch.utils import metrics as metricsmod

    JOINS = ("join_field", "place_state", "host_sums", "shard_sums", "sum_planes")

    def run(mesh, out):
        scene = models.build("test")
        pack, static = compiler.compile_scene(scene, "cpu")
        cam = Camera(image_width=16, aspect_ratio=1.0, samples_per_pixel=1, max_depth=3,
                     position=(0, 0, 1), look_at=(0, 0, 0), focal_length=50.0)
        n = 64
        ar = torch.arange(n)
        px, py = ar % 16, (ar // 16) % 16
        smp = torch.zeros_like(ar)

        def batch_fn(p, px, py, sample, seed, differentiable=False):
            ctx = vrng.Ctx(pixel=py * 16 + px, sample=sample, bounce=0, seed=seed)
            org, dirn = cam.generate_rays(px, py, sample, ctx)
            return integrator.trace(p, static, org, dirn, ctx, 3, 0.25,
                                    differentiable=differentiable)

        rad = pmesh.shard_batch_fn(batch_fn, mesh)(pack, px, py, smp, 0)
        m = metricsmod.RenderMetrics()
        pool_cam = Camera(image_width=16, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4,
                          position=(0, 0, 1), look_at=(0, 0, 0), focal_length=50.0)
        # the pool's joins (render/pool.py), counted by name, and its states
        joins = {name: 0 for name in JOINS}
        real = {name: getattr(poolmod, name) for name in JOINS}

        def counted(name):
            def call(*a, **k):
                joins[name] += 1
                return real[name](*a, **k)
            return call

        for name in JOINS:
            setattr(poolmod, name, counted(name))
        step = poolmod.make_step(pack, static, pool_cam, 256 * 4, 4, 3, mesh=mesh)
        states = []
        try:
            img = poolmod.render_pool(pack, static, pool_cam, 256, 4, 256, "cpu", seed=3,
                                      mesh=mesh, metrics=m,
                                      step=lambda p, s: states.append(s) or step(p, s))
        finally:
            for name in JOINS:
                setattr(poolmod, name, real[name])
        kinds = {(int(isinstance(s, poolmod.ShardedState)), len(s), s[0].org.shape[0])
                 for s in states}
        step = pmesh.train_step_fn(
            lambda *a: batch_fn(*a, differentiable=True),
            lambda r, t: ((r - t) ** 2).mean(), mesh)
        loss, grads = step(pack, px, py, smp, 0, torch.zeros((n, 3)))
        # the batch render through its batch programs (graphs.applies as on
        # the card; the loops run as graphs.PlainLoop) and eagerly
        r = Renderer(scene, cam, seed=5, batch_size=96, device="cpu", mesh=mesh)
        real = graphs.applies
        graphs.applies = lambda device, kernel, pack: True
        try:
            bm = BatchMetrics()
            prog_img = r.render(mode="batch", metrics=bm).hdr()
        finally:
            graphs.applies = real
        eager_img = r.render(mode="batch").hdr()
        np.savez(out, rad=rad.numpy(), img=img.numpy(), issued=m.samples_issued,
                 steps=m.steps, loss=float(loss), prog_img=prog_img, eager_img=eager_img,
                 prog_batches=bm.batches, joins=[joins[name] for name in JOINS],
                 state_kinds=np.array(sorted(kinds)),
                 **{"grad_" + f: g.numpy() for f, g in zip(pack.float_fields(), grads)})
""")

_WORKER = _WORK + textwrap.dedent("""
    pid, addr, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    pmesh.init_multihost(addr, num_processes=2, process_id=pid, local_device_count=2,
                         device="cpu")
    pmesh.init_multihost(addr, num_processes=2, process_id=pid, device="cpu")  # a no-op
    import torch.distributed as dist
    try:
        mesh = pmesh.make_mesh(device="cpu")
        assert (mesh.n_shards, mesh.n_local, mesh.first) == (4, 2, 2 * pid), mesh
        run(mesh, out if pid == 0 else out + ".rank1.npz")
    finally:
        dist.destroy_process_group()
""")

_SINGLE = _WORK + textwrap.dedent("""
    torch.set_num_threads(1)
    run(pmesh.make_mesh(4, device="cpu"), sys.argv[1])
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + env.get("PYTHONPATH", "").split(os.pathsep))
    return env


def _finish(procs):
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            p.communicate()
            pytest.fail(f"a worker did not finish within {TIMEOUT} s")
        outs.append((p.returncode, err))
    assert all(rc == 0 for rc, _ in outs), "\n".join(err[-2000:] for _, err in outs)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost")
    addr = f"127.0.0.1:{_free_port()}"
    two = [subprocess.Popen([sys.executable, "-c", _WORKER, str(pid), addr, str(d / "two.npz")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=_env())
           for pid in range(2)]
    one = [subprocess.Popen([sys.executable, "-c", _SINGLE, str(d / "one.npz")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=_env())]
    _finish(two + one)
    load = lambda name: dict(np.load(d / name))  # noqa: E731
    return load("two.npz"), load("two.npz.rank1.npz"), load("one.npz")


def test_two_process_batch_radiance_bit_identical(results):
    """Every lane's radiance from 2 processes x 2 shards equals 1 process x
    4 shards bit for bit, and both ranks hold the whole gathered array."""
    two, rank1, one = results
    assert two["rad"].shape == (64, 3) and np.abs(two["rad"]).max() > 0
    np.testing.assert_array_equal(two["rad"], one["rad"])
    np.testing.assert_array_equal(rank1["rad"], one["rad"])


def test_two_process_pool_image(results):
    """The pool over 2 processes stops at the same poll on both ranks (the
    counts are all-reduced), issues every job, and its image equals the
    one-process image within float sum order."""
    two, rank1, one = results
    assert int(two["issued"]) == int(one["issued"]) == 256 * 4
    assert int(two["steps"]) == int(rank1["steps"]) == int(one["steps"])
    np.testing.assert_array_equal(two["img"], rank1["img"])
    np.testing.assert_allclose(two["img"], one["img"], rtol=2e-5, atol=1e-6)


def test_two_process_pool_keeps_each_shard_state(results):
    """With two local shards a process (and four in the one process), every
    pool step takes and gives each shard's own state, 64 lanes a shard, and
    the render joins only at a poll (one count read each, all-reduced) and
    at the end (one plane sum): no join inside a step, no placement."""
    for res, n_local in ((results[0], 2), (results[1], 2), (results[2], 4)):
        polls = int(res["steps"]) // 10
        assert res["joins"].tolist() == [0, 0, 0, polls, 1], res["joins"]
        assert res["state_kinds"].tolist() == [[1, n_local, 64]]


def test_two_process_train_step(results):
    """train_step_fn's loss and gradients, psum-reduced over 2 processes,
    equal the one-process 4-shard step within rtol 1e-6."""
    two, rank1, one = results
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-6)
    keys = [k for k in one if k.startswith("grad_")]
    assert keys and any(np.abs(one[k]).max() > 0 for k in keys if one[k].size)
    for k in keys:
        np.testing.assert_allclose(two[k], one[k], rtol=1e-6, atol=1e-9, err_msg=k)
        np.testing.assert_array_equal(rank1[k], two[k])


def test_two_process_batch_program_image(results):
    """The batch render through its batch programs over 2 processes x 2
    shards (each batch's radiance gathered across the processes after its
    wait) equals the 1-process 4-shard render and the eager render bit for
    bit, on both ranks."""
    two, rank1, one = results
    assert int(two["prog_batches"]) == 3 and np.abs(two["prog_img"]).max() > 0
    for got in (two["prog_img"], rank1["prog_img"], two["eager_img"], rank1["eager_img"]):
        np.testing.assert_array_equal(got, one["prog_img"])
    np.testing.assert_array_equal(one["eager_img"], one["prog_img"])
