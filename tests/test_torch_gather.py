"""The per-lane row gathers (rust_raytracer_torch/ops/gather.py:rows) on
the CPU.

The backward kernel (csrc/row_gather.cu) runs only on the card
(scripts/gather_check.py holds it there against a float64 index_add_).
Here:

- the CPU route is `table[idx]`: the same forward and gradients bit for
  bit, on the kernel's index sets cut to size (all lanes on one row, six
  rows, a large table with 90% of the ids on rows 0-5, a permutation, an
  empty batch), float32 and float64; under no_grad and for a table that
  needs no grad too;
- the engaged route's autograd op, with the kernel's wrapper replaced by
  its plain version (`plain_row_gather_bwd`): the same forward bits and
  gradients within float order, tables of any rank, ids that wrap;
- the differentiable trace reaches `rows` at every gather of its bounce
  (spheres', planes', triangles' and materials' rows, the sorted lanes),
  under each remat mode, and the engaged route gives its gradients;
- the engaged route's and the wrapper's checks raise (a meta tensor stands
  for a device tensor where the check comes before any launch);
- the launch counter in render/graphs.py's counters, advanced per replay;
- the benchmark's reader `grad_gather_bwd_ms.grad`.
"""
import types

import pytest
import torch

from perfbench.core import devtrace, spec
from perfbench.core.workload import Unit
from rust_raytracer_torch.core import rng as trng
from rust_raytracer_torch.ops import gather
from rust_raytracer_torch.render import graphs as tgraphs
from rust_raytracer_torch.render import integrator as tint
from rust_raytracer_torch.scene import compiler as tcompiler
from rust_raytracer_torch.scene import graph as tg

from test_torch_graph import DirectCapture, camera_of
from test_torch_scene import texture_scene

torch.set_num_threads(2)

LANES, DEPTH = 4096, 3
BIG_ROWS = 869556   # the triangles' table of cornell_dragon
DTYPES = (torch.float32, torch.float64)


def index_sets(n=LANES, seed=5):
    """tag -> (rows, cols, ids) of the kernel's index sets, cut to size."""
    gen = torch.Generator().manual_seed(seed)
    crowded = torch.randint(0, 6, (n,), generator=gen)
    spread = torch.randint(0, BIG_ROWS, (n,), generator=gen)
    far = torch.rand((n,), generator=gen) >= 0.9
    return {
        "one_row": (6, 19, torch.zeros(n, dtype=torch.int64)),
        "six_rows": (6, 19, torch.randint(0, 6, (n,), generator=gen)),
        "crowded_big": (BIG_ROWS, 3, torch.where(far, spread, crowded)),
        "permutation": (n, 3, torch.randperm(n, generator=gen)),
        "empty": (6, 19, torch.zeros(0, dtype=torch.int64)),
    }


SETS = index_sets()


def table_and_weights(rows, cols, n, dtype, seed=9):
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn((rows, cols), generator=gen, dtype=torch.float64).to(dtype)
    weights = torch.randn((n, cols), generator=gen, dtype=torch.float64).to(dtype)
    return table, weights


def grad_of(gather_fn, table, weights):
    """(forward, d sum(forward * weights) / d table) of `gather_fn(table)`."""
    leaf = table.clone().requires_grad_(True)
    out = gather_fn(leaf)
    (g,) = torch.autograd.grad((out * weights).sum(), [leaf], allow_unused=True)
    return out.detach(), torch.zeros_like(table) if g is None else g


@pytest.fixture
def engaged(monkeypatch):
    """The engaged route on the CPU: `engages` without its CUDA condition,
    the kernel's wrapper replaced by its plain version; yields the calls
    the backward made, (rows, cols, n) each."""
    calls = []

    def plain(grad, idx, n_rows):
        calls.append((n_rows, grad.shape[1], idx.shape[0]))
        return gather.plain_row_gather_bwd(grad, idx, n_rows)

    monkeypatch.setattr(gather, "engages",
                        lambda t: torch.is_grad_enabled() and t.requires_grad)
    monkeypatch.setattr(gather, "row_gather_bwd", plain)
    return calls


# ---------------------------------------------------------------- the CPU route

@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("tag", list(SETS))
def test_cpu_route_is_indexing(tag, dtype):
    """On the CPU `rows` is `table[idx]`: forward and gradient bit for bit
    (PyTorch's deterministic algorithms on, as the CPU's index_put_ sums a
    row's lanes across threads otherwise), counted as a plain call, with no
    launch."""
    rows, cols, idx = SETS[tag]
    table, weights = table_and_weights(rows, cols, idx.shape[0], dtype)
    before = dict(gather.plain_calls)
    launched = gather.launches["row_gather_bwd"]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = grad_of(lambda t: gather.rows(t, idx, "tri_attr"), table, weights)
        want = grad_of(lambda t: t[idx], table, weights)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].dtype == dtype and got[1].shape == table.shape
    assert gather.plain_calls["tri_attr"] == before["tri_attr"] + 1
    assert gather.launches["row_gather_bwd"] == launched


def test_no_grad_and_constant_tables_take_indexing():
    """Under no_grad, and for a table that needs no grad, `rows` is
    `table[idx]` and does not engage (on the CPU it never does)."""
    rows, cols, idx = SETS["six_rows"]
    table, _ = table_and_weights(rows, cols, idx.shape[0], torch.float32)
    leaf = table.clone().requires_grad_(True)
    with torch.no_grad():
        out = gather.rows(leaf, idx, "mrow")
    assert torch.equal(out, table[idx]) and not out.requires_grad
    assert torch.equal(gather.rows(table, idx, "mrow"), table[idx])
    assert not gather.engages(leaf) and not gather.engages(table)
    ids = torch.tensor([0, 2, 1])
    assert torch.equal(gather.rows(ids, torch.tensor([2, 0]), "lanes"), torch.tensor([1, 0]))


# ---------------------------------------------------------------- the engaged route

@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("tag", list(SETS))
def test_engaged_route_matches_indexing(engaged, tag, dtype):
    """The autograd op: the forward of `table[idx]` bit for bit, the
    gradient of `table[idx]` within float order (n eps times a row's sum of
    |contributions|, the bound of a sum of n terms in either order), one
    backward call a gather with the table's rows and columns."""
    rows, cols, idx = SETS[tag]
    n = idx.shape[0]
    table, weights = table_and_weights(rows, cols, n, dtype)
    got = grad_of(lambda t: gather.rows(t, idx, "pln_row"), table, weights)
    want = grad_of(lambda t: t[idx], table, weights)
    assert torch.equal(got[0], want[0])
    l1 = gather.plain_row_gather_bwd(weights.abs().double(), idx, rows)
    tol = 2 * n * torch.finfo(dtype).eps * float(l1.max()) if n else 0.0
    assert float((got[1].double() - want[1].double()).abs().max()) <= tol
    assert engaged == [(rows, cols, n)]


@pytest.mark.parametrize("shape", [(7,), (7, 2, 3)])
def test_engaged_route_any_rank_and_wrapping_ids(engaged, shape):
    """A table of one or three dimensions, ids that wrap (-1 is the last
    row, as in `table[idx]`)."""
    idx = torch.tensor([0, -1, 6, 3, 3, -7, 2])
    gen = torch.Generator().manual_seed(3)
    table = torch.randn(shape, generator=gen, dtype=torch.float64)
    weights = torch.randn((idx.shape[0],) + shape[1:], generator=gen, dtype=torch.float64)
    got = grad_of(lambda t: gather.rows(t, idx, "sph_row"), table, weights)
    want = grad_of(lambda t: t[idx], table, weights)
    assert torch.equal(got[0], want[0])
    assert torch.allclose(got[1], want[1], rtol=0.0, atol=1e-14)
    assert engaged == [(7, got[0][0].numel(), idx.shape[0])]


# ---------------------------------------------------------------- the trace

@pytest.fixture(scope="module")
def textured():
    """tests/test_torch_scene.py's texture scene (spheres, planes, a mesh,
    every material) on the CPU, its camera at 16 px."""
    scene = texture_scene(tg)
    pack, static = tcompiler.compile_scene(scene, "cpu")
    return pack, static, camera_of(scene, depth=DEPTH)


def trace_grads(pack, static, cam, remat, n=256, seed=3):
    """The differentiable trace (compacted) of n raster-order lanes and the
    gradients of mean(rad ** 2) in every float table of the pack."""
    ar = torch.arange(n)
    px, py = ar % cam.image_width, (ar // cam.image_width) % cam.image_height
    smp = torch.zeros_like(ar)

    def loss(p):
        ctx = trng.Ctx(pixel=py * cam.image_width + px, sample=smp, bounce=0, seed=seed)
        org, dirn = cam.generate_rays(px, py, smp, ctx)
        rad = tint.trace(p, static, org, dirn, ctx, DEPTH, cam.light_bias, compact=True,
                         differentiable=True, kernel="threaded", remat=remat)
        return (rad ** 2).mean()

    return tgraphs.value_and_grad(loss, pack.with_grad())


@pytest.mark.parametrize("remat", tint.REMAT_MODES)
def test_trace_reaches_rows(textured, remat):
    """Each bounce of the differentiable trace gathers through `rows`: the
    spheres', planes', triangles' and materials' rows once a bounce (twice
    where the backward recomputes the shading), the 8 lane fields once a
    sort (one sort a bounce)."""
    pack, static, cam = textured
    assert pack.sph_center.shape[0] and pack.pln_corner.shape[0] and pack.tri_v0.shape[0]
    before = dict(gather.plain_calls)
    trace_grads(pack, static, cam, remat)
    counts = {k: gather.plain_calls[k] - before[k] for k in gather.SITES}
    shaded = DEPTH * (1 if remat == "none" else 2)
    assert counts == {"sph_row": shaded, "pln_row": shaded, "tri_attr": shaded,
                      "mrow": shaded, "lanes": 8 * DEPTH}


@pytest.mark.parametrize("remat", tint.REMAT_MODES)
def test_trace_engaged_route_gradients(textured, engaged, remat):
    """The engaged route through the whole trace: the loss bit for bit and
    the gradients within float order of the CPU route's; backward calls
    for every site's table (the lane state's from the second bounce, where
    it first depends on the scene)."""
    pack, static, cam = textured
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gather, "engages", lambda t: False)
        want = trace_grads(pack, static, cam, remat)
    got = trace_grads(pack, static, cam, remat)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        scale = float(w.abs().max()) if w.numel() else 0.0
        assert torch.allclose(g, w, rtol=1e-5, atol=1e-7 * max(scale, 1.0))
    tables = {r for r, _, _ in engaged}
    assert {pack.sph_center.shape[0], pack.pln_corner.shape[0], pack.tri_attr.shape[0],
            pack.mat_type.shape[0], 256} <= tables


# ---------------------------------------------------------------- checks

def test_engaged_route_checks_raise(monkeypatch):
    """The engaged route takes ids on the table's device, a contiguous
    float32 or float64 table and (n,) int64 ids, and raises otherwise."""
    monkeypatch.setattr(gather, "engages", lambda t: True)
    meta = torch.empty((6, 19), device="meta")
    ids = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="table's device"):
        gather.rows(meta, torch.zeros(4, dtype=torch.int64), "pln_row")
    with pytest.raises(ValueError, match="contiguous"):
        gather.rows(torch.empty((19, 6), device="meta").t(), ids, "pln_row")
    with pytest.raises(ValueError, match="float32 or float64"):
        gather.rows(torch.empty((6, 19), dtype=torch.float16, device="meta"), ids, "pln_row")
    with pytest.raises(ValueError, match="int64"):
        gather.rows(meta, ids.int(), "pln_row")
    with pytest.raises(ValueError, match="int64"):
        gather.rows(meta, ids.reshape(2, 2), "pln_row")


def test_wrapper_raises_off_the_card():
    """The backward's wrapper takes CUDA tensors on one device, a
    contiguous (n, C) float gradient and (n,) int64 ids; nothing falls back
    to the CPU."""
    grad, ids = torch.zeros((4, 3)), torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        gather.row_gather_bwd(grad, ids, 6)
    with pytest.raises(ValueError, match="one device"):
        gather.row_gather_bwd(grad.to("meta"), ids, 6)
    with pytest.raises(ValueError, match="CUDA"):
        gather.row_gather_bwd(grad.double(), ids, 6)


# ---------------------------------------------------------------- counters

def test_launch_counter_in_graph_counts(textured, monkeypatch):
    """`row_gather_bwd` is among render/graphs.py's launch counters: a
    GraphedGrad replay advances it by one step's backward calls (a stand-in
    for the wrapper that counts as the kernel's does), the warm-up and the
    capture by none."""
    pack, static, cam = textured

    def counted(grad, idx, n_rows):
        gather.launches["row_gather_bwd"] += 1
        return gather.plain_row_gather_bwd(grad, idx, n_rows)

    monkeypatch.setattr(gather, "engages", lambda t: torch.is_grad_enabled() and t.requires_grad)
    monkeypatch.setattr(gather, "row_gather_bwd", counted)
    assert "row_gather_bwd" in tgraphs.launch_counts()
    ar = torch.arange(128)
    lanes = (ar % cam.image_width, (ar // cam.image_width) % cam.image_height,
             torch.zeros_like(ar), torch.tensor(4))

    def loss(p, px, py, smp, seed):
        ctx = trng.Ctx(pixel=py * cam.image_width + px, sample=smp, bounce=0, seed=seed)
        org, dirn = cam.generate_rays(px, py, smp, ctx)
        rad = tint.trace(p, static, org, dirn, ctx, DEPTH, cam.light_bias, compact=False,
                         differentiable=True, kernel="threaded", remat="none")
        return (rad ** 2).mean()

    start = gather.launches["row_gather_bwd"]
    tgraphs.value_and_grad(loss, pack.with_grad(), *lanes)
    eager = gather.launches["row_gather_bwd"] - start
    # no sort: at most the four scene tables a bounce (a gather whose rows
    # do not reach the loss has no backward)
    assert 0 < eager <= 4 * DEPTH
    step = tgraphs.GraphedGrad(loss, capture=DirectCapture())
    start = gather.launches["row_gather_bwd"]
    step(pack, *lanes)
    per = step.captures[torch.device("cpu")].launched["row_gather_bwd"]
    assert per == eager
    assert gather.launches["row_gather_bwd"] == start + per
    step(pack, *lanes)
    assert gather.launches["row_gather_bwd"] == start + 2 * per
    counts = tgraphs.launch_counts()
    tgraphs._set_launches({**counts, "row_gather_bwd": 5})
    assert gather.launches["row_gather_bwd"] == 5
    tgraphs._set_launches(counts)


# ---------------------------------------------------------------- the benchmark's reader

def test_grad_gather_bwd_reader():
    """Device ms a traced step of PyTorch's indexing backward kernels and the
    port's two, whole names only; none without a trace or such a kernel."""
    read = spec.metric_reader("grad_gather_bwd_ms.grad")
    names = [
        ("void (anonymous namespace)::indexing_backward_kernel_small_stride<float, float>"
         "(long const*, long const*, float const*, float*, long, long, long, long, bool)", 4e-3),
        ("void (anonymous namespace)::indexing_backward_kernel<float, 4>(long const*)", 1e-3),
        ("void (anonymous namespace)::row_gather_bwd_tile<float>(int const*, long long "
         "const*, float const*, float*, float*, int*, int, int)", 2e-4),
        ("void (anonymous namespace)::row_gather_bwd_carry<float>(int const*, float const*, "
         "int const*, float*, int, int)", 1e-4),
        ("void (anonymous namespace)::indexing_backward_kernel_quantized<float>(long)", 5.0),
        ("void at::native::vectorized_elementwise_kernel<4>(int)", 7.0),
    ]
    ivs, t = [], 0.0
    for name, secs in names:
        ivs.append((t, t + secs, name))
        t += secs
    trace = devtrace.DeviceTrace(window_s=20.0, intervals={0: ivs}, host=[], devices=(0,))
    units = [Unit(0, 1, 64, True), Unit(1, 2, 64, True)]
    ctx = types.SimpleNamespace(trace=trace, traced_units=units)
    assert read(ctx) == pytest.approx(1e3 * (4e-3 + 1e-3 + 2e-4 + 1e-4) / 2)
    assert read(types.SimpleNamespace(trace=None, traced_units=units)) is None
    empty = devtrace.DeviceTrace(window_s=1.0, intervals={0: ivs[-2:]}, host=[], devices=(0,))
    assert read(types.SimpleNamespace(trace=empty, traced_units=units)) is None
