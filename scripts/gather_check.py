"""Hold the row gathers' backward kernel (rust_raytracer_torch/ops/gather.py:
row_gather_bwd, csrc/row_gather.cu) against a float64 index_add_ on the
card, show that it gives the same bits on every run and in a CUDA graph as
eagerly, and time it beside its bound and beside PyTorch's
index_put_(accumulate=True), the backward it replaces.

    python3 scripts/gather_check.py            # on the GPU, ~1-2 min

The sets, at the fwd+bwd step's 2^16 lanes (gradients drawn from a fixed
seed): all lanes on one row of a 6 x 19 table (the planes' rows), 6 rows of
it, the triangles' 869,556 x 27 table with 90% of the ids on rows 0-5, a
permutation (the lane state, 3 columns), an empty batch, runs of 1 to 2,047
ids laid across the kernel's tile edges; then the ids and
gradients of every routed gather of one real step of the benchmark's
`dragon_grad` cell (perfbench/: 20 bounces x the planes', triangles' and
materials' rows), recorded from its eager backward.  Each set's float32
result must lie within 1e-6 of the set's largest reference entry, its
float64 result within 1e-12, and two runs must agree bit for bit, as must
a CUDA graph of the call and the eager call.  Then one `dragon_grad` step:
two eager steps and the GraphedGrad replay must give the same loss and
gradients bit for bit, the replay must launch the backward once per routed
gather (gather.launches) and the profiled replay must hold no
indexing_backward_kernel*.

Times by CUDA events around one replay of a CUDA graph of REPS calls (the
device's time): the whole backward (zeros, the ids' sort, both kernels),
the two kernels alone on sorted ids, the sort alone, and the library call
(`library_ms`: torch.zeros(...).index_put_((idx,), grad, accumulate=True),
which the port never calls).  The bound: grad_out's bytes read once plus
the touched rows' bytes written once, over 3.35 TB/s (NVIDIA H100 SXM).
"""
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

LANES = 1 << 16
PEAK_BYTES = 3.35e12
REPS = 50
REL_F32, REL_F64 = 1e-6, 1e-12
SEED = 1729
# run lengths against the kernel's 256-position tiles (csrc/row_gather.cu)
EDGE_RUNS = [1, 255, 256, 257, 511, 512, 513, 3, 2047, 768, 2]
BACKWARD_KERNELS = ("row_gather_bwd_tile", "row_gather_bwd_carry")
LIBRARY_KERNELS = ("indexing_backward_kernel", "indexing_backward_kernel_small_stride",
                   "indexing_backward_kernel_stride_1")


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def synthetic_sets(dev):
    """[(tag, grad (n, C) f32, idx (n,) int64, rows)] of the module
    docstring's synthetic sets."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def grad(n, c):
        return torch.randn((n, c), generator=gen, device=dev)

    n = LANES
    crowded = torch.randint(0, 6, (n,), generator=gen, device=dev)
    spread = torch.randint(0, 869556, (n,), generator=gen, device=dev)
    far = torch.rand((n,), generator=gen, device=dev) >= 0.9
    return [
        ("one row (6 x 19)", grad(n, 19), torch.zeros(n, dtype=torch.int64, device=dev), 6),
        ("6 rows (6 x 19)", grad(n, 19), torch.randint(0, 6, (n,), generator=gen, device=dev),
         6),
        ("869556 x 27, 90% on rows 0-5", grad(n, 27), torch.where(far, spread, crowded),
         869556),
        ("permutation (n x 3)", grad(n, 3), torch.randperm(n, generator=gen, device=dev), n),
        ("empty batch (6 x 19)", grad(0, 19), torch.zeros(0, dtype=torch.int64, device=dev), 6),
        ("runs across tile edges", grad(n, 5), edge_runs(n, dev), n),
    ]


def edge_runs(n, dev):
    """(n,) sorted ids in runs whose lengths cycle through EDGE_RUNS: runs
    that end on a tile's last position, cross one edge or several, and
    tiles of one run cut on one side only."""
    lengths = torch.tensor(EDGE_RUNS * (n // sum(EDGE_RUNS) + 1), device=dev)
    ids = torch.repeat_interleave(torch.arange(lengths.numel(), device=dev), lengths)
    return ids[:n].contiguous()


def step_runner(seed):
    """The benchmark's dragon_grad program (perfbench/core/workload.py) and
    one step's inputs."""
    from perfbench.core import spec, workload

    runner = workload.Runner(spec.load_cell("dragon_grad"), seed, "cuda")
    w = runner.camera.image_width
    pix, smp, target = workload.step_inputs(runner.seed, 0, runner.lanes, runner.target)
    return runner, (pix % w, pix // w, smp, target, runner.seed_t)


def recorded_sets(runner, lanes):
    """[(tag, grad, idx, rows)] of every call of the backward in one eager
    step of `runner`, in the order the backward made them."""
    from rust_raytracer_torch.ops import gather
    from rust_raytracer_torch.render import graphs

    got = []
    real = gather.row_gather_bwd

    def spy(grad, idx, n_rows):
        got.append((grad.clone(), idx.clone(), n_rows))
        return real(grad, idx, n_rows)

    gather.row_gather_bwd = spy
    try:
        graphs.value_and_grad(runner.step.fn, runner.pack.with_grad(), *lanes)
    finally:
        gather.row_gather_bwd = real
    torch.cuda.synchronize()
    return [(f"dragon_grad step, call {k} ({r} x {g.shape[1]})", g, i, r)
            for k, (g, i, r) in enumerate(got)]


def graphed(fn, reps=1):
    """A CUDA graph of `reps` calls of fn() (warmed up once on a side
    stream) and the last call's output."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    out = []
    with torch.cuda.graph(g):
        for _ in range(reps):
            out[:] = [fn()]
    return g, out


def graph_ms(fn, reps=REPS):
    """Device ms of one call of fn(): one replay of a graph of `reps` calls
    by CUDA events, after one warm replay."""
    g, _ = graphed(fn, reps)
    g.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / reps
    del g
    return ms


def library(grad, idx, n_rows):
    """PyTorch's backward of table[idx]: index_put_ with accumulate."""
    return torch.zeros((n_rows, grad.shape[1]), dtype=grad.dtype,
                       device=grad.device).index_put_((idx,), grad, accumulate=True)


def hold(tag, grad, idx, n_rows):
    """Check one set (module docstring); returns its numbers."""
    from rust_raytracer_torch.ops import gather

    ref = torch.zeros((n_rows, grad.shape[1]), dtype=torch.float64, device=grad.device)
    ref.index_add_(0, idx, grad.double())
    scale = float(ref.abs().max()) if ref.numel() and grad.shape[0] else 1.0
    scale = scale or 1.0
    a = gather.row_gather_bwd(grad, idx, n_rows)
    b = gather.row_gather_bwd(grad, idx, n_rows)
    g, out = graphed(lambda: gather.row_gather_bwd(grad, idx, n_rows))
    g.replay()
    torch.cuda.synchronize()
    c = out[0].clone()
    del g, out
    d64 = gather.row_gather_bwd(grad.double(), idx, n_rows)
    err = float((a.double() - ref).abs().max()) / scale if a.numel() else 0.0
    err64 = float((d64 - ref).abs().max()) / scale if a.numel() else 0.0
    lib = library(grad, idx, n_rows)
    lib_err = float((lib.double() - ref).abs().max()) / scale if a.numel() else 0.0
    twice, in_graph = torch.equal(a, b), torch.equal(a, c)
    distinct = int(torch.unique(idx).numel())
    log(f"row gather bwd, {tag}: {grad.shape[0]} lanes, {distinct} rows touched; f32 max |d| "
        f"/ max |ref| {err:.3e} (bound {REL_F32:g}; index_put_ {lib_err:.3e}), f64 "
        f"{err64:.3e} (bound {REL_F64:g}); two runs bit-equal {twice}, graph = eager bit for "
        f"bit {in_graph}")
    if not (err <= REL_F32 and err64 <= REL_F64 and twice and in_graph):
        raise AssertionError(f"row gather bwd, {tag}: err {err:.3e}, f64 {err64:.3e}, "
                             f"twice {twice}, graph {in_graph}")
    return dict(err=err, err64=err64, distinct=distinct)


def times(tag, grad, idx, n_rows, distinct, card):
    """The set's times (module docstring), in ms."""
    from rust_raytracer_torch.ops import _cuda, gather

    n, cols = grad.shape
    keys, lanes = torch.sort(idx.remainder(n_rows).to(torch.int32), stable=True)
    tiles = (n + gather.TILE - 1) // gather.TILE
    out = torch.zeros((n_rows, cols), dtype=grad.dtype, device=grad.device)
    carry = torch.empty((2 * tiles, cols), dtype=grad.dtype, device=grad.device)
    carry_id = torch.empty(2 * tiles, dtype=torch.int32, device=grad.device)
    ms = graph_ms(lambda: gather.row_gather_bwd(grad, idx, n_rows))
    kernels = graph_ms(lambda: _cuda.launch("rrt_row_gather_bwd",
                                            (keys, lanes, grad, out, carry, carry_id),
                                            (n, cols, 0), grad.device))
    sort = graph_ms(lambda: torch.sort(idx.remainder(n_rows).to(torch.int32), stable=True))
    lib = graph_ms(lambda: library(grad, idx, n_rows))
    bound = (n + distinct) * cols * grad.element_size() / PEAK_BYTES * 1e3
    log(f"time row gather bwd, {tag}: {ms:.4f} ms (the two kernels {kernels:.4f}, the sort "
        f"{sort:.4f}); bound {bound:.4f} ms (bytes), kernels at {100 * bound / kernels:.1f}% "
        f"of it; library_ms (index_put_ accumulate) {lib:.4f} ({card})")
    return dict(ms=ms, kernels_ms=kernels, sort_ms=sort, bound_ms=bound, library_ms=lib)


def step_check(runner, lanes, n_calls, card):
    """One dragon_grad step eagerly twice and graphed: bits, launches (a
    replay's = `n_calls`, the eager step's backward calls) and the profiled
    replay's kernels (module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from rust_raytracer_torch.ops import gather
    from rust_raytracer_torch.render import graphs

    def eager():
        return graphs.value_and_grad(runner.step.fn, runner.pack.with_grad(), *lanes)

    e1, e2 = eager(), eager()
    g1 = runner.step(runner.pack, *lanes)     # warm-up, capture, first replay
    before = gather.launches["row_gather_bwd"]
    g2 = runner.step(runner.pack, *lanes)
    per_replay = gather.launches["row_gather_bwd"] - before
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner.step(runner.pack, *lanes)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]

    def count(kernels):
        import re
        return sum(1 for nm in names if any(re.search(rf"(?<!\w){k}(?!\w)", nm)
                                            for k in kernels))

    def same(a, b):
        return torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))

    ours, theirs = count(BACKWARD_KERNELS), count(LIBRARY_KERNELS)
    twice, in_graph = same(e1, e2), same(e1, g1) and same(e1, g2)
    log(f"dragon_grad step ({LANES} lanes, depth 20): eager twice bit-equal {twice}; graphed = "
        f"eager bit for bit {in_graph} (loss {float(e1[0]):.6e}); row_gather_bwd launches a "
        f"replay {per_replay}; profiled replay: row_gather_bwd kernels {ours}, "
        f"indexing_backward kernels {theirs} ({card})")
    if not (twice and in_graph and per_replay == n_calls and ours == 2 * per_replay
            and theirs == 0):
        raise AssertionError(f"dragon_grad step: twice {twice}, graph {in_graph}, launches "
                             f"{per_replay}, kernels {ours}, library kernels {theirs}")
    return per_replay


def step_times(recorded, card):
    """Device ms of all the backward calls of one step, each set once, in a
    graph: ours and the library's."""
    from rust_raytracer_torch.ops import gather

    ours = graph_ms(lambda: [gather.row_gather_bwd(g, i, r) for _, g, i, r in recorded], 5)
    lib = graph_ms(lambda: [library(g, i, r) for _, g, i, r in recorded], 5)
    log(f"time row gather bwd, a dragon_grad step's {len(recorded)} calls: {ours:.3f} ms "
        f"a step, library_ms (index_put_ accumulate) {lib:.3f} ms ({card})")
    return ours, lib


def run(card, seed=3100000011):
    """Every check and time of the module docstring; returns the kernel's
    entry for chip_smoke.py's kernels line."""
    from rust_raytracer_torch.ops import _cuda, gather

    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    _cuda.build_library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, a in gather.attributes().items():
        log(f"{name}: {a['registers']} registers, {a['local_bytes']} local bytes, "
            f"{a['shared_bytes']} static shared bytes a block")
    sets = synthetic_sets(dev)
    runner, lanes = step_runner(seed)
    recorded = recorded_sets(runner, lanes)
    held = {tag: hold(tag, g, i, r) for tag, g, i, r in sets + recorded}
    worst = max(h["err"] for h in held.values())
    timed = {tag: times(tag, g, i, r, held[tag]["distinct"], card)
             for tag, g, i, r in sets[:4] + recorded[:3]}
    per_replay = step_check(runner, lanes, len(recorded), card)
    step_ms, step_lib = step_times(recorded, card)
    crowded = timed[sets[2][0]]
    log(f"row gather bwd: {len(held)} sets, worst f32 error {worst:.3e}; "
        f"{per_replay} calls a dragon_grad step")
    return dict(name="row_gather_bwd", route="cuda", source="rust_raytracer_torch/csrc/"
                "row_gather.cu", replaces=None, launches=per_replay, max_abs_err=worst,
                ms=crowded["ms"], kernels_ms=crowded["kernels_ms"], sort_ms=crowded["sort_ms"],
                bound_ms=crowded["bound_ms"], bound_by="bytes",
                library_ms=crowded["library_ms"], step_ms=step_ms, step_library_ms=step_lib)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("gather_check: needs a CUDA GPU")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(json.dumps(run(card)))


if __name__ == "__main__":
    main()
