"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the traversal kernels from rust_raytracer_torch/csrc, builds the
full ~870k-triangle cornell_dragon scene on the card, holds the BVH8 kernel
against its plain PyTorch version on 2^18 primary, bounce and capped/dead
rays (the pool width) and times both, checks that a small render on the
card agrees with the same render on the CPU, then renders cornell_dragon at
1200x1200, 1 spp, depth 20 through `Renderer(...).render(mode="pool")` with
2^18 lanes and checks that every pool step launched the kernel.  It renders
again with every pool step's traversal inputs recorded and holds the kernel
against the plain version on each, then splits a pool step's device time.

Then the same for the wavefront traversal (`kernel="wavefront"`: on the
main path two kernels, the fused cull+compact and Möller–Trumbore; the
standalone cull and compact kernels are held too): each kernel against
its plain version, the fused kernel against compact(cull(...)), and the
pipeline against the BVH8 kernel, on the traversal inputs that a
wavefront render passes at its first, a mid-render and a drain step, and
on primary rays over the whole image; the dense single-level pipeline on
2^15 lanes; each kernel's time against its plain version's, the fused
kernel's against cull then compact, and the peak memory of one pipeline2
call and of its stages fused and unfused; cull, cull+compact and MT
against their plain versions on adversarial sets of 4096 packets (NaN
slabs, n1 = 0 and n1 = k1 rows, repeated supernodes, a cap inside a
slot; clusters listed twice or beside an identical copy, t tied across
lanes, cnt 0 and cnt = k, dead rays beside live ones); the share of the
mid-render step's listed (ray, cluster) pairs whose own box test hits;
the wavefront main-path render, its launches (the kernels line reports
these, and the parity phases' apart), overflow and image against the
BVH8 render's; and its step split.

Then the threaded-BVH walk (`kernel="threaded"`, K3): the kernel against
its plain version and against the BVH8 kernel on 2^18 sorted primary,
bounce and capped/dead rays, its time against both with the counts its
bound needs; the batch render (`render(mode="batch")`) of cornell_dragon at
full width through it, its launches and its image against the BVH8 pool
image; the fwd+bwd step (the differentiable trace at 2^15 lanes, depth 20,
gradients of every float scene table) with remat "none" and "hits", as one
CUDA graph replay a step (render/graphs.py:GraphedGrad): its rate, graph
nodes, capture seconds, peak and held memory and device split, its
gradients against the BVH8 walk's; and a small gradient on the card
against the same on the CPU.

Then volumes, the CLI and checkpoint/resume: cornell_smoke (two box
volumes) at 64x64 on the card against the CPU; 2^18 random rays through `intersect` and
`hit_attributes` on cornell_smoke with a sphere, a sheared-box and a
352-triangle mesh volume added (every boundary kind), card against CPU,
with its time, its peak memory and each volume's span time;
cornell_dragon with a fog sphere through the pool at the main path's
size (K1 every step, lanes stopping in the volume); the CLI
(`utils/cli.py:main`, with `--metrics=1`) on cornell_smoke at its own
600x600 and on cornell_dragon at 1200x1200, 1 spp, depth 20 (rc 0, the PNG,
the metrics line; K1 launches = pool steps); and the resumable pool on
the card, interrupted and resumed (lane state equal bit for bit, image
within float sum order; the checkpoint's save time and size at 2^18
lanes).  The BVH8 and wavefront pool steps must launch the kernels
STEP_LAUNCHES counts (the wavefront step within STEP_SLACK).

Then the f64 validation dtype and the mesh (parallel/mesh.py): the scene
of tests/_grad_fd_main.py at f64 through the "jnp" walk on the card against
the CPU (radiance and gradients within 1e-9 relative, central differences
within rtol 1e-3 of the gradients, no K1 or K3 launch, an f64 Renderer with
kernel="auto" refused); cornell_dragon at the main path's size through the
pool with make_mesh(1) and with two shards on the one card (K1 launches =
shards x steps, every job issued, the image against the unsharded pool's,
the rates side by side; each shard's state made and kept on its device,
render/pool.py's ShardedState), the two-shard step graphed against eager
over 20 steps (lane state bit-equal shard for shard, each shard's state
its graph's donated buffers) and its steady step split beside the
unsharded graphed step's (wall, busy, kernels, and what the host issues
a step: no aten op besides the replays, the CUDA runtime's graph
launches and other launches), the wavefront pool with make_mesh(1) (its
overflow equal to the unsharded render's), the batch render through K3
with 1 and 2 shards, and train_step_fn through K3 with 1 and 2 shards,
eager and graphed (one GraphedGrad replay a shard a step; equal after
normalisation); and a 2-shard pool state saved in the stacked layout,
loaded back on the mesh shard for shard and stepped on beside the live
one (lane state equal bit for bit; the file's size, save and load
times).  The kernels line gives each kernel's launches on these sharded
paths (`sharded_launches`).

Then the CUDA graphs (render/graphs.py; phase 25): on the card every pool
render above replays a captured graph a step, and the phases that hook a
step's Python (the recorded steps) or check STEP_LAUNCHES run the eager
step.  Phase 25 steps the main path's BVH8 and wavefront pools eagerly
and graphed from one start, in turns, 20 steps each (lane state
bit-equal, accumulator within float order, the graphed steps' kernel
launches = steps); renders the main path both ways in turns
(eager, graphed with its capture, graphed, eager): rates, wall ms/step,
the graph's nodes a step read from libcuda beside STEP_LAUNCHES, capture
seconds, peak memory, images within float order; and splits a steady
step's device time both ways.  Phase 26 runs the fwd+bwd step eagerly and
graphed in turns at seeds 1-3 for remat "none", "hits" and "full" through
K3 and K1 (loss bit-equal, gradients within the eager-vs-eager gap and
1e-5, one capture for the three seeds, launches = replays x 20, x 40 under
"full"), with its wall and device busy ms, nodes and memory.  Phase 27
renders (pool and batch) at k = 1, 2, 4 seeds with the Renderer's graph
cache as it stood before its bound and as it is, for "auto" and
"wavefront", and prints the device memory after each k: the bounded
cache's must not grow.

Since phase 28's slice a batch of the batch render (phases 15, 23, 27,
28) is one launch of a graph holding the whole batch program: lane ids,
camera rays, a conditional WHILE node over the bounce with its stop test
on the card (csrc/loop_cond.cu), the scatter back
(render/renderer.py:BatchProgram, render/graphs.py:LoopGraph); the host
sums batch i while batch i + 1 runs.  Phase 15 profiles the batch render
eagerly (the profiler records one pass of a conditional node's body a
launch).  Phase 28 holds one LANES-lane batch of the program against the
eager trace (radiance bit-equal, the device bounce counter = the eager
bounces = K3 launches, and one K3 kernel node in the loop body, read
from libcuda, so that the graph's K3 launches are its bounces) with its
build seconds, graph nodes and peak memory; loop_cond's flag against its plain version at every bounce, both
timed; the cornell_dragon batch render eager and graphed in turns
(images bit-equal, rates, one loop graph launch and one event wait a
batch, no other host sync under torch's sync debug mode, the host's
launch, wait and float64-sum seconds, the device's time by CUDA events
around each batch's graph launch in the timed render, and the idle share
that time leaves in its wall); and a card under an open sky,
whose paths all end by their second bounce, both ways.

K1 and K3 test a leaf with the whole warp (rust_raytracer_torch/csrc/
traverse_common.cuh:warp_leaf_test).  Beside each of
their times the smoke prints the counts that design answers to, from the
walks in torch ops (warps of 32 lanes in ray order): leaf visits, the warp
leaf passes a per-thread 128-slot leaf loop would run and the share of
lanes busy in them, the warps' loop iterations, and the cooperative
test's equivalent (leaf visits x 4 / 128 passes).  Phase 1 prints K1's,
K3's, K2a's (standalone and fused with K2b), K2c's and loop_cond's registers, local
(stack and spill) bytes and shared bytes as the loaded module reports
them (cudaFuncGetAttributes), the SASS instructions a test in K2a's (both
kernels) and K2c's inner loops (cuobjdump, where the toolkit has it), and
holds K2c's branch-free reciprocal equal to __frcp_rn on every float in
its range.

A kernel's time is the mean over KERNEL_REPS back-to-back calls of its
wrapper between two CUDA events, after a warm-up call (PLAIN_REPS for a
plain version); the calls repeat the same inputs, so whatever of them
fits in the 50 MB L2 stays there.

Each kernel's bound (the least time the card could take for the work) is
the larger of its operations over 67 TFLOP/s (f32, outside the tensor
cores) and its bytes over 3.35 TB/s (NVIDIA H100 SXM data sheet), from
counts of what these rays need: a slab test is 25 operations, a
Möller–Trumbore test 56; rays are read and results written once, and each
distinct node and cluster touched is read once.

Since phase 29's slice the path vertex runs as four hand-written kernels
(rust_raytracer_torch/ops/vertex.py: KV1 vertex_hit, KV2 vertex_shade, KV3
lane_update with lane_bbox and compaction_key, KV4 pool_refill) on every
forward path: each pool step launches each once (phases 5, 11, 19, 20, 23
and 25 count them = steps) and each batch bounce all but the refill
(phases 15 and 28); the fwd+bwd step and the f64 trace take the plain torch ops and
launch none (phases 16 and 22).  Each path's log line says which route
it took.  The graphed BVH8 pool step may hold at most
MAX_STEP_KERNEL_NODES kernel nodes (phase 25).  Phase 29
(scripts/vertex_parity.py) holds each vertex kernel against its plain
version on the inputs of the BVH8 and the wavefront pool's first, a
mid-render and a drain step at 2^18 lanes, of the fog scene (volume hits),
of a card under a sky and a sun (with an aperture), of a scene with
every texture node kind and material, and of that scene with a rotated,
non-uniformly scaled sphere (the affine sphere rows): lanes not bit-equal and max |d| an
output, within vertex_parity.TOLERANCE; then times each kernel against its
plain version (CUDA events) beside its bound.

The differentiable trace's row gathers take a hand-written backward on the
card (rust_raytracer_torch/ops/gather.py, csrc/row_gather.cu): the fwd+bwd
steps launch it once per routed gather whose rows reach the loss (at most
GATHERS_A_BOUNCE a bounce of cornell_dragon; phases 16 and 26 count
them), the f64 trace its float64 instance (phase 22).  Phase 30
(scripts/gather_check.py) holds it against a float64 index_add_ on
synthetic sets and on the calls of one benchmark `dragon_grad` step,
checks its bits over two runs and in a graph against eager, the step's
bits graphed against eager, and times it beside its bound and PyTorch's
index_put_(accumulate=True).

In a scene with volumes the pool step and the batch bounce launch one more
kernel between the walk and KV2, the free-flight kernel KV-FF
(ops/vertex.py:free_flight, csrc/free_flight.cu): the hit merge and each
volume's free flight, in place of ops/intersect.py:merge_volumes's torch
ops (phases 19-20 count its launches = steps, and read the scattering
events from the step's counter).  Phase 31 (scripts/free_flight_check.py)
holds it bit for bit against merge_volumes on recorded cornell_smoke and
fog steps and on random rays through every boundary kind and three
seeded scenes of rotated boxes and ellipsoids, a graph replay against
the eager call, and times it beside its bound and the plain version.

Any failed check raises, so the exit code is non-zero.  The last two lines
of standard output are a JSON line describing each kernel and the final
JSON result line.

Requires CUDA (exits non-zero without printing a result otherwise).  Nothing
of JAX or of the JAX reference package is imported: `jax` is blocked at the
top of this script and `rust_raytracer_tpu` is checked at the end.
"""
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from collections import Counter

sys.modules["jax"] = None  # the port must run without JAX

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

W, SPP, DEPTH, LANES = 1200, 1, 20, 1 << 18
GRAD_LANES = 1 << 15
HERE = os.path.dirname(os.path.abspath(__file__))

# bounds: NVIDIA H100 SXM, f32 outside the tensor cores and HBM3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
SLAB_OPS, MT_OPS = 25, 56      # operations of one slab test, one Möller–Trumbore test
RAY_BYTES, HIT_BYTES = 28, 8   # org, dirn, t_max in; t, slot out
CLUSTER_BYTES = 128 * 48       # one cluster's triangle rows
KERNEL_REPS, PLAIN_REPS = 50, 3
# kernels a steady cornell_dragon pool step launches eagerly, as measured on
# the H100 since the path vertex runs as the kernels of ops/vertex.py
# (before them 1668 and ~1739): the traversal, the six launches of the four
# vertex kernels (KV3 is the update, the box and the key), the sort's, the
# index_add's and a few fills; a scene without
# volumes adds none to them (a scene with volumes adds one, the free-flight
# kernel KV-FF, in place of the ~190 torch ops its step launched before),
# and the metrics recorder none at all.  The BVH8 step's count is exact;
# the wavefront step's mean over five steps varied by up to 2 across runs
# before (its L1 stage), so it is held within STEP_SLACK of its count.  A
# graphed step replays these and 11 copies of the next state into the
# graph's buffers.
STEP_LAUNCHES = {"auto": 34, "wavefront": 106}
STEP_SLACK = {"auto": 0, "wavefront": 2}
# the graphed BVH8 pool step's kernel nodes may not pass this (1,653 before
# the vertex kernels)
MAX_STEP_KERNEL_NODES = 150
# the path vertex kernels (ops/vertex.py) a pool step launches once each,
# and those a batch bounce launches (no refill)
VERTEX_POOL = ("vertex_hit", "vertex_shade", "lane_update", "lane_bbox", "compaction_key",
               "pool_refill")
VERTEX_BOUNCE = VERTEX_POOL[:5]
# routed row gathers (ops/gather.py) a differentiable cornell_dragon bounce
# makes: the planes', the triangles' and the materials' rows (the scene has
# no sphere); each has one backward where its rows reach the loss
GATHERS_A_BOUNCE = 3
VERTEX_SOURCES = dict(zip(VERTEX_POOL, ("vertex_hit.cu", "vertex_shade.cu", "lane_update.cu",
                                        "lane_update.cu", "lane_update.cu", "pool_refill.cu")))


def log(*a):
    print(*a, flush=True)


def reset_vertex():
    """Set the path vertex kernels' launch and plain-call counts to 0."""
    from rust_raytracer_torch.ops import vertex

    torch.cuda.synchronize()
    for name in vertex.KERNELS:
        vertex.launches[name] = vertex.plain_calls[name] = 0


def vertex_want(n, names=VERTEX_POOL, free_flight=0):
    """vertex.launches after n steps (or bounces) that launch each of
    `names` once, and KV-FF `free_flight` times in all (a step of a scene
    with volumes launches it once)."""
    from rust_raytracer_torch.ops import vertex

    return {**dict.fromkeys(vertex.KERNELS, 0), **dict.fromkeys(names, n),
            "free_flight": free_flight}


def vertex_route():
    """The route the path vertex took since reset_vertex, for the log."""
    from rust_raytracer_torch.ops import vertex

    return (f"vertex kernels launched {dict(vertex.launches)}, plain calls "
            f"{ {k: v for k, v in vertex.plain_calls.items() if v} }")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def is_kernel(symbol, kernel):
    """Whether `symbol` (a mangled or demangled function name) names the
    function `kernel` as a whole: wf_cull_kernel is not
    wf_cull_compact_kernel."""
    return (symbol.startswith(f"_Z{len(kernel)}{kernel}")
            or re.search(rf"(?<!\w){kernel}(?!\w)", symbol) is not None)


def sass_loops(lib_path, kernel):
    """The loops of `kernel`'s SASS in the built library (`cuobjdump
    --dump-sass`): for each backward branch, the opcodes of the
    instructions from its target to the branch (static counts, "_total"
    among them).  None where cuobjdump is missing or fails."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(exe):
        return None
    out = subprocess.run([exe, "--dump-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        return None
    funcs, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(line)
    name = next((f for f in funcs if is_kernel(f, kernel)), None)
    if name is None:
        return None
    insts, labels, pending = [], {}, []
    for line in funcs[name]:
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if ins:
            addr = int(ins.group(1), 16)
            labels.update((lb, addr) for lb in pending)
            pending = []
            insts.append((addr, ins.group(2)))
    def opcode(text):
        return next(w for w in text.split() if not w.startswith("@"))

    def branch_target(text):
        hexa, lab = re.search(r"0x([0-9a-f]+)", text), re.search(r"(\.L_x_\d+)", text)
        return int(hexa.group(1), 16) if hexa else labels.get(lab.group(1)) if lab else None

    loops = []
    for addr, text in insts:
        if not opcode(text).startswith("BRA"):
            continue
        target = branch_target(text)
        if target is None or target > addr:
            continue
        body = [(a, t) for a, t in insts if target <= a <= addr]
        # the hot path: skip each region that a predicated forward branch
        # jumps over and that holds a CALL (rcp.rn's or the rare __frcp_rn
        # slow path)
        cold = set()
        for a, t in body:
            if t.startswith("@") and opcode(t).startswith("BRA"):
                end = branch_target(t)
                if end is not None and a < end <= addr:
                    region = [b for b, u in body if a < b < end]
                    if any(opcode(u).startswith("CALL") for b, u in body if a < b < end):
                        cold.update(region)
        ops = Counter(opcode(t) for _, t in body)
        ops["_total"] = len(body)
        ops["_hot"] = len(body) - len(cold)
        ops["_hot_rcp"] = sum(opcode(t) == "MUFU.RCP" for a, t in body if a not in cold)
        loops.append(ops)
    return loops


def loop_per_test(loops, kernel):
    """SASS instructions a test on the hot path of the kernel's inner loop
    (sass_loops): for wf_mt the loop whose hot path holds a MUFU.RCP for
    each of its tests (one reciprocal a Möller–Trumbore test; the walk of
    a packet whose rays are all live), for wf_cull the slot loop (the one
    holding its barrier and ballot; 8 slab tests a pass).  Returns (hot
    instructions a test, hot and static instructions of the loop, tests
    in it, min/max a test) or None.  `kernel` is wf_mt, or wf_cull or
    wf_cull_compact (one slot loop)."""
    def count(lp, prefix):
        return sum(n for o, n in lp.items() if o.startswith(prefix))

    if not loops:
        return None
    if kernel == "wf_mt":
        cand = [lp for lp in loops if lp["_hot_rcp"] >= 8]
        if not cand:
            return None
        lp = min(cand, key=lambda x: x["_hot"] / x["_hot_rcp"])
        tests = lp["_hot_rcp"]
    else:
        cand = [lp for lp in loops if count(lp, "BAR") and count(lp, "VOTE")]
        if not cand:
            return None
        lp, tests = min(cand, key=lambda x: x["_hot"]), 8
    return (lp["_hot"] / tests, lp["_hot"], lp["_total"], tests,
            count(lp, "FMNMX") / tests)


def leaf_work(counts, n):
    """The counts the leaf-test design answers to (warps of 32 lanes in ray
    order): leaf visits; the warp leaf passes a per-thread 128-slot leaf
    loop runs (iterations in which any lane of the warp holds a leaf) and
    the share of lanes busy in them; the warps' loop iterations; and the
    warp-cooperative test's equivalent, leaf visits x 4 / 128 passes; with
    the BVH8 walk's "groups", the groups of 32 slots tested, their share of
    4 a visit and the bytes a visit reads (leaf_bytes)."""
    warps = -(-n // 32)
    lv, wp = counts["leaf_visits"], counts["warp_leaf_passes"]
    out = (f"leaf visits {lv}, warp leaf passes {wp} ({wp / warps:.2f} a warp), leaf "
           f"efficiency {lv / max(32 * wp, 1):.1%}, loop iterations "
           f"{counts['warp_steps'] / warps:.1f} a warp; cooperative leaf test "
           f"{lv * 4 / 128:.1f} pass equivalents ({lv * 4 / 128 / warps:.2f} a warp)")
    if "groups" in counts:
        out += (f"; groups tested {counts['groups']} ({counts['groups'] / max(4 * lv, 1):.2%} "
                f"of 4 a visit), bytes a leaf visit {leaf_bytes(counts):.0f} (128-slot scan "
                f"{CLUSTER_BYTES})")
    return out


def leaf_bytes(counts):
    """Bytes a leaf visit of the BVH8 walk reads, from bvh8_walk's counts:
    the 96 bytes of group boxes and 32 rows of 48 bytes a group tested."""
    return 96 + counts["groups"] * 32 * 48 / max(counts["leaf_visits"], 1)


def make_rays(camera, n, device):
    """Primary rays of n pixels spread over the whole image (bench.py's
    column stride 7; rows spread evenly, where bench.py's stride 13 covers
    only the top rows at this width)."""
    from rust_raytracer_torch.core import rng as vrng

    ar = torch.arange(n, dtype=torch.int64, device=device)
    px = ar * 7 % camera.image_width
    py = ar * camera.image_height // n
    smp = torch.zeros_like(ar)
    ctx = vrng.Ctx(pixel=py * camera.image_width + px, sample=smp, bounce=0, seed=0)
    org, dirn = camera.generate_rays(px, py, smp, ctx)
    return org.contiguous(), dirn.contiguous()


def bounce_rays(org, dirn, t, slot):
    """A bounce-like wavefront, as bench.py:kernel_parity_check makes it:
    origins at the primary hits, directions from a seeded normal draw."""
    hit = slot >= 0
    t_h = torch.where(hit, t, torch.ones_like(t))
    org2 = (org + dirn * t_h[:, None]).contiguous()
    r = np.random.default_rng(0)
    d2 = r.normal(size=(org.shape[0], 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return org2, torch.from_numpy(d2).to(org.device)


def compare(pack, org, dirn, tag, t_max=None, quiet=False):
    """Kernel vs plain version on the same rays: equal hit masks, t within
    rtol 2e-5 / atol 1e-6, slot agreement >= 0.999, t == t_max on a miss.
    Returns the max abs t error and the slot agreement over lanes both hit,
    the hit count, and the kernel's (t, slot)."""
    from rust_raytracer_torch.ops import bvh8

    n = org.shape[0]
    if t_max is None:
        t_max = torch.full((n,), 3.4e38, dtype=torch.float32, device=org.device)
    t_k, i_k = bvh8.intersect_triangles_bvh8(pack, org, dirn, None, t_max)
    t_p, i_p = bvh8.traverse_plain(pack, org, dirn, t_max)
    torch.cuda.synchronize()
    hk, hp = i_k >= 0, i_p >= 0
    if not torch.equal(hk, hp):
        raise AssertionError(f"{tag}: hit masks differ on {(hk != hp).sum().item()} rays")
    both = hk & hp
    err = (t_k[both] - t_p[both]).abs()
    if both.any() and not torch.all(err <= 1e-6 + 2e-5 * t_p[both].abs()):
        raise AssertionError(f"{tag}: t differs, max abs err {err.max().item()}")
    if not torch.equal(t_k[~hk], t_max[~hk]):
        raise AssertionError(f"{tag}: missed rays do not return t_max")
    agree = (i_k[both] == i_p[both]).float().mean().item() if both.any() else 1.0
    if agree < 0.999:
        raise AssertionError(f"{tag}: slot agreement {agree} < 0.999")
    max_err = err.max().item() if both.any() else 0.0
    n_hit = int(both.sum())
    if not quiet:
        log(f"parity {tag}: {n} rays, hits {n_hit}, slot agreement "
            f"{agree:.6f}, max |dt| {max_err:.3e}")
    return max_err, agree, n_hit, (t_k, i_k)


def occupancy(metrics):
    """Mean share of the pool's lanes live at a poll, from a RenderMetrics."""
    return metrics.summary()["mean_occupancy"] / LANES


def time_ms(fn, reps=KERNEL_REPS):
    """ms a call of `fn`: CUDA events around `reps` back-to-back calls
    after a warm-up call, divided by `reps`."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def light_region(camera, corners):
    """Pixel-space bounding box of a world-space quad seen by the camera."""
    pos = np.asarray(camera.position, np.float64)
    a = np.stack([np.zeros(3), -camera.pixel_delta_u, -camera.pixel_delta_v], 1)
    pts = []
    for c in corners:
        a[:, 0] = np.asarray(c, np.float64) - pos
        _, px, py = np.linalg.solve(a, camera.first_pixel - pos)
        pts.append((px, py))
    pts = np.asarray(pts)
    x0, y0 = np.ceil(pts.min(0)).astype(int) + 2
    x1, y1 = np.floor(pts.max(0)).astype(int) - 2
    return x0, x1, y0, y1


def pool_step_parity(renderer):
    """Render through the main path again with the traversal's inputs
    (org, dirn, t_max) recorded at every pool step, then hold the kernel
    against the plain version on each step's own inputs: primary and bounce
    rays in compaction order, t_max = +inf where no sphere or plane bounds
    the ray, 0 on dead lanes.  Returns the max abs t error."""
    from rust_raytracer_torch.ops import bvh8

    recorded = record_steps(renderer, bvh8, "intersect_triangles_bvh8")
    max_err, min_agree, rays, hits, inf_lanes, dead_lanes = 0.0, 1.0, 0, 0, 0, 0
    for k, (org, dirn, t_max) in enumerate(recorded):
        err, agree, n_hit, _ = compare(renderer.pack, org, dirn, f"pool step {k + 1}",
                                       t_max, quiet=True)
        max_err, min_agree = max(max_err, err), min(min_agree, agree)
        rays += org.shape[0]
        hits += n_hit
        inf_lanes += int(torch.isinf(t_max).sum())
        dead_lanes += int((t_max == 0).sum())
    if not (inf_lanes and dead_lanes):
        raise AssertionError("the pool steps passed no +inf or no dead (0) t_max")
    log(f"parity pool steps: {len(recorded)} steps, {rays} rays, hits {hits}, "
        f"t_max +inf on {inf_lanes}, 0 (dead) on {dead_lanes}; min slot agreement "
        f"{min_agree:.6f}, max |dt| {max_err:.3e}")
    return max_err


class OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched while it is on: the device work the
    host issues itself (a graph replay dispatches none)."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


# the host's CUDA runtime calls that put work on a stream outside a graph
HOST_LAUNCH = re.compile(r"cu(da)?(LaunchKernel|LaunchCooperative|Memcpy|Memset)")


def step_split(renderer, camera, card, names, warm=10, steps=5, mesh=None, graph=False):
    """Time `steps` steady-state pool steps of `renderer`'s path, then
    profile as many more: wall time, device time, and the share of each
    traversal kernel (`names`: its `__global__` name less `_kernel`,
    matched whole).  The profiler
    slows the host, so device busy time is read against the unprofiled
    wall time.  The step is eager unless `graph` (then the warm-up steps
    include its capture, and the kernels a step are those the profiler
    sees a replay run).  Eager and without a `mesh`, raises unless the
    profiled steps' mean launches a step is within STEP_SLACK[kernel] of
    STEP_LAUNCHES[kernel]; with one, the step is the sharded step, from
    each shard's state made on its device.  Also counted a step: the aten
    ops the host dispatched (one more step, outside the profiler), and the
    profiler's CUDA runtime calls, graph launches apart from the launches,
    copies and fills issued outside a graph (None if the profiler recorded
    neither).  Returns a dict: launches (kernels a step), wall_ms, busy_ms,
    ops, replays, host_launches."""
    from torch.profiler import ProfilerActivity, profile

    from rust_raytracer_torch.render import pool as poolmod

    n_pixels = camera.image_width * camera.image_height
    total = n_pixels * SPP
    if mesh is None:
        state = poolmod.init_state(LANES, n_pixels, renderer.pack.device)
    else:
        state = poolmod.init_shards(LANES, n_pixels, mesh)
    step = poolmod.make_step(renderer.pack, renderer.static, camera, total, SPP,
                             renderer.seed, kernel=renderer.kernel, mesh=mesh, graph=graph)
    for _ in range(warm):
        state = step(renderer.pack, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(renderer.pack, state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with OpCount() as dispatched:
        state = step(renderer.pack, state)
    n_ops = sum(dispatched.ops.values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = step(renderer.pack, state)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / steps
    api = Counter()
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA and e.key.startswith("cu"):
            api[e.key] += e.count
    replays = sum(n for k, n in api.items() if k.startswith("cudaGraphLaunch")) / steps
    host_launches = sum(n for k, n in api.items() if HOST_LAUNCH.match(k)) / steps
    if not (replays or host_launches):
        replays = host_launches = None
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    own = {nm: sum(e.self_device_time_total for e in kernels
                   if is_kernel(e.key, nm + "_kernel")) / 1e3 / steps for nm in names}
    trav_ms = sum(own.values())
    n_launch = sum(e.count for e in kernels) / steps
    shares = ", ".join(f"{nm} {ms:.3f} ms ({ms / dev_ms:.1%})" for nm, ms in own.items())
    tag = renderer.kernel if mesh is None else f"{renderer.kernel}, {mesh.n_shards} shard(s)"
    tag += ", graphed" if graph else ""
    log(f"pool step split ({tag}): wall {wall_ms:.3f} ms/step (steps "
        f"{warm + 1}-{warm + steps}, profiler off); step {warm + steps + 1}: {n_ops} aten "
        f"ops dispatched by the host; steps {warm + steps + 2}-"
        f"{warm + 2 * steps + 1} profiled: wall {prof_ms:.3f} ms/step, device busy "
        f"{dev_ms:.3f} ms/step ({n_launch:.0f} kernels/step), named kernels "
        f"{trav_ms:.3f} ms/step [{shares}], rest {dev_ms - trav_ms:.3f} ms/step; CUDA "
        f"runtime a step: graph launches {replays}, launches/copies/fills outside a graph "
        f"{host_launches} ({card})")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step  "
            f"x{e.count // steps:<4d} {e.key[:90]}")
    if mesh is None and not graph and (abs(n_launch - STEP_LAUNCHES[renderer.kernel])
                                       > STEP_SLACK[renderer.kernel]):
        raise AssertionError(f"a {renderer.kernel} pool step launched {n_launch} kernels, not "
                             f"{STEP_LAUNCHES[renderer.kernel]}")
    return {"launches": n_launch, "wall_ms": wall_ms, "busy_ms": dev_ms, "ops": n_ops,
            "replays": replays, "host_launches": host_launches}


def device_split(tag, fn, card, names, absent=(), required=True):
    """Run `fn` once under the profiler: its device busy time, and the
    device time and launches of each traversal kernel (`names`: its
    `__global__` name less `_kernel`, matched whole) over the whole call;
    raises if one of `names` was not seen (unless not `required`: the
    profiler's record of a conditional graph node's body is partial) or
    one of `absent` ran.  Returns {name: (ms, launches)}, and under "busy"
    (device busy ms, profiled wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    own = {nm: (sum(e.self_device_time_total for e in kernels
                    if is_kernel(e.key, nm + "_kernel")) / 1e3,
                sum(e.count for e in kernels if is_kernel(e.key, nm + "_kernel")))
           for nm in names}
    if required and any(n == 0 for _, n in own.values()):
        raise AssertionError(f"device split {tag}: a traversal kernel was not seen: {own}")
    ran = [nm for nm in absent if any(is_kernel(e.key, nm + "_kernel") for e in kernels)]
    if ran:
        raise AssertionError(f"device split {tag}: {ran} ran")
    log(f"device split, {tag}: wall {wall_ms:.1f} ms (profiled), device busy {dev_ms:.1f} ms, "
        f"{sum(e.count for e in kernels)} kernels; " + "; ".join(
            f"{nm} {ms:.1f} ms in {n} launches ({ms / max(dev_ms, 1e-9):.1%} of device time)"
            for nm, (ms, n) in own.items()) + f" ({card})")
    own["busy"] = (dev_ms, wall_ms)
    return own


def check_image(film, camera):
    """The film's HDR image: shape, finite, not black, and the light's
    pixels the brightest (median of the light region >= the image's 99th
    percentile).  Returns the image."""
    hdr = film.hdr()
    h = camera.image_height
    if hdr.shape != (h, W, 3) or not np.isfinite(hdr).all() or not hdr.mean() > 0:
        raise AssertionError(f"bad image: shape {hdr.shape}, mean {hdr.mean()}")
    lum = hdr.mean(-1)
    x0, x1, y0, y1 = light_region(camera, [(147.5, 554.9, 172.5), (407.5, 554.9, 172.5),
                                           (147.5, 554.9, 382.5), (407.5, 554.9, 382.5)])
    lit = lum[y0:y1 + 1, x0:x1 + 1]
    p99 = np.percentile(lum, 99.0)
    log(f"light region px [{x0},{x1}]x[{y0},{y1}]: median {np.median(lit):.3f}, "
        f"image p99 {p99:.3f}, image mean {lum.mean():.4f}")
    if not (lit.size > 0 and np.median(lit) >= p99):
        raise AssertionError("the light's pixels are not the brightest")
    return hdr


# ---------------------------------------------------------------- wavefront

def record_steps(renderer, fn_module, fn_name):
    """Render through the main path's eager step (a graph replay runs no
    Python) with the traversal inputs (org, dirn, t_max) of every pool step
    recorded (on the card).  Returns the list."""
    recorded = []
    launch = getattr(fn_module, fn_name)

    def record(pack, org, dirn, t_min, t_max, **kw):
        recorded.append((org.clone(), dirn.clone(), t_max.clone()))
        return launch(pack, org, dirn, t_min, t_max, **kw)

    setattr(fn_module, fn_name, record)
    renderer.graph = False
    try:
        renderer.render(mode="pool")
    finally:
        setattr(fn_module, fn_name, launch)
        renderer.graph = True
    return recorded


def pick_steps(recorded):
    """(tag, index) of the first step that traces rays (primary rays: the
    pool starts with every lane dead), a mid-render step and a drain step
    (the first step past the middle with fewer than half the lanes live)."""
    live = [float((t_max != 0).float().mean()) for _, _, t_max in recorded]
    first = next(k for k, x in enumerate(live) if x > 0)
    mid = len(recorded) // 2
    drain = next((k for k in range(mid + 1, len(recorded)) if live[k] < 0.5),
                 len(recorded) - 1)
    return [("first", first), ("mid", mid), ("drain", drain)], live


def hold_vs_exact(pack, org, dirn, t_max, t, slot, dropped, tag):
    """The wavefront result (t, slot) against the BVH8 kernel's on the same
    rays.  On lanes of packets that did not overflow: hit masks equal, t
    within rtol 2e-5 / atol 1e-6, slot agreement >= 0.999.  On packets that
    overflowed: no hit the exact walk lacks, none nearer than its.
    Returns (max |dt| on non-overflowed hits, slot agreement)."""
    from rust_raytracer_torch.ops import bvh8

    t_e, i_e = bvh8.intersect_triangles_bvh8(pack, org, dirn, None, t_max)
    lane_drop = dropped.repeat_interleave(8)[:org.shape[0]]
    keep = ~lane_drop
    hw, he = slot >= 0, i_e >= 0
    if not torch.equal(hw[keep], he[keep]):
        bad = int((hw[keep] != he[keep]).sum())
        raise AssertionError(f"{tag}: hit masks differ from the BVH8 kernel on {bad} "
                             f"lanes of packets that did not overflow")
    both = keep & hw
    err = (t[both] - t_e[both]).abs()
    if both.any() and not torch.all(err <= 1e-6 + 2e-5 * t_e[both].abs()):
        raise AssertionError(f"{tag}: t differs from the BVH8 kernel, max {err.max().item()}")
    agree = (slot[both] == i_e[both]).float().mean().item() if both.any() else 1.0
    if agree < 0.999:
        raise AssertionError(f"{tag}: slot agreement with the BVH8 kernel {agree} < 0.999")
    if (lane_drop & hw & ~he).any():
        raise AssertionError(f"{tag}: an overflowed packet reports a hit the exact walk lacks")
    od = lane_drop & hw & he
    if (t[od] < t_e[od]).any():
        raise AssertionError(f"{tag}: an overflowed packet reports a hit nearer than exact")
    if not torch.equal(t[~hw], t_max[~hw]):
        raise AssertionError(f"{tag}: missed rays do not return t_max")
    return (err.max().item() if both.any() else 0.0), agree


def fused_equal(got, want):
    """(row, total, counts) of the fused A+L2 against another's."""
    return all(torch.equal(a, b) for a, b in zip(got, want))


def wf_stage_parity(pack, org, dirn, t_max, tag):
    """Each wavefront kernel against its plain version on the same inputs
    (A: keys and counts equal; L2: rows and totals equal; A+L2 fused: row,
    total and counts equal to L2's over A's and to its plain version's;
    MT: max |dt| 0, slots equal; overflow counts equal), then the kernel
    pipeline against the BVH8 kernel.  Returns a dict of what was
    measured."""
    from rust_raytracer_torch.ops import wavefront as wf

    S = pack.wf_sn_lo.shape[0]
    k1 = min(wf.K1, -(-S // 8) * 8)
    kc = wf.KC
    k = min(wf.PAIRS_PER_PACKET_CAP, k1 * kc)
    tm = torch.clamp(t_max, max=wf.BIG)
    sn_slot, l1_cnt = wf.nearest_boxes(pack.wf_sn_lo, pack.wf_sn_hi, org, dirn, t_max, k1)
    n1 = torch.clamp(l1_cnt, max=k1)
    a_in = (sn_slot, n1, pack.wf_sn_start, pack.wf_sn_bounds, org, dirn, tm, kc)
    keys, counts = wf.cull(*a_in)
    keys_p, counts_p = wf.cull_plain(*a_in)
    if not (torch.equal(keys, keys_p) and torch.equal(counts, counts_p)):
        raise AssertionError(f"{tag}: wf_cull differs from its plain version")
    cl, real = wf.compact(keys, counts, n1, k)
    cl_p, real_p = wf.compact_plain(keys, counts, n1, k)
    if not (torch.equal(cl, cl_p) and torch.equal(real, real_p)):
        raise AssertionError(f"{tag}: wf_compact differs from its plain version")
    fused = wf.cull_compact(*a_in, k)
    if not fused_equal(fused, (cl, real, counts)):
        raise AssertionError(f"{tag}: wf_cull_compact differs from compact(cull(...))")
    if not fused_equal(fused, wf.cull_compact_plain(*a_in, k)):
        raise AssertionError(f"{tag}: wf_cull_compact differs from its plain version")
    cnt = torch.clamp(real, max=k)
    t, slot = wf.mt(cl, cnt, org, dirn, tm, pack.tri_rows)
    t_p, slot_p = wf.mt_plain(cl, cnt, org, dirn, tm, pack.tri_rows)
    torch.cuda.synchronize()
    mt_err = (t - t_p).abs().max().item()
    if not (mt_err == 0 and torch.equal(slot, slot_p)):
        raise AssertionError(f"{tag}: wf_mt differs from its plain version "
                             f"(max |dt| {mt_err}, slots equal {torch.equal(slot, slot_p)})")
    dropped = wf.overflowed(l1_cnt, counts, real, k1, kc, k)
    if not torch.equal(dropped, wf.overflowed(l1_cnt, counts_p, real_p, k1, kc, k)):
        raise AssertionError(f"{tag}: overflow counts differ between kernels and plain")
    t = torch.where(slot < 0, t_max, t)
    exact_err, agree = hold_vs_exact(pack, org, dirn, t_max, t, slot, dropped, tag)
    out = dict(mt_err=mt_err, exact_err=exact_err, agree=agree,
               overflow=int(dropped.sum()), packets=dropped.numel(),
               hits=int((slot >= 0).sum()), live=int((t_max != 0).sum()),
               pairs=int(cnt.sum()), l1=float(n1.float().mean()))
    log(f"wavefront parity {tag}: {org.shape[0]} rays ({out['live']} live), A/L2 equal, "
        f"fused A+L2 equal to L2(A) and to its plain version, "
        f"MT max |dt| {mt_err:.3e} slots equal; vs BVH8 kernel: hits {out['hits']}, "
        f"max |dt| {exact_err:.3e}, slot agreement {agree:.6f}; overflow "
        f"{out['overflow']}/{out['packets']} packets ({out['overflow'] / out['packets']:.4%}), "
        f"mean supernodes {out['l1']:.2f}, candidate pairs {out['pairs']}")
    return out


def dense_parity(pack, org, dirn, t_max):
    """The dense single-level pipeline (cull and top k in torch ops, then
    MT) on these rays: MT kernel against its plain version, the pipeline
    against the BVH8 kernel."""
    from rust_raytracer_torch.ops import wavefront as wf

    k = min(wf.PAIRS_PER_PACKET_CAP, pack.wf_cl_lo.shape[0])
    t, slot, dropped = wf.pipeline(pack.wf_cl_lo, pack.wf_cl_hi, pack.tri_rows,
                                   org, dirn, t_max)
    cl, pk_cnt = wf.nearest_boxes(pack.wf_cl_lo, pack.wf_cl_hi, org, dirn, t_max, k)
    t_p, slot_p = wf.mt_plain(cl, torch.clamp(pk_cnt, max=k), org, dirn,
                              torch.clamp(t_max, max=wf.BIG), pack.tri_rows)
    torch.cuda.synchronize()
    err = (t - t_p).abs().max().item()
    if not (err == 0 and torch.equal(slot, slot_p)):
        raise AssertionError(f"dense: wf_mt differs from its plain version ({err})")
    t = torch.where(slot < 0, t_max, t)
    exact_err, agree = hold_vs_exact(pack, org, dirn, t_max, t, slot, dropped, "dense")
    log(f"wavefront dense pipeline: {org.shape[0]} rays, {pack.wf_cl_lo.shape[0]} "
        f"clusters, k {k}: MT max |dt| {err:.3e} slots equal; vs BVH8 kernel: hits "
        f"{int((slot >= 0).sum())}, max |dt| {exact_err:.3e}, slot agreement {agree:.6f}, "
        f"overflow {int(dropped.sum())}/{dropped.numel()} packets")
    return err


def peak_above(fn):
    """Device bytes `fn` allocates at its peak above what was allocated
    before it (max_memory_allocated after reset_peak_memory_stats), its
    result held until the peak is read.  Returns (bytes, result)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, out


def wf_times(pack, org, dirn, t_max, card):
    """Each wavefront kernel and its plain version on the same inputs
    (time_ms: CUDA events around back-to-back calls), and each kernel's
    bound from what these inputs need: A slab-tests 8 rays against the 128
    cluster boxes of each live supernode slot; L2 reads each live slot's
    kept ids; A+L2 fused does A's tests and writes the row and total in
    place of the keys; MT tests 8 rays against the 128 triangles of each
    listed cluster.  The fused kernel and A then L2 are timed in turns
    (A+L2 apart, fused, fused, A+L2 apart), and the peak memory of one
    pipeline2 call, and of the stages alone from the L1's slots (A+L2 ->
    MT against A -> L2 -> MT), in one run.  Returns ({name: (kernel_ms, plain_ms)} with "cull+compact"
    for A then L2, {name: (bound_ms, bound_by)}, MT's inputs (cl, cnt,
    org, dirn, tm, tri_rows), the peaks)."""
    from rust_raytracer_torch.ops import wavefront as wf

    S = pack.wf_sn_lo.shape[0]
    k1 = min(wf.K1, -(-S // 8) * 8)
    k = min(wf.PAIRS_PER_PACKET_CAP, k1 * wf.KC)
    tm = torch.clamp(t_max, max=wf.BIG)
    sn_slot, l1_cnt = wf.nearest_boxes(pack.wf_sn_lo, pack.wf_sn_hi, org, dirn, t_max, k1)
    n1 = torch.clamp(l1_cnt, max=k1)
    a_in = (sn_slot, n1, pack.wf_sn_start, pack.wf_sn_bounds, org, dirn, tm, wf.KC)
    keys, counts = wf.cull(*a_in)
    cl, real = wf.compact(keys, counts, n1, k)
    mt_in = (cl, torch.clamp(real, max=k), org, dirn, tm, pack.tri_rows)
    n_pk = org.shape[0] // wf.R
    live = torch.arange(k1, device=org.device)[None, :] < n1[:, None]
    pairs = int(mt_in[1].sum())
    listed = mt_in[0][torch.arange(k, device=org.device)[None, :] < mt_in[1][:, None]]
    rays = n_pk * wf.R * RAY_BYTES
    slab_ops = int(n1.sum()) * 128 * wf.R * SLAB_OPS
    cull_in = (rays + n_pk * (k1 + 1) * 4 + int(sn_slot[live].unique().numel()) * 6 * 128 * 4
               + S * 4)
    bounds = {
        "wf_cull": bound(slab_ops, cull_in + n_pk * k1 * (wf.KC + 1) * 4),
        "wf_cull_compact": bound(slab_ops, cull_in + n_pk * k1 * 4 + n_pk * (k + 1) * 4),
        "wf_compact": bound(0, int(torch.clamp(counts, max=wf.KC)[live].sum()) * 4
                            + n_pk * (k1 + 1) * 4 + n_pk * (k + 1) * 4),
        "wf_mt": bound(pairs * wf.R * 128 * MT_OPS,
                       pairs * 4 + n_pk * 4 + rays + int(listed.unique().numel()) * CLUSTER_BYTES
                       + n_pk * wf.R * HIT_BYTES),
    }

    def apart():
        return wf.compact(*wf.cull(*a_in), n1, k)

    def fused():
        return wf.cull_compact(*a_in, k)

    turns = [time_ms(f) for f in (apart, fused, fused, apart)]
    times = {
        "l1": (time_ms(lambda: wf.nearest_boxes(pack.wf_sn_lo, pack.wf_sn_hi, org, dirn,
                                                t_max, k1)), None),
        "wf_cull_compact": ((turns[1] + turns[2]) / 2,
                            time_ms(lambda: wf.cull_compact_plain(*a_in, k), PLAIN_REPS)),
        "cull+compact": ((turns[0] + turns[3]) / 2, None),
        "wf_cull": (time_ms(lambda: wf.cull(*a_in)),
                    time_ms(lambda: wf.cull_plain(*a_in), PLAIN_REPS)),
        "wf_compact": (time_ms(lambda: wf.compact(keys, counts, n1, k)),
                       time_ms(lambda: wf.compact_plain(keys, counts, n1, k), PLAIN_REPS)),
        "wf_mt": (time_ms(lambda: wf.mt(*mt_in)),
                  time_ms(lambda: wf.mt_plain(*mt_in), PLAIN_REPS)),
    }
    del keys
    names = ("wf_cull_compact", "wf_cull", "wf_compact", "wf_mt")
    log(f"time wavefront mid-render step x{org.shape[0]}: L1 (torch ops) "
        f"{times['l1'][0]:.3f} ms; " + "; ".join(
            f"{nm} kernel {times[nm][0]:.3f} ms, plain {times[nm][1]:.3f} ms" for nm in names)
        + f" (CUDA events, mean of {KERNEL_REPS} / plain {PLAIN_REPS} calls; {card})")
    log(f"time fused vs apart, mid-render step, in turns: wf_cull then wf_compact "
        f"{turns[0]:.4f} ms, wf_cull_compact {turns[1]:.4f} ms, wf_cull_compact "
        f"{turns[2]:.4f} ms, wf_cull then wf_compact {turns[3]:.4f} ms; fused / apart "
        f"{times['wf_cull_compact'][0] / times['cull+compact'][0]:.3f} ({card})")
    log(f"wavefront counts: {n_pk} packets, live supernode slots {int(n1.sum())}, candidate "
        f"pairs {pairs}, distinct listed clusters {int(listed.unique().numel())}; bounds: "
        + "; ".join(f"{nm} {bounds[nm][0]:.4f} ms by {bounds[nm][1]} "
                    f"({bounds[nm][0] / times[nm][0]:.2%} of the kernel's time)" for nm in names))

    # peak memory of one call, each above what was allocated before it;
    # pipeline2's result must be the unfused stages' on the same L1 slots
    def stages_fused():
        row, total, counts = wf.cull_compact(*a_in, k)
        return wf.mt(row, torch.clamp(total, max=k), org, dirn, tm, pack.tri_rows), counts

    def stages_apart():
        keys, counts = wf.cull(*a_in)
        row, total = wf.compact(keys, counts, n1, k)
        t, slot = wf.mt(row, torch.clamp(total, max=k), org, dirn, tm, pack.tri_rows)
        return t, slot, wf.overflowed(l1_cnt, counts, total, k1, wf.KC, k), keys

    peaks = {}
    peaks["pipeline2"], got = peak_above(lambda: wf.pipeline2(
        pack.wf_sn_lo, pack.wf_sn_hi, pack.wf_sn_start, pack.wf_sn_bounds, pack.tri_rows, org,
        dirn, t_max))
    peaks["A+L2 -> MT"], _ = peak_above(stages_fused)
    peaks["A -> L2 -> MT"], want = peak_above(stages_apart)
    if not all(torch.equal(a, b) for a, b in zip(got, want[:3])):
        raise AssertionError("pipeline2 differs from cull -> compact -> mt on its L1 slots")
    del got, want
    mb = {nm: b / 1e6 for nm, b in peaks.items()}
    log(f"peak memory above the inputs, one call at {org.shape[0]} lanes (max_memory_allocated, "
        f"peak reset before each): pipeline2 {mb['pipeline2']:.1f} MB, its result equal to "
        f"cull -> compact -> mt's; from the L1's slots: A+L2 -> MT {mb['A+L2 -> MT']:.1f} MB, "
        f"A -> L2 -> MT {mb['A -> L2 -> MT']:.1f} MB (fused less unfused "
        f"{mb['A+L2 -> MT'] - mb['A -> L2 -> MT']:.1f} MB); bytes {peaks} ({card})")
    return times, bounds, mt_in, peaks


def cull_adversarial(dev, n_pk=4096, k1=40, seed=5):
    """Kernel A's inputs at n_pk packets that probe its edge rows: a
    synthetic table of 48 supernodes (dyadic boxes, a quarter of them flat
    in one axis, some +3.4e38 point boxes), rays with a +-0 direction
    component whose origin lies on a flat box's plane (a NaN slab: 0 * inf),
    dead and capped lanes, and slot rows with n1 = 0, n1 = k1 and a
    supernode repeated.  Returns the cull arguments without kc."""
    r = np.random.default_rng(seed)
    S, planes = 48, np.array([-0.5, 0.0, 0.25, 0.5], np.float32)
    lo = np.round(r.uniform(-1, 1, (S, 3, 128)) * 64) / 64
    hi = lo + np.round(r.uniform(0, 0.5, (S, 3, 128)) * 64) / 64
    flat = r.random((S, 128)) < 0.25
    axis = r.integers(0, 3, (S, 128))
    at = planes[r.integers(0, 4, (S, 128))]
    for a in range(3):
        m = flat & (axis == a)
        lo[:, a][m] = hi[:, a][m] = at[m]
    bounds = np.concatenate([lo, hi], axis=1).astype(np.float32)
    bounds[:, :, 120:] = 3.4e38                          # unused lanes
    n = n_pk * 8
    org = r.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    dirn = r.normal(size=(n, 3)).astype(np.float32)
    on = np.repeat(r.random(n_pk) < 0.5, 8)              # packets on a plane
    ax = r.integers(0, 3, n)
    rows = np.nonzero(on)[0]
    org[rows, ax[rows]] = planes[r.integers(0, 4, rows.size)]
    dirn[rows, ax[rows]] = np.where(r.random(rows.size) < 0.5, 0.0, -0.0)
    tm = np.full(n, 3.4e38, np.float32)
    lane = np.arange(n) % 8
    tm[lane == 1] = 0.0
    tm[lane == 2] = 1e-3
    tm[lane == 3] = r.uniform(0.01, 2.0, (lane == 3).sum())
    sn_slot = r.integers(0, S, (n_pk, k1)).astype(np.int32)
    sn_slot[1::7] = sn_slot[1::7, :1]                    # one supernode in every slot
    n1 = r.integers(0, k1 + 1, n_pk).astype(np.int32)
    n1[::5], n1[2::5] = 0, k1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (t(sn_slot), t(n1), t(np.arange(S, dtype=np.int32) * 128), t(bounds), t(org),
            t(dirn), t(tm))


def nan_share(sn_slot, n1, sn_bounds, org, dirn, tm, step=512):
    """Over the live (ray, box) pairs of kernel A's inputs: the pairs whose
    slab holds a NaN, and the hit bits that would flip if min/max dropped
    NaN (torch.fmin/fmax) instead of propagating it."""
    n_pk, k1 = sn_slot.shape
    t_min = torch.tensor(1e-3, device=org.device)
    nan = flips = 0
    for s in range(0, n_pk, step):
        p = slice(s, s + step)
        blk = sn_bounds[sn_slot[p].long()][:, :, None]            # (P, k1, 1, 6, SN)
        o = org.view(n_pk, 1, 8, 3, 1)[p]
        inv = (1.0 / dirn).view(n_pk, 1, 8, 3, 1)[p]
        t = [(blk[..., a + 3 * e, :] - o[..., a, :]) * inv[..., a, :]
             for e in (0, 1) for a in range(3)]
        live = (torch.arange(k1, device=org.device)[None, :] < n1[p, None])[:, :, None, None]
        hits = []
        for mn, mx in ((torch.minimum, torch.maximum), (torch.fmin, torch.fmax)):
            near = mx(mx(mn(t[0], t[3]), mn(t[1], t[4])), mx(mn(t[2], t[5]), t_min))
            far = mn(mn(mx(t[0], t[3]), mx(t[1], t[4])),
                     mn(mx(t[2], t[5]), tm.view(n_pk, 1, 8, 1)[p]))
            hits.append((near <= far) & live)
        nan += int((torch.stack(t).isnan().any(dim=0) & live).sum())
        flips += int((hits[0] != hits[1]).sum())
    return nan, flips


def mt_adversarial(pack, cl, cnt, org, dirn, tm, n_pk=4096):
    """Kernel MT's inputs at the n_pk packets with the most candidates of a
    recorded step, rewritten to probe its tie rule: the triangle table gets
    a copy of every cluster (ids + nc) and a copy whose odd lanes repeat the
    even lanes (ids + 2 nc, so a t ties across lanes); packets in turn list
    each cluster then its copy, the copy first, each cluster twice, the
    lane-tied copies padded to a full row of k (cnt = k), or nothing (cnt =
    0); a quarter of the packets get dead lanes (tm 0, 5e-4, 1e-3) beside
    live ones and one packet in 16 only dead lanes.  Returns the mt
    arguments."""
    nc, k = pack.tri_rows.shape[0] // 128, cl.shape[1]
    rows = pack.tri_rows.view(nc, 128, 12)
    tied = rows.clone()
    tied[:, 1::2] = rows[:, 0::2]
    tri = torch.cat([rows, rows, tied]).reshape(-1, 12).contiguous()
    pk = torch.sort(cnt, descending=True, stable=True).indices[:n_pk]
    base, c0 = cl[pk].long(), cnt[pk].long()
    j = torch.arange(k, device=cl.device)
    src = base.gather(1, torch.minimum(j // 2, (c0[:, None] - 1).clamp(min=0)).expand(-1, k))
    kind = torch.arange(pk.numel(), device=cl.device) % 5
    alt = (j % 2)[None, :]
    out = torch.where(kind[:, None] == 0, src + nc * alt, src)          # c, copy
    out = torch.where(kind[:, None] == 1, src + nc * (1 - alt), out)    # copy, c
    full = base.gather(1, j[None, :] % c0[:, None].clamp(min=1))
    out = torch.where(kind[:, None] == 3, full + 2 * nc, out)           # lane ties
    n_new = torch.where(kind <= 2, torch.clamp(2 * c0, max=k), c0)
    n_new = torch.where(kind == 3, torch.full_like(c0, k), n_new)
    n_new = torch.where(kind == 4, torch.zeros_like(c0), n_new)
    sel = (pk[:, None] * 8 + torch.arange(8, device=cl.device)).reshape(-1)
    o, d, t = org[sel].contiguous(), dirn[sel].contiguous(), tm[sel].clone()
    lane = torch.arange(t.numel(), device=t.device)
    part = ((lane // 8) % 4 == 1) & (lane % 8 < 3)
    t = torch.where(part & (lane % 8 == 0), 0.0, t)
    t = torch.where(part & (lane % 8 == 1), 5e-4, t)
    t = torch.where(part & (lane % 8 == 2), 1e-3, t)
    t = torch.where((lane // 8) % 16 == 3, 0.0, t)
    return (out.to(torch.int32).contiguous(), n_new.to(torch.int32).contiguous(), o, d,
            t.contiguous(), tri)


def caps_inside_a_slot(counts, n1, kc, k):
    """Packets whose cap k cuts a live slot's kept ids (off < k < off +
    min(count, kc), off the slot's offset in the row): (any slot, a slot
    past the first kept one, off > 0)."""
    live = torch.arange(counts.shape[1], device=counts.device)[None, :] < n1[:, None]
    c = torch.where(live, torch.clamp(counts, max=kc), 0)
    off = torch.cumsum(c, dim=1) - c
    inside = (off < k) & (k < off + c)
    return int(inside.any(dim=1).sum()), int((inside & (off > 0)).any(dim=1).sum())


def wf_adversarial(wpack, org, dirn, cl, cnt, tm, dev, card):
    """K2a, K2a+K2b fused and K2c against cull_plain, compact(cull(...))
    and cull_compact_plain, and mt_plain on the adversarial sets:
    cull_adversarial (the fused kernel at k 16 and 128), and mt_adversarial
    from a recorded step's rays and lists (org, dirn, cl, cnt, tm).
    Returns MT's max |dt|."""
    from rust_raytracer_torch.ops import wavefront as wf

    a_in = cull_adversarial(dev)
    nan, flips = nan_share(a_in[0], a_in[1], a_in[3], a_in[4], a_in[5], a_in[6])
    if not flips:
        raise AssertionError("the adversarial cull set exercises no decisive NaN slab")
    for kc in (wf.KC, 4):
        keys, counts = wf.cull(*a_in, kc)
        keys_p, counts_p = wf.cull_plain(*a_in, kc)
        if not (torch.equal(keys, keys_p) and torch.equal(counts, counts_p)):
            raise AssertionError(f"adversarial cull (kc {kc}): wf_cull differs from cull_plain")
        for k in (16, 128):
            fused = wf.cull_compact(*a_in, kc, k)
            if not fused_equal(fused, (*wf.compact(keys, counts, a_in[1], k), counts)):
                raise AssertionError(f"adversarial cull (kc {kc}, k {k}): wf_cull_compact "
                                     f"differs from compact(cull(...))")
            if not fused_equal(fused, wf.cull_compact_plain(*a_in, kc, k)):
                raise AssertionError(f"adversarial cull (kc {kc}, k {k}): wf_cull_compact "
                                     f"differs from cull_compact_plain")
            cut = caps_inside_a_slot(counts, a_in[1], kc, k)
            over = int((fused[1] > k).sum())
            log(f"wavefront adversarial cull+compact, kc {kc}, k {k}: row, total and counts "
                f"equal to compact(cull(...)) and to cull_compact_plain; totals over k on "
                f"{over} packets, the cap inside a slot on {cut[0]} ({cut[1]} past the "
                f"row's first slot)")
            if k == 16 and not cut[1]:
                raise AssertionError("no adversarial packet has its cap inside a later slot")
    n1 = a_in[1]
    log(f"wavefront adversarial cull: {a_in[0].shape[0]} packets (n1 = 0 on "
        f"{int((n1 == 0).sum())}, n1 = k1 on {int((n1 == a_in[0].shape[1]).sum())}), "
        f"{nan} live (ray, box) pairs with a NaN slab, {flips} hit bits that NaN-dropping "
        f"min/max would flip; keys and counts equal to cull_plain at kc {wf.KC} and 4")
    k = cl.shape[1]
    m_in = mt_adversarial(wpack, cl, cnt, org, dirn, tm)
    t, slot = wf.mt(*m_in)
    t_p, slot_p = wf.mt_plain(*m_in)
    torch.cuda.synchronize()
    err = (t - t_p).abs().max().item()
    if not (err == 0 and torch.equal(slot, slot_p)):
        raise AssertionError(f"adversarial MT: wf_mt differs from mt_plain (max |dt| {err}, "
                             f"slots equal {torch.equal(slot, slot_p)})")
    nc = wpack.tri_rows.shape[0] // 128
    dead = m_in[4] <= 1e-3
    if not (torch.equal(t[dead], m_in[4][dead]) and bool((slot[dead] == -1).all())):
        raise AssertionError("adversarial MT: a dead ray did not return (tm, -1)")
    log(f"wavefront adversarial MT: {m_in[0].shape[0]} packets (cnt 0 on "
        f"{int((m_in[1] == 0).sum())}, cnt = k on {int((m_in[1] == k).sum())}), "
        f"{int(dead.sum())} dead rays, hits {int((slot >= 0).sum())} (on a cluster copy "
        f"{int((slot >= 128 * nc).sum())}); max |dt| {err:.3e}, slots equal to mt_plain "
        f"({card})")
    return err


def listed_box_hits(pack, cl, cnt, org, dirn, tm, chunk=1 << 18):
    """Of the listed (ray, cluster) pairs (each of a packet's 8 rays with
    each cluster of its row), how many pass the ray's own slab test against
    that cluster's box (wf_cl_lo/hi, near clamped at T_MIN, far at tm); the
    others are tested by MT only because a packet-mate's box test hit.
    Returns (hits, pairs)."""
    k = cl.shape[1]
    p_idx, j_idx = torch.nonzero(torch.arange(k, device=cl.device)[None, :] < cnt[:, None],
                                 as_tuple=True)
    hits = 0
    for s in range(0, p_idx.numel(), chunk):
        p, c = p_idx[s:s + chunk], cl[p_idx[s:s + chunk], j_idx[s:s + chunk]].long()
        lo, hi = pack.wf_cl_lo[c][:, None], pack.wf_cl_hi[c][:, None]
        o, d = org.view(-1, 8, 3)[p], dirn.view(-1, 8, 3)[p]
        inv = 1.0 / d
        t0, t1 = (lo - o) * inv, (hi - o) * inv
        near = torch.maximum(torch.maximum(torch.minimum(t0[..., 0], t1[..., 0]),
                                           torch.minimum(t0[..., 1], t1[..., 1])),
                             torch.clamp(torch.minimum(t0[..., 2], t1[..., 2]), min=1e-3))
        far = torch.minimum(torch.minimum(torch.maximum(t0[..., 0], t1[..., 0]),
                                          torch.maximum(t0[..., 1], t1[..., 1])),
                             torch.minimum(torch.maximum(t0[..., 2], t1[..., 2]),
                                           tm.view(-1, 8)[p]))
        hits += int((near <= far).sum())
    return hits, p_idx.numel() * 8


def image_agreement(a, b):
    """bench.py's image parity, per pixel: the share of pixels with every
    channel within 1e-3 * mean(b) + 1e-3 * |b|, and mean |a - b| / mean(b)."""
    scale = max(float(np.mean(b)), 1e-6)
    off = np.any(np.abs(a - b) > 1e-3 * scale + 1e-3 * np.abs(b), axis=-1)
    return 1.0 - float(off.mean()), float(np.mean(np.abs(a - b))) / scale


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of operations over the card's f32
    rate and bytes over its memory rate."""
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bvh8_walk(pack, org, dirn, t_max):
    """The BVH8 kernel's walk in torch ops (csrc/bvh8_traverse.cu: a stack
    per ray, children pushed 7 -> 0, near clamped at T_MIN, a leaf's
    groups of 32 slots tested where the ray enters their box,
    ops/bvh8.py:leaf_test_plain), to count what it does: returns (t, slot,
    counts) with internal-node visits (8 slab tests each), leaf visits,
    the groups tested there ("groups"), distinct internal nodes and
    clusters, and for warps of 32 lanes in ray order the loop iterations
    ("warp_steps": per step, the warps with a lane still walking) and
    "warp_leaf_passes" (per step, the warps with a lane at a leaf).  Its
    (t, slot) must equal the kernel's, slots included."""
    from rust_raytracer_torch.ops import bvh8, threaded

    n, dev = org.shape[0], org.device
    inv = 1.0 / dirn
    best = torch.clamp(t_max, max=3.4e38)
    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    stack = torch.zeros((n, bvh8.STACK), dtype=torch.int64, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)
    box, child = pack.bvh8_box, pack.bvh8_child.to(torch.int64)
    seen8 = torch.zeros((box.shape[0],), dtype=torch.bool, device=dev)
    seen_cl = torch.zeros((pack.tri_rows.shape[0] // 128,), dtype=torch.bool, device=dev)
    visits = leaves = groups = warp_steps = leaf_passes = 0
    lanes = torch.arange(n, device=dev)
    t_min = torch.tensor(1e-3, device=dev)
    while lanes.numel():
        sp[lanes] -= 1
        v = stack[lanes, sp[lanes]]
        leaf = v < 0
        ln, cl = lanes[leaf], -v[leaf] - 1
        warp_steps += int(threaded.warps_of(lanes))
        leaf_passes += int(threaded.warps_of(ln))
        if ln.numel():
            tmin, first, tested = bvh8.leaf_test_plain(pack, org[ln], dirn[ln], best[ln], cl)
            groups += int(tested.sum())
            better = tmin < best[ln]
            best[ln] = torch.where(better, tmin, best[ln])
            slot[ln] = torch.where(better, (cl * 128 + first).to(torch.int32), slot[ln])
            seen_cl[cl] = True
            leaves += ln.numel()
        li, nd = lanes[~leaf], v[~leaf]
        if li.numel():
            b, ch = box[nd], child[nd]
            o, iv = org[li][:, None], inv[li][:, None]
            t0 = (b[..., 0:3] - o) * iv
            t1 = (b[..., 3:6] - o) * iv
            near = torch.maximum(torch.maximum(torch.minimum(t0[..., 0], t1[..., 0]),
                                               torch.minimum(t0[..., 1], t1[..., 1])),
                                 torch.maximum(torch.minimum(t0[..., 2], t1[..., 2]), t_min))
            far = torch.minimum(torch.minimum(torch.maximum(t0[..., 0], t1[..., 0]),
                                              torch.maximum(t0[..., 1], t1[..., 1])),
                                torch.minimum(torch.maximum(t0[..., 2], t1[..., 2]),
                                              best[li][:, None]))
            push = (near <= far) & (ch != 0)
            for c in range(7, -1, -1):
                m = push[:, c]
                idx = li[m]
                stack[idx, sp[idx]] = ch[m, c]
                sp[idx] += 1
            seen8[nd] = True
            visits += li.numel()
        lanes = lanes[sp[lanes] > 0]
    t = torch.where(slot < 0, t_max, best)
    return t, slot, dict(node_visits=visits, leaf_visits=leaves, groups=groups,
                         nodes=int(seen8.sum()),
                         clusters=int(seen_cl.sum()), warp_steps=warp_steps,
                         warp_leaf_passes=leaf_passes)


def bvh8_bound(pack, n, counts):
    """K1's bound from bvh8_walk's counts: 8 slab tests an internal node,
    4 slab tests a leaf and Möller–Trumbore of 32 slots a group tested;
    224 bytes a node (8 boxes, 8 ids)."""
    ops = (counts["node_visits"] * 8 * SLAB_OPS + counts["leaf_visits"] * 4 * SLAB_OPS
           + counts["groups"] * 32 * MT_OPS)
    nbytes = (n * (RAY_BYTES + HIT_BYTES) + counts["nodes"] * 224
              + counts["clusters"] * CLUSTER_BYTES)
    return bound(ops, nbytes)


def threaded_bound(n, counts):
    """K3's bound from the plain walk's counts: one slab test a node visit,
    Möller–Trumbore of 128 slots a leaf visit; 32 bytes a node."""
    ops = counts["node_visits"] * SLAB_OPS + counts["leaf_visits"] * 128 * MT_OPS
    nbytes = (n * (RAY_BYTES + HIT_BYTES) + counts["nodes"] * 32
              + counts["clusters"] * CLUSTER_BYTES)
    return bound(ops, nbytes)


def sort_rays(org, dirn):
    """Rays in the compaction-sort order the renderers trace them in."""
    from rust_raytracer_torch.render import integrator

    alive = torch.ones((org.shape[0],), dtype=torch.bool, device=org.device)
    perm = torch.sort(integrator._compaction_key(org, dirn, alive), stable=True).indices
    return org[perm].contiguous(), dirn[perm].contiguous()


def t_max_mix(t, slot):
    """t_max per lane as the renderers pass it: +inf (no sphere or plane in
    the way), 0 (a dead lane), 3.4e38, or capped short of the hit."""
    lane = torch.arange(t.shape[0], device=t.device)
    inf = torch.full_like(t, float("inf"))
    cap = torch.where(lane % 4 == 0, inf, torch.full_like(t, 3.4e38))
    cap = torch.where(lane % 4 == 1, torch.zeros_like(t), cap)
    return torch.where(lane % 4 == 3, torch.where(slot >= 0, t * 0.5, inf), cap)


def hold(tag, got, want, t_max, exact_slots):
    """(t, slot) against (t, slot) on the same rays: hit masks equal, max
    |dt| 0, t == t_max on a miss, and with exact_slots no slot differing.
    Returns (max |dt|, slots differing, hits)."""
    (t_g, i_g), (t_w, i_w) = got, want
    torch.cuda.synchronize()
    if not torch.equal(i_g >= 0, i_w >= 0):
        raise AssertionError(f"{tag}: hit masks differ on {int(((i_g >= 0) != (i_w >= 0)).sum())} rays")
    both = i_g >= 0
    err = (t_g[both] - t_w[both]).abs().max().item() if both.any() else 0.0
    if err != 0:
        raise AssertionError(f"{tag}: max |dt| {err}")
    if not torch.equal(t_g[~both], t_max[~both]):
        raise AssertionError(f"{tag}: missed rays do not return t_max")
    differ = int((i_g[both] != i_w[both]).sum())
    if exact_slots and differ:
        raise AssertionError(f"{tag}: {differ} slots differ")
    return err, differ, int(both.sum())


def threaded_parity(pack, camera, dev):
    """K3 against its plain version (hit masks, t and slots equal) and
    against the BVH8 kernel (hit masks and t equal; only an equal-t tie may
    pick another slot) on 2^18 sorted primary rays over the whole image, a
    sorted bounce wavefront, and the bounce rays with the t_max mix.
    Returns the max |dt| and the ray sets, for timing."""
    from rust_raytracer_torch.ops import bvh8, threaded

    org, dirn = sort_rays(*make_rays(camera, LANES, dev))
    inf = torch.full((LANES,), float("inf"), device=dev)
    t_p, i_p = threaded.traverse_plain(pack, org, dirn, inf)
    org2, dirn2 = sort_rays(*bounce_rays(org, dirn, t_p, i_p))
    t_b, i_b = threaded.traverse_plain(pack, org2, dirn2, inf)
    cases = {"primary": (org, dirn, inf), "bounce": (org2, dirn2, inf),
             "bounce +inf/3.4e38/0/capped": (org2, dirn2, t_max_mix(t_b, i_b))}
    max_err = 0.0
    for tag, (o, d, tm) in cases.items():
        k3 = threaded.intersect_triangles_threaded(pack, o, d, None, tm)
        plain = threaded.traverse_plain(pack, o, d, tm)
        err, differ_p, hits = hold(f"K3 {tag}", k3, plain, tm, exact_slots=True)
        k1 = bvh8.intersect_triangles_bvh8(pack, o, d, None, tm)
        err1, differ, _ = hold(f"K3 vs BVH8 {tag}", k3, k1, tm, exact_slots=False)
        max_err = max(max_err, err, err1)
        log(f"threaded parity {tag}: {LANES} rays, hits {hits}; vs plain: hit masks equal, "
            f"max |dt| {err:.3e}, slot agreement {1 - differ_p / max(hits, 1):.6f}; vs BVH8 "
            f"kernel: hit masks equal, max |dt| {err1:.3e}, slot agreement "
            f"{1 - differ / max(hits, 1):.6f} ({differ} equal-t ties broken apart)")
    return max_err, cases


def threaded_times(pack, cases, card):
    """K3, its plain version and the BVH8 kernel on the same 2^18 primary
    and bounce rays (time_ms), with the plain walk's counts and K3's
    bound, and the BVH8 walk's counts (its torch-ops walk held equal to the
    kernel, slots included).  Returns {tag: (k3_ms, plain_ms, k1_ms,
    bound_ms, bound_by)}."""
    from rust_raytracer_torch.ops import bvh8, threaded

    out = {}
    for tag in ("primary", "bounce"):
        o, d, tm = cases[tag]
        counts = {}
        threaded.traverse_plain(pack, o, d, tm, counts)
        b_ms, b_by = threaded_bound(o.shape[0], counts)
        out[tag] = (time_ms(lambda: threaded.intersect_triangles_threaded(pack, o, d, None, tm)),
                    time_ms(lambda: threaded.traverse_plain(pack, o, d, tm), PLAIN_REPS),
                    time_ms(lambda: bvh8.intersect_triangles_bvh8(pack, o, d, None, tm)),
                    b_ms, b_by)
        k3, plain, k1 = out[tag][:3]
        t_w, i_w, k1_counts = bvh8_walk(pack, o, d, tm)
        hold(f"BVH8 counting walk, sorted {tag}", (t_w, i_w),
             bvh8.intersect_triangles_bvh8(pack, o, d, None, tm), tm, exact_slots=True)
        log(f"time threaded {tag} rays x{o.shape[0]}: kernel {k3:.3f} ms, plain {plain:.3f} ms, "
            f"BVH8 kernel {k1:.3f} ms (K3/K1 {k3 / k1:.2f}) (CUDA events, mean of "
            f"{KERNEL_REPS} / plain {PLAIN_REPS} calls; {card}); "
            f"plain walk counts (the kernel's own): node visits {counts['node_visits']}, "
            f"distinct nodes {counts['nodes']}, distinct clusters {counts['clusters']}, "
            f"{leaf_work(counts, o.shape[0])}; bound {b_ms:.4f} ms by {b_by} "
            f"({b_ms / k3:.2%} of the kernel's time)")
        log(f"BVH8 walk counts, sorted {tag} rays x{o.shape[0]} (equal to the kernel, slots "
            f"included): internal node visits {k1_counts['node_visits']}, "
            f"{leaf_work(k1_counts, o.shape[0])}")
    return out


def grad_steps(static, camera, remat, kernel):
    """bench.py's fwd+bwd step (bench_backward) as (eager, graphed), each
    `step(pack, seed) -> (loss, {field: gradient})`: one sample per lane,
    pixels laid out as bench.py:62-67, the differentiable trace to DEPTH
    without compaction, loss mean(rad ** 2), gradients of every float
    table of the pack (zeros where a table takes no part); the seed a 0-d
    int64 tensor on the card.  `graphed` replays one graphs.GraphedGrad
    (`graphed.grad`; `graphed.captures` lists the device of each capture it
    made); `eager` runs graphs.value_and_grad on pack.with_grad()."""
    from rust_raytracer_torch.core import rng as vrng
    from rust_raytracer_torch.render import graphs, integrator

    def loss(pack, px, py, smp, seed):
        ctx = vrng.Ctx(pixel=py * camera.image_width + px, sample=smp, bounce=0, seed=seed)
        org, dirn = camera.generate_rays(px, py, smp, ctx)
        rad = integrator.trace(pack, static, org, dirn, ctx, DEPTH, camera.light_bias,
                               compact=False, differentiable=True, kernel=kernel, remat=remat)
        return (rad ** 2).mean()

    def lanes(pack, seed):
        ar = torch.arange(GRAD_LANES, device=pack.device)
        return (ar % camera.image_width, (ar // camera.image_width) % camera.image_height,
                torch.zeros_like(ar), torch.tensor(seed, dtype=torch.int64, device=pack.device))

    def named(pack, out):
        return out[0], dict(zip(pack.float_fields(), out[1]))

    def eager(pack, seed):
        return named(pack, graphs.value_and_grad(loss, pack.with_grad(), *lanes(pack, seed)))

    def graphed(pack, seed):
        return named(pack, graphed.grad(pack, *lanes(pack, seed)))

    def capture(body, device):
        graphed.captures.append(device)
        return graphs.cuda_capture(body, device)

    graphed.grad = graphs.GraphedGrad(loss, capture=capture)
    graphed.captures = []
    return eager, graphed


def grad_gap(a, b):
    """max over fields of max |a - b| / max |b| (0 where both are 0)."""
    worst = 0.0
    for f in b:
        if b[f].numel() == 0:
            continue
        scale = float(b[f].abs().max())
        if scale > 0:
            worst = max(worst, float((a[f] - b[f]).abs().max()) / scale)
        elif a[f].abs().max() > 0:
            return float("inf")
    return worst


def probe_scene():
    """tests/_grad_fd_main.py's scene: a diffuse ball on a diffuse floor
    lit by an emissive quad and a dim sky."""
    from rust_raytracer_torch.scene import graph as g

    light = g.Plane((0, 2.0, 0), (0.8, 0, 0), (0, 0, 0.8),
                    g.Emissive(g.Constant((6.0, 6.0, 6.0))))
    floor = g.Plane((0, -0.4, 0), (-4, 0, 0), (0, 0, 4),
                    g.Lambertian(g.Constant((0.6, 0.6, 0.6))))
    ball = g.Sphere((0, 0, 0), 0.35, g.Lambertian(g.Constant((0.7, 0.2, 0.2))))
    sky = g.Sky(g.Constant((0.1, 0.1, 0.1)))
    return g.SceneDef(world=g.Group([ball, floor, light, sky]), lights=[light, sky], config={})


def probe_grads(scene, camera, fields, device):
    """Gradients of _grad_fd_main.py's loss (the sum of radiance times cos
    weights over 16x16 pixels, 1 spp, depth 3, f32) with respect to
    `fields`, on `device`, through the threaded walk."""
    from rust_raytracer_torch.core import rng as vrng
    from rust_raytracer_torch.render import integrator
    from rust_raytracer_torch.scene import compiler

    pack, static = compiler.compile_scene(scene, device)
    pack = pack.with_grad()
    n = 256
    ar = torch.arange(n, device=device)
    px, py = ar % 16, (ar // 16) % camera.image_height
    smp = torch.zeros_like(ar)
    ctx = vrng.Ctx(pixel=py * 16 + px, sample=smp, bounce=0, seed=7)
    org, dirn = camera.generate_rays(px, py, smp, ctx)
    wgt = torch.cos(torch.arange(n * 3, dtype=torch.float64)).reshape(n, 3).float().to(device)
    rad = integrator.trace(pack, static, org, dirn, ctx, 3, 0.25, differentiable=True,
                           kernel="threaded")
    loss = (rad * wgt).sum()
    grads = torch.autograd.grad(loss, [getattr(pack, f) for f in fields])
    return {f: g.detach().cpu() for f, g in zip(fields, grads)}


# ---------------------------------------------------------------- volumes, CLI, resume

def uv_sphere_mesh(g, center, r, rings, segs, material):
    """A convex triangle mesh on a sphere: `rings` latitude bands of `segs`
    segments, fans at the poles (2 * segs * (rings - 1) triangles)."""
    th = np.linspace(0.0, np.pi, rings + 1)[1:-1]
    ph = np.linspace(0.0, 2.0 * np.pi, segs, endpoint=False)
    ring = np.stack([np.outer(np.sin(th), np.cos(ph)), np.repeat(np.cos(th)[:, None], segs, 1),
                     np.outer(np.sin(th), np.sin(ph))], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 1, 0]], ring, [[0, -1, 0]]]) * r + np.asarray(center, float)
    top, bot = 0, len(verts) - 1
    faces = []
    for j in range(segs):
        k = (j + 1) % segs
        faces.append((top, 1 + k, 1 + j))
        faces.append((bot, 1 + (rings - 2) * segs + j, 1 + (rings - 2) * segs + k))
        for i in range(rings - 2):
            a, b = 1 + i * segs + j, 1 + i * segs + k
            faces += [(a, b, b + segs), (a, b + segs, a + segs)]
    faces = np.asarray(faces)
    tris = np.stack([faces, np.zeros_like(faces), np.full_like(faces, -1)], -1).astype(np.int32)
    return g.Mesh(vertices=verts, normals=np.zeros((0, 3)), uvs=np.zeros((0, 2)),
                  triangles=tris, material=material)


def volume_kinds_scene(g, smoke):
    """cornell_smoke (two oriented boxes) with a sphere volume, a sheared
    box (12 triangles) and a 352-triangle sphere mesh added: every boundary
    kind, and a mesh block of the few hundred triangles whose span runs in
    chunks at 2^18 rays."""
    white = g.Lambertian(g.Constant((0.73, 0.73, 0.73)))
    iso = g.Isotropic(g.Constant((0.9, 0.9, 0.9)))
    shear = g.Transform(g.Box((0, 0, 0), (10.0, 10.0, 10.0), white))
    shear.rotate_z(30).scale(1.5, 1.0, 1.0).translate(-12.0, 12.0, -5.0)
    extra = [g.Volume(g.Sphere((12.0, 14.0, 0.0), 7.0, white), iso, 0.1),
             g.Volume(shear, iso, 0.1),
             g.Volume(uv_sphere_mesh(g, (0.0, -5.0, 10.0), 8.0, 12, 16, white), iso, 0.1)]
    return g.SceneDef(world=g.Group(list(smoke.world.items) + extra), lights=smoke.lights,
                      config=dict(smoke.config))


def volume_intersect_parity(scene, dev, card):
    """2^18 random rays through `intersect` and `hit_attributes` on the card
    and on the CPU: kind and prim agree on >= 0.999 of rays, t within rtol
    1e-5 / atol 1e-4 and pos within rtol 1e-5 / atol 1e-3 (a scene of scale
    30) where they agree, mat, valid and front_face equal.  Prints the
    intersect time and its peak memory above its inputs, and each
    volume's span time, on the card."""
    from rust_raytracer_torch.core import rng as vrng
    from rust_raytracer_torch.ops import intersect as isect
    from rust_raytracer_torch.scene import compiler
    from rust_raytracer_torch.scene import pack as sp

    r = np.random.default_rng(7)
    org = r.uniform(-27.0, 27.0, (LANES, 3)).astype(np.float32)
    dirn = r.normal(size=(LANES, 3)).astype(np.float32)
    out = []
    for d in (dev, torch.device("cpu")):
        pack, _ = compiler.compile_scene(scene, d)
        o, di = torch.from_numpy(org).to(d), torch.from_numpy(dirn).to(d)
        ctx = vrng.Ctx(torch.arange(LANES, device=d), torch.zeros(LANES, dtype=torch.int64,
                                                                  device=d), 2, 0)
        hit = isect.intersect(pack, o, di, 1e-3, ctx)
        attr = isect.hit_attributes(pack, o, di, hit)
        out.append((hit._replace(**{f: getattr(hit, f).cpu() for f in hit._fields}),
                    attr._replace(**{f: getattr(attr, f).cpu() for f in attr._fields})))
        if len(out) == 1:  # on the card
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            isect.intersect(pack, o, di, 1e-3, ctx)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            ms = time_ms(lambda: isect.intersect(pack, o, di, 1e-3, ctx), reps=10)
            spans = [(pack.vol_kinds[vi], int((pack.vol_tri_e1[vi] != 0).any(dim=1).sum()), time_ms(
                lambda: isect._volume_boundary_span(pack, o, di, vi), reps=10))
                for vi in range(len(pack.vol_kinds))]
    (h_g, a_g), (h_c, a_c) = out
    agree = (h_g.kind == h_c.kind) & (h_g.prim == h_c.prim)
    share = agree.double().mean().item()
    vol = h_c.kind == sp.PRIM_VOLUME
    per_vol = torch.bincount(h_c.prim[vol].long(), minlength=len(spans)).tolist()
    t_g, t_c = h_g.t[agree], h_c.t[agree]
    fin = torch.isfinite(t_c)
    if not (share >= 0.999 and torch.equal(torch.isfinite(t_g), fin)
            and torch.allclose(t_g[fin], t_c[fin], rtol=1e-5, atol=1e-4)
            and torch.allclose(a_g.pos[agree], a_c.pos[agree], rtol=1e-5, atol=1e-3)
            and all(torch.equal(getattr(a_g, f)[agree], getattr(a_c, f)[agree])
                    for f in ("mat", "valid", "front_face"))
            and min(per_vol) > 0):
        raise AssertionError(f"volume intersect card vs cpu: agreement {share}, volume hits "
                             f"{per_vol}")
    dt = (t_g[fin] - t_c[fin]).abs().max().item()
    names = {sp.VOL_SPHERE: "sphere", sp.VOL_BOX: "box", sp.VOL_MESH: "mesh"}
    log(f"volume intersect card vs cpu, {LANES} rays, cornell_smoke + 3 volumes: kind and prim "
        f"agree on {share:.6f}, max |dt| {dt:.3e}, volume hits per volume {per_vol}")
    log(f"volume intersect on the card: {ms:.3f} ms a call of {LANES} rays (CUDA events, mean "
        f"of 10), peak {peak} bytes above its inputs; spans: " + ", ".join(
            f"{names[k]}{f' ({tb} triangles)' if k == sp.VOL_MESH else ''} {t:.3f} ms"
            for k, tb, t in spans) + f" ({card})")
    return {"ms": ms, "peak": peak, "spans": spans}


def fog_pool_render(scene, camera, dev, card):
    """cornell_dragon with one fog sphere (the port's graph) through the
    pool at the main path's size: K1, the path vertex kernels and the
    free-flight kernel KV-FF launch every step and no plain walk or plain
    vertex runs, lanes stop in the volume (the step's free-flight counter,
    RenderMetrics.volume_hits, which the shading kernel adds to), the image
    is finite; then the same render through the graphed step: K1, vertex
    and KV-FF launches = steps, the same count of volume hits, the image
    within float order of the eager one."""
    from rust_raytracer_torch.ops import bvh8, vertex
    from rust_raytracer_torch.render.renderer import Renderer
    from rust_raytracer_torch.scene import graph as g
    from rust_raytracer_torch.utils.metrics import RenderMetrics

    white = g.Lambertian(g.Constant((0.73, 0.73, 0.73)))
    fog = g.Volume(g.Sphere((150.0, 120.0, 150.0), 100.0, white),
                   g.Isotropic(g.Constant((1.0, 1.0, 1.0))), 0.01)
    fog_scene = g.SceneDef(world=g.Group(list(scene.world.items) + [fog]),
                           lights=scene.lights, config=dict(scene.config))
    renderer = Renderer(fog_scene, camera, batch_size=LANES, device=dev, graph=False)
    metrics = RenderMetrics()
    torch.cuda.synchronize()
    bvh8.launches = bvh8.plain_calls = 0
    reset_vertex()
    t0 = time.perf_counter()
    film = renderer.render(mode="pool", metrics=metrics)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    vol_hits = metrics.volume_hits
    hdr = film.hdr()
    if not (bvh8.launches == metrics.steps > 0 and bvh8.plain_calls == 0
            and vertex.launches == vertex_want(metrics.steps, free_flight=metrics.steps)
            and not any(vertex.plain_calls.values())
            and vol_hits > 0 and np.isfinite(hdr).all() and hdr.mean() > 0):
        raise AssertionError(f"fog pool render: K1 launches {bvh8.launches}, steps "
                             f"{metrics.steps}, volume hits {vol_hits}, vertex launches "
                             f"{vertex.launches}, plain {vertex.plain_calls}")
    film.save(os.path.join(HERE, "build", "chip_smoke_cornell_dragon_fog.png"))
    total = camera.image_width * camera.image_height * SPP
    log(f"fog pool render: cornell_dragon + a fog sphere, {camera.image_width}x"
        f"{camera.image_height}@{SPP}spp depth {DEPTH}, {LANES} lanes: {total / secs:.1f} "
        f"pixel-samples/s ({secs:.3f} s), {metrics.steps} steps, K1 launches {bvh8.launches}, "
        f"plain calls 0, {vol_hits} lane-bounces stopped in the volume; {vertex_route()} "
        f"({card})")
    renderer.graph = True
    g_metrics = RenderMetrics()
    torch.cuda.synchronize()
    bvh8.launches = 0
    reset_vertex()
    t0 = time.perf_counter()
    g_hdr = renderer.render(mode="pool", metrics=g_metrics).hdr()
    torch.cuda.synchronize()
    g_secs = time.perf_counter() - t0
    agree, rel = image_agreement(g_hdr, hdr)
    log(f"fog pool render, graphed: {total / g_secs:.1f} pixel-samples/s ({g_secs:.3f} s with "
        f"its capture), {g_metrics.steps} steps, K1 launches {bvh8.launches}, "
        f"{g_metrics.volume_hits} lane-bounces stopped in the volume; image vs the "
        f"eager render: pixel agreement {agree:.6f}, mean |d|/mean {rel:.3e} ({card})")
    if not (bvh8.launches == g_metrics.steps == metrics.steps and agree >= 0.999999
            and rel <= 1e-5 and g_metrics.volume_hits == vol_hits
            and vertex.launches == vertex_want(metrics.steps, free_flight=metrics.steps)):
        raise AssertionError(f"the graphed fog render differs from the eager one (vertex "
                             f"launches {vertex.launches})")


def png_size(path):
    """(width, height) from a PNG's IHDR."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return tuple(int.from_bytes(head[i:i + 4], "big") for i in (16, 20))


def cli_render(argv, spp, dev, card):
    """`cli.main(argv)` on the card with --metrics=1: rc 0, one metrics
    line whose samples_issued is the image's pixel-samples (`spp` a
    pixel), and the PNG.
    Returns the metrics summary and the launches of each traversal
    kernel in the run (counts set to 0 just before)."""
    from rust_raytracer_torch.ops import bvh8, threaded
    from rust_raytracer_torch.ops import wavefront as wf
    from rust_raytracer_torch.utils import cli

    out = os.path.join(HERE, "build", f"chip_smoke_cli_{argv[0]}.png")
    if os.path.exists(out):
        os.unlink(out)
    buf = io.StringIO()
    torch.cuda.synchronize()
    bvh8.launches = bvh8.plain_calls = threaded.launches = threaded.plain_calls = 0
    for name in wf.KERNELS:
        wf.launches[name], wf.plain_calls[name] = 0, 0
    reset_vertex()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv) + ["--metrics=1", f"-o={out}"], device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"bvh8_traverse": bvh8.launches, "threaded_traverse": threaded.launches,
                **{k: v for k, v in wf.launches.items()}}
    plain = bvh8.plain_calls + threaded.plain_calls + sum(wf.plain_calls.values())
    lines = [json.loads(x)["render_metrics"] for x in buf.getvalue().splitlines()
             if x.startswith('{"render_metrics"')]
    w, h = png_size(out)
    from rust_raytracer_torch.ops import vertex
    if not (rc == 0 and len(lines) == 1 and plain == 0
            and lines[0]["samples_issued"] == lines[0]["pixel_samples"] == w * h * spp
            and vertex.launches == vertex_want(
                lines[0]["steps"],
                free_flight=lines[0]["steps"] if argv[0] == "cornell_smoke" else 0)
            and not any(vertex.plain_calls.values())):
        raise AssertionError(f"cli {argv}: rc {rc}, metrics {lines}, png {w}x{h}, plain {plain}, "
                             f"{vertex_route()}")
    m = lines[0]
    log(f"cli {' '.join(argv)} --metrics=1 on the card: rc 0, {w}x{h} PNG, "
        f"{m['samples_issued']} samples issued, {m['steps']} steps, "
        f"{m['pixel_samples_per_s']:.1f} pixel-samples/s in the metrics line, "
        f"{secs:.2f} s for main() with the scene build, launches "
        f"{ {k: v for k, v in launches.items() if v} }; {vertex_route()} ({card})")
    log("cli metrics line: " + json.dumps({"render_metrics": m}))
    return m, launches


def resume_check(pack, static, scene, dev, card, width=600):
    """The resumable pool on the card: 20 steps, a checkpoint at 2^18 lanes
    (its save time and size printed), 20 more steps straight on and 20
    from the reloaded file (through a step of its own: a graphed step
    donates its state): lane state equal bit for bit, accumulator within
    float sum order.  Then a render resumed from the step-20 file
    to its end against a straight render: image within sum-order
    tolerance.  cornell_dragon at `width` (600) square, 4 spp, so a pixel
    sums several paths."""
    from rust_raytracer_torch.render import checkpoint as ckpt
    from rust_raytracer_torch.render import pool as poolmod
    from rust_raytracer_torch.render.camera import camera_from_config
    from rust_raytracer_torch.utils import config as cfg

    cam = camera_from_config(cfg.merge_scene_config(scene.config, {"output_width": width}),
                             cfg.RenderConfig(samples_per_pixel=4, max_depth=DEPTH))
    n_pixels, spp = cam.image_width * cam.image_height, cam.actual_spp
    step, step_b = (poolmod.make_step(pack, static, cam, n_pixels * spp, spp, 0)
                    for _ in range(2))
    state = poolmod.init_state(LANES, n_pixels, dev)
    for _ in range(20):
        state = step(pack, state)
    path = os.path.join(HERE, "build", "chip_smoke_resume.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save_pool_state(path, state, {
        "step_count": 20, "params_hash": ckpt.params_hash(0, spp, n_pixels, LANES, cam)})
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    loaded, _ = ckpt.load_pool_state(path, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    lane = ("org", "dirn", "throughput", "radiance", "pixel", "sample", "bounce", "active",
            "next_flat", "overflow")
    if not all(torch.equal(getattr(loaded, f), getattr(state, f)) for f in lane + ("accum",)):
        raise AssertionError("the reloaded checkpoint differs from the saved state")
    a, b = state, loaded
    for _ in range(20):
        a, b = step(pack, a), step_b(pack, b)
    same = [f for f in lane if torch.equal(getattr(a, f), getattr(b, f))]
    d_acc = (a.accum - b.accum).abs().max().item()
    scale = a.accum.abs().max().item()
    acc_equal = torch.equal(a.accum, b.accum)
    if len(same) != len(lane) or d_acc > 1e-5 * scale:
        raise AssertionError(f"resume on the card: lane fields equal {same}, accum max |d| "
                             f"{d_acc} of {scale}")
    straight = poolmod.render_pool(pack, static, cam, n_pixels, spp, LANES, dev)
    resumed = ckpt.render_pool_resumable(pack, static, cam, n_pixels, spp, LANES, dev,
                                         checkpoint_path=path)
    d_img = (straight - resumed).abs().max().item()
    n_diff = int((straight != resumed).any(dim=1).sum())
    if not torch.allclose(resumed, straight, rtol=1e-5, atol=1e-6 * straight.abs().max().item()):
        raise AssertionError(f"resumed image differs from the straight one: max |d| {d_img}")
    log(f"resume on the card (cornell_dragon {cam.image_width}x{cam.image_height}@{spp}spp, "
        f"{LANES} lanes): checkpoint at step 20 {size} bytes, save {save_s * 1e3:.1f} ms, load "
        f"{load_s * 1e3:.1f} ms; 20 steps on from the file vs straight on: lane state equal "
        f"bit for bit ({len(same)} fields), accum {'equal' if acc_equal else 'max |d| '}"
        f"{'' if acc_equal else f'{d_acc:.3e} of {scale:.3e}'}; resumed render vs straight: "
        f"{n_diff} of {n_pixels} pixels differ, max |d| {d_img:.3e} of "
        f"{straight.abs().max().item():.3e} ({card})")
    os.unlink(path)
    return {"bytes": size, "save_ms": save_s * 1e3, "load_ms": load_s * 1e3}


def cli_volume_resume_phases(scene, camera, renderer, dev, card):
    """Phases 18-21: volumes on the card, a fog render, the
    CLI's main path and checkpoint/resume.  `scene`, `camera`, `renderer`
    are the main path's cornell_dragon SceneDef, camera and BVH8 renderer."""
    from rust_raytracer_torch import models
    from rust_raytracer_torch.render.camera import camera_from_config
    from rust_raytracer_torch.render.renderer import Renderer
    from rust_raytracer_torch.scene import graph as g
    from rust_raytracer_torch.utils import config as cfg

    # ---- 18. volumes: cornell_smoke on the card against the same on the
    # CPU, then 2^18 rays through intersect with every boundary kind ----
    smoke = models.build("cornell_smoke")
    smoke_cam = camera_from_config(cfg.merge_scene_config(smoke.config, {"output_width": 64}),
                                   cfg.RenderConfig(samples_per_pixel=4, max_depth=8))
    imgs = [Renderer(smoke, smoke_cam, batch_size=4096, device=d).render().hdr()
            for d in (dev, "cpu")]
    rel = np.abs(imgs[0] - imgs[1]).mean() / imgs[1].mean()
    close = np.isclose(imgs[0], imgs[1], rtol=1e-3, atol=1e-4).mean()
    log(f"cornell_smoke 64x64@4spp depth 8 card vs cpu: mean |d|/mean {rel:.3e}, pixels close "
        f"{close:.4f}")
    if not (rel <= 1e-3 and close >= 0.995):
        raise AssertionError("the card's cornell_smoke render disagrees with the CPU's")
    volume_intersect_parity(volume_kinds_scene(g, smoke), dev, card)

    # ---- 19. cornell_dragon with a fog sphere through the pool ----
    fog_pool_render(scene, camera, dev, card)

    # ---- 20. the CLI on the card (this slice's main path): cornell_smoke
    # at its own 600x600, cornell_dragon at the main path's size ----
    _, smoke_launches = cli_render(["cornell_smoke", "-s=1", f"--max-depth={DEPTH}"], 1, dev,
                                   card)
    cli_m, cli_launches = cli_render(["cornell_dragon", f"-w={W}", f"-s={SPP}",
                                      f"--max-depth={DEPTH}"], SPP, dev, card)
    if any(smoke_launches.values()) or cli_launches != {
            **{k: 0 for k in cli_launches}, "bvh8_traverse": cli_m["steps"]}:
        raise AssertionError(f"cli launches: cornell_smoke {smoke_launches}, cornell_dragon "
                             f"{cli_launches} in {cli_m['steps']} pool steps")

    # ---- 21. checkpoint/resume of the pool on the card ----
    resume_check(renderer.pack, renderer.static, scene, dev, card)
    return cli_launches


# ---------------------------------------------------------------- f64, the mesh, sharded checkpoints

def f64_phase(dev, card):
    """Phase 22: tests/_grad_fd_main.py's scene at f64 through the "jnp"
    walk on the card against the same on the CPU (radiance and the probed
    gradients within 1e-9 relative), the card's central differences against
    its gradients (rtol 1e-3), Renderer(dtype=float64, kernel="auto") on the
    card refused with TypeError, and no K1, K3 or path vertex kernel launch
    in the phase (an f64 pack takes the vertex's plain route)."""
    from rust_raytracer_torch.core import rng as vrng
    from rust_raytracer_torch.ops import bvh8, gather, threaded, vertex
    from rust_raytracer_torch.render import integrator
    from rust_raytracer_torch.render.camera import Camera
    from rust_raytracer_torch.render.renderer import Renderer
    from rust_raytracer_torch.scene import compiler

    f64 = torch.float64
    fields = ("sph_center", "sph_radius", "pln_corner", "background", "tex_const")
    cam = Camera(image_width=16, aspect_ratio=1.0, samples_per_pixel=1, max_depth=3,
                 position=(0, 0.3, 1.6), look_at=(0, 0, 0), focal_length=35.0)
    k1, k3 = bvh8.launches, threaded.launches
    row_bwd = gather.launches["row_gather_bwd"]
    reset_vertex()
    out = []
    for where in (dev, torch.device("cpu")):
        pack, static = compiler.compile_scene(probe_scene(), where, f64)
        n = 256
        ar = torch.arange(n, device=where)
        px, py, smp = ar % 16, (ar // 16) % 16, torch.zeros_like(ar)
        ctx = vrng.Ctx(pixel=py * 16 + px, sample=smp, bounce=0, seed=7)
        org, dirn = cam.generate_rays(px, py, smp, ctx, f64)
        wgt = torch.cos(torch.arange(n * 3, dtype=f64)).reshape(n, 3).to(where)

        def loss_of(p, differentiable=False):
            rad = integrator.trace(p, static, org, dirn, ctx, 3, 0.25, kernel="jnp",
                                   differentiable=differentiable)
            return rad, (rad * wgt).sum()

        if where.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rad, _ = loss_of(pack)
        if where.type == "cuda":
            torch.cuda.synchronize()
        trace_ms = (time.perf_counter() - t0) * 1e3
        gp = pack.with_grad()
        _, loss = loss_of(gp, True)
        grads = dict(zip(fields, torch.autograd.grad(loss, [getattr(gp, f) for f in fields])))
        floor = int(torch.argmin(pack.pln_corner[:, 1]))
        probes = [("sph_center", (0, a)) for a in range(3)] + [
            ("sph_radius", (0,)), ("pln_corner", (floor, 1)), ("background", (1,))]
        cg = grads["tex_const"].cpu().numpy()
        probes += [("tex_const", tuple(int(i) for i in np.unravel_index(int(fi), cg.shape)))
                   for fi in np.argsort(-np.abs(cg).ravel())[:4]
                   if abs(cg.ravel()[fi]) >= 1e-6]
        fd = {}
        for field, idx in probes:
            vals = []
            for delta in (1e-6, -1e-6):
                arr = getattr(pack, field).clone()
                arr[idx] += delta
                vals.append(float(loss_of(pack._replace(**{field: arr}))[1]))
            fd[(field, idx)] = (vals[0] - vals[1]) / 2e-6
        out.append((rad.cpu(), {f: g.cpu() for f, g in grads.items()}, fd, trace_ms))
    (r_g, g_g, fd_g, ms_g), (r_c, g_c, _, ms_c) = out
    rad_gap = float(((r_g - r_c).abs() / r_c.abs().clamp(min=1e-300)).max())
    grad_gaps = {f: float((g_g[f] - g_c[f]).abs().max() / g_c[f].abs().max().clamp(min=1e-300))
                 for f in fields}
    fd_worst = 0.0
    for (field, idx), v in fd_g.items():
        an = float(g_g[field][idx])
        if not abs(an - v) <= 1e-5 + 1e-3 * abs(v):
            raise AssertionError(f"f64 central difference {field}{idx}: {v} vs autograd {an}")
        fd_worst = max(fd_worst, abs(an - v) / max(abs(v), 1e-300))
    row_bwd = gather.launches["row_gather_bwd"] - row_bwd
    try:
        Renderer(probe_scene(), cam, device=dev, dtype=f64)
    except TypeError as e:
        refused = str(e)
    else:
        raise AssertionError("Renderer(dtype=float64, kernel='auto') on the card did not raise")
    log(f"f64 on the card (_grad_fd_main scene 16x16, depth 3, kernel jnp): radiance card vs "
        f"cpu max rel {rad_gap:.3e}, gradients max |d|/max |g| "
        + ", ".join(f"{f} {v:.3e}" for f, v in grad_gaps.items())
        + f" (bound 1e-9); {len(fd_g)} central differences (eps 1e-6) vs autograd on the card: "
        f"worst rel {fd_worst:.3e} (rtol 1e-3, atol 1e-5); f64 trace {ms_g:.1f} ms on the card, "
        f"{ms_c:.1f} ms on the cpu; auto on the card refused: TypeError; {vertex_route()}; "
        f"row gather backward launches {row_bwd} (float64) ({card})")
    if not (rad_gap <= 1e-9 and max(grad_gaps.values()) <= 1e-9):
        raise AssertionError("the card's f64 trace disagrees with the CPU's")
    if not row_bwd > 0:
        raise AssertionError("the f64 gradient on the card launched no row gather backward")
    if (bvh8.launches, threaded.launches) != (k1, k3) or "jnp" not in refused or any(
            vertex.launches.values()):
        raise AssertionError("the f64 phase launched a CUDA traversal or vertex kernel")
    return {"rad_gap": rad_gap, "grad_gap": max(grad_gaps.values()), "fd_worst": fd_worst,
            "trace_ms": ms_g}


def pool_rate(pack, static, camera, dev, kernel, mesh, step=None):
    """One full pool render of `camera`'s image at LANES lanes, sharded over
    `mesh` (None: the one-device step), through `step` (a make_step of
    these arguments; a new one, captured in the render, by default):
    (accum, metrics, seconds)."""
    from rust_raytracer_torch.render import pool as poolmod
    from rust_raytracer_torch.utils.metrics import RenderMetrics

    m = RenderMetrics()
    n_pixels = camera.image_width * camera.image_height
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    accum = poolmod.render_pool(pack, static, camera, n_pixels, SPP, LANES, dev, metrics=m,
                                kernel=kernel, mesh=mesh, step=step)
    torch.cuda.synchronize()
    return accum, m, time.perf_counter() - t0


def mesh_phase(renderer, wf_renderer, b_renderer, camera, wf_overflow, dev, card):
    """Phase 23: cornell_dragon at the main path's size through every kernel
    on a mesh of the one card: the BVH8 pool (K1) with make_mesh(1) and two
    shards on the card, each shard's state on its device, against the
    unsharded pool (issued = total, K1 launches = shards x steps, image
    within float order, rates side by side, each render cold with its
    captures and warm through the same step); the two-shard step graphed
    against eager shard for shard over 20 steps, and its graphed step
    split beside the unsharded one's (no aten op dispatched besides the
    replays); the wavefront pool (fused K2a+K2b, K2c) with make_mesh(1), its
    overflow equal to the unsharded wavefront render's; the batch render
    through K3 with 1 and 2 shards (images compared, pixels not bit-equal
    counted); train_step_fn at GRAD_LANES lanes through K3 with 1 and 2
    shards, eager and graphed (one capture, then one replay a shard a step;
    graphed within 1e-5 of eager; the 2-shard loss and gradients equal to
    the 1-shard ones after normalisation, rtol 1e-5).
    Returns the launches of each kernel on these sharded paths."""
    from rust_raytracer_torch.core import rng as vrng
    from rust_raytracer_torch.ops import bvh8, loop_cond, threaded
    from rust_raytracer_torch.ops import wavefront as wf
    from rust_raytracer_torch.parallel import mesh as pmesh
    from rust_raytracer_torch.render import graphs, integrator

    one, two = pmesh.make_mesh(1), pmesh.make_mesh(device=[dev, dev])
    total = camera.image_width * camera.image_height * SPP
    pack, static = renderer.pack, renderer.static
    launches = Counter()

    def reset():
        torch.cuda.synchronize()
        bvh8.launches = bvh8.plain_calls = threaded.launches = threaded.plain_calls = 0
        for name in wf.KERNELS:
            wf.launches[name], wf.plain_calls[name] = 0, 0

    def make_step(mesh):
        from rust_raytracer_torch.render import pool as poolmod
        return poolmod.make_step(pack, static, camera, total, SPP, 0, mesh=mesh)

    # each render twice through one step: cold (its graphs captured in it)
    # and warm
    base_step = make_step(None)
    base, base_m, base_s = pool_rate(pack, static, camera, dev, "auto", None, base_step)
    base_img = (base / SPP).reshape(camera.image_height, camera.image_width, 3).cpu().numpy()
    base_warm = pool_rate(pack, static, camera, dev, "auto", None, base_step)[2]
    warm = {}
    for tag, mesh in (("make_mesh(1)", one), ("2 shards on one card", two)):
        step = make_step(mesh)
        for run in ("cold", "warm"):
            reset()
            accum, m, secs = pool_rate(pack, static, camera, dev, "auto", mesh, step)
            k1 = bvh8.launches
            img = (accum / SPP).reshape(base_img.shape).cpu().numpy()
            agree, rel = image_agreement(img, base_img)
            ref_s = base_s if run == "cold" else base_warm
            log(f"mesh pool, K1, {tag}, {run}: {total / secs:.1f} pixel-samples/s ({secs:.3f} "
                f"s) beside the unsharded pool's {total / ref_s:.1f} ({ref_s:.3f} s, {run}) in "
                f"this run ({ref_s / secs:.3f}x), {m.steps} steps ({base_m.steps} unsharded), "
                f"issued {m.samples_issued} of {total}, K1 launches {k1} = {mesh.n_shards} x "
                f"{m.steps}; image vs unsharded: pixel agreement {agree:.6f}, mean |d|/mean "
                f"{rel:.3e} ({card})")
            if not (m.samples_issued == total and k1 == mesh.n_shards * m.steps
                    and bvh8.plain_calls == 0 and agree >= 0.999 and rel <= 1e-5):
                raise AssertionError(f"the sharded pool ({tag}) disagrees with the unsharded "
                                     f"one")
            launches["bvh8_traverse"] += k1
        warm[mesh.n_shards] = secs
        del step
        step_split(renderer, camera, card, ("bvh8_traverse",), steps=3, mesh=mesh)

    # the two-shard step graphed: one replay a shard and nothing else, held
    # against the eager step shard for shard, beside the unsharded step
    lane_state_parity(renderer, "auto", camera, dev, card, ("bvh8_traverse",), mesh=two)
    one_card = step_split(renderer, camera, card, ("bvh8_traverse",), steps=3, graph=True)
    split2 = step_split(renderer, camera, card, ("bvh8_traverse",), steps=3, mesh=two,
                        graph=True)
    log(f"mesh pool step, graphed, 2 shards on one card / unsharded: wall "
        f"{split2['wall_ms']:.3f} / {one_card['wall_ms']:.3f} ms a step, device busy "
        f"{split2['busy_ms']:.3f} / {one_card['busy_ms']:.3f} ms a step (wall / busy "
        f"{split2['wall_ms'] / split2['busy_ms']:.3f} / "
        f"{one_card['wall_ms'] / one_card['busy_ms']:.3f}), kernels {split2['launches']:.0f} / "
        f"{one_card['launches']:.0f} a step; the host a step: aten ops dispatched "
        f"{split2['ops']} / {one_card['ops']}, graph launches {split2['replays']} / "
        f"{one_card['replays']}, launches, copies and fills outside a graph "
        f"{split2['host_launches']} / {one_card['host_launches']}; warm render rate 2 "
        f"shards / unsharded {base_warm / warm[2]:.3f}x ({card})")
    if split2["ops"]:
        raise AssertionError(f"the graphed two-shard step dispatched {split2['ops']} ops "
                             f"besides its replays")

    reset()
    accum, m, secs = pool_rate(wf_renderer.pack, wf_renderer.static, camera, dev, "wavefront",
                               one)
    wf_l = dict(wf.launches)
    log(f"mesh pool, wavefront, make_mesh(1): {total / secs:.1f} pixel-samples/s ({secs:.3f} s), "
        f"{m.steps} steps, launches {wf_l}, overflow {m.wf_overflow_packets} packets (the "
        f"unsharded wavefront render's: {wf_overflow}) ({card})")
    if not (m.wf_overflow_packets == wf_overflow and wf_l["wf_cull_compact"] == m.steps
            == wf_l["wf_mt"] and wf_l["wf_cull"] == wf_l["wf_compact"] == 0
            and m.samples_issued == total):
        raise AssertionError("the 1-shard wavefront pool differs from the unsharded one")
    for name, v in wf_l.items():
        launches[name] += v

    imgs = {}
    for n, mesh in ((1, one), (2, two)):
        reset()
        b_renderer.mesh = mesh
        lc = loop_cond.launches
        t0 = time.perf_counter()
        imgs[n] = b_renderer.render(mode="batch").hdr()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches["threaded_traverse"] += threaded.launches
        launches["loop_cond"] += loop_cond.launches - lc
        log(f"mesh batch render, K3, {n} shard(s): {total / secs:.1f} pixel-samples/s "
            f"({secs:.3f} s), K3 launches {threaded.launches}, loop_cond launches "
            f"{loop_cond.launches - lc} ({card})")
        if not (threaded.launches == loop_cond.launches - lc > 0 and threaded.plain_calls == 0):
            raise AssertionError("the sharded batch render launched no K3 kernel")
    b_renderer.mesh = None
    agree, rel = image_agreement(imgs[2], imgs[1])
    n_diff = int((imgs[2] != imgs[1]).any(axis=-1).sum())
    log(f"mesh batch images, 2 shards vs 1: {n_diff} of {imgs[1].shape[0] * imgs[1].shape[1]} "
        f"pixels not bit-equal, pixel agreement {agree:.6f}, mean |d|/mean {rel:.3e}")
    if not (agree >= 0.999 and rel <= 1e-5):
        raise AssertionError("the 2-shard batch render disagrees with the 1-shard one")

    tpack = b_renderer.pack
    ar = torch.arange(GRAD_LANES, device=dev)
    px = ar % camera.image_width
    py = (ar // camera.image_width) % camera.image_height
    smp = torch.zeros_like(ar)

    def batch_fn(p, px, py, sample, seed):
        ctx = vrng.Ctx(pixel=py * camera.image_width + px, sample=sample, bounce=0, seed=seed)
        org, dirn = camera.generate_rays(px, py, sample, ctx)
        return integrator.trace(p, b_renderer.static, org, dirn, ctx, DEPTH,
                                camera.light_bias, compact=False, differentiable=True,
                                kernel="threaded")

    res = {}
    real_capture = graphs.cuda_capture
    for n, mesh in ((1, one), (2, two)):
        secs, out = {}, {}
        for graph in (False, True):
            captures = []

            def capture(body, device):
                captures.append(device)
                return real_capture(body, device)

            graphs.cuda_capture = capture
            try:
                step = pmesh.train_step_fn(batch_fn, lambda r, t: (r ** 2).mean(), mesh,
                                           kernel="threaded", graph=graph)
                secs[graph] = []
                for _ in range(1 + int(graph)):
                    reset()
                    t0 = time.perf_counter()
                    out[graph] = step(tpack, px, py, smp, 0,
                                      torch.zeros((GRAD_LANES, 3), device=dev))
                    torch.cuda.synchronize()
                    secs[graph].append(time.perf_counter() - t0)
                    launches["threaded_traverse"] += threaded.launches
                    if threaded.launches != n * 20 or threaded.plain_calls:
                        raise AssertionError(f"train_step_fn, {n} shard(s), graph {graph}: K3 "
                                             f"launches {threaded.launches}")
            finally:
                graphs.cuda_capture = real_capture
            del step
            if len(captures) != int(graph):
                raise AssertionError(f"train_step_fn, {n} shard(s), graph {graph}: "
                                     f"{len(captures)} captures")
        loss, grads = out[True]
        res[n] = (float(loss) / n, {f: g / n for f, g in zip(tpack.float_fields(), grads)})
        e_gap = grad_gap(dict(zip(tpack.float_fields(), out[True][1])),
                         dict(zip(tpack.float_fields(), out[False][1])))
        log(f"mesh train_step_fn, K3, {n} shard(s): {GRAD_LANES} lanes, depth {DEPTH}: eager "
            f"{secs[False][0] * 1e3:.1f} ms a step, graphed "
            f"{secs[True][1] * 1e3:.1f} ms a step, {n} replay(s) of one capture (the first "
            f"{secs[True][0] * 1e3:.1f} ms with the capture); K3 launches {n * 20} a step "
            f"both ways; graphed vs eager: loss equal {bool(out[True][0] == out[False][0])}, "
            f"gradients max |d|/max |g| {e_gap:.3e} (bound 1e-5) ({card})")
        if not e_gap <= 1e-5:
            raise AssertionError(f"train_step_fn, {n} shard(s): graphed differs from eager")
    loss_gap = abs(res[2][0] - res[1][0]) / abs(res[1][0])
    gap = grad_gap(res[2][1], res[1][1])
    log(f"mesh train_step_fn, graphed, 2 shards / 2 vs 1 shard: loss rel {loss_gap:.3e}, "
        f"gradients max |d|/max |g| {gap:.3e} (bound 1e-5)")
    if not (loss_gap <= 1e-5 and gap <= 1e-5):
        raise AssertionError("train_step_fn at 2 shards disagrees with 1 shard")
    return dict(launches)


def sharded_checkpoint(pack, static, camera, dev, card):
    """Phase 24: a 2-shard pool state of the main path (2 shards on the one
    card, each shard's state its graphed step's buffers) saved after 20
    steps in the stacked layout and loaded back on the mesh, shard for
    shard; 20 more steps from each (the loaded one through a step of its
    own: a graphed sharded step donates its state): lane state equal bit
    for bit, next_flat per shard equal, shard for shard.  The file's size
    and its save and load times at LANES lanes."""
    from rust_raytracer_torch.parallel import mesh as pmesh
    from rust_raytracer_torch.render import checkpoint as ckpt
    from rust_raytracer_torch.render import pool as poolmod

    mesh = pmesh.make_mesh(device=[dev, dev])
    n_pixels = camera.image_width * camera.image_height
    args = (pack, static, camera, n_pixels * SPP, SPP, 0)
    step, step_b = (poolmod.make_step(*args, mesh=mesh) for _ in range(2))
    state = poolmod.init_shards(LANES, n_pixels, mesh)
    for _ in range(20):
        state = step(pack, state)
    path = os.path.join(HERE, "build", "chip_smoke_sharded.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save_pool_state(path, state, {"step_count": 20})
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    with np.load(path) as z:
        shapes = {f: z[f].shape for f in ("accum", "next_flat")}
        at_20 = z["next_flat"].tolist()
    t0 = time.perf_counter()
    loaded, _ = ckpt.load_pool_state(path, dev, mesh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if not (isinstance(loaded, poolmod.ShardedState) and len(loaded) == 2 and all(
            torch.equal(getattr(x, f), getattr(y, f))
            for x, y in zip(loaded, state) for f in poolmod.PoolState._fields)):
        raise AssertionError("the reloaded sharded checkpoint differs from the saved state")
    a, b = state, loaded
    for _ in range(20):
        a, b = step(pack, a), step_b(pack, b)
    lane = poolmod.PoolState._fields[:8] + ("next_flat", "overflow")
    same = [f"{f} (shard {i})" for i, (x, y) in enumerate(zip(a, b)) for f in lane
            if torch.equal(getattr(x, f), getattr(y, f))]
    d_acc = max((x.accum - y.accum).abs().max().item() for x, y in zip(a, b))
    scale = max(x.accum.abs().max().item() for x in a)
    log(f"sharded checkpoint on the card (2 shards on one card, {LANES} lanes, cornell_dragon "
        f"{camera.image_width}x{camera.image_height}): file accum {shapes['accum']}, next_flat "
        f"{at_20} at step 20, {size} bytes, save {save_s * 1e3:.1f} ms, load on the mesh "
        f"{load_s * 1e3:.1f} ms, each shard's state equal to the saved one; 20 steps on from "
        f"the file vs straight on: lane state equal bit for bit shard for shard ({len(same)} "
        f"of {2 * len(lane)} fields), next_flat {[int(x.next_flat) for x in a]} vs "
        f"{[int(y.next_flat) for y in b]}, accum max |d| {d_acc:.3e} of {scale:.3e} ({card})")
    if (len(same) != 2 * len(lane) or d_acc > 1e-5 * scale
            or shapes != {"accum": (2, n_pixels, 3), "next_flat": (2,)}):
        raise AssertionError("the sharded pool resumed from its checkpoint diverged")
    os.unlink(path)
    return {"bytes": size, "save_ms": save_s * 1e3, "load_ms": load_s * 1e3}


# ---------------------------------------------------------------- CUDA graphs

# CUgraphNodeType (cuda.h): the kinds a captured step holds
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 5: "empty", 6: "event wait",
              7: "event record", 10: "mem alloc", 11: "mem free"}


def graph_nodes(graph):
    """The nodes of a captured torch.cuda.CUDAGraph (kept with
    keep_graph=True) by kind, read with libcuda's cuGraphGetNodes and
    cuGraphNodeGetType."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetNodes failed")
    kinds = Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise AssertionError("cuGraphNodeGetType failed")
        kinds[NODE_KINDS.get(kind.value, f"kind {kind.value}")] += 1
    return kinds


def graph_kernel_names(graph):
    """The kernel nodes of a captured torch.cuda.CUDAGraph (kept with
    keep_graph=True) by the name of their function, read with libcuda's
    cuGraphKernelNodeGetParams and cuFuncGetName (cuKernelGetName where the
    node holds a CUkernel)."""
    import ctypes

    class KernelNodeParams(ctypes.Structure):   # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p)] + [(f, ctypes.c_uint) for f in (
            "grid_x", "grid_y", "grid_z", "block_x", "block_y", "block_z", "shared")] + [
            (f, ctypes.c_void_p) for f in ("kernel_params", "extra", "kern", "ctx")]

    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetNodes failed")
    names = Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise AssertionError("cuGraphNodeGetType failed")
        if kind.value != 0:
            continue
        params, name = KernelNodeParams(), ctypes.c_char_p()
        err = cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params))
        if err == 0:
            err = (cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func))
                   if params.func else
                   cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)))
        if err != 0:
            raise AssertionError(f"reading a kernel node's function: CUDA error {err}")
        names[name.value.decode()] += 1
    return names


def the_capture(step):
    """The one capture of a graphed step (render/graphs.py:GraphedStep)."""
    (cap,) = step.captures.values()
    return cap


def lane_state_parity(r, kernel, camera, dev, card, names, steps=20, mesh=None):
    """Eager and graphed pool steps of renderer `r` from one start state, in
    turns, `steps` each: every lane field bit-equal, the accumulator within
    float order (index_add on the card sums in no fixed order), and the
    graphed steps' launches of each traversal kernel in `names` equal to
    the steps (times the shards), and each shard's graphed step donating
    its state (the same buffers every step).  With `mesh`, the sharded
    steps from each shard's state on its device, held shard for shard.
    Returns the accumulator's max |d|."""
    from rust_raytracer_torch.render import graphs
    from rust_raytracer_torch.render import pool as poolmod

    n_pixels = camera.image_width * camera.image_height
    args = (r.pack, r.static, camera, n_pixels * SPP, SPP, r.seed)
    eager = poolmod.make_step(*args, kernel=kernel, graph=False, mesh=mesh)
    graphed = poolmod.make_step(*args, kernel=kernel, mesh=mesh)
    if mesh is None:
        e = g = poolmod.init_state(LANES, n_pixels, dev)
    else:
        e = g = poolmod.init_shards(LANES, n_pixels, mesh)
    launched = Counter()
    held = None
    for _ in range(steps):
        e = eager(r.pack, e)
        before = graphs.launch_counts()
        g = graphed(r.pack, g)
        launched.update({k: v - before[k] for k, v in graphs.launch_counts().items()})
        held = held or [s.org for s in poolmod.shards(g)]
        if any(s.org is not h for s, h in zip(poolmod.shards(g), held)):
            raise AssertionError("a graphed shard step returned new tensors, not its "
                                 "buffers")
    torch.cuda.synchronize()
    lane = ("org", "dirn", "throughput", "radiance", "pixel", "sample", "bounce", "active",
            "next_flat", "overflow")
    pairs = [(e, g)] if mesh is None else list(zip(e, g))
    differ = [f + ("" if mesh is None else f" (shard {i})") for i, (a, b) in enumerate(pairs)
              for f in lane if not torch.equal(getattr(a, f), getattr(b, f))]
    d_acc = max(float((a.accum - b.accum).abs().max()) for a, b in pairs)
    scale = max(float(a.accum.abs().max()) for a, _ in pairs)
    launched = {k: v for k, v in launched.items() if v}
    caps = graphed.shard_steps
    capture_s = sum(the_capture(c).seconds for c in caps)
    tag = kernel if mesh is None else f"{kernel}, {mesh.n_shards} shards"
    log(f"graph lane state, {tag}: {steps} eager and {steps} graphed steps in turns from "
        f"one start: lane fields not bit-equal {differ or 'none'} (of {len(lane)} a shard, "
        f"{len(pairs)} shard(s)), accum max |d| {d_acc:.3e} of {scale:.3e} (float order), "
        f"graphed launches {launched}, captures {len(caps)}, {capture_s:.2f} s ({card})")
    if differ or d_acc > 1e-5 * scale or launched != {
            nm: steps * len(pairs) for nm in names + VERTEX_POOL}:
        raise AssertionError(f"graphed {tag} steps differ from the eager ones")
    return d_acc


def graph_render_pair(r, kernel, camera, dev, card, names):
    """The main path's full render of renderer `r`, eager and graphed, in
    turns (eager, graphed with its capture, graphed, eager), each with a
    fresh step: rates, wall ms/step, peak memory (max_memory_allocated from
    a reset; the graphed one's includes its capture), steps equal, the
    traversal kernels' launches equal to the steps on each graphed render,
    the images within float order of each other (agreement >= 0.999999 at
    1 spp).  Returns a dict of the numbers."""
    from rust_raytracer_torch.render import graphs
    from rust_raytracer_torch.render import pool as poolmod
    from rust_raytracer_torch.utils.metrics import RenderMetrics

    n_pixels = camera.image_width * camera.image_height
    total = n_pixels * SPP
    runs = []
    steps = {}
    for mode in ("eager", "graphed", "graphed", "eager"):
        if mode not in steps or mode == "eager":
            steps[mode] = poolmod.make_step(r.pack, r.static, camera, total, SPP, r.seed,
                                            kernel=kernel, graph=mode == "graphed")
        m = RenderMetrics()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = graphs.launch_counts()
        t0 = time.perf_counter()
        accum = poolmod.render_pool(r.pack, r.static, camera, n_pixels, SPP, LANES, dev,
                                    seed=r.seed, metrics=m, kernel=kernel, step=steps[mode])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        launched = {k: v - before[k] for k, v in graphs.launch_counts().items()
                    if v != before[k]}
        runs.append((mode, secs, m.steps, peak, launched, accum))
        if launched != {nm: m.steps for nm in names + VERTEX_POOL}:
            raise AssertionError(f"{mode} {kernel} render: launches {launched}, {m.steps} steps")
    cap = the_capture(steps["graphed"].shard_steps[0])
    nodes = graph_nodes(cap.graph)
    h = camera.image_height
    imgs = {mode: (a / SPP).reshape(h, W, 3).cpu().numpy() for mode, *_, a in runs}
    agree, rel = image_agreement(imgs["graphed"], imgs["eager"])
    e_s = (runs[0][1] + runs[3][1]) / 2
    g_s = runs[2][1]
    n_steps = {s for _, _, s, *_ in runs}
    out = {"eager_rate": total / e_s, "graphed_rate": total / g_s,
           "eager_ms_step": e_s * 1e3 / runs[0][2], "graphed_ms_step": g_s * 1e3 / runs[2][2],
           "first_graphed_s": runs[1][1], "capture_s": cap.seconds,
           "eager_peak": max(runs[0][3], runs[3][3]), "graphed_peak": runs[1][3],
           "nodes": dict(nodes), "agree": agree, "rel": rel, "steps": runs[0][2]}
    log(f"graph render, {kernel}: cornell_dragon {W}x{h}@{SPP}spp depth {DEPTH}, {LANES} "
        f"lanes, eager / graphed / graphed / eager: {', '.join(f'{s:.3f}' for _, s, *_ in runs)} "
        f"s; eager {out['eager_rate']:.1f} pixel-samples/s ({out['eager_ms_step']:.3f} ms/step, "
        f"mean of 2), graphed {out['graphed_rate']:.1f} ({out['graphed_ms_step']:.3f} ms/step; "
        f"the first graphed render {runs[1][1]:.3f} s with its capture, {cap.seconds:.3f} s "
        f"set-up), {runs[0][2]} steps each; graph nodes a step {dict(nodes)} "
        f"({sum(nodes.values())} in all) beside STEP_LAUNCHES {STEP_LAUNCHES[kernel]}; peak "
        f"memory above the inputs: eager {out['eager_peak'] / 2**20:.1f} MiB, graphed "
        f"{out['graphed_peak'] / 2**20:.1f} MiB (capture included); graphed image vs eager: "
        f"pixel agreement {agree:.6f}, mean |d|/mean {rel:.3e}; graphed launches "
        f"{runs[2][4]} ({card})")
    if len(n_steps) != 1 or not (agree >= 0.999999 and rel <= 1e-5):
        raise AssertionError(f"graphed {kernel} render differs from the eager one")
    if kernel == "auto" and nodes["kernel"] > MAX_STEP_KERNEL_NODES:
        raise AssertionError(f"the graphed BVH8 step holds {nodes['kernel']} kernel nodes, "
                             f"more than {MAX_STEP_KERNEL_NODES}")
    return out


def graph_phase(renderer, wf_renderer, camera, dev, card):
    """Phase 25: the pool step as a CUDA graph (render/graphs.py) against
    the eager step on the card.  The eager step's device split is phases 7
    and 12's; the batch render's graph is phase 28's."""
    out = {}
    for kernel, r, names in (("auto", renderer, ("bvh8_traverse",)),
                             ("wavefront", wf_renderer, ("wf_cull_compact", "wf_mt"))):
        lane_state_parity(r, kernel, camera, dev, card, names)
        out[kernel] = graph_render_pair(r, kernel, camera, dev, card, names)
        out[kernel]["split"] = step_split(r, camera, card, names + VERTEX_POOL, graph=True)
    return out


def grad_graph_phase(pack, static, camera, card, kept):
    """Phase 26: the fwd+bwd step graphed (render/graphs.py:GraphedGrad)
    against the eager step, in turns at seeds 1, 2 and 3 (eager, graphed;
    at seed 1 eager once more), for remat "none", "hits" and "full",
    through K3 ("threaded") and K1 ("auto"): the loss bit-equal (no
    atomics in the forward under compact=False); the gradients within the
    gap between the two eager runs at seed 1, printed beside it, and
    within 1e-5 of each field's largest entry; one capture for the three
    seeds; the walk's launches = replays x 20 (x 40 under "full", whose
    backward recomputes the traversal), no other traversal kernel and no
    plain call; a steady replay's wall ms and pixel-samples/s beside the
    eager step's, one graphed step's device busy ms (profiled; K1's "none"
    and "hits" steps are not profiled), the peak memory of the eager and
    the graphed calls above what was allocated when each began (a capture
    included) and the memory the capture holds.  `kept` holds phase 16's steps (threaded "none" and "hits"),
    captured at seed 0 and split there: they are replayed here, and their
    capture, memory and split are phase 16's.  Returns {(kernel, remat):
    numbers}."""
    from rust_raytracer_torch.ops import bvh8, threaded
    from rust_raytracer_torch.render import graphs

    walks = {"threaded": "threaded_traverse", "auto": "bvh8_traverse"}
    out = {}
    for kernel, name in walks.items():
        for remat in ("none", "hits", "full"):
            t_combo = time.perf_counter()
            row = kept.pop((kernel, remat), None)
            if row is None:
                eager, graphed = grad_steps(static, camera, remat, kernel)
            else:
                eager, graphed = row["eager"], row["graphed"]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base, base_res = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
            plain = (bvh8.plain_calls, threaded.plain_calls)
            ms = {"eager": [], "graphed": []}
            peaks = {"eager": 0, "graphed": 0}
            launched, loss_equal, gaps, spread = Counter(), True, [], None
            for seed in (1, 2, 3):
                res = {}
                for tag in ("eager", "graphed", "eager again")[:3 if seed == 1 else 2]:
                    mode = "graphed" if tag == "graphed" else "eager"
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    start = torch.cuda.memory_allocated()
                    before = graphs.launch_counts()
                    t0 = time.perf_counter()
                    res[tag] = (graphed if tag == "graphed" else eager)(pack, seed)
                    torch.cuda.synchronize()
                    ms[mode].append((time.perf_counter() - t0) * 1e3)
                    peaks[mode] = max(peaks[mode], torch.cuda.max_memory_allocated() - start)
                    if tag == "graphed":
                        launched.update({k: v - before[k]
                                         for k, v in graphs.launch_counts().items()})
                loss_equal &= torch.equal(res["graphed"][0], res["eager"][0])
                gaps.append(grad_gap(res["graphed"][1], res["eager"][1]))
                if seed == 1:
                    spread = grad_gap(res["eager again"][1], res["eager"][1])
            del res
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graphed(pack, 4)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            cap = the_capture(graphed.grad)
            nodes = sum(graph_nodes(cap.graph).values())
            row_per = cap.launched.get("row_gather_bwd", 0)
            if row is None:
                held = torch.cuda.memory_allocated() - base
                torch.cuda.empty_cache()
                held_res = torch.cuda.memory_reserved() - base_res
                # the walks are <= 0.7% of a step: K1's none and hits steps are
                # not profiled again (K3's are phase 16's)
                busy = None if (kernel, remat) in (("auto", "none"), ("auto", "hits")) else (
                    device_split(f"fwd+bwd step, {kernel}, remat={remat}, graphed",
                                 lambda: graphed(pack, 5), card, (name,))["busy"][0])
                row = dict(busy_ms=busy, peak=peaks["graphed"], held=held,
                           held_reserved=held_res, nodes=nodes, capture_s=cap.seconds)
                src = "this phase's"
            else:
                src = "phase 16's"
            graphed.grad.release()
            del cap
            per = 40 if remat == "full" else 20
            launched = {k: v for k, v in launched.items() if v}
            e_ms = float(np.mean(ms["eager"]))
            busy_txt = ("not profiled" if row["busy_ms"] is None
                        else f"{row['busy_ms']:.1f} ms (profiled)")
            out[(kernel, remat)] = dict(
                eager_ms=e_ms, graphed_ms=wall_ms, gap=max(gaps), eager_gap=spread,
                eager_peak=peaks["eager"], **{k: v for k, v in row.items()
                                               if k not in ("eager", "graphed")})
            log(f"grad graph, {kernel}, remat={remat}: seeds 1-3 in turns (eager, graphed): "
                f"loss graphed = eager bit for bit: {loss_equal}; gradients graphed vs eager "
                f"max |d| / max |g| {', '.join(f'{x:.3e}' for x in gaps)}, eager vs eager at "
                f"seed 1 {spread:.3e} (bound: that gap, and 1e-5); captures "
                f"{len(graphed.captures)}; graphed launches {launched} in 3 replays ({per} a "
                f"step), plain calls "
                f"{bvh8.plain_calls - plain[0] + threaded.plain_calls - plain[1]}; eager "
                f"{e_ms:.1f} ms a step (mean of 4), graphed {wall_ms:.1f} ms, one replay ("
                f"{GRAD_LANES / wall_ms * 1e3:.1f} pixel-samples/s against eager "
                f"{GRAD_LANES / e_ms * 1e3:.1f}); peak memory above a call's start: eager "
                f"{peaks['eager'] / 2**30:.3f} GiB, graphed calls "
                f"{peaks['graphed'] / 2**30:.3f} GiB; {src} capture, memory and split: "
                f"{row['capture_s']:.3f} s set-up, {row['nodes']} graph nodes, peak "
                f"{row['peak'] / 2**30:.3f} GiB above its start (capture included), held "
                f"{row['held'] / 2**20:.1f} MiB allocated and {row['held_reserved'] / 2**30:.3f} "
                f"GiB reserved, device busy {busy_txt} a graphed step; "
                f"{time.perf_counter() - t_combo:.1f} s ({card})")
            if not loss_equal:
                raise AssertionError(f"grad graph {kernel} {remat}: the loss differs")
            if not max(gaps) <= min(spread, 1e-5):
                raise AssertionError(f"grad graph {kernel} {remat}: gradients off by "
                                     f"{max(gaps):.3e}, eager vs eager {spread:.3e}")
            if len(graphed.captures) != 1 or launched != {
                    name: 3 * per, "row_gather_bwd": 3 * row_per} or (
                    bvh8.plain_calls, threaded.plain_calls) != plain:
                raise AssertionError(f"grad graph {kernel} {remat}: captures "
                                     f"{len(graphed.captures)}, launches {launched}")
            del eager, graphed
    return out


def unbounded_cached(cache, pins, values, build):
    """render/graphs.py:cached as it stood before its bound: an entry for
    every key, none dropped."""
    key = tuple(id(p) for p in pins) + values
    if key not in cache:
        cache[key] = (pins, build())
    return cache[key][1]


def cache_memory(scene, camera, dev, card):
    """Phase 27: the Renderer's graph cache over renders at k seeds: the
    device memory (allocated; reserved after empty_cache, which keeps the
    live graphs' pools) after k = 1, 2 and 4 rounds of a pool render and a
    batch render at seeds 0..k-1, for "auto" and "wavefront", with the
    cache as it stood before its bound (unbounded, and every graph keyed
    by the seed, as the batch bounce's was: `unbounded_cached` into a
    cache of its own, with the renderer's seed added to each key) and
    with the bounded cache, on one Renderer a kernel.  The bounded cache's
    memory must not grow with k: from k = 1 to 4 by at most 8 MiB
    allocated and 64 MiB reserved, where each further seed adds ~54 MiB
    allocated and ~400-1,500 MiB reserved to the unbounded cache (an
    allocation of ~1 MiB made once after the first render, seen in one
    run, is not growth with k)."""
    from rust_raytracer_torch.render import graphs
    from rust_raytracer_torch.render.renderer import Renderer

    bounded = graphs.cached
    out = {}
    for kernel in ("auto", "wavefront"):
        r = Renderer(scene, camera, batch_size=LANES, kernel=kernel, device=dev)
        for repaired in (False, True):
            old = {}
            if not repaired:
                graphs.cached = lambda cache, pins, values, build: unbounded_cached(
                    old, pins, values + (r.seed,), build)
            try:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
                mem = {}
                for k in range(4):
                    r.seed = k
                    r.render(mode="pool")
                    r.render(mode="batch")
                    if k + 1 in (1, 2, 4):
                        torch.cuda.synchronize()
                        torch.cuda.empty_cache()
                        mem[k + 1] = (torch.cuda.memory_allocated() - base[0],
                                      torch.cuda.memory_reserved() - base[1])
            finally:
                graphs.cached = bounded
            entries = len(r._graphs if repaired else old)
            del old
            tag = "bounded" if repaired else "unbounded, keyed by seed (before the bound)"
            out[(kernel, repaired)] = mem
            log(f"graph cache memory, {kernel}, {tag}: after k renders (pool + batch) at k "
                f"seeds, above the start: " + "; ".join(
                    f"k={k}: {a / 2**20:.1f} MiB allocated, {v / 2**20:.1f} MiB reserved"
                    for k, (a, v) in mem.items()) + f"; {entries} cache entries ({card})")
            if repaired and not (mem[4][0] <= mem[1][0] + 8 * 2**20
                                 and mem[4][1] <= mem[1][1] + 64 * 2**20):
                raise AssertionError(f"the bounded graph cache grew with k: {mem}")
        del r
    return out


# ---------------------------------------------------------------- the batch program

# loop_cond_kernel: any_alive (1 byte), depth (8) and the bounce counter (8)
# read, the flag (1) and the counter (8) written; a compare, an and, an add
LOOP_COND_BYTES, LOOP_COND_OPS = 26, 3


def sky_card_scene(g):
    """A diffuse two-triangle card facing the camera under an open sky
    (tests/test_torch_batch_program.py:sky_scene): every path ends by its
    second bounce, long before max_depth."""
    corners = np.array([[-0.3, -0.3, 0.0], [0.3, -0.3, 0.0], [0.3, 0.3, 0.0], [-0.3, 0.3, 0.0]])
    tris = np.zeros((2, 3, 3), np.int32)
    tris[:, :, 0] = [[0, 1, 2], [0, 2, 3]]
    tris[:, :, 2] = -1
    card = g.Mesh(corners, np.array([[0.0, 0.0, 1.0]]), np.zeros((0, 2)), tris,
                  g.Lambertian(g.Constant((0.2, 0.7, 0.2))))
    sky = g.Sky(g.Constant((0.5, 0.7, 1.0)))
    return g.SceneDef(world=g.Group([card, sky]), lights=[sky], config={})


@contextlib.contextmanager
def calls_counted(cls, name, counter, key):
    """Count the calls of method `cls.name` into counter[key] meanwhile."""
    real = getattr(cls, name)

    def counted(self, *a, **k):
        counter[key] += 1
        return real(self, *a, **k)

    setattr(cls, name, counted)
    try:
        yield
    finally:
        setattr(cls, name, real)


@contextlib.contextmanager
def launches_timed(times):
    """Record a pair of CUDA events on the current stream around each
    graphs.LoopGraph launch meanwhile; append the pairs to `times`.  A
    start event is reached when the stream reaches the launch (after the
    batch before it), so a pair times one batch's graph on the device
    without a host wait."""
    from rust_raytracer_torch.render import graphs

    real = graphs.LoopGraph.launch

    def timed(self):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        real(self)
        t1.record()
        times.append((t0, t1))

    graphs.LoopGraph.launch = timed
    try:
        yield
    finally:
        graphs.LoopGraph.launch = real


def batch_renders(r, tag, card):
    """`r`'s whole batch render eager and graphed in turns (eager, graphed,
    graphed, eager): images bit-equal, K3 launches = bounces each time, and
    on the graphed renders the loop_cond launches = bounces, one loop graph
    launch and one event wait a batch a shard, and no other host sync (the
    second graphed render runs under torch.cuda.set_sync_debug_mode("warn"):
    each synchronising op would warn).  On that render CUDA events around
    each batch's graph launch give the device's time, and its idle share
    of the wall.  Returns a dict of the numbers (the host split from
    BatchMetrics, of the second graphed render)."""
    import warnings

    from rust_raytracer_torch.render import graphs
    from rust_raytracer_torch.render import renderer as rmod

    total = r.camera.image_width * r.camera.image_height * SPP
    secs, imgs, out = {False: [], True: []}, {}, {}
    for k, mode in enumerate((False, True, True, False)):
        r.graph = mode
        m = rmod.BatchMetrics()
        calls = Counter()
        events = []
        before = graphs.launch_counts()
        torch.cuda.synchronize()
        with launches_timed(events), \
                calls_counted(graphs.LoopGraph, "launch", calls, "launch"), \
                calls_counted(rmod.BatchRun, "wait", calls, "wait"), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if k == 2:
                torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                imgs[mode] = r.render(mode="batch", metrics=m).hdr()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        secs[mode].append(time.perf_counter() - t0)
        launched = {n: v - before[n] for n, v in graphs.launch_counts().items() if v != before[n]}
        want = {"threaded_traverse": m.bounces, **{nm: m.bounces for nm in VERTEX_BOUNCE}}
        if mode:
            want["loop_cond"] = m.bounces
        if launched != want:
            raise AssertionError(f"{tag}: launches {launched}, bounces {m.bounces}")
        if k == 2:
            syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
            shards = 1 if r.mesh is None else r.mesh.n_local
            out.update(metrics=m, syncs=len(syncs), launches=calls["launch"],
                       waits=calls["wait"], shards=shards,
                       batch_ms=[a.elapsed_time(b) for a, b in events])
            if syncs or calls["launch"] != m.batches * shards or calls["wait"] != m.batches:
                raise AssertionError(f"{tag}: {calls['launch']} loop graph launches and "
                                     f"{calls['wait']} waits in {m.batches} batches on {shards} "
                                     f"shard(s); host syncs besides: {syncs[:3]}")
    r.graph = True
    n_diff = int((imgs[True] != imgs[False]).any(axis=-1).sum())
    e_s, g_s = float(np.mean(secs[False])), secs[True][1]
    m = out["metrics"]
    device_ms = sum(out["batch_ms"])
    out.update(eager_s=e_s, graphed_s=g_s, first_graphed_s=secs[True][0],
               eager_rate=total / e_s, graphed_rate=total / g_s, n_diff=n_diff,
               batches=m.batches, bounces=m.bounces, img=imgs[True], device_ms=device_ms,
               idle=1 - device_ms / (g_s * 1e3))
    log(f"{tag}: eager {out['eager_rate']:.1f} pixel-samples/s ({e_s:.3f} s, mean of 2), "
        f"graphed {out['graphed_rate']:.1f} ({g_s:.3f} s; the first graphed render "
        f"{secs[True][0]:.3f} s with its capture), {m.batches} batches, {m.bounces} bounces "
        f"({m.bounces / m.batches:.2f} a batch), K3 and loop_cond launches = bounces; a graphed "
        f"batch: {out['launches'] / m.batches:.0f} loop graph launch(es), "
        f"{out['waits'] / m.batches:.0f} event wait, {out['syncs']} other host syncs; host "
        f"{(m.launch_s + m.wait_s + m.sum_s) * 1e3:.1f} ms: launch (start fill, graph launch, "
        f"copies home) {m.launch_s * 1e3:.1f}, wait {m.wait_s * 1e3:.1f}, f64 sum {m.sum_s * 1e3:.1f}; "
        f"device {device_ms:.1f} ms (CUDA events around each batch's graph launch in that "
        f"render: {', '.join(f'{x:.2f}' for x in out['batch_ms'])} ms), idle share "
        f"{out['idle']:.1%} of its wall; {n_diff} pixels not bit-equal ({card})")
    if n_diff:
        raise AssertionError(f"{tag}: the graphed batch render differs from the eager one")
    return out


def batch_program_phase(b_renderer, camera, dev, card, eager_busy_ms):
    """Phase 28: a batch of the batch render as one graph launch
    (render/renderer.py:BatchProgram, render/graphs.py:LoopGraph, the stop
    test csrc/loop_cond.cu).  One LANES-lane batch through the program
    against the eager trace (radiance bit-equal, the device bounce counter
    = the eager bounces = K3 launches), the capture's seconds, graph nodes
    and peak memory; loop_cond's flag against its plain version at every
    bounce, and both timed; the whole cornell_dragon batch render eager
    and graphed in turns (`batch_renders`: the graphed render's device time
    by CUDA events around each batch's launch, and its idle share); the
    graphed render as the profiler records it, beside the eager render's
    profiled kernel time (`eager_busy_ms`, phase 15's); the sky-card scene, whose paths all end by their
    second bounce, both ways.  Returns the numbers for the kernels line."""
    from rust_raytracer_torch.ops import loop_cond, threaded
    from rust_raytracer_torch.render import graphs, integrator
    from rust_raytracer_torch.render.camera import Camera
    from rust_raytracer_torch.render.renderer import BatchProgram, Renderer
    from rust_raytracer_torch.scene import graph as g

    w, h = camera.image_width, camera.image_height
    total = w * h * SPP
    start = (h // 3) * w * SPP
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prog = BatchProgram(b_renderer.pack, b_renderer.static, camera, LANES, 0, total, SPP,
                        "threaded")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    nodes = [dict(graph_nodes(c)) for c in prog.loop.captures]
    k3_nodes = [sum(v for name, v in graph_kernel_names(c).items()
                    if is_kernel(name, "threaded_traverse_kernel"))
                for c in prog.loop.captures]
    prog.start.fill_(start)
    prog.seed.fill_(b_renderer.seed)
    before = graphs.launch_counts()
    prog.run()
    bounces = int(prog.bounces)
    prog.loop.count(bounces)
    launched = {n: v - before[n] for n, v in graphs.launch_counts().items() if v != before[n]}
    got = prog.out.clone()
    b_renderer.graph = False
    first = torch.full((), start, dtype=torch.int64, device=dev)
    _, px, py, smp = integrator.batch_lanes(first, LANES, total, SPP, w)
    stats = {}
    k3 = threaded.launches
    want = b_renderer.trace_batch(px, py, smp, stats)
    k3_eager = threaded.launches - k3
    b_renderer.graph = True
    differ = int((got != want).any(dim=1).sum())
    batch_ms = time_ms(prog.run, 5)
    log(f"batch program: one {LANES}-lane batch from lane {start}: {differ} lanes' radiance not "
        f"bit-equal to the eager trace; device bounce counter {bounces}, eager bounces "
        f"{stats['bounces']}, K3 launches {launched.get('threaded_traverse')} (eager "
        f"{k3_eager}), loop_cond launches {launched.get('loop_cond')}; one launch "
        f"{batch_ms:.3f} ms (CUDA events, mean of 5); build (warm-up, 3 captures, conditional "
        f"graph, instantiate) {prog.loop.seconds:.3f} s, peak memory {peak / 2**20:.1f} MiB "
        f"above its start, held {held / 2**20:.1f} MiB; graph nodes: prologue {nodes[0]}, "
        f"body {nodes[1]} (run once a bounce), epilogue {nodes[2]}; threaded_traverse_kernel "
        f"nodes (prologue, body, epilogue) {tuple(k3_nodes)}, so the graph's K3 launches = "
        f"its bounces ({card})")
    if differ or not (bounces == stats["bounces"] == k3_eager
                      == launched.get("threaded_traverse") == launched.get("loop_cond") > 0):
        raise AssertionError("the batch program differs from the eager trace")
    if k3_nodes != [0, 1, 0]:
        raise AssertionError(f"threaded_traverse_kernel nodes {k3_nodes}, want one in the body")

    # loop_cond against its plain version at every bounce: the stages run
    # eagerly on the card, the kernel launched alone after each body
    flags = []
    with torch.no_grad():
        prog.prologue()
        while True:
            prog.body()
            plain = loop_cond.flag_plain(prog.state.alive, prog.state.depth, DEPTH)
            loop_cond.loop_cond(prog.any_alive, prog.state.depth, prog.flag, prog.bounces, DEPTH)
            flags.append((int(prog.flag), int(plain)))
            if not flags[-1][0]:
                break
        prog.epilogue()
    mismatch = sum(f != p for f, p in flags)
    same = torch.equal(prog.out, got)
    cond_args = (prog.any_alive, prog.state.depth, prog.flag, prog.bounces, DEPTH)
    lc_ms = time_ms(lambda: loop_cond.loop_cond(*cond_args), 1000)
    lc_plain_ms = time_ms(lambda: loop_cond.flag_plain(prog.any_alive, prog.state.depth, DEPTH),
                          1000)
    lc_bound = bound(LOOP_COND_OPS, LOOP_COND_BYTES)
    log(f"loop_cond: flag vs plain alive.any() & (depth < {DEPTH}) at each of {len(flags)} "
        f"bounces: {mismatch} differ; eager stages + kernel radiance equal to the graph's: "
        f"{same}; kernel {lc_ms * 1e3:.2f} us a launch, plain {lc_plain_ms * 1e3:.2f} us "
        f"(CUDA events, mean of 1000), bound {lc_bound[0] * 1e6:.3f} ns by {lc_bound[1]} "
        f"({card})")
    if mismatch or len(flags) != bounces or not same:
        raise AssertionError("loop_cond disagrees with its plain version")
    del prog, got, want

    out = {"loop_cond": dict(max_abs_err=float(mismatch), ms=lc_ms, plain_ms=lc_plain_ms,
                             bound=lc_bound)}
    out["dragon"] = d = batch_renders(b_renderer, f"batch program render: cornell_dragon "
                                      f"{W}x{h}@{SPP}spp depth {DEPTH}, batches of {LANES}", card)
    # the profiler sees none, some or all of the body's launches (PERF.md
    # §7): a reading, not a check; the graph's K3 node count and bounce
    # counter above are the check
    seen = device_split("batch program render, graphed, as the profiler records it",
                        lambda: b_renderer.render(mode="batch"), card,
                        ("threaded_traverse", "loop_cond"), required=False)
    log(f"batch program render: idle share {d['idle']:.1%} (device {d['device_ms']:.1f} ms by "
        f"CUDA events around each batch's graph launch, over the graphed render's wall "
        f"{d['graphed_s'] * 1e3:.1f} ms); eager render's profiled kernel time "
        f"{eager_busy_ms:.1f} ms (phase 15); profiled graphed render: "
        f"{seen['threaded_traverse'][1]} K3 and {seen['loop_cond'][1]} loop_cond launches seen "
        f"of {d['bounces']}, device busy {seen['busy'][0]:.1f} ms by the profiler's count in "
        f"{seen['busy'][1]:.1f} ms profiled wall; host per "
        f"batch: launch {d['metrics'].launch_s * 1e3 / d['batches']:.2f} ms, wait "
        f"{d['metrics'].wait_s * 1e3 / d['batches']:.2f} ms, f64 sum "
        f"{d['metrics'].sum_s * 1e3 / d['batches']:.2f} ms ({card})")
    d.update(busy_ms=eager_busy_ms, profiled_busy_ms=seen["busy"][0])

    sky_cam = Camera(image_width=W, aspect_ratio=1.0, samples_per_pixel=SPP, max_depth=DEPTH,
                     position=(0.0, 0.0, 1.6), look_at=(0.0, 0.0, 0.0), focal_length=35.0)
    sky = Renderer(sky_card_scene(g), sky_cam, batch_size=LANES, kernel="threaded", device=dev)
    out["sky"] = s = batch_renders(sky, f"batch program render, early-ending scene (a card "
                                   f"under the sky): {W}x{W}@{SPP}spp depth {DEPTH}, batches of "
                                   f"{LANES}", card)
    if not s["bounces"] < s["batches"] * DEPTH or not np.isfinite(s["img"]).all():
        raise AssertionError("the sky-card scene's paths did not end early")
    del sky
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs a CUDA GPU")
    sys.path.insert(0, HERE)
    from rust_raytracer_torch import models, native
    from rust_raytracer_torch.core import rng as vrng
    from rust_raytracer_torch.models import builtin
    from rust_raytracer_torch.ops import bvh8, loop_cond, threaded, vertex
    from rust_raytracer_torch.ops import wavefront as wf
    from rust_raytracer_torch.render import integrator
    from rust_raytracer_torch.render.camera import camera_from_config
    from rust_raytracer_torch.render.renderer import BatchMetrics, Renderer
    from rust_raytracer_torch.scene import compiler
    from rust_raytracer_torch.scene import graph as g
    from rust_raytracer_torch.utils import config as cfg
    from rust_raytracer_torch.utils import procgen
    from rust_raytracer_torch.utils.metrics import RenderMetrics

    dev = torch.device("cuda:0")
    start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- 1. build the kernel library from the checkout's sources ----
    t0 = time.perf_counter()
    lib = bvh8.build_library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(lib, HERE)}")
    from rust_raytracer_torch.ops import _cuda
    for name in ("bvh8_traverse", "threaded_traverse", "wf_cull", "wf_cull_compact", "wf_mt",
                 "loop_cond"):
        a = _cuda.attributes("rrt_" + name)
        log(f"{name}_kernel: {a['registers']} registers, {a['local_bytes']} local bytes "
            f"(stack frame and spills), {a['shared_bytes']} static shared bytes a thread block")
        if name.startswith("wf_cull") and a["local_bytes"]:
            raise AssertionError(f"{name}_kernel spills: {a['local_bytes']} local bytes")
    for name, a in vertex.attributes().items():
        held = "; the texture closure's values" if name == "vertex_shade" else ""
        log(f"{name}_kernel: {a['registers']} registers, {a['local_bytes']} local bytes "
            f"(stack frame and spills{held}), {a['shared_bytes']} static shared bytes a "
            f"thread block")
    sass = {}
    for name, ops in (("wf_cull", SLAB_OPS), ("wf_cull_compact", SLAB_OPS), ("wf_mt", MT_OPS)):
        sass[name] = per = loop_per_test(sass_loops(lib, name + "_kernel"), name)
        if per is None:
            log(f"{name}_kernel SASS: not read (no cuobjdump, or no inner loop found)")
        else:
            log(f"{name}_kernel SASS inner loop: {per[0]:.2f} instructions a test on its hot "
                f"path ({per[1]} hot of {per[2]} static instructions, {per[3]} tests a pass), "
                f"{per[4]:.1f} min/max a test; the bound counts {ops} operations a test")
    # wf_mt's reciprocal (rcp_fast) against __frcp_rn on every float in its range
    rcp = torch.zeros(2, dtype=torch.int64, device=dev)
    _cuda.launch("rrt_wf_mt_rcp_check", (rcp,), (), dev)
    differ, checked = rcp.tolist()
    if differ or checked != 2 * 252 * (1 << 23):
        raise AssertionError(f"rcp_fast differs from __frcp_rn on {differ} of {checked} floats")
    log(f"wf_mt reciprocal: equal to __frcp_rn bit for bit on all {checked} floats with "
        f"2^-126 <= |x| < 2^126")

    # the RNG's int64 arithmetic on the card equals the CPU's bit for bit
    q = np.random.default_rng(1).integers(0, 2**32, size=(4, 4096), dtype=np.int64)
    q[:, :4] = np.array([0, 2**31, 2**32 - 1, 2**32 - 128])[None]
    cpu_bits = vrng.random_bits4(*(torch.from_numpy(x) for x in q))
    gpu_bits = vrng.random_bits4(*(torch.from_numpy(x).to(dev) for x in q))
    for on_cpu, on_gpu in zip(cpu_bits, gpu_bits):
        if not torch.equal(on_cpu, on_gpu.cpu()):
            raise AssertionError("pcg4d on the card differs from the CPU")
    log("rng: pcg4d on the card equals the CPU bit for bit")

    # ---- 2. the full cornell_dragon scene on the card ----
    t0 = time.perf_counter()
    scene = models.build("cornell_dragon")
    scene_config = cfg.merge_scene_config(scene.config, {"output_width": W})
    camera = camera_from_config(
        scene_config, cfg.RenderConfig(samples_per_pixel=SPP, max_depth=DEPTH))
    pack, static = compiler.compile_scene(scene, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_slots = int(pack.tri_v0.shape[0])
    n_tris = int((pack.tri_rows[:, 3:9] != 0).any(dim=1).sum())
    log(f"scene cornell_dragon: {n_tris} triangles in {n_slots} slots, "
        f"{pack.tri_rows.shape[0] // 128} clusters, n8 {pack.bvh8_child.shape[0]}, "
        f"BVH8 depth {pack.bvh8_depth}, build {build_s:.2f} s, "
        f"native SAH builder: {native.available()}")

    # ---- 3. kernel against its plain version at the pool width, then both
    # timed on the same rays ----
    org, dirn = make_rays(camera, LANES, dev)
    err_p, _, _, (t_k, i_k) = compare(pack, org, dirn, "primary")
    org2, dirn2 = bounce_rays(org, dirn, t_k, i_k)
    err_b, _, _, (t_b, i_b) = compare(pack, org2, dirn2, "bounce")
    # t_max as the pool passes it: +inf (no sphere or plane in the way), 0
    # (dead lane), capped short of the triangle hit; 3.4e38 as bench.py's
    lane = torch.arange(LANES, device=dev)
    inf = torch.full_like(t_b, float("inf"))
    cap = torch.where(lane % 4 == 0, inf, torch.full_like(t_b, 3.4e38))
    cap = torch.where(lane % 4 == 1, torch.zeros_like(t_b), cap)
    cap = torch.where(lane % 4 == 3, torch.where(i_b >= 0, t_b * 0.5, inf), cap)
    err_c, _, _, (_, i_c) = compare(pack, org2, dirn2, "bounce +inf/capped/dead", cap)
    if (i_c[lane % 4 == 1] >= 0).any() or (i_c[lane % 4 == 3] >= 0).any():
        raise AssertionError("a dead or capped ray reported a hit beyond its t_max")
    if not torch.equal(i_c[lane % 4 == 0] >= 0, i_b[lane % 4 == 0] >= 0):
        raise AssertionError("t_max = +inf and 3.4e38 give different hits")
    max_err = max(err_p, err_b, err_c)

    t_max = torch.full((LANES,), 3.4e38, dtype=torch.float32, device=dev)
    times = {}
    for tag, (o, d) in (("primary", (org, dirn)), ("bounce", (org2, dirn2))):
        times[tag] = (
            time_ms(lambda: bvh8.intersect_triangles_bvh8(pack, o, d, None, t_max)),
            time_ms(lambda: bvh8.traverse_plain(pack, o, d, t_max), PLAIN_REPS),
        )
        log(f"time {tag} rays x{LANES}: kernel {times[tag][0]:.3f} ms, plain "
            f"{times[tag][1]:.3f} ms (CUDA events, mean of {KERNEL_REPS} / plain "
            f"{PLAIN_REPS} calls; {card})")
    # the BVH8 walk's own counts on the timed rays, for its bound; the
    # counting walk in torch ops must give the kernel's (t, slot), and its
    # leaf visits and groups tested the kernel's own counter
    k1_bounds = {}
    for tag, (o, d) in (("primary", (org, dirn)), ("bounce", (org2, dirn2))):
        t_w, i_w, k1_counts = bvh8_walk(pack, o, d, t_max)
        kernel_counts = torch.zeros(2, dtype=torch.int64, device=dev)
        hold(f"BVH8 counting walk, {tag}", (t_w, i_w), bvh8.intersect_triangles_bvh8(
            pack, o, d, None, t_max, kernel_counts), t_max, exact_slots=True)
        walk_counts = [k1_counts["leaf_visits"], k1_counts["groups"]]
        if kernel_counts.tolist() != walk_counts:
            raise AssertionError(f"{tag}: K1's counter {kernel_counts.tolist()} != the walk's "
                                 f"leaf visits and groups {walk_counts}")
        k1_bounds[tag] = b_ms, b_by = bvh8_bound(pack, LANES, k1_counts)
        log(f"BVH8 walk counts, {tag} rays x{LANES} (the torch-ops walk equals the kernel, "
            f"slots included; its leaf visits and groups equal K1's counter): kernel "
            f"{times[tag][0]:.3f} ms, internal node visits {k1_counts['node_visits']}, distinct "
            f"nodes {k1_counts['nodes']}, distinct clusters {k1_counts['clusters']}, "
            f"{leaf_work(k1_counts, LANES)}; bound {b_ms:.4f} ms by {b_by} "
            f"({b_ms / times[tag][0]:.2%} of the kernel's time)")
    k1_bound = k1_bounds["bounce"]
    del pack

    # ---- 4. a small render on the card agrees with the same on the CPU ----
    small_cfg = cfg.merge_scene_config(scene.config, {"output_width": 32})
    small_cam = camera_from_config(small_cfg, cfg.RenderConfig(samples_per_pixel=4, max_depth=8))
    mat_white, walls = builtin._cornell_shell()
    mat_gloss = g.Glossy(g.Constant((0.73, 0.73, 0.73)), g.Constant(0.0), 1.5)
    light = g.Plane((277.5, 554.9, 277.5), (-130, 0, 0), (0, 0, -105),
                    g.Emissive(g.Constant((15.0, 15.0, 15.0))), render_backface=True)
    knot = g.Transform(procgen.torus_knot_mesh(mat_gloss, rings=40, segments=12))
    knot.scale(110).rotate_y(225).translate(267.5, 200.0, 277.5)
    mini = g.SceneDef(
        world=g.Group([g.Plane((277.5, 0, 277.5), (277.5, 0, 0), (0, 0, -277.5), mat_white)]
                      + walls + [light, knot]),
        lights=[light], config=dict(scene.config))
    imgs = [Renderer(mini, small_cam, batch_size=1024, device=d).render().hdr()
            for d in (dev, "cpu")]
    rel = np.abs(imgs[0] - imgs[1]).mean() / imgs[1].mean()
    close = np.isclose(imgs[0], imgs[1], rtol=1e-3, atol=1e-4).mean()
    log(f"small render card vs cpu: mean |d|/mean {rel:.3e}, pixels close {close:.4f}")
    if not (rel <= 1e-3 and close >= 0.995):
        raise AssertionError("the card's render disagrees with the CPU's")

    # ---- 5. the main path: full-width pool render through the kernel ----
    renderer = Renderer(scene, camera, batch_size=LANES, kernel="auto", device=dev)
    metrics = RenderMetrics()
    torch.cuda.synchronize()
    bvh8.launches = 0
    bvh8.plain_calls = 0
    reset_vertex()
    t0 = time.perf_counter()
    film = renderer.render(mode="pool", metrics=metrics)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches, plain_calls = bvh8.launches, bvh8.plain_calls
    v_launches = dict(vertex.launches)
    if not (launches > 0 and launches == metrics.steps and plain_calls == 0
            and v_launches == vertex_want(metrics.steps)
            and not any(vertex.plain_calls.values())):
        raise AssertionError(
            f"main path: {launches} kernel launches, {metrics.steps} pool steps, "
            f"{plain_calls} plain calls; {vertex_route()}")
    hdr = check_image(film, camera)
    h = camera.image_height
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    film.save(os.path.join(HERE, "build", "chip_smoke_cornell_dragon.png"))
    total = W * h * SPP
    log(f"main path: cornell_dragon {W}x{h}@{SPP}spp depth {DEPTH}, {LANES} lanes, graphed "
        f"step (its capture included): {total / render_s:.1f} pixel-samples/s ({render_s:.3f} s), "
        f"{metrics.steps} steps, mean occupancy {occupancy(metrics):.4f}, "
        f"kernel launches {launches}; {vertex_route()} ({card})")

    # ---- 6. the kernel against its plain version on every pool step's own
    # inputs ----
    max_err = max(max_err, pool_step_parity(renderer))

    # ---- 7. where a steady pool step's device time goes ----
    step_split(renderer, camera, card, ("bvh8_traverse",) + VERTEX_POOL)
    split = device_split("BVH8 pool render", lambda: renderer.render(mode="pool"), card,
                         ("bvh8_traverse",) + VERTEX_POOL)

    # ---- 8. wavefront: each kernel against its plain version, and the
    # pipeline against the BVH8 kernel, on the traversal inputs of a
    # kernel="wavefront" render at its first, a mid-render and a drain step ----
    wf_renderer = Renderer(scene, camera, batch_size=LANES, kernel="wavefront", device=dev)
    wpack = wf_renderer.pack
    for name in wf.KERNELS:
        wf.launches[name] = 0
    log(f"wavefront tables: {wpack.wf_cl_lo.shape[0]} clusters, "
        f"{wpack.wf_sn_lo.shape[0]} supernodes, K1 {wf.K1}, KC {wf.KC}, "
        f"cap {wf.PAIRS_PER_PACKET_CAP}")
    recorded = record_steps(wf_renderer, wf, "intersect_triangles_wavefront")
    picks, live = pick_steps(recorded)
    log(f"recorded {len(recorded)} wavefront pool steps; live lane share per step: "
        + " ".join(f"{x:.3f}" for x in live))
    stage = {}
    for tag, k in picks:
        stage[tag] = wf_stage_parity(wpack, *recorded[k], f"{tag} (step {k + 1})")
    # the pool's first rays cover the top image rows, which hold no
    # triangle: also primary rays over the whole image, in the pool's
    # compaction order, with t_max = +inf
    org, dirn = make_rays(camera, LANES, dev)
    alive = torch.ones((LANES,), dtype=torch.bool, device=dev)
    perm = torch.sort(integrator._compaction_key(org, dirn, alive), stable=True).indices
    stage["primary"] = wf_stage_parity(
        wpack, org[perm].contiguous(), dirn[perm].contiguous(),
        torch.full((LANES,), float("inf"), device=dev), "primary (whole image)")
    mid = recorded[picks[1][1]]
    del recorded

    # ---- 9. the dense single-level pipeline on 2^15 lanes of the mid step
    # (cornell_dragon's dispatch takes the two-level one) ----
    n_dense = 1 << 15
    dense_err = dense_parity(wpack, *(a[:n_dense].contiguous() for a in mid))

    # ---- 10. each wavefront kernel's time against its plain version's ----
    wf_time, wf_bounds, (cl, cnt, _, _, tm, _), wf_peaks = wf_times(wpack, *mid, card)

    # ---- 10b. K2a and K2c on adversarial inputs, and how many of the mid
    # step's listed (ray, cluster) pairs hit the cluster's box themselves ----
    t0 = time.perf_counter()
    adv_err = wf_adversarial(wpack, mid[0], mid[1], cl, cnt, tm, dev, card)
    box_hits, pairs = listed_box_hits(wpack, cl, cnt, mid[0], mid[1], tm)
    log(f"wavefront listed pairs, mid-render step: {pairs} (ray, cluster) pairs tested by MT, "
        f"{box_hits} ({box_hits / max(pairs, 1):.2%}) pass the ray's own slab test against the "
        f"cluster's box; the rest are tested because a packet-mate's box test hit (phase "
        f"{time.perf_counter() - t0:.1f} s)")
    del mid, cl, cnt, tm
    # the launches of phases 8-10b, where alone the standalone cull and
    # compact run; reported apart from the main path's
    parity_launches = dict(wf.launches)

    # ---- 11. the wavefront main path ----
    wf_metrics = RenderMetrics()
    torch.cuda.synchronize()
    bvh8.launches, bvh8.plain_calls = 0, 0
    for name in wf.KERNELS:
        wf.launches[name], wf.plain_calls[name] = 0, 0
    reset_vertex()
    t0 = time.perf_counter()
    wf_film = wf_renderer.render(mode="pool", metrics=wf_metrics)
    torch.cuda.synchronize()
    wf_render_s = time.perf_counter() - t0
    wf_launches = dict(wf.launches)
    want = {"wf_cull_compact": wf_metrics.steps, "wf_cull": 0, "wf_compact": 0,
            "wf_mt": wf_metrics.steps}
    wf_v_launches = dict(vertex.launches)
    if not (wf_metrics.steps > 0 and wf_launches == want
            and bvh8.launches == 0 and bvh8.plain_calls == 0
            and not any(wf.plain_calls.values())
            and wf_v_launches == vertex_want(wf_metrics.steps)
            and not any(vertex.plain_calls.values())):
        raise AssertionError(
            f"wavefront main path: launches {wf_launches}, {wf_metrics.steps} pool steps, "
            f"plain calls {wf.plain_calls}, BVH8 launches {bvh8.launches}, "
            f"BVH8 plain calls {bvh8.plain_calls}")
    wf_hdr = check_image(wf_film, camera)
    wf_film.save(os.path.join(HERE, "build", "chip_smoke_cornell_dragon_wavefront.png"))
    ov_frac = wf_metrics.wf_overflow_packets / wf_metrics.wf_total_packets
    log(f"wavefront main path: cornell_dragon {W}x{h}@{SPP}spp depth {DEPTH}, {LANES} "
        f"lanes: {total / wf_render_s:.1f} pixel-samples/s ({wf_render_s:.3f} s; BVH8 "
        f"path above {total / render_s:.1f}), {wf_metrics.steps} steps, mean occupancy "
        f"{occupancy(wf_metrics):.4f}, launches {wf_launches}, overflow "
        f"{wf_metrics.wf_overflow_packets}/{wf_metrics.wf_total_packets} packets "
        f"({ov_frac:.4%}); {vertex_route()} ({card})")
    agree, rel = image_agreement(wf_hdr, hdr)
    log(f"wavefront image vs BVH8 image: pixel agreement {agree:.6f}, "
        f"mean |d|/mean {rel:.3e}")
    if not (agree >= 0.99 and rel <= 1e-2):
        raise AssertionError("the wavefront render disagrees with the BVH8 render")

    # ---- 12. where a steady wavefront pool step's device time goes ----
    step_split(wf_renderer, camera, card, ("wf_cull_compact", "wf_mt") + VERTEX_POOL)
    split.update(device_split("wavefront pool render", lambda: wf_renderer.render(mode="pool"),
                              card, ("wf_cull_compact", "wf_mt"),
                              absent=("wf_cull", "wf_compact")))

    # ---- 13. the threaded walk (K3) against its plain version and the BVH8
    # kernel on 2^18 sorted primary, bounce and capped/dead rays ----
    tpack = renderer.pack
    k3_err, k3_cases = threaded_parity(tpack, camera, dev)

    # ---- 14. K3's time against its plain version's and the BVH8 kernel's ----
    k3_time = threaded_times(tpack, k3_cases, card)
    del k3_cases

    # ---- 15. the batch render at full width through K3 ----
    b_renderer = Renderer(scene, camera, batch_size=LANES, kernel="threaded", device=dev)
    b_metrics = BatchMetrics()
    torch.cuda.synchronize()
    threaded.launches = threaded.plain_calls = bvh8.launches = bvh8.plain_calls = 0
    loop_cond.launches = loop_cond.plain_calls = 0
    for name in wf.KERNELS:
        wf.launches[name], wf.plain_calls[name] = 0, 0
    reset_vertex()
    t0 = time.perf_counter()
    b_film = b_renderer.render(mode="batch", metrics=b_metrics)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    k3_launches, lc_launches = threaded.launches, loop_cond.launches
    b_v_launches = dict(vertex.launches)
    if b_v_launches != vertex_want(b_metrics.bounces, VERTEX_BOUNCE) \
            or any(vertex.plain_calls.values()):
        raise AssertionError(f"batch path: {b_metrics.bounces} bounces; {vertex_route()}")
    if not (k3_launches == b_metrics.bounces == lc_launches > 0 and threaded.plain_calls == 0
            and loop_cond.plain_calls == 0
            and bvh8.launches == bvh8.plain_calls == 0 and not any(wf.launches.values())
            and not any(wf.plain_calls.values())):
        raise AssertionError(
            f"batch path: K3 launches {k3_launches}, bounces {b_metrics.bounces}, plain calls "
            f"{threaded.plain_calls}, BVH8 launches {bvh8.launches}, wavefront launches "
            f"{wf.launches}")
    b_hdr = check_image(b_film, camera)
    b_film.save(os.path.join(HERE, "build", "chip_smoke_cornell_dragon_batch.png"))
    log(f"batch path: cornell_dragon {W}x{h}@{SPP}spp depth {DEPTH}, batches of {LANES}: "
        f"{total / batch_s:.1f} pixel-samples/s ({batch_s:.3f} s; BVH8 pool render above "
        f"{total / render_s:.1f}), {b_metrics.batches} batches, {b_metrics.bounces} bounces, "
        f"K3 launches {k3_launches}, loop_cond launches {lc_launches} (one graph launch a "
        f"batch, its capture included), plain calls 0, BVH8 and wavefront launches 0; "
        f"{vertex_route()} ({card})")
    agree, rel = image_agreement(b_hdr, hdr)
    log(f"batch image vs BVH8 pool image: pixel agreement {agree:.6f}, mean |d|/mean {rel:.3e}")
    if not (agree >= 0.999 and rel <= 1e-3):
        raise AssertionError("the batch render disagrees with the BVH8 pool render")
    del b_film, b_hdr
    # profiled eagerly, the graph's kernels one by one: the profiler's
    # record of a conditional graph node's body is not complete in every
    # run (phase 28)
    def eager_batch_render():
        b_renderer.graph = False
        try:
            b_renderer.render(mode="batch")
        finally:
            b_renderer.graph = True

    b_split = device_split("batch render (K3), eager", eager_batch_render, card,
                           ("threaded_traverse",))
    k3_split = {"batch render": b_split["threaded_traverse"]}
    if k3_split["batch render"][1] != b_metrics.bounces:
        raise AssertionError(f"the profiler saw {k3_split['batch render'][1]} K3 launches in "
                             f"{b_metrics.bounces} bounces")

    # ---- 16. the fwd+bwd step (bench.py's bench_backward) through K3,
    # graphed (render/graphs.py:GraphedGrad): 2^15 lanes, depth 20,
    # gradients of every float table ----
    grads, kept = {}, {}
    for remat in ("none", "hits"):
        eager, step = grad_steps(renderer.static, camera, remat, "threaded")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base, base_res = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        threaded.launches = threaded.plain_calls = 0
        reset_vertex()
        t0 = time.perf_counter()
        grads[remat] = step(tpack, 0)[1]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for r in range(3):
            step(tpack, r + 1)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / 3
        peak = torch.cuda.max_memory_allocated() - base
        held = torch.cuda.memory_allocated() - base
        torch.cuda.empty_cache()
        held_res = torch.cuda.memory_reserved() - base_res
        cap = the_capture(step.grad)
        nodes = graph_nodes(cap.graph)
        if not (threaded.launches == 4 * 20 and threaded.plain_calls == 0
                and set(cap.launched) == {"threaded_traverse", "row_gather_bwd"}
                and cap.launched["threaded_traverse"] == 20
                and 0 < cap.launched["row_gather_bwd"] <= 20 * GATHERS_A_BOUNCE
                and not any(vertex.launches.values())):
            raise AssertionError(f"fwd+bwd {remat}: K3 launches {threaded.launches} in 4 "
                                 f"replays, plain calls {threaded.plain_calls}, a capture's "
                                 f"{cap.launched}")
        log(f"fwd+bwd remat={remat}, graphed: cornell_dragon, {GRAD_LANES} lanes, depth "
            f"{DEPTH}, {len(grads[remat])} float tables: {GRAD_LANES / step_s:.1f} "
            f"pixel-samples/s ({step_s * 1e3:.1f} ms a step, one replay, mean of 3 after the "
            f"first; the first {first_s:.3f} s with its capture, {cap.seconds:.3f} s set-up), "
            f"graph nodes {dict(nodes)} ({sum(nodes.values())} in all), peak memory above "
            f"the start {peak / 2**30:.3f} GiB ({peak} bytes, capture included), held after "
            f"the calls {held / 2**20:.1f} MiB allocated (the static gradients and the "
            f"first call's), {held_res / 2**30:.3f} GiB reserved (the graph's pool), K3 "
            f"launches {threaded.launches} in 4 replays, plain calls 0; the vertex in torch ops "
            f"(autograd), {vertex_route()} ({card})")
        split16 = device_split(f"fwd+bwd step, remat={remat}, graphed", lambda: step(tpack, 4),
                               card, ("threaded_traverse",))
        k3_split[f"fwd+bwd step ({remat})"] = split16["threaded_traverse"]
        # phase 26 replays this capture at seeds 1-3 against the eager step
        kept[("threaded", remat)] = dict(
            eager=eager, graphed=step, busy_ms=split16["busy"][0], peak=peak, held=held,
            held_reserved=held_res, nodes=sum(nodes.values()), capture_s=cap.seconds)
        del step, cap
    g0 = grads["none"]
    bad = [f for f, gr in g0.items() if not bool(torch.isfinite(gr).all())]
    if bad:
        raise AssertionError(f"non-finite gradients: {bad}")
    if not g0["tex_const"].abs().max() > 0:
        raise AssertionError("the gradient of tex_const is zero")
    remat_gap = grad_gap(grads["hits"], g0)
    g_auto = grad_steps(renderer.static, camera, "none", "auto")[0](tpack, 0)[1]
    auto_gap = grad_gap(g_auto, g0)
    used = sum(int(gr.numel() > 0 and gr.abs().max() > 0) for gr in g0.values())
    log(f"fwd+bwd gradients: all finite, {used} of {len(g0)} tables nonzero, |tex_const| max "
        f"{float(g0['tex_const'].abs().max()):.4e}; remat hits vs none (graphed): max |d| / "
        f"max |g| {remat_gap:.3e} (bound 1e-5); kernel auto (BVH8, eager) vs threaded: "
        f"{auto_gap:.3e} (bound 1e-3)")
    if not remat_gap <= 1e-5:
        raise AssertionError("remat 'hits' and 'none' give different gradients")
    if not auto_gap <= 1e-3:
        raise AssertionError("the BVH8 walk's gradients differ from K3's")
    del grads, g0, g_auto

    # ---- 17. small gradients on the card against the same on the CPU: the
    # scene of tests/_grad_fd_main.py (spheres and planes), then the
    # cornell_dragon shell around a small knot seen from close by (K3) ----
    from rust_raytracer_torch.render.camera import Camera

    probe_cam = Camera(image_width=16, aspect_ratio=1.0, samples_per_pixel=1, max_depth=3,
                       position=(0, 0.3, 1.6), look_at=(0, 0, 0), focal_length=35.0)
    knot_cam = Camera(image_width=16, aspect_ratio=1.0, samples_per_pixel=1, max_depth=3,
                      position=tuple(scene.config["camera_pos"]),
                      look_at=(267.5, 200.0, 277.5), focal_length=120.0)
    probes = (("_grad_fd_main scene", probe_scene(), probe_cam,
               ("sph_center", "sph_radius", "pln_corner", "background", "tex_const")),
              ("small cornell_dragon", mini, knot_cam, ("tri_attr", "pln_corner", "tex_const")))
    for tag, pscene, pcam, fields in probes:
        threaded.launches = 0
        on_card = probe_grads(pscene, pcam, fields, dev)
        card_launches = threaded.launches
        on_cpu = probe_grads(pscene, pcam, fields, torch.device("cpu"))
        cpu_gap = grad_gap(on_card, on_cpu)
        log(f"probe gradients card vs cpu, {tag} (16x16, depth 3, K3 launches "
            f"{card_launches}): max |d| / max |g| {cpu_gap:.3e} (bound 1e-4)")
        if not cpu_gap <= 1e-4:
            raise AssertionError(f"{tag}: the card's gradients disagree with the CPU's")
    if card_launches == 0:
        raise AssertionError("the small cornell_dragon gradient launched no K3 kernel")

    # ---- 18-21. volumes, the CLI (this slice's main path) and
    # checkpoint/resume on the card ----
    cli_launches = cli_volume_resume_phases(scene, camera, renderer, dev, card)

    # ---- 22. the f64 validation dtype on the card ----
    f64_phase(dev, card)

    # ---- 23. the mesh on the card, through every kernel (this slice's
    # main path: each sharded path's launches counted from 0) ----
    sharded = mesh_phase(renderer, wf_renderer, b_renderer, camera,
                         wf_metrics.wf_overflow_packets, dev, card)

    # ---- 24. the sharded checkpoint on the card ----
    sharded_checkpoint(renderer.pack, renderer.static, camera, dev, card)

    # ---- 25. the pool step as a CUDA graph against the eager step ----
    graph_phase(renderer, wf_renderer, camera, dev, card)

    # ---- 26. the fwd+bwd step as one CUDA graph against the eager step ----
    grad_graph_phase(tpack, renderer.static, camera, card, kept)
    del kept

    # ---- 27. the Renderer's graph cache does not grow with the seeds ----
    cache_memory(scene, camera, dev, card)

    # ---- 28. a batch of the batch render as one graph launch, its bounce
    # loop stopped on the card ----
    program = batch_program_phase(b_renderer, camera, dev, card, b_split["busy"][0])

    # ---- 29. the path vertex kernels against their plain versions on the
    # recorded pool-step inputs (first, mid and drain steps, BVH8 and
    # wavefront), the fog scene, a sky and sun, every texture node; and
    # timed against them ----
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import vertex_parity

    t0 = time.perf_counter()
    v_rep, v_time = vertex_parity.run(card, dragon=scene, bvh8_renderer=renderer,
                                      wf_renderer=wf_renderer)
    log(f"vertex parity phase: {time.perf_counter() - t0:.1f} s")

    # ---- 30. the row gathers' backward against a float64 index_add_, its
    # bits over two runs and in a graph, one dragon_grad step graphed
    # against eager, and its times beside its bound and index_put_ ----
    import gather_check

    t0 = time.perf_counter()
    row_entry = gather_check.run(card)
    log(f"row gather phase: {time.perf_counter() - t0:.1f} s")

    # ---- 31. the free-flight kernel against merge_volumes on recorded and
    # random sets (every boundary kind), a graph replay against the eager
    # call, and its time beside its bound and the plain version ----
    import free_flight_check

    t0 = time.perf_counter()
    free_flight_check.run(card)
    log(f"free flight phase: {time.perf_counter() - t0:.1f} s")

    if "jax" in sys.modules and sys.modules["jax"] is not None:
        raise AssertionError("jax was imported")
    loaded = [m for m in sys.modules if m.split(".")[0] == "rust_raytracer_tpu"]
    if loaded:
        raise AssertionError(f"modules of the JAX package were imported: {loaded}")
    # step 2's redesign order: each kernel's measured device time over one
    # main-path run, less its launches times its bound at 2^18 rays
    excess = [("K1 bvh8_traverse, BVH8 pool render", *split["bvh8_traverse"], k1_bound[0])]
    excess += [(f"{k} {nm}, wavefront pool render", *split[nm], wf_bounds[nm][0])
               for k, nm in (("K2a+K2b", "wf_cull_compact"), ("K2c", "wf_mt"))]
    excess += [(f"K3 threaded_traverse, {tag}", *v, k3_time["bounce"][3])
               for tag, v in k3_split.items()]
    excess.sort(key=lambda x: -(x[1] - x[2] * x[3]))
    log("redesign order, by measured device ms a main-path run less launches x bound: "
        + "; ".join(f"{tag} {ms:.1f} - {n} x {b:.4f} = {ms - n * b:.1f} ms"
                    for tag, ms, n, b in excess) + f" ({card})")
    wf_err = {"wf_cull_compact": 0, "wf_cull": 0, "wf_compact": 0,
              "wf_mt": max([dense_err, adv_err] + [st["mt_err"] for st in stage.values()])}
    pwf = "rust_raytracer_tpu/ops/pallas_wavefront.py"
    # launches: the main path's (phase 11; 0 for the standalone cull and
    # compact); parity_launches: phases 8-10b's
    wf_json = {
        "wf_cull_compact": dict(source="wf_cull.cu", replaces=302, replaces_also=f"{pwf}:386",
                                render_device_ms=split["wf_cull_compact"][0],
                                unfused_ms=wf_time["cull+compact"][0],
                                peak_bytes=wf_peaks),
        "wf_cull": dict(source="wf_cull.cu", replaces=302, render_device_ms=None),
        "wf_compact": dict(source="wf_compact.cu", replaces=386, render_device_ms=None),
        "wf_mt": dict(source="wf_mt.cu", replaces=108, render_device_ms=split["wf_mt"][0]),
    }
    log(f"smoke run: {time.perf_counter() - start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "bvh8_traverse",
        "route": "cuda",
        "source": "rust_raytracer_torch/csrc/bvh8_traverse.cu",
        "replaces": "rust_raytracer_tpu/ops/pallas_bvh8.py:63",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["bounce"][0],
        "plain_ms": times["bounce"][1],
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": None,
        "ms_primary": times["primary"][0],
        "plain_ms_primary": times["primary"][1],
        "render_device_ms": split["bvh8_traverse"][0],
        "cli_launches": cli_launches["bvh8_traverse"],
        "sharded_launches": sharded.get("bvh8_traverse", 0),
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"rust_raytracer_torch/csrc/{e['source']}",
        "replaces": f"{pwf}:{e['replaces']}",
        "launches": wf_launches[name],
        "max_abs_err": wf_err[name],
        "ms": wf_time[name][0],
        "plain_ms": wf_time[name][1],
        "bound_ms": wf_bounds[name][0],
        "bound_by": wf_bounds[name][1],
        "library_ms": None,
        "parity_launches": parity_launches[name],
        "sharded_launches": sharded.get(name, 0),
        **{key: v for key, v in e.items() if key not in ("source", "replaces")},
    } for name, e in wf_json.items()] + [{
        "name": "threaded_traverse",
        "route": "cuda",
        "source": "rust_raytracer_torch/csrc/threaded_traverse.cu",
        "replaces": "rust_raytracer_tpu/ops/pallas_intersect.py:61",
        "launches": k3_launches,
        "max_abs_err": k3_err,
        "ms": k3_time["bounce"][0],
        "plain_ms": k3_time["bounce"][1],
        "bound_ms": k3_time["bounce"][3],
        "bound_by": k3_time["bounce"][4],
        "library_ms": None,
        "ms_primary": k3_time["primary"][0],
        "plain_ms_primary": k3_time["primary"][1],
        "render_device_ms": k3_split["batch render"][0],
        "step_device_ms": k3_split["fwd+bwd step (none)"][0],
        "sharded_launches": sharded.get("threaded_traverse", 0),
    }, {
        "name": "loop_cond",
        "route": "cuda",
        "source": "rust_raytracer_torch/csrc/loop_cond.cu",
        "replaces": None,
        "launches": lc_launches,
        "max_abs_err": program["loop_cond"]["max_abs_err"],
        "ms": program["loop_cond"]["ms"],
        "plain_ms": program["loop_cond"]["plain_ms"],
        "bound_ms": program["loop_cond"]["bound"][0],
        "bound_by": program["loop_cond"]["bound"][1],
        "library_ms": None,
        "sharded_launches": sharded.get("loop_cond", 0),
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"rust_raytracer_torch/csrc/{VERTEX_SOURCES[name]}",
        "replaces": None,
        "launches": v_launches[name],
        "max_abs_err": v_rep.max_abs_err(name),
        "ms": v_time[name][0],
        "plain_ms": v_time[name][1],
        "bound_ms": v_time[name][2],
        "bound_by": v_time[name][3],
        "library_ms": v_time[name][5],
        "ms_eager": v_time[name][4],
        "not_bit_equal_share": v_rep.worst_share[name],
        "wavefront_launches": wf_v_launches[name],
        "batch_launches": b_v_launches[name],
        "render_device_ms": split[name][0],
    } for name in VERTEX_POOL] + [row_entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
