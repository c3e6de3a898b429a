"""The fused cull+compact kernel (rust_raytracer_torch/csrc/wf_cull.cu:
wf_cull_compact_kernel) in the forms its design chose between, built side
by side from the checkout's source and run on the same inputs.

    python3 scripts/wf_cull_variants.py

Forms: "shared@N" keeps the row's fill `off` in shared memory,
double-buffered beside the warp counts (the shipped form at N = 8);
"reg@N" carries `off` in a register through the slot walk.  N is the
resident blocks an SM that __launch_bounds__ asks of the fused kernel.
Each form is the shipped source with text edits (the script fails if the
source no longer holds the text it edits), built into its own library.

For each form: registers and spill bytes (ptxas -v), local and shared
bytes (cudaFuncGetAttributes) and SASS instructions a test in the slot
loop (cuobjdump).  Then, on three input sets at KC 32 and k 128 --
cull_adversarial's 4096 packets, primary rays over the whole
cornell_dragon image (2^18, in the pool's compaction order) and the
mid-render step of a kernel="wavefront" pool render -- whether its row,
total and counts equal the shipped wrapper's (ops/wavefront.py:
cull_compact), and its time beside cull then compact: CUDA events around
50 back-to-back calls after a warm-up, every form in turn, then again in
reverse order; the mean of the two readings and both.

Needs a CUDA GPU and nvcc; builds under build/wf_cull_variants/.  Any
failed check raises, so the exit code is non-zero.
"""
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (blocks jax)
import torch  # noqa: E402

KERNEL = "wf_cull_compact_kernel"
BOUNDS = "__launch_bounds__(WF_SN, WF_CULL_MIN_BLOCKS)\nwf_cull_compact_kernel"
# `off` in a register: the shared fill, its reset and its read after the
# walk go
TO_REGISTER = (
    ("    __shared__ int off_s[2];  // kFused: the row's fill before slot s, at s & 1\n", ""),
    ("        if (kFused && lane == 0) off_s[0] = 0;\n", ""),
    ("                const int off_now = off_s[s & 1];\n"
     "                if (hit && rank < kc && off_now + rank < k) row[off_now + rank] = base + lane;\n"
     "                if (lane == 0) off_s[(s + 1) & 1] = off_now + min(total, kc);\n",
     "                if (hit && rank < kc && off + rank < k) row[off + rank] = base + lane;\n"
     "                off += min(total, kc);\n"),
    ("        if (kFused) {\n"
     "            __syncthreads();\n"
     "            off = off_s[n_live & 1];\n"
     "        }\n", ""),
)
FORMS = (("shared", 8), ("shared", 7), ("reg", 8), ("reg", 7), ("reg", 6))


def variant_source(src, kind, blocks):
    edits = ((BOUNDS, BOUNDS.replace("WF_CULL_MIN_BLOCKS", str(blocks))),)
    if kind == "reg":
        edits += TO_REGISTER
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"{kind}@{blocks}: wf_cull.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def ptxas_info(text):
    """(registers, spill store bytes, spill load bytes) of the fused
    kernel from ptxas -v's report."""
    lines = text.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m and cs.is_kernel(m.group(1), KERNEL):
            rest = "\n".join(lines[i + 1:i + 5])
            regs = re.search(r"Used (\d+) registers", rest)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", rest)
            if regs and spill:
                return int(regs.group(1)), int(spill.group(1)), int(spill.group(2))
    raise AssertionError(f"ptxas -v reported no {KERNEL}:\n{text}")


def build(forms):
    """Each form's library, built in parallel (one nvcc each, then one
    link each).  Returns {tag: (library path, ptxas_info)}."""
    from rust_raytracer_torch.ops import _cuda

    out = os.path.join(ROOT, "build", "wf_cull_variants")
    os.makedirs(out, exist_ok=True)
    src = (_cuda.CSRC / "wf_cull.cu").read_text()
    nvcc = _cuda.find_nvcc()
    procs = {}
    for kind, blocks in forms:
        stem = os.path.join(out, f"{kind}{blocks}")
        with open(stem + ".cu", "w") as f:
            f.write(variant_source(src, kind, blocks))
        cmd = _cuda.nvcc_command(nvcc, stem + ".cu", stem + ".o") + [
            "-I", str(_cuda.CSRC), "-Xptxas", "-v"]
        procs[f"{kind}@{blocks}"] = (stem, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for tag, (stem, cmd, p) in procs.items():
        so, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)}\nexit {p.returncode}:\n{err}")
        subprocess.run(_cuda.link_command(nvcc, [stem + ".o"], stem + ".so"), check=True,
                       timeout=300)
        libs[tag] = (stem + ".so", ptxas_info(so + err))
    return libs


class Form:
    """One built form: its launch and its attributes."""

    def __init__(self, path):
        self.path = path
        self.lib = ctypes.CDLL(path)
        self.fn = self.lib.rrt_wf_cull_compact
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        attrs = self.lib.rrt_wf_cull_compact_attrs
        attrs.restype = ctypes.c_int
        attrs.argtypes = [ctypes.POINTER(ctypes.c_int)]
        a = (ctypes.c_int * 3)()
        if attrs(a) != 0:
            raise RuntimeError(f"{path}: cudaFuncGetAttributes failed")
        self.registers, self.local_bytes, self.shared_bytes = a[0], a[1], a[2]

    def __call__(self, a_in, kc, k):
        n_pk, k1 = a_in[0].shape
        dev = a_in[0].device
        row = torch.empty((n_pk, k), dtype=torch.int32, device=dev)
        total = torch.empty((n_pk,), dtype=torch.int32, device=dev)
        counts = torch.empty((n_pk, k1), dtype=torch.int32, device=dev)
        err = self.fn(*(t.data_ptr() for t in (*a_in, row, total, counts)), n_pk, k1, kc, k,
                      torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.path}: launch failed, CUDA error {err}")
        return row, total, counts


def input_sets(dev):
    """{name: cull arguments without kc} for the three sets."""
    from rust_raytracer_torch import models
    from rust_raytracer_torch.ops import wavefront as wf
    from rust_raytracer_torch.render import integrator
    from rust_raytracer_torch.render.camera import camera_from_config
    from rust_raytracer_torch.render.renderer import Renderer
    from rust_raytracer_torch.utils import config as cfg

    scene = models.build("cornell_dragon")
    camera = camera_from_config(cfg.merge_scene_config(scene.config, {"output_width": cs.W}),
                                cfg.RenderConfig(samples_per_pixel=cs.SPP, max_depth=cs.DEPTH))
    renderer = Renderer(scene, camera, batch_size=cs.LANES, kernel="wavefront", device=dev)
    pack = renderer.pack
    k1 = min(wf.K1, -(-pack.wf_sn_lo.shape[0] // 8) * 8)

    def cull_in(org, dirn, t_max):
        sn_slot, l1_cnt = wf.nearest_boxes(pack.wf_sn_lo, pack.wf_sn_hi, org, dirn, t_max, k1)
        return tuple(x.contiguous() for x in (
            sn_slot, torch.clamp(l1_cnt, max=k1), pack.wf_sn_start, pack.wf_sn_bounds, org,
            dirn, torch.clamp(t_max, max=wf.BIG)))

    org, dirn = cs.make_rays(camera, cs.LANES, dev)
    alive = torch.ones((cs.LANES,), dtype=torch.bool, device=dev)
    perm = torch.sort(integrator._compaction_key(org, dirn, alive), stable=True).indices
    sets = {"adversarial": cs.cull_adversarial(dev),
            "primary": cull_in(org[perm], dirn[perm],
                               torch.full((cs.LANES,), float("inf"), device=dev))}
    recorded = cs.record_steps(renderer, wf, "intersect_triangles_wavefront")
    picks, _ = cs.pick_steps(recorded)
    sets["mid-render step"] = cull_in(*recorded[picks[1][1]])
    return sets


def main():
    if not torch.cuda.is_available():
        raise SystemExit("wf_cull_variants: needs a CUDA GPU")
    from rust_raytracer_torch.ops import wavefront as wf

    dev = torch.device("cuda:0")
    card = cs.card_line()
    cs.log(f"card: {card}")
    built = build(FORMS)
    forms = {}
    for tag, (path, (regs, st, ld)) in built.items():
        forms[tag] = form = Form(path)
        per = cs.loop_per_test(cs.sass_loops(path, KERNEL), "wf_cull_compact")
        sass = "not read" if per is None else f"{per[0]:.2f} instructions a test"
        cs.log(f"{tag}: ptxas {regs} registers, spill stores {st} / loads {ld} bytes; "
               f"loaded {form.registers} registers, {form.local_bytes} local bytes, "
               f"{form.shared_bytes} shared bytes; SASS slot loop {sass}")

    for name, a_in in input_sets(dev).items():
        kc = wf.KC
        k = min(wf.PAIRS_PER_PACKET_CAP, a_in[0].shape[1] * kc)
        want = wf.cull_compact(*a_in, kc, k)
        for tag, form in forms.items():
            if not all(torch.equal(a, b) for a, b in zip(form(a_in, kc, k), want)):
                raise AssertionError(f"{name}: {tag} differs from the shipped kernel")
        runs = dict(forms, **{"cull then compact": lambda a, c, kk: wf.compact(
            *wf.cull(*a, c), a[1], kk)})
        readings = {tag: [] for tag in runs}
        for tag in list(runs) + list(reversed(runs)):
            readings[tag].append(cs.time_ms(lambda: runs[tag](a_in, kc, k)))
        cs.log(f"{name}: {a_in[0].shape[0]} packets, mean live slots "
               f"{float(a_in[1].float().mean()):.2f}, every form equal to the shipped kernel; ms "
               + "; ".join(f"{tag} {sum(r) / 2:.4f} ({r[0]:.4f} {r[1]:.4f})"
                           for tag, r in readings.items())
               + f" (CUDA events, mean of {cs.KERNEL_REPS} calls a reading; {card})")
    cs.log("done")


if __name__ == "__main__":
    main()
