"""Build and load the port's CUDA kernel library.

Every csrc/*.cu (with the shared csrc/*.cuh headers) is compiled by nvcc for
sm_90a at first use and linked into one shared library with a plain C interface, build/rrt_torch/librrt_kernels.so
(gitignored), loaded with ctypes.  The sources compile in parallel, one nvcc
process each, then one nvcc links the objects.  Flags: IEEE division and no
FMA contraction (-fmad=false, no --use_fast_math), so a kernel's arithmetic
equals its plain PyTorch version's operation for operation.

Each exported C function takes its device pointers, then its int
arguments, then the CUDA stream, and returns cudaGetLastError() of its
launch; `function` binds one by that shape.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rrt_torch"
LIB_PATH = _BUILD_DIR / "librrt_kernels.so"

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-fmad=false", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


def sources():
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    """nvcc from PATH, else $CUDA_HOME/bin (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the traversal "
        "kernels are built from rust_raytracer_torch/csrc at first use and "
        "need the CUDA toolkit"
    )


def nvcc_command(nvcc: str, source: Path, obj: Path):
    """Compile one source into one object: sm_90a, IEEE division, no FMA
    contraction."""
    return [nvcc, *_FLAGS, "-c", "-o", str(obj), str(source)]


def link_command(nvcc: str, objs, out: Path):
    return [nvcc, "-shared", "-o", str(out), *[str(o) for o in objs]]


def _run_all(cmds):
    """Start every command at once; raise with nvcc's stderr on a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errors = []
    for cmd, p in zip(cmds, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"{' '.join(cmd)}\nexit {p.returncode}:\n{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def build_library() -> Path:
    """Compile csrc/*.cu into LIB_PATH if it is missing or older than a
    source or a header (csrc/*.cuh).  Raises with nvcc's stderr on
    failure."""
    srcs = sources()
    deps = srcs + sorted(CSRC.glob("*.cuh"))
    if LIB_PATH.exists() and all(
        s.stat().st_mtime <= LIB_PATH.stat().st_mtime for s in deps
    ):
        return LIB_PATH
    nvcc = find_nvcc()
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=LIB_PATH.parent) as tmp:
        objs = [Path(tmp) / f"{s.stem}.o" for s in srcs]
        _run_all([nvcc_command(nvcc, s, o) for s, o in zip(srcs, objs)])
        lib = Path(tmp) / LIB_PATH.name
        _run_all([link_command(nvcc, objs, lib)])
        os.replace(lib, LIB_PATH)
    return LIB_PATH


def _library():
    """The loaded library, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build_library()))
    return _lib


def c_function(name: str, argtypes):
    """The library's C function `name` (building and loading the library
    at first use), bound with `argtypes`, returning an int."""
    fn = getattr(_library(), name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


def function(name: str, n_ptrs: int, n_ints: int):
    """The library's C function `name`, bound as (n_ptrs pointers, n_ints
    ints, stream) -> int."""
    return c_function(name, [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                      + [ctypes.c_void_p])


def attributes(name: str) -> dict:
    """Registers a thread, local bytes a thread (stack frame and spills)
    and static shared bytes of the kernel behind the C function `name`,
    from cudaFuncGetAttributes (its `name`_attrs export)."""
    fn = getattr(_library(), name + "_attrs")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 3)()
    err = fn(out)
    if err != 0:
        raise RuntimeError(f"{name}: cudaFuncGetAttributes failed, CUDA error {err}")
    return dict(registers=out[0], local_bytes=out[1], shared_bytes=out[2])


def launch(name: str, ptrs, ints, device) -> None:
    """Call the C function `name` on the current stream of `device`, with
    `device` current (a kernel launches into the current device's context);
    raise if the launch failed.  A pointer given as None is null."""
    fn = function(name, len(ptrs), len(ints))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(None if p is None else p.data_ptr() for p in ptrs), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
