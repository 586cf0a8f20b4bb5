"""Building and loading the port's hand-written CUDA kernels.

Every `csrc/*.cu` file has a plain C interface. It is compiled with
`nvcc` for sm_90a into its own shared library at first use and loaded
with `ctypes` — no torch headers, so a build takes seconds. Sources may
include the `csrc/*.cuh` headers. Libraries go into a build directory
keyed by a hash of the source, the headers and the flags, so an edited
source or header is rebuilt and an unchanged one is reused.

Nothing here runs when the package is imported: machines without a
CUDA toolkit import every module and run the kernels' plain torch
versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

# -fmad=false: no FMA contraction, so kernel arithmetic rounds like the
# unfused eager-torch plain versions (see csrc/pairs_kernel.cu).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

# Kernel name -> source file under csrc/.
SOURCES = {
    "pairs_kernel": "pairs_kernel.cu",
    "traverse_kernel": "traverse_kernel.cu",
    "recompute_vjp": "recompute_vjp.cu",
    "post_kernel": "post_kernel.cu",
}

_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    """Where built libraries go: $SPHEREFLAKE_TORCH_BUILD_DIR, else
    `build/sphereflake_tpu_torch` beside the package."""
    return os.environ.get("SPHEREFLAKE_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "sphereflake_tpu_torch"
    )


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of sphereflake_tpu_torch are compiled at first use"
    )


def _headers() -> list[str]:
    """The `csrc/*.cuh` headers, which any source may include."""
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith(".cuh")
    )


def _lib_path(name: str, extra_flags=()) -> tuple[str, str]:
    """(source, library path): the library's name carries a hash of the
    source, every header and the flags, so that an edit to any of them
    builds a new library."""
    src = os.path.join(CSRC_DIR, SOURCES[name])
    digest = hashlib.sha256()
    for path in [src, *_headers()]:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    return src, os.path.join(
        build_dir(), f"lib{name}_{digest.hexdigest()[:16]}.so"
    )


def build(names=None, extra_flags=(), verbose: bool = False) -> dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet
    — one `nvcc` process per source, all started together — and return
    {name: library path}. `extra_flags` (e.g. ("-Xptxas", "-v")) are
    appended; with `verbose` the compiler's output is printed."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(build_dir(), exist_ok=True)
    paths, procs = {}, {}
    for name in names:
        src, lib = _lib_path(name, extra_flags)
        paths[name] = lib
        if not os.path.exists(lib):
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp, src]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ),
                tmp,
            )
    failures = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, paths[name])  # atomic: no half-written library
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it at first use."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(build([name])[name])
    return _libs[name]


def entry_point(lib: str, name: str, n_ptrs: int, n_ints: int,
                n_floats: int = 0):
    """C entry point `name` of the built library `lib`, taking `n_ptrs`
    device pointers, `n_ints` ints, `n_floats` floats and the stream; it
    returns cudaGetLastError()."""
    fn = getattr(load(lib), name)
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
        + [ctypes.c_float] * n_floats + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def enqueue(fn, what: str, tensors, ints, dev, floats=()):
    """Launch on the current stream of `dev`; raise if the launch was
    refused. The launch is asynchronous and ctypes keeps no reference
    to the tensors: that is safe because the launch goes to the current
    stream, and the caching allocator reuses a freed block only in
    stream order."""
    with torch.cuda.device(dev):
        err = fn(
            *(x.data_ptr() for x in tensors), *ints, *floats,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: cudaGetLastError() = {err}"
        )


def check_tensors(specs, anchor, anchor_name: str):
    """Raise on anything a kernel does not take. `specs` rows are
    (name, tensor, dtype, shape with None for any size); every tensor
    must lie on the device of `anchor` (called `anchor_name` in the
    message) and be contiguous."""
    for name, x, _, _ in specs:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
    for name, x, dtype, shape in specs:
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != anchor.device:
            raise ValueError(
                f"{name} lies on {x.device}, {anchor_name} on {anchor.device}"
            )
        if x.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, x.shape)
        ):
            raise ValueError(
                f"{name} must have shape {shape}, got {tuple(x.shape)}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
