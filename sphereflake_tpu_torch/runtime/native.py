"""ctypes bindings to the port's native host library
(`sphereflake_tpu_torch/native/*.cpp`).

Counterpart of the reference package's `runtime/native.py`, with the
same API. The library carries the host-side subsystems the C++ app
implements in C++ — Sobol sampling (Sobol.cpp), mt19937 (the SSAO
noise, SSAO.cpp) and the display path (a PNG encoder instead of a GL
window). It is built with the host C++ compiler at first use (the flags
of the reference's `native/Makefile`) into the build directory of
`kernels.build_dir()`, keyed by a hash of the sources, the flags and the
host (`-march=native` code runs where it was built), and loaded with
ctypes. `available()` is False only where no C++ compiler exists; a
compiler that fails raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess

import numpy as np

from sphereflake_tpu_torch.kernels import build_dir

_SRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
SOURCES = ("sobol.cpp", "mt19937.cpp", "png.cpp")
HEADERS = ("common.h", "joekuo_params.h")
# native/Makefile's CXXFLAGS and LDFLAGS.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-Wextra", "-shared")


def find_cxx() -> str | None:
    """The host C++ compiler: $CXX, else c++ / g++ / clang++ on PATH."""
    for cand in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    return None


def _lib_path(cxx: str) -> str:
    digest = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join((cxx,) + CXX_FLAGS).encode())
    digest.update(f"{platform.node()} {platform.machine()}".encode())
    return os.path.join(
        build_dir(), f"libsphereflake_native_{digest.hexdigest()[:16]}.so"
    )


def build() -> str:
    """Compile the library unless it is built; return its path. Raises
    where no C++ compiler exists or the compiler fails."""
    cxx = find_cxx()
    if cxx is None:
        raise RuntimeError(
            "no C++ compiler ($CXX, c++, g++, clang++): the native host "
            "library of sphereflake_tpu_torch is compiled at first use"
        )
    lib = _lib_path(cxx)
    if not os.path.exists(lib):
        os.makedirs(build_dir(), exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", tmp,
             *(os.path.join(_SRC_DIR, s) for s in SOURCES)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cxx} failed on the native library:\n{proc.stdout}"
                f"{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: no half-written library
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.sf_sobol_direction_numbers.argtypes = [u32p, ctypes.c_int]
    lib.sf_sobol_direction_numbers.restype = ctypes.c_int
    lib.sf_sobol_sample_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_int, u32p,
    ]
    lib.sf_sobol_sample_batch.restype = ctypes.c_int
    lib.sf_mt19937_draw.argtypes = [u32p, ctypes.c_uint32, ctypes.c_uint64,
                                    ctypes.c_uint64]
    lib.sf_mt19937_draw.restype = None
    lib.sf_png_encode_rgb8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
    ]
    lib.sf_png_encode_rgb8.restype = ctypes.c_int64
    return lib


def available() -> bool:
    """True when the library is (or can be) built: a C++ compiler exists."""
    return find_cxx() is not None


def sobol_direction_numbers(dims: int) -> np.ndarray:
    out = np.zeros((dims, 52), dtype=np.uint32)
    rc = _lib().sf_sobol_direction_numbers(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), dims
    )
    if rc != 0:
        raise ValueError(f"dims={dims} exceeds native Joe-Kuo table")
    return out


def sobol_sample_batch(index_base: int, count: int, dim: int,
                       scramble: np.ndarray | None = None) -> np.ndarray:
    out = np.zeros(count, dtype=np.float64)
    scr = None
    if scramble is not None:
        scramble = np.ascontiguousarray(scramble, dtype=np.uint32)
        if scramble.shape != (count,):
            raise ValueError(f"scramble of shape {scramble.shape}, want "
                             f"({count},)")
        scr = scramble.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    rc = _lib().sf_sobol_sample_batch(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        index_base, count, dim, scr,
    )
    if rc != 0:
        raise ValueError(f"bad dim {dim}")
    return out


def mt19937_draw(seed: int, count: int, skip: int = 0) -> np.ndarray:
    out = np.zeros(count, dtype=np.uint32)
    _lib().sf_mt19937_draw(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        seed & 0xFFFFFFFF, skip, count,
    )
    return out


def encode_png_native(rgb: np.ndarray) -> bytes:
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"RGB8 image [H, W, 3] expected, got {rgb.shape}")
    h, w, _ = rgb.shape
    lib = _lib()
    src = rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    size = lib.sf_png_encode_rgb8(None, 0, src, w, h)
    buf = (ctypes.c_uint8 * size)()
    n = lib.sf_png_encode_rgb8(buf, size, src, w, h)
    if n != size:
        raise RuntimeError(f"PNG encoder wrote {n} of {size} bytes")
    return bytes(buf)
