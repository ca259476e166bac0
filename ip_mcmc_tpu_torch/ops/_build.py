"""Build and load the CUDA kernels at first use.

``nvcc`` compiles ``csrc/fused_da_pcn.cu`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers: a build
takes seconds, not minutes). The library lands in ``_build/`` inside the
package (listed in ``.gitignore``), named by a hash of the sources and
flags so an edited source is rebuilt. Nothing here runs at import.

Also home of the launch counters: each wrapper adds one to its kernel's
count where it launches the kernel, and each plain version to its own
count, so a run can show which path it went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_da_pcn.cu", "darcy_misfit.cuh", "counter_rng.cuh")
# No --use_fast_math / -ftz: the transmissibility denominators add a
# subnormal 1e-38, and the RNG needs accurate logf/cosf/sinf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launch_counts: collections.Counter = collections.Counter()

_lib = None
build_seconds = None  # wall time of this process's build (None: not built)


class MisfitSpec(ctypes.Structure):
    """Mirror of ``IpxMisfitSpec`` in ``csrc/darcy_misfit.cuh``."""

    _fields_ = [
        ("basis", ctypes.c_void_p),
        ("V", ctypes.c_void_p),
        ("lam", ctypes.c_void_p),
        ("source", ctypes.c_void_p),
        ("obs", ctypes.c_void_p),
        ("data", ctypes.c_void_p),
        ("noise", ctypes.c_void_p),
        ("n", ctypes.c_int),
        ("K", ctypes.c_int),
        ("modes", ctypes.c_int),
        ("cg_iters", ctypes.c_int),
        ("m", ctypes.c_int),
        ("log_a_mean", ctypes.c_float),
    ]


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the kernels (if this source's library is not built yet) and
    return the library's path. The nvcc log (registers, spills) is kept
    beside the library."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libipx_kernels_{_digest()}.so"
    if so.exists():
        return so
    t0 = time.perf_counter()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / "fused_da_pcn.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    return so


def library():
    """The loaded kernel library (built on first call in this process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        spec = ctypes.POINTER(MisfitSpec)
        lib.ipx_darcy_misfit.argtypes = [spec, p, i, p, p]
        lib.ipx_darcy_misfit.restype = i
        lib.ipx_fused_da_pcn.argtypes = [
            spec, spec,           # exact, surrogate
            p, p, p,              # positions (n, d), Φ0 (n,), Φ*0 (n,)
            p, p, f, f,           # prior mean (d,), scale (d,), β, √(1−β²)
            i, i, i, i, i, i, i,  # seed, n, d, n_steps, k, block_chains, thin
            p, p, p, p,           # out (n, d), acc (n,), inner (n,), samples
            p,                    # stream
        ]
        lib.ipx_fused_da_pcn.restype = i
        lib.ipx_error_string.argtypes = [i]
        lib.ipx_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(status: int, name: str):
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if status != 0:
        msg = library().ipx_error_string(status).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {status} ({msg})")
