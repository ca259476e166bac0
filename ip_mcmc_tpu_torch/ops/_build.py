"""Build and load the CUDA kernels at first use.

``nvcc`` compiles every ``csrc/*.cu`` into a shared library of its own
with a plain C interface, all compilers started together, loaded with
``ctypes`` (no PyTorch headers: a build takes seconds, not minutes). The
libraries land in ``_build/`` inside the package (listed in
``.gitignore``), named by a hash of every source and header under
``csrc/`` and the flags, so an edited or added file is rebuilt. Nothing
here runs at import.

Also home of the launch counters: each wrapper adds one to its kernel's
count where it launches the kernel, and each plain version to its own
count, so a run can show which path it went through. The scan path, which
has no kernel, counts its steps by device (``scan_rwm_step[cuda]``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# No --use_fast_math / -ftz: the transmissibility denominators add a
# subnormal 1e-38, and the RNG needs accurate logf/cosf/sinf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launch_counts: collections.Counter = collections.Counter()

_lib = None
build_seconds = None  # wall time of this process's build (None: not built)


def sources():
    """Every file under ``csrc/`` (hashed), and the ``.cu`` files among
    them (each compiled into its own library)."""
    files = sorted(f for f in CSRC.iterdir() if f.suffix in (".cu", ".cuh"))
    return files, [f for f in files if f.suffix == ".cu"]


class MisfitSpec(ctypes.Structure):
    """Mirror of ``IpxMisfitSpec`` in ``csrc/darcy_misfit.cuh``."""

    _fields_ = [
        ("basis", ctypes.c_void_p),
        ("V", ctypes.c_void_p),
        ("lam", ctypes.c_void_p),
        ("S", ctypes.c_void_p),
        ("source", ctypes.c_void_p),
        ("obs", ctypes.c_void_p),
        ("data", ctypes.c_void_p),
        ("noise", ctypes.c_void_p),
        ("n", ctypes.c_int),
        ("K", ctypes.c_int),
        ("modes", ctypes.c_int),
        ("cg_iters", ctypes.c_int),
        ("m", ctypes.c_int),
        ("precond", ctypes.c_int),
        ("log_a_mean", ctypes.c_float),
        ("solver", ctypes.c_int),
        ("omega", ctypes.c_float),
    ]


# IpxMisfitSpec.precond and .solver
PRECOND_CODES = {"jacobi": 0, "dst_trunc": 1, "dst": 2}
SOLVER_CODES = {"cg": 0, "richardson": 1}


class BurgersSpec(ctypes.Structure):
    """Mirror of ``IpxBurgersSpec`` in ``csrc/burgers_misfit.cuh``."""

    _fields_ = [
        ("basis", ctypes.c_void_p),
        ("mean", ctypes.c_void_p),
        ("obs", ctypes.c_void_p),
        ("data", ctypes.c_void_p),
        ("noise", ctypes.c_void_p),
        ("n_cells", ctypes.c_int),
        ("K", ctypes.c_int),
        ("m", ctypes.c_int),
        ("n_segments", ctypes.c_int),
        ("seg_steps", ctypes.c_int * 8),  # IPX_MAX_SEGMENTS
        ("half_dt_over_h", ctypes.c_float),
    ]


class GaussianSpec(ctypes.Structure):
    """Mirror of ``IpxGaussianSpec`` in ``csrc/gaussian_potential.cuh``."""

    _fields_ = [
        ("At", ctypes.c_void_p),
        ("center", ctypes.c_void_p),
        ("data", ctypes.c_void_p),
        ("noise", ctypes.c_void_p),
        ("m", ctypes.c_int),
        ("K", ctypes.c_int),
    ]


class LvSpec(ctypes.Structure):
    """Mirror of ``IpxLvSpec`` in ``csrc/lv_rk4.cu``."""

    _fields_ = [
        ("obs_step", ctypes.c_void_p),
        ("species", ctypes.c_void_p),
        ("data", ctypes.c_void_p),
        ("noise", ctypes.c_void_p),
        ("z0", ctypes.c_float * 2),
        ("half_dt", ctypes.c_float),
        ("dt", ctypes.c_float),
        ("dt6", ctypes.c_float),
        ("n_steps", ctypes.c_int),
        ("T", ctypes.c_int),
        ("S", ctypes.c_int),
    ]


class ChainArgs(ctypes.Structure):
    """Mirror of ``IpxChainArgs`` in ``csrc/fused_scaffold.cuh``."""

    _fields_ = [
        ("pos_in", ctypes.c_void_p),
        ("mean", ctypes.c_void_p),
        ("scale", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("acc", ctypes.c_void_p),
        ("samples", ctypes.c_void_p),
        ("seed", ctypes.c_int),
        ("n", ctypes.c_int),
        ("d", ctypes.c_int),
        ("n_steps", ctypes.c_int),
        ("block_chains", ctypes.c_int),
        ("thin", ctypes.c_int),
    ]


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> list:
    """Compile the kernels (those whose library is not built yet, in
    parallel) and return the libraries' paths. The nvcc logs (registers,
    spills) are kept beside them in ``nvcc.log``."""
    global build_seconds
    files, units = sources()
    digest = _digest(files)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = [BUILD_DIR / f"libipx_{u.stem}_{digest}.so" for u in units]
    todo = [(u, so) for u, so in zip(units, libs) if not so.exists()]
    if not todo:
        return libs
    t0 = time.perf_counter()
    nvcc = _nvcc()
    procs = []
    for unit, so in todo:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(unit)]
        procs.append((cmd, tmp, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, tmp, so, proc in procs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {cmd[-1]}:\n{out}")
        else:
            os.replace(tmp, so)
    (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return libs


def ptxas_report(log_path=None) -> list:
    """What ptxas reported for each kernel of a build, read from its
    ``nvcc.log`` (default: this package's): dicts of ``unit`` (the
    ``.cu``), ``kernel`` (the mangled name), ``registers``,
    ``spill_stores`` and ``spill_loads`` (bytes). Empty when there is no
    log (the libraries were built by another process)."""
    log_path = pathlib.Path(log_path or BUILD_DIR / "nvcc.log")
    if not log_path.exists():
        return []
    rows, unit, entry, spills = [], None, None, (0, 0)
    for line in log_path.read_text().splitlines():
        if line.rstrip().endswith(".cu") and " -o " in line:  # an nvcc command
            unit = line.rstrip().rsplit("/", 1)[-1]
        elif "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            spills = (int(m.group(1)), int(m.group(2)))
        elif "Used" in line and "registers" in line and entry is not None:
            rows.append({"unit": unit, "kernel": entry,
                         "registers": int(re.search(r"Used (\d+) registers", line).group(1)),
                         "spill_stores": spills[0], "spill_loads": spills[1]})
            entry, spills = None, (0, 0)
    return rows


class _Kernels:
    """The C functions of every built library under one namespace."""

    def __init__(self, paths):
        self._libs = [ctypes.CDLL(str(p)) for p in paths]

    def bind(self, name, argtypes, restype=ctypes.c_int):
        for lib in self._libs:
            try:
                fn = getattr(lib, name)
            except AttributeError:
                continue
            fn.argtypes, fn.restype = argtypes, restype
            setattr(self, name, fn)
            return
        raise RuntimeError(f"{name} is in none of the built kernel libraries")


def library():
    """The loaded kernels (built on first call in this process)."""
    global _lib
    if _lib is None:
        lib = _Kernels(build())
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        spec, chain = ctypes.POINTER(MisfitSpec), ctypes.POINTER(ChainArgs)
        bspec = ctypes.POINTER(BurgersSpec)
        gspec = ctypes.POINTER(GaussianSpec)
        # spec, U (K, B), B, Φ (B,), stream
        lib.bind("ipx_darcy_misfit", [spec, p, i, p, p])
        # spec, U (K, B), x0 (n², B), B, Φ (B,), x (n², B), stream
        lib.bind("ipx_darcy_misfit_warm", [spec, p, p, i, p, p, p])
        # spec, B, out (4,): the cluster misfit kernels' geometry
        lib.bind("ipx_darcy_misfit_cluster_geometry", [spec, i, p])
        # spec, B, out (3,): the geometry of the warp misfit kernel on the
        # 16x16 DA kernel's levels
        lib.bind("ipx_darcy_misfit_warp_geometry", [spec, i, p])
        # the same arguments: the one-draw-a-CTA kernel of the spec's layout
        lib.bind("ipx_darcy_misfit_warm_layout", [spec, p, p, i, p, p, p])
        # spec, B, out (3,): the 16x16 warm warp misfit kernel's geometry
        lib.bind("ipx_darcy_misfit_warm_warp_geometry", [spec, i, p])
        # spec, B, out (3,): the 16x16 dense-dst warm warp misfit kernel's
        # geometry
        lib.bind("ipx_darcy_misfit_warm_dst_warp_geometry", [spec, i, p])
        # spec, B, out (3,): the 16x16 Jacobi slice misfit kernel's geometry
        lib.bind("ipx_darcy_misfit_slice_geometry", [spec, i, p])
        # exact, surrogate, chain, Φ0 (n,), Φ*0 (n,), β, √(1−β²), k,
        # inner acceptance (n,), stream
        lib.bind("ipx_fused_da_pcn", [spec, spec, chain, p, p, f, f, i, p, p])
        # exact, surrogate, chain, out (3,): the 16x16 DA kernel's geometry
        lib.bind("ipx_da_pcn_warp_geometry", [spec, spec, chain, p])
        # exact, surrogate, d: the kernel the pair goes to (ROUTES)
        lib.bind("ipx_da_pcn_route", [spec, spec, i])
        # exact, surrogate or null (warm pCN), chain, out (4,): the cluster
        # kernels' geometry (64x64, and the 32x32 warm pCN)
        lib.bind("ipx_darcy_cluster_geometry", [spec, spec, chain, p])
        # spec, chain, Φ0 (n,), x0 (n², n) or null (cold), β, √(1−β²), stream
        lib.bind("ipx_fused_pcn", [spec, chain, p, p, f, f, p])
        # spec, chain, warm, out (3,): the 16x16 pCN warp kernel's geometry
        lib.bind("ipx_pcn_warp_geometry", [spec, chain, i, p])
        # spec, d, warm: the kernel the spec goes to (ROUTES)
        lib.bind("ipx_pcn_route", [spec, i, i])
        # spec, chain, Φ0 (n,), max_shrink, stream
        lib.bind("ipx_fused_ess", [spec, chain, p, i, p])
        # spec, chain, max_shrink, out (3,): the ESS kernel's geometry
        lib.bind("ipx_ess_warp_geometry", [spec, chain, i, p])
        # spec, d: the kernel the spec goes to (ROUTES)
        lib.bind("ipx_ess_route", [spec, i])
        # spec, U (K, B), aux0 (2n², B) or null (cold), B, Φ (B,), ∇Φ (K, B),
        # aux (2n², B) or null, stream
        lib.bind("ipx_darcy_misfit_grad", [spec, p, p, i, p, p, p, p])
        # spec, B, out (3,): the cold warp gradient misfit kernel's geometry
        lib.bind("ipx_darcy_misfit_grad_warp_geometry", [spec, i, p])
        # spec, B, out (3,): the warm warp gradient misfit kernel's geometry
        lib.bind("ipx_darcy_misfit_grad_warm_warp_geometry", [spec, i, p])
        # spec, chain, Φ0 (n,), ∇Φ0 (d, n), aux0 (2n², n) or null (cold), ε,
        # stream
        lib.bind("ipx_fused_mala", [spec, chain, p, p, p, f, p])
        # spec, chain, warm, out (3,): the MALA kernel's geometry
        lib.bind("ipx_mala_warp_geometry", [spec, chain, i, p])
        # spec, d, warm: the kernel the spec goes to (ROUTES)
        lib.bind("ipx_mala_route", [spec, i, i])
        # spec, chain (state in place), Φ (n,), pCN and stretch acceptance
        # counts (n,), record (n, d) or null, β, √(1−β²), a, M, step, parity,
        # stream
        lib.bind("ipx_fused_fes", [spec, chain, p, p, p, p, f, f, f, i, i, i, p])
        # spec, chain, M, out (3,): the ensemble kernel's geometry
        lib.bind("ipx_fes_warp_geometry", [spec, chain, i, p])
        # spec, d: the kernel the spec goes to (ROUTES)
        lib.bind("ipx_fes_route", [spec, i])
        # the Burgers instantiations: the same arguments on the other spec
        lib.bind("ipx_burgers_misfit", [bspec, p, i, p, p])
        # spec, B, out (3,): the geometry of the Burgers misfit a draw a warp
        lib.bind("ipx_burgers_misfit_warp_geometry", [bspec, i, p])
        lib.bind("ipx_fused_da_pcn_burgers", [bspec, bspec, chain, p, p, f, f, i, p, p])
        # exact, surrogate, chain, k, out (3,): the Burgers DA warp kernel's
        # geometry
        lib.bind("ipx_da_pcn_burgers_warp_geometry", [bspec, bspec, chain, i, p])
        # spec, chain, Φ0 (n,), β, √(1−β²), stream
        lib.bind("ipx_fused_pcn_burgers", [bspec, chain, p, f, f, p])
        # spec, chain, out (3,): the Burgers pCN warp kernel's geometry
        lib.bind("ipx_pcn_burgers_warp_geometry", [bspec, chain, p])
        # fine, middle, coarse, chain, Φf0, Φm0, Φc0 (n,), β, √(1−β²),
        # k_inner, k_mid, middle acceptance (n,), stream
        lib.bind("ipx_fused_da3_pcn_burgers",
                 [bspec, bspec, bspec, chain, p, p, p, f, f, i, i, p, p])
        # fine, middle, coarse, chain, k_inner, k_mid, out (3,): its geometry
        lib.bind("ipx_da3_warp_geometry", [bspec, bspec, bspec, chain, i, i, p])
        # fine, middle, coarse, d: the kernel the levels go to (ROUTES)
        lib.bind("ipx_da3_route", [bspec, bspec, bspec, i])
        # the linear-Gaussian potential: spec, U (d, B), B, Φ (B,), stream
        lib.bind("ipx_linear_gaussian_misfit", [gspec, p, i, p, p])
        # spec, U (d, B), B, Φ (B,), ∇Φ (d, B), stream
        lib.bind("ipx_linear_gaussian_misfit_grad", [gspec, p, i, p, p, p])
        # the six samplers on the linear-Gaussian potential, one chain a CTA:
        # the arguments of their Darcy / Burgers entry points on this spec
        # (no carried solution), and each one's route (ROUTES)
        lib.bind("ipx_fused_pcn_linear", [gspec, chain, p, f, f, p])
        lib.bind("ipx_pcn_linear_route", [gspec, i])
        lib.bind("ipx_fused_da_pcn_linear", [gspec, gspec, chain, p, p, f, f, i, p, p])
        lib.bind("ipx_da_pcn_linear_route", [gspec, gspec, i])
        lib.bind("ipx_fused_da3_pcn_linear",
                 [gspec, gspec, gspec, chain, p, p, p, f, f, i, i, p, p])
        lib.bind("ipx_da3_linear_route", [gspec, gspec, gspec, i])
        lib.bind("ipx_fused_ess_linear", [gspec, chain, p, i, p])
        lib.bind("ipx_ess_linear_route", [gspec, i])
        lib.bind("ipx_fused_fes_linear", [gspec, chain, p, p, p, p, f, f, f, i, i, i, p])
        lib.bind("ipx_fes_linear_route", [gspec, i])
        # spec, chain, Φ0 (n,), ∇Φ0 (d, n), ε, stream
        lib.bind("ipx_fused_mala_linear", [gspec, chain, p, p, f, p])
        lib.bind("ipx_mala_linear_route", [gspec, i])
        # spec, chain, step size, prior (0 / 1), stream
        lib.bind("ipx_fused_rwm", [gspec, chain, f, i, p])
        lib.bind("ipx_fused_rwm_darcy", [spec, chain, f, i, p])
        # spec, chain, Lᵀ (d, d), β, √(1−β²), stream
        lib.bind("ipx_fused_pcn_dense", [gspec, chain, p, f, f, p])
        # spec, chain, out (3,): the linear-Gaussian group kernels' geometry
        lib.bind("ipx_gaussian_group_geometry", [gspec, chain, p])
        # spec, chain (state in place), Φ (n,), acceptance count (n,),
        # acceptance probability (n,), log β per block, step, stream
        lib.bind("ipx_fused_pcn_adapt", [gspec, chain, p, p, p, p, i, p])
        # acceptance probability (n,), log β per block, β (n,), n,
        # block_chains, γ_i, target, log 1e-4, log 0.999, stream
        lib.bind("ipx_pcn_adapt_update", [p, p, p, i, i, f, f, f, f, p])
        # spec, chain (out: final positions, acc: acceptance rates), β (n,),
        # γ (n_steps,), target, log 1e-4, log 0.999, log β0, β0, 1 / n_steps,
        # stream: the whole burn-in in one launch
        lib.bind("ipx_fused_pcn_adapt_chain", [gspec, chain, p, p, f, f, f, f, f, f, p])
        # spec, chain, out (4,): the adaptive group kernel's geometry
        lib.bind("ipx_pcn_adapt_group_geometry", [gspec, chain, p])
        # the Lotka-Volterra misfit and gradient: spec, θ (n, 4), n, states
        # scratch ((n_steps + 1) 2n; null for a spec lv_stages_takes sends to
        # lv_misfit_grad_kernel, which keeps its stages on chip), Φ (n,),
        # ∇Φ (n, 4), stream
        lspec = ctypes.POINTER(LvSpec)
        lib.bind("ipx_lv_misfit_grad", [lspec, p, i, p, p, p, p])
        # the same arguments: lv_misfit_grad_states_kernel whatever the rule
        lib.bind("ipx_lv_misfit_grad_states", [lspec, p, i, p, p, p, p])
        # spec, n, out (3,): lv_misfit_grad_kernel's geometry
        lib.bind("ipx_lv_stages_geometry", [lspec, i, p])
        # spec, θ (4,), out (2,), stream: the kernels' latency floor
        lib.bind("ipx_lv_forward_floor", [lspec, p, p, p])
        lib.bind("ipx_lv_spec_size", [])
        lib.bind("ipx_error_string", [i], ctypes.c_char_p)
        lib.bind("ipx_misfit_spec_size", [])
        _lib = lib
    return _lib


def check(status: int, name: str):
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if status != 0:
        msg = library().ipx_error_string(status).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {status} ({msg})")
