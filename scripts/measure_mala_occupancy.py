"""Warm MALA (fused_mala_warm_kernel) at 3 and at 4 CTAs per SM on one card.

    python scripts/measure_mala_occupancy.py

The kernel ships under ``__launch_bounds__(256, 4)`` (at most 64 registers
a thread). This compiles ``csrc/fused_mala.cu`` twice into libraries of its
own, as it stands and with that one bound patched to ``(256, 3)`` (80
registers), and times one step of each at the shipped size of
``darcy_mala_warm`` (4096 chains, dst / 6 + 6 CG) as the slope between two
launch lengths, in the order 4, 3, 3, 4. It checks that both give the same
chains, and prints the card's name and power limit, the registers and
spills that ptxas reports, and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SHIPPED = "__launch_bounds__(kFusedThreads, 4) fused_mala_warm_kernel"


def compile_variants(_build):
    """{CTAs per SM: the C function ``ipx_fused_mala`` of that build}."""
    out_dir = _build.BUILD_DIR / "occupancy"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "fused_mala.cu").read_text()
    assert src.count(SHIPPED) == 1, "the warm kernel's launch bound moved"
    procs = {}
    for ctas in (3, 4):
        unit = out_dir / f"fused_mala_ctas{ctas}.cu"
        unit.write_text(src.replace(SHIPPED, SHIPPED.replace(", 4)", f", {ctas})")))
        so = out_dir / f"libfused_mala_ctas{ctas}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(so), str(unit)]
        procs[ctas] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for ctas, (so, proc) in procs.items():
        log = proc.communicate()[0].splitlines()
        if proc.returncode != 0:
            raise RuntimeError("\n".join(log))
        for i, line in enumerate(log):
            if "fused_mala_warm_kernel" in line and "Compiling" in line:
                print(f"({ctas} CTAs) " + " ".join(s.strip() for s in log[i:i + 4]))
        fn = ctypes.CDLL(str(so)).ipx_fused_mala
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.POINTER(_build.MisfitSpec),
                       ctypes.POINTER(_build.ChainArgs), p, p, p,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
        fns[ctas] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import _build, _scaffold

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    p = configs.build("darcy_mala_warm", "cuda")
    pag, aux_dim = p.batched_warm_potential
    pos = p.init_positions(torch.Generator().manual_seed(5), p.n_chains).cuda()
    eps, block = p.kernel_params["step_size"], p.kernel_params["block_chains"]
    fns = compile_variants(_build)
    spec = pag.spec()
    # the start values, as the wrapper takes them: both solves from zero
    phi0, g0, aux0 = pag(pos.T.contiguous(), torch.zeros(
        (aux_dim, p.n_chains), dtype=torch.float32, device="cuda"))

    def run(ctas, steps):
        args, keep = _scaffold.chain_args(pos, p.prior.mean, p.prior.scale, 7,
                                          steps, block)
        status = fns[ctas](
            ctypes.byref(spec), ctypes.byref(args), phi0.data_ptr(),
            g0.data_ptr(), aux0.data_ptr(), float(eps),
            torch.cuda.current_stream().cuda_stream)
        _build.check(status, f"fused_mala_warm_kernel at {ctas} CTAs per SM")
        return keep[3]

    def time_ms(ctas, steps, reps=3):
        run(ctas, steps)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            run(ctas, steps)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    finals, times = {}, []
    for ctas in (4, 3, 3, 4):
        finals.setdefault(ctas, run(ctas, 16))
        times.append((ctas, (time_ms(ctas, 136) - time_ms(ctas, 8)) / 128))
    torch.cuda.synchronize()
    same = bool(torch.equal(finals[3], finals[4]))
    print(json.dumps({"card": card, "ms_per_step": times, "same_chains": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
