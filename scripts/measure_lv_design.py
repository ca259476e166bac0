"""The designs of the Lotka-Volterra value-and-gradient kernel, on one card.

    python scripts/measure_lv_design.py [--parent TREE]

Three kernels compute Phi and dPhi/dtheta of ``ode_mala``'s misfit (200 RK4
steps, 40 observations): the parent, ``lv_misfit_grad_states_kernel`` (a
thread a chain, the states in a global scratch, each step's stages
recomputed in the backward; the package's forced entry
``misfit_and_grad_states``); design A, the shipped ``lv_misfit_grad_kernel``
(the stage exponentials kept in shared memory, the backward recomputing
nothing, two chains a CTA); design B, ``scripts/lv_warp_adjoint.cuh`` built
in a copy of ``csrc/`` in place of A (a warp a chain, the adjoint composed
over the lanes by a shuffle scan). Beside them the latency floor: a kernel
of one thread that runs only the forward's stage chain (n_steps x 4 stages,
nothing stored); and A cut short after its forward (with the stores) and
after Phi, to split its time. ``--parent TREE`` also builds ``TREE``'s
``csrc/lv_rk4.cu`` (the parent commit unpacked, e.g. with ``git archive``)
and holds the shipped kernel to it bit for bit.

At 256, 512 and 1024 chains (prior draws, half doubled, as ``chip_smoke.py``
draws them), in the order parent, A, B, [TREE], parent: the device time that
the profiler records in the kernel over 50 calls and CUDA events around 50
calls through the wrapper; each design's (Phi, gradient) against the
parent's, bit for bit (the count of chains that differ), and against the
plain version (autograd through the RK4 loop on the card) within
``chip_smoke.py``'s LV_PHI_RTOL and LV_GRAD_TOL. Prints the card's name and
power limit, ptxas's registers and spills of each kernel, the bound
(``chip_smoke.lv_bound``) and one JSON line; exit status 1 if a design
disagrees with the plain version or A differs from the parent.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import torch

from _kernel_variants import build_patch_sets, card_line, device_ms, event_ms, load_with, ptxas_row

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = "lv_rk4.cu"
START = "// --- the stages kernel (LvStagesDesign)"
END = "// --- end of the stages kernel"
WIDTHS = (256, 512, 1024)
REPS = 50
def region(text: str) -> str:
    """The shipped design's text: from the line after START to END."""
    start = text.index("\n", text.index(START)) + 1
    return text[start:text.index(END)]


def build_tree(_build, tree: pathlib.Path):
    """nvcc of another tree's csrc/lv_rk4.cu: (its library, the directory
    of its nvcc.log)."""
    out = _build.BUILD_DIR / "lv_tree"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(tree / "ip_mcmc_tpu_torch" / "csrc", out / "csrc")
    so = out / "libipx_lv_rk4.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(out / "csrc"), "-o", str(so),
           str(out / "csrc" / SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out / "nvcc.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {tree}'s {SOURCE}:\n{proc.stderr}")
    return ctypes.CDLL(str(so)), out


def differing(out, ref) -> int:
    """Chains whose Phi or any gradient entry differs from ``ref``'s."""
    return int(((out[0] != ref[0]) | (out[1] != ref[1]).any(dim=1)).sum())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="a tree whose csrc/lv_rk4.cu the shipped kernel is held to")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import _build, lv_rk4

    card = card_line()
    print(f"card: {card}", flush=True)
    shipped_lib = _build.library()
    problem = configs.build("ode_mala", "cuda")
    pot = problem.potential_fn
    spec = pot.spec
    assert lv_rk4.stages_takes(spec)

    text = (_build.CSRC / SOURCE).read_text()
    design_b = (ROOT / "scripts" / "lv_warp_adjoint.cuh").read_text()
    phi_line = "  phi[ch] = lv_misfit_dz(s, ez, dz);\n"
    builds = build_patch_sets(_build, (SOURCE,), {
        "B": [(SOURCE, region(text), design_b)],
        # A cut short, for where its time goes (Phi and the gradient not
        # computed): the forward with its stores; and up to Phi
        "A forward": [(SOURCE, phi_line, "  phi[ch] = ezN[0] + ezN[1];\n  return;\n")],
        "A forward + Phi": [(SOURCE, phi_line, phi_line + "  return;\n")]}, "lv_design")
    cut = {}
    for key in ("A forward", "A forward + Phi"):
        if isinstance(builds[key], str):
            raise RuntimeError(f"{key} does not build: {builds[key]}")
        cut[key] = load_with(_build, builds[key][0])
    if isinstance(builds["B"], str):
        raise RuntimeError(f"design B does not build: {builds['B']}")
    sos, b_dir = builds["B"]
    lib_b = load_with(_build, sos)
    tree = build_tree(_build, args.parent) if args.parent else None
    if tree:
        tree[0].ipx_lv_misfit_grad.argtypes = [ctypes.POINTER(_build.LvSpec), ctypes.c_void_p,
                                               ctypes.c_int, *[ctypes.c_void_p] * 4]
    ptxas = {"parent": ptxas_row(_build.BUILD_DIR, "lv_misfit_grad_states_kernel"),
             "A": ptxas_row(_build.BUILD_DIR, "lv_misfit_grad_kernel"),
             "B": ptxas_row(b_dir, "lv_misfit_grad_kernel"),
             "floor": ptxas_row(_build.BUILD_DIR, "lv_forward_floor_kernel")}
    if tree:
        ptxas["tree"] = ptxas_row(tree[1], "lv_misfit_grad_kernel")
    for k, v in ptxas.items():
        print(f"ptxas ({k}): {v[0]} registers, {v[1]} / {v[2]} bytes spilled" if v
              else f"ptxas ({k}): not in the log", flush=True)

    def tree_call(th):
        n = th.shape[0]
        states = torch.empty((spec.n_steps + 1) * 2 * n, device="cuda")
        phi, grad = torch.empty(n, device="cuda"), torch.empty(n, 4, device="cuda")
        _build.check(tree[0].ipx_lv_misfit_grad(
            ctypes.byref(spec.c_struct), th.data_ptr(), n, states.data_ptr(), phi.data_ptr(),
            grad.data_ptr(), torch.cuda.current_stream().cuda_stream), "the tree's kernel")
        return phi, grad

    ok, rows, floor = True, [], {}
    th0 = torch.zeros(4, device="cuda")
    run_floor = lambda: lv_rk4.forward_floor(th0, spec)  # noqa: E731
    floor["device_ms"] = device_ms(run_floor, REPS, ("lv_forward_floor_kernel",))
    floor["ms"] = event_ms(run_floor, REPS)
    print("latency floor (one thread, the forward's stages, nothing stored): "
          + json.dumps(floor), flush=True)
    breakdown = []
    for n in WIDTHS:
        th = problem.prior.sample(torch.Generator().manual_seed(75 + n), n)
        for key, lib in cut.items():
            _build._lib = lib
            fn = lambda th=th: lv_rk4.misfit_and_grad(th, spec)  # noqa: E731
            breakdown.append({"chains": n, "cut": key,
                              "device_ms": device_ms(fn, REPS, ("lv_misfit_grad",))})
            print(json.dumps(breakdown[-1]), flush=True)
        _build._lib = shipped_lib
    for n in WIDTHS:
        th = problem.prior.sample(torch.Generator().manual_seed(75 + n), n)
        th[n // 2:] *= 2.0
        plain = pot.plain_value_and_grad(th)
        parent = lv_rk4.misfit_and_grad_states(th, spec)
        bound = chip_smoke.lv_bound(spec, n)
        order = [("parent", shipped_lib, lambda th=th: lv_rk4.misfit_and_grad_states(th, spec)),
                 ("A", shipped_lib, lambda th=th: lv_rk4.misfit_and_grad(th, spec)),
                 ("B", lib_b, lambda th=th: lv_rk4.misfit_and_grad(th, spec))]
        if tree:
            order.append(("tree", shipped_lib, lambda th=th: tree_call(th)))
        order.append(order[0])
        for name, lib, fn in order:
            _build._lib = lib
            out = fn()
            torch.cuda.synchronize()
            phi_rel = float(((out[0].double() - plain[0]).abs() / plain[0].abs()).max())
            grad_rel = float(((out[1].double() - plain[1]).abs().amax(1)
                              / plain[1].abs().amax(1)).max())
            row = {"chains": n, "design": name,
                   "device_ms": device_ms(fn, REPS, ("lv_misfit_grad",)),
                   "ms": event_ms(fn, REPS), "chains_differing_from_parent": differing(out, parent),
                   "phi_max_rel": phi_rel, "grad_max_rel": grad_rel, "ptxas": ptxas[name],
                   **bound, "floor_device_ms": floor["device_ms"]}
            ok = ok and phi_rel <= chip_smoke.LV_PHI_RTOL and grad_rel <= chip_smoke.LV_GRAD_TOL
            if name in ("A", "tree"):
                ok = ok and row["chains_differing_from_parent"] == 0
            rows.append(row)
            print(json.dumps(row), flush=True)
        _build._lib = shipped_lib
    print(json.dumps({"card": card, "steps": spec.n_steps, "floor": floor, "ptxas": ptxas,
                      "breakdown": breakdown, "rows": rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
