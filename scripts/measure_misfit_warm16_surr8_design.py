"""The designs of two standalone misfits on their samplers' solves, on one
card: ``darcy_pcn_warm``'s 16x16 warm misfit a draw a warp on the warm pCN's
level, and the 8x8 surrogate of the 16x16 DA runs (CG and Richardson) a
draw a warp on the DA kernel's surrogate level.

    python scripts/measure_misfit_warm16_surr8_design.py

``darcy_misfit_warm_warp_kernel`` (``csrc/fused_pcn.cu``) runs one draw a
warp on ``WarpTruncSliceLevel``, the level of the warm pCN
``fused_pcn_warp_kernel<·, kPrecondDstTrunc>``: its set-up, stencil and dot
products on the warp, the dst_trunc products over the CTA's draws by
``mma.sync`` from V staged, three CTA barriers an apply. It takes its
design from one line, ``MisfitWarmWarpDesign``: ``kWarps`` draws a CTA (W)
and ``kSmWarps`` warps an SM for the launch bound (which caps a thread's
registers at 65536 / (32 kSmWarps)). The alternatives: W 8; a bound of 32
warps an SM; V read through L2 (the patch of
``scripts/measure_pcn_warp_design.py``, which reads K7's V so too); and the
parent's one-draw-a-CTA ``darcy_misfit_warm_kernel`` (the rule off), which
adds in the plain twin's order. For each, Phi from x0 = 0 against the f32
plain twin and against the plain version in f64 with the same bf16
roundings (``float64_twin``): the median, the share within 1e-4 and the
largest relative difference (``chip_smoke.py``'s ``BF16_COLD_START_TOL``
holds the shipped design to 2e-5, 0.90, 5e-3 against the f64 version); and
the f32 twin against the f64 version.

``darcy_misfit_warp_kernel<8, SOLVER>`` (``csrc/fused_da_pcn.cu``) runs one
draw a warp on the DA kernel's 8x8 surrogate level (``WarpLevel<8, ·>``, the
factors staged once a CTA), its design the line ``MisfitSurrWarpDesign``:
W 8, 16 or 32 (the exchange sized to W's mma tiles of 8 draws) and the
launch bound.

The alternatives are patches in copies of ``csrc/``. This builds each unit
once for each of its alternatives, those compilers started together; prints the
registers and spills that ptxas reports for the kernel; and times one call
under each (the warm misfit on ``darcy_pcn_warm``'s spec at 4096 draws from
x0 = 0; the surrogate on ``darcy_da_fused``'s and on rich3_w0.9's at 4096
draws), in the order shipped, alternatives, shipped: CUDA events around 20
calls through the wrapper, which a call this small can leave waiting on the
host, and the device time the profiler records in the kernel; each
design's outputs compared with the shipped design's bit for bit.

Then each standalone misfit against its sampler's own solve of the same u
(``sampler_first_solves``): copies of ``fused_pcn_warp_kernel`` and
``fused_da_pcn_warp_kernel`` patched to write their first step's solve
(K7: Phi and x of the proposal; DA: the first inner step's Phi*), run for
one step with beta = 0 under a zero prior mean, so that the proposal is the
start position: the warm misfit's (Phi, x) from x0 = 0 must equal K7's, and
the 8x8 surrogate's Phi* the DA kernel's under each solver, bit for bit
(exit status 1 if not). Prints the card's name and power limit and one JSON
line.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import sys

import torch

from _kernel_variants import (build_patch_sets, card_line, device_ms, event_ms, load_with,
                              ptxas_row)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

WARM_SOURCE, SURR_SOURCE, SOLVE = "fused_pcn.cu", "fused_da_pcn.cu", "darcy_misfit.cuh"
WARM_KERNEL = "darcy_misfit_warm_warp_kernel"
PARENT_WARM_KERNEL = "darcy_misfit_warm_kernelINS_8DarcyPotINS_8Layout16"
SURR_KERNELS = {"cg": "darcy_misfit_warp_kernelILi8ELi0E",
                "richardson": "darcy_misfit_warp_kernelILi8ELi1E"}
# the same as the profiler names them
# (the warm needle also holds the parent's darcy_misfit_warm_kernel)
WARM_DEVICE, SURR_DEVICE = ("darcy_misfit_warm",), ("darcy_misfit_warp_kernel<8,",)
WARM_LINE = re.compile(r"struct MisfitWarmWarpDesign \{ static constexpr int kWarps = (\d+), "
                       r"kSmWarps = (\d+); \};")
SURR_LINE = re.compile(r"struct MisfitSurrWarpDesign \{ static constexpr int kWarps = (\d+), "
                       r"kSmWarps = (\d+); \};")
# (W, warps an SM, V: "staged" once a CTA, "via L2"; or "the parent's
# kernel", the rule off)
WARM_DESIGNS = [(16, 16, "staged"), (8, 16, "staged"), (16, 32, "staged"), (16, 16, "via L2"),
                (16, 16, "the parent's kernel")]
# (W, warps an SM)
SURR_DESIGNS = [(16, 16), (8, 16), (8, 32), (16, 32), (32, 32)]

# V through L2 on WarpTruncSliceLevel: nothing staged but the exchange, the
# level's V the misfit's (modes, cells) rows
V_THROUGH_L2 = [
    ("    return xchg_bytes(kRows) + sizeof(__nv_bfloat16) * modes * kVRow;\n",
     "    return xchg_bytes(kRows);\n"),
    ("    for (int e = threadIdx.x; e < s.modes * kCells; e += blockDim.x)\n"
     "      Vs[(e / kCells) * kVRow + e % kCells] = gV[e];\n"
     "    return {base, carve_xchg(staged, kRows), Vs, 1.0f};\n",
     "    return {base, carve_xchg(staged, kRows), gV, 1.0f};\n"),
    ("load_a_v<true>(a, V, kVRow, mt * 16, k0);", "load_a_v<false>(a, V, kCells, mt * 16, k0);"),
    ("load_a_vt<true>(a, V, kVRow, ct * 16, k0);", "load_a_vt<false>(a, V, kCells, ct * 16, k0);"),
]
# the rule off: ipx_darcy_misfit_warm sends the spec to the parent's
# one-draw-a-CTA kernel
RULE_OFF = [(WARM_SOURCE, "  return pcn_warp_takes(s, kPcnD, true);\n}", "  return false;\n}")]

# K7's first proposal's solve (Phi, x) to its Phi0 and x0 inputs, which it
# has read into registers by then; the DA kernel's first inner step's Phi*
# to the inner-acceptance output
FIRST_SOLVES = [
    (WARM_SOURCE, "      phi_prop = lv.phi_warm(prop, x_prop);\n",
     "      phi_prop = lv.phi_warm(prop, x_prop);\n"
     "      if (i == 0u && c.live) {\n"
     "        if (l == 0) const_cast<float*>(a.phi0)[c.c] = phi_prop;\n"
     "#pragma unroll\n"
     "        for (int k = 0; k < kC; ++k)\n"
     "          const_cast<float*>(a.x0)[static_cast<size_t>(Level::cell(k)) * a.chain.n + c.c] =\n"
     "              x_prop[k];\n"
     "      }\n"),
    (SURR_SOURCE, "      const float sp = darcy_phi_warp<SURR_SOLVER>(surr, prop);\n",
     "      const float sp = darcy_phi_warp<SURR_SOLVER>(surr, prop);\n"
     "      if (i == 0u && j == 0 && x.live && l == 0) a.inner[x.c] = sp;\n"),
    (SURR_SOURCE, "  if ((threadIdx.x & 31) == 0 && c < a.chain.n)\n    a.inner[c] = step.in_acc",
     "  if (false)\n    a.inner[c] = step.in_acc"),
]


def first_solve_library(_build):
    """The package's kernels with fused_pcn.cu and fused_da_pcn.cu patched by
    FIRST_SOLVES (built in parallel)."""
    built = build_patch_sets(_build, (WARM_SOURCE, SURR_SOURCE), {"first": FIRST_SOLVES},
                             "first_solves")["first"]
    if isinstance(built, str):
        raise AssertionError(f"the patched samplers do not build: {built}")
    return load_with(_build, built[0])


def sampler_first_solves(_build, lib, warm, U, surrogates):
    """With ``lib`` from ``first_solve_library``: K7's first warm solve of
    each column of U from x0 = 0, (Phi, x), on the warm misfit ``warm``;
    and for each (exact, surrogate) pair of ``surrogates`` the DA kernel's
    first surrogate solve Phi* of each column of U. beta = 0 and a zero
    prior mean make every proposal its start position."""
    from ip_mcmc_tpu_torch.ops import _scaffold
    from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

    n, d = U.shape[1], U.shape[0]
    pos = U.T.contiguous()
    mean, scale = torch.zeros(d, device="cuda"), torch.ones(d, device="cuda")
    args, _keep = _scaffold.chain_args(pos, mean, scale, 3, 1, 256)
    phi = torch.zeros(n, device="cuda")
    x = torch.zeros(warm.aux_dim, n, device="cuda")
    spec = warm.spec()
    status = lib.ipx_fused_pcn(ctypes.byref(spec), ctypes.byref(args), phi.data_ptr(),
                               x.data_ptr(), 0.0, 1.0, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "fused_pcn_warp_kernel (first solve)")
    shipped, _build._lib = _build._lib, lib
    try:
        sps = [da._launch(e, s, pos, mean, scale, 0.0, 3, 1, 1, 512)[2] for e, s in surrogates]
    finally:
        _build._lib = shipped
    torch.cuda.synchronize()
    return (phi, x), sps


def warm_patches(d, line):
    w, smw, what = d
    if what == "the parent's kernel":
        return list(RULE_OFF)
    out = [(WARM_SOURCE, line, f"struct MisfitWarmWarpDesign {{ static constexpr int kWarps = "
                               f"{w}, kSmWarps = {smw}; }};")]
    if what == "via L2":
        out += [(SOLVE, a, b) for a, b in V_THROUGH_L2]
    return out


def warm_kernels(d):
    """The kernels whose ptxas report a warm design's row shows."""
    return (PARENT_WARM_KERNEL,) if d[2] == "the parent's kernel" else (WARM_KERNEL,)


def warm_label(d) -> str:
    w, smw, what = d
    return what if what == "the parent's kernel" else f"W={w}, {smw} warps/SM, V {what}"


def surr_label(d) -> str:
    return f"W={d[0]}, {d[1]} warps/SM"


def rel_stats(got, ref) -> dict:
    """Per draw |got - ref| / |ref|: median, share within 1e-4, largest."""
    rel = ((got - ref).abs() / ref.abs()).double().cpu()
    return {"median": float(rel.median()), "within_1e-4": float((rel <= 1e-4).double().mean()),
            "max": float(rel.max())}


def time_designs(name, shipped, others, builds, shipped_lib, needles, run, label, _build,
                 device_needles, check):
    """Each design's call in turns (shipped, alternatives, shipped): its
    time (CUDA events around 20 calls through the wrapper) and its device
    time (the profiler's, in the kernels of ``device_needles``), its
    outputs against the shipped design's and ``check(outputs)`` (their
    distance to the plain twins); the rows."""
    libs, rows = {shipped: shipped_lib}, []
    kernels = needles if callable(needles) else (lambda _: needles)
    regs = {shipped: [ptxas_row(_build.BUILD_DIR, k) for k in kernels(shipped)]}
    for d in others:
        if isinstance(builds[d], str):
            print(f"{name} ({label(d)}): does not build ({builds[d]})", flush=True)
            rows.append({"design": label(d), "ms": None, "refused": builds[d]})
            continue
        libs[d] = load_with(_build, builds[d][0])
        regs[d] = [ptxas_row(builds[d][1], k) for k in kernels(d)]
    _build._lib = shipped_lib
    ref = run()
    torch.cuda.synchronize()
    for d in (shipped, *[d for d in others if d in libs], shipped):
        _build._lib = libs[d]
        try:
            out = run()
        except RuntimeError as e:  # a launch the card refuses
            print(f"{name} ({label(d)}): not run ({e})", flush=True)
            rows.append({"design": label(d), "ms": None, "refused": str(e)})
            continue
        ms, dev = event_ms(run, 20), device_ms(run, 20, device_needles)
        equal = all(bool(torch.equal(a, b)) for a, b in zip(out, ref))
        twin = check(out)
        rows.append({"design": label(d), "ms": ms, "device_ms": dev,
                     "bit_equal_to_shipped": equal, "ptxas": regs.get(d), "vs_twin": twin})
        print(f"{name} ({label(d)}; ptxas registers, spill stores, loads {regs.get(d)}): "
              f"{ms:.4f} ms a call, device {dev} ms; equal to the shipped design's bit for bit "
              f"{equal}; Phi against the plain twin {twin}", flush=True)
    _build._lib = shipped_lib
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import _build

    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    report = {"card": card}
    n = 4096
    g = torch.Generator().manual_seed(5)

    warm_p, da_p = (configs.build(c, "cuda") for c in ("darcy_pcn_warm", "darcy_da_fused"))
    rich = {v: configs.darcy_da_richardson(v, "cuda") for v in configs.RICHARDSON_VARIANTS}
    warm, aux_dim = warm_p.batched_warm_potential
    assert warm.warm_kernel_label == f"{WARM_KERNEL}[n=16]", warm.warm_kernel_label
    U = warm_p.prior.sample(g, n).T.contiguous()
    zeros = torch.zeros(aux_dim, n, device="cuda")
    twin_warm = warm._forward_warm_plain(U, zeros)[0]
    f64_warm = warm.float64_twin()._forward_warm_plain(U.double(), zeros.double())[0]
    report["warm_twin_vs_f64"] = rel_stats(twin_warm, f64_warm)
    print(f"the f32 twin from x0 = 0 against the plain version in f64 (the same bf16 roundings): "
          f"{report['warm_twin_vs_f64']}", flush=True)

    # the designs: every unit's builds started together
    warm_src = (_build.CSRC / WARM_SOURCE).read_text()
    surr_src = (_build.CSRC / SURR_SOURCE).read_text()
    wm, sm = WARM_LINE.search(warm_src), SURR_LINE.search(surr_src)
    warm_shipped = (int(wm.group(1)), int(wm.group(2)), "staged")
    surr_shipped = (int(sm.group(1)), int(sm.group(2)))
    warm_others = [d for d in WARM_DESIGNS if d != warm_shipped]
    surr_others = [d for d in SURR_DESIGNS if d != surr_shipped]
    sets = {("warm", d): warm_patches(d, wm.group(0)) for d in warm_others}
    sets.update({("surr", d): [(SURR_SOURCE, sm.group(0),
                                f"struct MisfitSurrWarpDesign {{ static constexpr int kWarps = "
                                f"{d[0]}, kSmWarps = {d[1]}; }};")] for d in surr_others})
    warm_builds = build_patch_sets(_build, (WARM_SOURCE,),
                                   {k: v for k, v in sets.items() if k[0] == "warm"}, "warm16")
    surr_builds = build_patch_sets(_build, (SURR_SOURCE,),
                                   {k: v for k, v in sets.items() if k[0] == "surr"}, "surr8")

    report["warm"] = time_designs(
        f"warm misfit, darcy_pcn_warm's dst_trunc-64 / 4 CG, {n} draws from x0 = 0",
        warm_shipped, warm_others, {d: warm_builds[("warm", d)] for d in warm_others},
        shipped_lib, warm_kernels, lambda: warm(U, zeros), warm_label, _build, WARM_DEVICE,
        lambda out: {"f32 twin": rel_stats(out[0], twin_warm),
                     "f64": rel_stats(out[0], f64_warm)})
    cg, rich3 = da_p.batched_surrogate_fn, rich["rich3_w0.9"].batched_surrogate_fn
    twin_cg, twin_rich3 = cg._forward_plain(U), rich3._forward_plain(U)
    assert (cg.kernel_label, rich3.kernel_label) == ("darcy_misfit_warp_kernel[n=8]",
                                                     "darcy_misfit_warp_kernel[n=8,richardson]")
    report["surrogate"] = time_designs(
        f"8x8 surrogate, dst_trunc-64 / 3 CG and rich3_w0.9, {n} draws each", surr_shipped,
        surr_others, {d: surr_builds[("surr", d)] for d in surr_others}, shipped_lib,
        tuple(SURR_KERNELS.values()), lambda: (cg(U), rich3(U)), surr_label, _build,
        SURR_DEVICE, lambda out: {"cg": rel_stats(out[0], twin_cg),
                                  "rich3": rel_stats(out[1], twin_rich3)})

    # each standalone misfit against its sampler's own solve of the same u
    lib = first_solve_library(_build)
    pairs = {"darcy_da_fused": (da_p.batched_potential_fn, cg),
             **{v: (p.batched_potential_fn, p.batched_surrogate_fn) for v, p in rich.items()}}
    (phi_k7, x_k7), sps = sampler_first_solves(_build, lib, warm, U, list(pairs.values()))
    phi, x = warm(U, zeros)
    torch.cuda.synchronize()
    equal = bool(torch.equal(phi, phi_k7) and torch.equal(x, x_k7))
    print(f"warm misfit at {n} draws from x0 = 0: (Phi, x) equal to K7's first warm solve "
          f"(beta = 0) bit for bit {equal}", flush=True)
    report["warm_equals_k7_solve"] = equal
    ok = equal
    for (name, (_, surr)), sp in zip(pairs.items(), sps):
        same = bool(torch.equal(surr(U), sp))
        print(f"{name}'s surrogate ({surr.kernel_label}) at {n} draws: Phi* equal to the DA "
              f"kernel's first surrogate solve (beta = 0) bit for bit {same}", flush=True)
        report[f"surrogate_equals_da_solve[{name}]"] = same
        ok = ok and same
    print(json.dumps(report))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
