"""The standalone 16×16 exact misfit a draw a warp on the DA kernel's exact
level (``darcy_misfit_warp_kernel``, ``csrc/fused_da_pcn.cu``): which
misfits its rule takes (``fused_da_pcn.misfit_warp_takes``, the mirror of
``misfit_warp_takes`` in C), which launch-count name each misfit gets, and
the launch geometry's mirror (the card tests and ``chip_smoke.py`` hold
both against the C functions). The kernel's arithmetic is the DA kernel's
exact correction; its plain twin is ``DarcyMisfit._forward_plain``, which
``tests/test_torch_darcy.py`` holds against JAX on this very spec
(``exact16``: dst_trunc-128 / 12 CG)."""

import re

import pytest
import torch

from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
from ip_mcmc_tpu_torch.models import darcy
from ip_mcmc_tpu_torch.ops import _build
from ip_mcmc_tpu_torch.ops import fused_da_pcn as da
from ip_mcmc_tpu_torch.ops import fused_pcn

torch.set_num_threads(1)

WARP = "darcy_misfit_warp_kernel[n=16]"
# the shipped design's bytes at 128 modes: the exchange of 16 rows (bf16 r
# and coefficients in rows of 264, f32 back-projection in rows of 260 and
# a_bar), the staged factors (the f32 basis 64 × 256 and 128 eigenvalues,
# the bf16 modes in rows of 256 + 8) and a slice a warp (u, then p, th, tv
# of 256 cells), 16 warps
XCHG, SLICES = 16 * (2 * (264 + 264) + 4 * (260 + 1)), 16 * 4 * (64 + 3 * 256)


def staged(modes):
    return 4 * (64 * 256 + modes) + 2 * modes * (256 + 8)


SMEM = XCHG + staged(128) + SLICES


def _da_exact(name):
    p = (configs.build(name, "cpu") if name == "darcy_da_fused"
         else configs.darcy_da_richardson(name, "cpu"))
    return p.batched_potential_fn


def _bench_exact():
    """``bench.py``'s DA pair's exact level, as that script builds it in
    JAX (``make_darcy_forward(n_grid=16, n_modes_per_dim=8)``,
    dst_trunc-128 / 12 CG), here on the port's constants."""
    aux = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8)
    y = configs.build("darcy_da_fused", "cpu").data
    return darcy_misfit_from_arrays(aux, y, 0.002, cg_iters=12, precond="dst_trunc",
                                    precond_modes=128)


@pytest.mark.parametrize("name", ["darcy_da_fused", *sorted(configs.RICHARDSON_VARIANTS), "bench"])
def test_rule_takes_the_da_exact_levels(name):
    """darcy_da_fused's exact misfit, that of the four darcy_da_richardson
    runs and bench.py's DA pair's: dst_trunc-128 / 12 CG on 16², K 64, the
    level of the DA kernel's exact correction."""
    pot = _bench_exact() if name == "bench" else _da_exact(name)
    assert (pot.n, pot.K, pot.precond, pot.modes, pot.cg_iters, pot.solver) == (
        16, 64, "dst_trunc", 128, 12, "cg")
    assert da.misfit_warp_takes(**pot.spec_fields)
    assert not pot.on_cluster
    assert pot.kernel_label == WARP


def _leaves(pot):
    assert not da.misfit_warp_takes(**pot.spec_fields) and pot.kernel_label != WARP
    with pytest.raises(ValueError, match="warp misfit kernel takes"):
        da.misfit_warp_geometry(64, **pot.spec_fields)


@pytest.mark.parametrize("config", ["darcy_ess_fused", "darcy_pcn_4096", "darcy_fes_fused"])
def test_rule_leaves_the_16_jacobi_misfits(config):
    """The 16² Jacobi / 48 CG misfit (Φ0 of ESS, cold pCN and FES) is not
    this kernel's: WarpLevel would not keep block_sum's order. It goes to
    darcy_misfit_slice_kernel[n=16], a draw a warp on WarpSliceLevel, the
    solve its samplers run (tests/test_torch_misfit_slice.py)."""
    pot = configs.build(config, "cpu").batched_potential_fn
    assert (pot.n, pot.precond, pot.cg_iters) == (16, "jacobi", 48)
    _leaves(pot)
    assert da.misfit_slice_takes(**pot.spec_fields)
    assert pot.kernel_label == "darcy_misfit_slice_kernel[n=16]"


@pytest.mark.parametrize("variant, label", [("cg3", "darcy_misfit_kernel[n=8]"),
                                            ("rich3_w0.9", "darcy_misfit_kernel[n=8,richardson]")])
def test_rule_leaves_the_8_surrogates(variant, label):
    """The 8² surrogates, by CG and by Richardson (K17), which left this
    rule for the one-draw-a-CTA kernel ``label``, are now taken: the rule
    covers the DA kernel's 8² surrogate level too, and the label names
    this kernel on that level with the solver's tag (the rest of the 8²
    level's tests: tests/test_torch_misfit_warm16_surr8.py)."""
    pot = configs.darcy_da_richardson(variant, "cpu").batched_surrogate_fn
    assert da.misfit_warp_takes(**pot.spec_fields)
    assert pot.kernel_label != label
    assert pot.kernel_label == label.replace("darcy_misfit_kernel", "darcy_misfit_warp_kernel")
    assert da.misfit_warp_geometry(4096, **pot.spec_fields)[:2] == (da.MISFIT_SURR_WARP_DRAWS,
                                                                     256)


@pytest.mark.parametrize("kw", [
    dict(solver="richardson"),            # K17's solve on the 16² level
    dict(K=36),                           # another K
    dict(modes=100),                      # not a multiple of 16
    dict(modes=272),                      # more modes than cells
    dict(precond="jacobi", modes=0),      # Jacobi
    dict(precond="dst", modes=0),         # the dense dst preconditioner
    dict(n=32),                           # another grid
])
def test_rule_leaves_other_specs(kw):
    spec = {**dict(n=16, K=64, precond="dst_trunc", modes=128, solver="cg"), **kw}
    assert not da.misfit_warp_takes(**spec)
    with pytest.raises(ValueError, match="warp misfit kernel takes"):
        da.misfit_warp_geometry(64, **spec)


def test_richardson_at_16_keeps_its_label():
    """A 16² dst_trunc misfit solved by Richardson stays one draw a CTA."""
    aux = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8)
    pot = darcy_misfit_from_arrays(aux, configs.build("darcy_da_fused", "cpu").data, 0.002,
                                   cg_iters=3, precond="dst_trunc", precond_modes=128,
                                   solver="richardson", omega=0.9)
    _leaves(pot)
    assert pot.kernel_label == "darcy_misfit_kernel[n=16,richardson]"


@pytest.mark.parametrize("modes", [16, 64, 128, 144, 160, 256])
def test_rule_takes_the_dst_trunc_widths_whose_factors_fit(modes):
    """The factors are staged once a CTA beside 16 slices: up to 144 modes
    they fit the 232,448 bytes a CTA may have, and the kernel takes the
    spec; above, it stays on the one-draw-a-CTA kernel (the rule narrows
    nothing)."""
    fits = XCHG + staged(modes) + SLICES <= da.MAX_SMEM_BYTES
    assert fits == (modes <= 144)
    spec = dict(n=16, K=64, precond="dst_trunc", modes=modes, solver="cg")
    assert da.misfit_warp_takes(**spec) == fits
    if fits:
        assert da.misfit_warp_geometry(16, modes=modes) == (16, 1, XCHG + staged(modes) + SLICES)
    else:
        with pytest.raises(ValueError, match="warp misfit kernel takes"):
            da.misfit_warp_geometry(16, modes=modes)


@pytest.mark.parametrize("B, ctas", [(4096, 256), (13, 1), (16, 1), (17, 2), (1, 1), (0, 0)])
def test_geometry(B, ctas):
    """A draw a warp, 16 draws a CTA: the shipped 4096, a ragged 13 (one
    CTA, 3 spare warps running on zeros), 17 (a second CTA of 15 spare),
    none."""
    assert da.misfit_warp_geometry(B) == (da.MISFIT_WARP_DRAWS, ctas, SMEM)
    assert SMEM <= da.MAX_SMEM_BYTES


def test_geometry_refuses_a_negative_width():
    with pytest.raises(ValueError, match="B -1"):
        da.misfit_warp_geometry(-1)


def test_mirror_constants_follow_the_design_line():
    """MISFIT_WARP_DRAWS and MISFIT_WARP_STAGED are the C design line's."""
    text = (_build.CSRC / "fused_da_pcn.cu").read_text()
    m = re.search(r"struct MisfitWarpDesign \{ static constexpr int kWarps = (\d+), "
                  r"kSmWarps = \d+; static constexpr bool kStaged = (\w+); \};", text)
    assert m is not None
    assert (int(m.group(1)), m.group(2) == "true") == (da.MISFIT_WARP_DRAWS,
                                                       da.MISFIT_WARP_STAGED)


def test_warm_and_gradient_misfits_keep_their_kernels():
    """The warm and gradient entries never consult the rule: darcy_pcn_warm's
    warm misfit (16² dst_trunc-64, which the rule would take cold) goes by
    its own rule (fused_pcn.misfit_warm_warp_takes) to the warm pCN's level
    a draw a warp, and the MALA gradient misfits keep their kernels'
    names."""
    warm = configs.build("darcy_pcn_warm", "cpu").batched_warm_potential[0]
    assert da.misfit_warp_takes(**warm.spec_fields)
    assert fused_pcn.misfit_warm_warp_takes(**warm.spec_fields)
    assert warm.warm_kernel_label == "darcy_misfit_warm_warp_kernel[n=16]"
    before = dict(_build.launch_counts)
    jacobi = configs.build("darcy_mala_fused", "cpu").batched_potential_fn
    U = torch.zeros(64, 2)
    jacobi.value_and_grad(U)
    assert _build.launch_counts["darcy_misfit_grad_plain[n=16]"] == before.get(
        "darcy_misfit_grad_plain[n=16]", 0) + 1


def test_plain_twin_runs_on_the_cpu_and_counts_itself():
    """On CPU tensors the misfit the rule takes runs its plain version (the
    kernel's twin) and counts a plain launch, never the kernel's."""
    pot = _da_exact("darcy_da_fused")
    before = dict(_build.launch_counts)
    U = torch.randn(64, 3, generator=torch.Generator().manual_seed(0))
    phi = pot(U)
    assert phi.shape == (3,) and bool(torch.isfinite(phi).all())
    assert _build.launch_counts["darcy_misfit_plain[n=16]"] == before.get(
        "darcy_misfit_plain[n=16]", 0) + 1
    assert _build.launch_counts[WARP] == before.get(WARP, 0)
