"""Two standalone misfits on their samplers' solves, a draw a warp: the 16²
warm misfit of ``darcy_pcn_warm`` on the warm pCN's solve
(``WarpTruncSliceLevel``, ``darcy_misfit_warm_warp_kernel``,
``csrc/fused_pcn.cu``), and the 8²
surrogate of the 16² DA runs, by CG and by Richardson, on the DA kernel's
8² ``WarpLevel`` (``darcy_misfit_warp_kernel<8, SOLVER>``,
``csrc/fused_da_pcn.cu``).

On the CPU: which misfits the two rules take (the Python mirrors
``fused_pcn.misfit_warm_warp_takes`` and ``fused_da_pcn.misfit_warp_takes``
of the C rules), which launch-count name each misfit gets, the launch
geometries' mirrors (the card tests and ``chip_smoke.py`` hold them against
the C functions), the plain twins, which count a plain launch, and the f64
reference that holds the warm kernel from x0 = 0. The twins
are held against the JAX package on these very specs by
``tests/test_torch_darcy_warm.py`` (dst_trunc-64 / 4 CG) and
``tests/test_torch_darcy_richardson.py`` / ``tests/test_torch_darcy.py`` (8²)."""

import re

import numpy as np
import pytest
import torch

from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays, darcy_warm_misfit_from_arrays
from ip_mcmc_tpu_torch.models import darcy
from ip_mcmc_tpu_torch.ops import _build, fused_pcn
from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

torch.set_num_threads(1)

WARM = "darcy_misfit_warm_warp_kernel[n=16]"
SURR = {"cg": "darcy_misfit_warp_kernel[n=8]",
        "richardson": "darcy_misfit_warp_kernel[n=8,richardson]"}
# the exchange of 16 rows (bf16 r and coefficients in rows of 264, f32 back
# products in rows of 260 and a_bar)
XCHG16 = 16 * (2 * (264 + 264) + 4 * (260 + 1))


# the warm kernel's bytes: the KL basis in 64 rows of 256 cells padded by 4
# after every 32 (288 floats), the exchange, V in rows of 256 + 8 bf16, then
# a slice a warp for 16 warps: u (64), p, th, tv (288 each)
def warm_smem(modes):
    return 4 * 64 * 288 + XCHG16 + 2 * 264 * modes + 16 * 4 * (64 + 3 * 288)


# the 8² kernel's: the exchange, the staged 8² factors (the f32 basis 64 ×
# 64 and the eigenvalues, the bf16 modes in rows of 64 + 8), a slice a warp
# for 16 warps: u, then p, th, tv of 64 cells


def surr_smem(modes):
    return XCHG16 + 4 * (64 * 64 + modes) + 2 * modes * 72 + 16 * 4 * (64 + 3 * 64)


def _warm():
    return configs.build("darcy_pcn_warm", "cpu").batched_warm_potential[0]


def _surrogate(name):
    p = (configs.build(name, "cpu") if name == "darcy_da_fused"
         else configs.darcy_da_richardson(name, "cpu"))
    return p.batched_surrogate_fn


def _left(name):
    """Specs the two rules leave (on the shipped configs' data)."""
    fx = np.load(configs.FIXTURE)
    aux16 = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    if name in ("dst", "jacobi", "dst_trunc-128"):
        precond, iters = {"dst": ("dst", 4), "jacobi": ("jacobi", 16),
                          "dst_trunc-128": ("dst_trunc", 4)}[name]
        return darcy_warm_misfit_from_arrays(aux16, fx["y"], 0.002, cg_iters=iters,
                                             precond=precond, precond_modes=128)[0]
    if name == "warm8":
        aux8 = darcy.darcy_aux(n_grid=8, n_modes_per_dim=8, alpha=2.0, field_scale=10.0,
                               obs_indices=fx["obs_coarse"])
        return darcy_warm_misfit_from_arrays(aux8, fx["y_surr"], fx["surr_scale"], cg_iters=3,
                                             precond="dst_trunc", precond_modes=64)[0]
    if name == "K36":
        aux8 = darcy.darcy_aux(n_grid=8, n_modes_per_dim=6, alpha=2.0, field_scale=10.0,
                               obs_indices=fx["obs_coarse"])
        return darcy_misfit_from_arrays(aux8, fx["y_surr"], fx["surr_scale"], cg_iters=3,
                                        precond="dst_trunc", precond_modes=64)
    if name == "12x12":
        aux12 = darcy.darcy_aux(n_grid=12, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
        return darcy_misfit_from_arrays(aux12, fx["y"], 0.002, cg_iters=3,
                                        precond="dst_trunc", precond_modes=64)
    assert name == "richardson16"
    return darcy_misfit_from_arrays(aux16, fx["y"], 0.002, cg_iters=3, precond="dst_trunc",
                                    precond_modes=128, solver="richardson", omega=0.9)


# --- what the rules take ----------------------------------------------------------


def test_warm_rule_takes_the_warm_misfit_of_darcy_pcn_warm():
    """darcy_pcn_warm's warm misfit (16², K 64, dst_trunc-64 / 4 CG): the
    rule takes it, the label names the kernel a draw a warp, and at the
    config's 4096 draws the geometry is 256 CTAs of 16 draws."""
    warm = _warm()
    assert (warm.n, warm.K, warm.precond, warm.modes, warm.cg_iters, warm.solver) == (
        16, 64, "dst_trunc", 64, 4, "cg")
    assert fused_pcn.misfit_warm_warp_takes(**warm.spec_fields)
    assert fused_pcn.warp_takes(True, n=warm.n, d=warm.K, precond=warm.precond,
                                modes=warm.modes)  # the warm pCN's level
    assert warm.warm_kernel_label == WARM
    assert fused_pcn.misfit_warm_warp_geometry(4096, **warm.spec_fields) == (
        16, 256, warm_smem(64))


@pytest.mark.parametrize("name", ["darcy_da_fused", *sorted(configs.RICHARDSON_VARIANTS)])
def test_warp_rule_takes_the_8_surrogates(name):
    """The 8² surrogates of darcy_da_fused and of the four darcy_da_richardson
    runs (dst_trunc-64, CG or Richardson, K 64): the level of the DA
    kernel's surrogate, 16 draws a CTA."""
    surr = _surrogate(name)
    assert (surr.n, surr.K, surr.precond, surr.modes) == (8, 64, "dst_trunc", 64)
    assert da.misfit_warp_takes(**surr.spec_fields)
    assert surr.kernel_label == SURR[surr.solver]
    assert da.misfit_warp_geometry(4096, **surr.spec_fields) == (16, 256, surr_smem(64))


# --- what they leave ---------------------------------------------------------------


@pytest.mark.parametrize("name, label", [
    ("dst", "darcy_misfit_warm_dst_warp_kernel[n=16]"),  # dense dst: warm MALA's level
    ("jacobi", "darcy_misfit_warm_kernel"),         # Jacobi
    ("dst_trunc-128", "darcy_misfit_warm_kernel"),  # 128 > 112 modes
    ("warm8", "darcy_misfit_warm_kernel"),          # an 8² warm spec
    ("K36", "darcy_misfit_kernel[n=8]"),            # 8², K 36
    ("12x12", "darcy_misfit_kernel[n=12]"),         # another grid
    ("richardson16", "darcy_misfit_kernel[n=16,richardson]"),  # Richardson at 16²
])
def test_rules_leave_the_other_specs(name, label):
    """Each leaves the spec to another kernel (one draw a CTA; the 16²
    dense dst one a draw a warp on warm MALA's level), both geometry mirrors
    refuse it, and the label names that kernel."""
    pot = _left(name)
    assert not fused_pcn.misfit_warm_warp_takes(**pot.spec_fields)
    with pytest.raises(ValueError, match="warm warp misfit kernel takes"):
        fused_pcn.misfit_warm_warp_geometry(64, **pot.spec_fields)
    if isinstance(pot, darcy.DarcyMisfitWarm):
        assert pot.warm_kernel_label == label
    else:
        assert not da.misfit_warp_takes(**pot.spec_fields)
        with pytest.raises(ValueError, match="warp misfit kernel takes"):
            da.misfit_warp_geometry(64, **pot.spec_fields)
        assert pot.kernel_label == label


# --- the geometries ----------------------------------------------------------------


@pytest.mark.parametrize("B, ctas", [(4096, 256), (13, 1), (16, 1), (17, 2), (1, 1), (0, 0)])
@pytest.mark.parametrize("kind", ["warm", "surr"])
def test_geometry(kind, B, ctas):
    """A draw a warp, 16 draws a CTA: the shipped 4096, a ragged 13 (one CTA,
    3 spare warps running on zeros), 16, 17 (a second CTA of 15 spare), 1,
    none."""
    if kind == "warm":
        got, smem = fused_pcn.misfit_warm_warp_geometry(B), warm_smem(64)
    else:
        got, smem = da.misfit_warp_geometry(B, n=8, modes=64), surr_smem(64)
    assert got == (16, ctas, smem) and smem <= da.MAX_SMEM_BYTES


def test_geometries_refuse_a_negative_width():
    with pytest.raises(ValueError, match="B -1"):
        fused_pcn.misfit_warm_warp_geometry(-1)
    with pytest.raises(ValueError, match="B -1"):
        da.misfit_warp_geometry(-1, n=8, modes=64, solver="richardson")


def test_mirror_constants_follow_the_design_lines():
    """MISFIT_WARM_WARP_DRAWS and MISFIT_SURR_WARP_DRAWS are the C design
    lines' kWarps."""
    warm = (_build.CSRC / "fused_pcn.cu").read_text()
    m = re.search(r"struct MisfitWarmWarpDesign \{ static constexpr int kWarps = (\d+), "
                  r"kSmWarps = \d+; \};", warm)
    assert m is not None and int(m.group(1)) == fused_pcn.MISFIT_WARM_WARP_DRAWS
    surr = (_build.CSRC / "fused_da_pcn.cu").read_text()
    m = re.search(r"struct MisfitSurrWarpDesign \{ static constexpr int kWarps = (\d+), "
                  r"kSmWarps = \d+; \};", surr)
    assert m is not None and int(m.group(1)) == da.MISFIT_SURR_WARP_DRAWS


# --- the plain twins on the CPU ------------------------------------------------------


@pytest.mark.parametrize("kind", ["warm", "cg3", "rich3_w0.9"])
def test_plain_twins_run_on_the_cpu_and_count_themselves(kind):
    """On CPU tensors a misfit the rules take runs its plain version (the
    kernel's twin), finite and of the expected shape, and counts a plain
    launch, never the kernel's."""
    U = torch.randn(64, 3, generator=torch.Generator().manual_seed(0))
    before = dict(_build.launch_counts)
    if kind == "warm":
        warm = _warm()
        phi, x = warm(U, torch.zeros(warm.aux_dim, 3))
        assert x.shape == (256, 3) and bool(torch.isfinite(x).all())
        plain, kernel = "darcy_misfit_warm_plain", WARM
    else:
        surr = _surrogate(kind)
        phi = surr(U)
        plain, kernel = "darcy_misfit_plain[n=8]", surr.kernel_label
    assert phi.shape == (3,) and bool(torch.isfinite(phi).all())
    assert _build.launch_counts[plain] == before.get(plain, 0) + 1
    assert _build.launch_counts[kernel] == before.get(kernel, 0)


def test_float64_twin_keeps_the_bf16_roundings():
    """float64_twin: the f32 buffers in f64, the bf16 preconditioner factors
    kept, the original untouched; its plain version on f64 inputs gives f64
    values near the f32 twin's (the same algorithm, the same bf16 roundings
    of r and of the coefficients, only f32 rounding apart)."""
    warm = _warm()
    twin = warm.float64_twin()
    assert (twin.V.dtype, twin.basis.dtype, twin.lam.dtype) == (
        torch.bfloat16, torch.float64, torch.float64)
    assert (warm.V.dtype, warm.basis.dtype) == (torch.bfloat16, torch.float32)
    U = torch.randn(64, 8, generator=torch.Generator().manual_seed(1))
    zeros = torch.zeros(warm.aux_dim, 8)
    phi32, x32 = warm._forward_warm_plain(U, zeros)
    phi64, x64 = twin._forward_warm_plain(U.double(), zeros.double())
    assert (phi32.dtype, phi64.dtype, x64.dtype) == (torch.float32, torch.float64, torch.float64)
    assert float(((phi64 - phi32.double()).abs() / phi64.abs()).max()) <= 5e-3
