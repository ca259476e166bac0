"""The standalone 16×16 Jacobi misfit a draw a warp on the solve of the ESS,
cold pCN, FES and cold MALA kernels (``WarpSliceLevel``): the value misfit
``darcy_misfit_slice_kernel`` (``csrc/fused_da_pcn.cu``) and the cold value
and gradient ``darcy_misfit_grad_warp_kernel`` (``csrc/fused_mala.cu``).

On the CPU: which misfits the two rules take (the Python mirrors
``fused_da_pcn.misfit_slice_takes`` and ``fused_mala.misfit_grad_warp_takes``
of the C rules), which launch-count name each misfit gets, the launch
geometry's mirrors (the card tests and ``chip_smoke.py`` hold them against
the C functions), and the plain twins, which the kernels must match on the
card, against the JAX package's misfit and adjoint on this spec."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
from ip_mcmc_tpu_torch.models import darcy
from ip_mcmc_tpu_torch.ops import _build, fused_mala
from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

torch.set_num_threads(1)

SLICE = "darcy_misfit_slice_kernel[n=16]"
GRAD = "darcy_misfit_grad_warp_kernel[n=16]"
# the six 16² configs whose cold misfit is _darcy_problem's Jacobi / 48 CG
JACOBI_CONFIGS = ["darcy_pcn_4096", "darcy_pcn_warm", "darcy_ess_fused", "darcy_fes_fused",
                  "darcy_mala_fused", "darcy_mala_warm"]
# the shipped designs' bytes: the KL basis staged once a CTA (64 rows of 256
# cells padded by 4 after every 32: 288 floats), then a slice a warp: the
# value's 32 warps u (64), then p, th, tv (288 each); the gradient's 16
# warps u, then a, x, p, th, tv
BASIS = 4 * 64 * 288
SLICE_SMEM = BASIS + 32 * 4 * (64 + 3 * 288)
GRAD_SMEM = BASIS + 16 * 4 * (64 + 5 * 288)


def _jacobi(config="darcy_ess_fused"):
    return configs.build(config, "cpu").batched_potential_fn


def _aux16(n_modes_per_dim=8, **kw):
    return darcy.darcy_aux(n_grid=16, n_modes_per_dim=n_modes_per_dim, **kw)


def _left():
    """Misfits both rules leave, by name: the DA exact level (dst_trunc-128
    / 12 CG), dst_trunc-160, a 16² Richardson misfit, the 8² surrogates (CG,
    Richardson), darcy32_pcn_warm's cold 32² Jacobi misfit and a 16² Jacobi
    misfit with K = 36."""
    data = configs.build("darcy_da_fused", "cpu").data
    rich = configs.darcy_da_richardson("rich3_w0.9", "cpu")
    return {
        "dst_trunc-128": configs.build("darcy_da_fused", "cpu").batched_potential_fn,
        "dst_trunc-160": darcy_misfit_from_arrays(_aux16(), data, 0.002, cg_iters=12,
                                                  precond="dst_trunc", precond_modes=160),
        "richardson16": darcy_misfit_from_arrays(_aux16(), data, 0.002, cg_iters=3,
                                                 precond="dst_trunc", precond_modes=128,
                                                 solver="richardson", omega=0.9),
        "surrogate8": configs.build("darcy_da_fused", "cpu").batched_surrogate_fn,
        "surrogate8_richardson": rich.batched_surrogate_fn,
        "jacobi32": configs.build("darcy32_pcn_warm", "cpu").batched_potential_fn,
        "K36": darcy_misfit_from_arrays(_aux16(6, alpha=2.0, field_scale=10.0), data, 0.002),
    }


LEFT_LABELS = {
    "dst_trunc-128": ("darcy_misfit_warp_kernel[n=16]", "darcy_misfit_grad_kernel[n=16]"),
    "dst_trunc-160": ("darcy_misfit_kernel[n=16]", "darcy_misfit_grad_kernel[n=16]"),
    "richardson16": ("darcy_misfit_kernel[n=16,richardson]", "darcy_misfit_grad_kernel[n=16]"),
    "surrogate8": ("darcy_misfit_warp_kernel[n=8]", "darcy_misfit_grad_kernel[n=8]"),
    "surrogate8_richardson": ("darcy_misfit_warp_kernel[n=8,richardson]",
                              "darcy_misfit_grad_kernel[n=8]"),
    "jacobi32": ("darcy_misfit_kernel[n=32]", "darcy_misfit_grad_kernel[n=32]"),
    "K36": ("darcy_misfit_kernel[n=16]", "darcy_misfit_grad_kernel[n=16]"),
}


@pytest.mark.parametrize("config", JACOBI_CONFIGS)
def test_rules_take_the_16_jacobi_misfit_of_every_config(config):
    """The cold Jacobi / 48 CG misfit of the six 16² configs: both rules
    take it, and the launch counts name the kernels a draw a warp."""
    pot = _jacobi(config)
    assert (pot.n, pot.K, pot.precond, pot.modes, pot.cg_iters, pot.solver) == (
        16, 64, "jacobi", 0, 48, "cg")
    assert da.misfit_slice_takes(**pot.spec_fields)
    assert fused_mala.misfit_grad_warp_takes(**pot.spec_fields)
    assert not da.misfit_warp_takes(**pot.spec_fields) and not pot.on_cluster
    assert pot.kernel_label == SLICE
    assert pot.grad_kernel_label == GRAD


@pytest.mark.parametrize("name", sorted(LEFT_LABELS))
def test_rules_leave_the_other_misfits(name):
    """Each other misfit keeps the kernel it had: the geometry mirrors
    refuse it, the labels name the other kernels."""
    pot = _left()[name]
    assert not da.misfit_slice_takes(**pot.spec_fields)
    assert not fused_mala.misfit_grad_warp_takes(**pot.spec_fields)
    with pytest.raises(ValueError, match="slice misfit kernel takes"):
        da.misfit_slice_geometry(64, **pot.spec_fields)
    with pytest.raises(ValueError, match="warp gradient misfit kernel takes"):
        fused_mala.misfit_grad_warp_geometry(64, **pot.spec_fields)
    assert (pot.kernel_label, pot.grad_kernel_label) == LEFT_LABELS[name]


@pytest.mark.parametrize("kw", [
    dict(n=32),                            # another grid
    dict(K=36),                            # another K
    dict(precond="dst_trunc", modes=128),  # the DA exact level's preconditioner
    dict(precond="dst"),                   # the dense dst preconditioner (warm MALA's)
    dict(modes=16),                        # Jacobi with modes
    dict(solver="richardson"),             # K17's solve
])
def test_rules_leave_other_specs(kw):
    spec = {**dict(n=16, K=64, precond="jacobi", modes=0, solver="cg"), **kw}
    assert not da.misfit_slice_takes(**spec)
    assert not fused_mala.misfit_grad_warp_takes(**spec)
    with pytest.raises(ValueError, match="slice misfit kernel takes"):
        da.misfit_slice_geometry(64, **spec)
    with pytest.raises(ValueError, match="warp gradient misfit kernel takes"):
        fused_mala.misfit_grad_warp_geometry(64, **spec)


def test_gradient_rule_leaves_the_warm_misfits():
    """darcy_mala_warm's warm misfit (dst / 6 CG, aux0 given) and
    darcy_pcn_warm's (dst_trunc-64 / 4 CG) are not the cold gradient's: the
    rule leaves them, and the warm value and gradient keeps its kernel's
    name (``_grad_kernel`` with aux0)."""
    pag = configs.build("darcy_mala_warm", "cpu").batched_warm_potential[0]
    warm = configs.build("darcy_pcn_warm", "cpu").batched_warm_potential[0]
    for pot in (pag, warm):
        assert not fused_mala.misfit_grad_warp_takes(**pot.spec_fields)
    assert (pag.precond, pag.cg_iters) == ("dst", 6)
    before = dict(_build.launch_counts)
    pag(torch.zeros(64, 2), torch.zeros(pag.aux_dim, 2))
    assert sum(_build.launch_counts.values()) == sum(before.values()) + 1
    assert _build.launch_counts.get("darcy_misfit_grad_warm_kernel", 0) == before.get(
        "darcy_misfit_grad_warm_kernel", 0)


@pytest.mark.parametrize("B, ctas, grad_ctas", [(4096, 128, 256), (13, 1, 1), (16, 1, 1),
                                                (17, 1, 2), (33, 2, 3), (1, 1, 1), (0, 0, 0)])
def test_geometry(B, ctas, grad_ctas):
    """A draw a warp, 32 draws a CTA (the gradient: 16): the shipped 4096, a
    ragged 13 (one CTA, 19 or 3 spare warps), 17, 33, one, none; the bytes
    are the staged basis and a slice a warp."""
    assert da.misfit_slice_geometry(B) == (32, ctas, SLICE_SMEM)
    assert fused_mala.misfit_grad_warp_geometry(B) == (16, grad_ctas, GRAD_SMEM)
    assert max(SLICE_SMEM, GRAD_SMEM) <= da.MAX_SMEM_BYTES == fused_mala.MAX_SMEM_BYTES


@pytest.mark.parametrize("geometry", [da.misfit_slice_geometry,
                                      fused_mala.misfit_grad_warp_geometry])
def test_geometry_refuses_a_negative_width(geometry):
    with pytest.raises(ValueError, match="B -1"):
        geometry(-1)


@pytest.mark.parametrize("source, line, draws", [
    ("fused_da_pcn.cu", "MisfitSliceDesign", da.MISFIT_SLICE_DRAWS),
    ("fused_mala.cu", "MisfitGradWarpDesign", fused_mala.GRAD_WARP_DRAWS),
])
def test_mirror_constants_follow_the_design_lines(source, line, draws):
    """The mirrors' draws a CTA are the C design lines' kWarps."""
    text = (_build.CSRC / source).read_text()
    m = re.search(rf"struct {line} {{ static constexpr int kWarps = (\d+), kSmWarps = \d+;",
                  text)
    assert m is not None and int(m.group(1)) == draws


def test_plain_twins_run_on_the_cpu_and_count_themselves():
    """On CPU tensors the misfits the rules take run their plain versions
    (the kernels' twins) and count plain launches, never the kernels'."""
    pot = _jacobi()
    before = dict(_build.launch_counts)
    U = torch.randn(64, 3, generator=torch.Generator().manual_seed(0))
    phi = pot(U)
    phi2, g = pot.value_and_grad(U)
    assert phi.shape == (3,) and g.shape == (64, 3) and torch.equal(phi, phi2)
    for name in ("darcy_misfit_plain[n=16]", "darcy_misfit_grad_plain[n=16]"):
        assert _build.launch_counts[name] == before.get(name, 0) + 1
    for name in (SLICE, GRAD):
        assert _build.launch_counts[name] == before.get(name, 0)


def test_plain_twins_match_jax_on_the_jacobi_spec():
    """The kernels' twins on the Jacobi / 48 CG misfit (darcy_ess_fused's
    constants and data) against the JAX package's ``make_batched_misfit``
    and its custom_vjp adjoint, 4 prior draws: Φ within f32 summation-order
    rounding (1e-5), ∇Φ per draw within 1e-4 of its largest entry (the
    residuals are divided by σ² on their way into the adjoint, so f32
    rounding of the forward solution is amplified)."""
    pot = _jacobi()
    _, aux_j = jdarcy.make_darcy_forward(n_grid=16, n_modes_per_dim=8, alpha=2.0,
                                         field_scale=10.0)
    pj = jdarcy.make_batched_misfit(aux_j, jnp.asarray(pot.data.numpy()), 0.002, cg_iters=48,
                                    differentiable=True)
    U = np.random.default_rng(5).standard_normal((64, 4)).astype(np.float32)
    want_phi = np.asarray(pj(jnp.asarray(U)))
    want_g = np.asarray(jax.grad(lambda u: jnp.sum(pj(u)))(jnp.asarray(U)))
    phi, g = pot.value_and_grad(torch.from_numpy(U))
    np.testing.assert_allclose(pot(torch.from_numpy(U)).numpy(), want_phi, rtol=1e-5)
    np.testing.assert_allclose(phi.numpy(), want_phi, rtol=1e-5)
    err = np.abs(g.numpy() - want_g).max(axis=0) / np.abs(want_g).max(axis=0)
    assert err.max() <= 1e-4, err
