"""The 16² dense-``dst`` warm misfit a draw a warp
(``darcy_misfit_warm_dst_warp_kernel``, ``csrc/fused_pcn.cu``): the
mutation misfit of ``darcy_smc_warm`` on warm MALA's level
(``WarpDstSliceLevel``), the forward half of
``darcy_misfit_grad_warm_warp_kernel``.

On the CPU: which warm misfits the rule takes (the Python mirror
``fused_pcn.misfit_warm_dst_warp_takes`` of the C rule) and which it leaves,
the launch-count name each misfit gets, the launch geometry's mirror (the
card tests and ``chip_smoke.py`` hold it against the C function, and the
kernel against the one-draw-a-CTA kernel it replaces, bit for bit), and the
plain twin on a CPU tensor. The twin is held against the JAX package on
dense-``dst`` specs by ``tests/test_torch_darcy_warm.py``."""

import numpy as np
import pytest
import torch

from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.convert import darcy_warm_misfit_from_arrays
from ip_mcmc_tpu_torch.models import darcy
from ip_mcmc_tpu_torch.ops import _build, fused_pcn

torch.set_num_threads(1)

LABEL = "darcy_misfit_warm_dst_warp_kernel[n=16]"
# the CTA's bytes: the KL basis in 64 rows of 256 cells padded by 4 after
# every 32 (288 floats), S and Sᵀ in bf16 rows of 24, λ padded as the cells;
# then a slice a warp for 16 warps: u (64), p, th, tv and the dst stage
# buffer (288 each)
SMEM = 4 * 64 * 288 + (2 * 2 * 16 * 24 + 4 * 288) + 16 * 4 * (64 + 4 * 288)


def _smc_warm():
    return configs.build("darcy_smc_warm", "cpu").batched_warm_potential[0]


def _warm16(**kw):
    aux = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    return darcy_warm_misfit_from_arrays(aux, np.load(configs.FIXTURE)["y"], 0.002, **kw)[0]


def test_smc_warm_takes_the_rule():
    warm = _smc_warm()
    assert (warm.n, warm.K, warm.precond, warm.modes, warm.cg_iters) == (16, 64, "dst", 0, 6)
    assert fused_pcn.misfit_warm_dst_warp_takes(**warm.spec_fields)
    assert not fused_pcn.misfit_warm_warp_takes(**warm.spec_fields)
    assert warm.warm_kernel_label == LABEL
    assert fused_pcn.misfit_warm_dst_warp_geometry(4096, **warm.spec_fields) == (16, 256, SMEM)
    assert SMEM <= fused_pcn.MAX_SMEM_BYTES


@pytest.mark.parametrize("cg_iters", [1, 4, 48])
def test_any_cg_count_takes_the_rule(cg_iters):
    assert _warm16(cg_iters=cg_iters, precond="dst").warm_kernel_label == LABEL


@pytest.mark.parametrize("kw, label", [
    (dict(precond="jacobi", cg_iters=16), "darcy_misfit_warm_kernel"),
    (dict(precond="dst_trunc", precond_modes=64, cg_iters=4),
     "darcy_misfit_warm_warp_kernel[n=16]"),  # the warm pCN's level, tried first
    (dict(precond="dst_trunc", precond_modes=128, cg_iters=4), "darcy_misfit_warm_kernel"),
])
def test_rule_leaves_the_other_16_specs(kw, label):
    pot = _warm16(**kw)
    assert not fused_pcn.misfit_warm_dst_warp_takes(**pot.spec_fields)
    with pytest.raises(ValueError, match="dense-dst warm warp misfit kernel takes"):
        fused_pcn.misfit_warm_dst_warp_geometry(64, **pot.spec_fields)
    assert pot.warm_kernel_label == label


@pytest.mark.parametrize("fields", [
    dict(n=8, K=64), dict(n=32, K=64), dict(n=16, K=36), dict(n=16, K=64, modes=64),
    dict(n=16, K=64, solver="richardson"),
])
def test_rule_refuses_other_grids_widths_and_solvers(fields):
    spec = dict(n=16, K=64, precond="dst", modes=0, solver="cg")
    spec.update(fields)
    assert not fused_pcn.misfit_warm_dst_warp_takes(**spec)


@pytest.mark.parametrize("B, ctas", [(4096, 256), (13, 1), (16, 1), (17, 2), (1, 1), (0, 0)])
def test_geometry(B, ctas):
    """A draw a warp, 16 draws a CTA: a ragged last CTA's spare warps solve
    nothing; B < 0 is refused."""
    assert fused_pcn.misfit_warm_dst_warp_geometry(B) == (16, ctas, SMEM)
    with pytest.raises(ValueError, match="B -1"):
        fused_pcn.misfit_warm_dst_warp_geometry(-1)


def test_cpu_runs_the_plain_twin_and_the_reference_needs_the_card():
    warm = _smc_warm()
    U = configs.build("darcy_smc_warm", "cpu").prior.sample(
        torch.Generator().manual_seed(3), 8).T.contiguous()
    x0 = torch.zeros(warm.aux_dim, 8)
    before = _build.launch_counts["darcy_misfit_warm_plain"]
    phi, x = warm(U, x0)
    assert _build.launch_counts["darcy_misfit_warm_plain"] == before + 1
    assert phi.shape == (8,) and x.shape == (256, 8) and bool(torch.isfinite(phi).all())
    phi2, x2 = warm(U, x)  # from the solution: a converged start moves little
    assert float((x2 - x).abs().max()) < float(x.abs().max())
    with pytest.raises(ValueError, match="launches a kernel"):
        warm.forward_layout(U, x0)
