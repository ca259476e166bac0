"""The CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU (and nvcc: the kernels build at first use); they
skip elsewhere. On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

chip_smoke.py runs the same comparisons at the main path's full width.
"""

import numpy as np
import pytest
import torch

from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.ops import _build
from ip_mcmc_tpu_torch.ops import fused_da_pcn as da
from ip_mcmc_tpu_torch.ops import fused_ess, fused_fes, fused_mala, fused_pcn

pytestmark = pytest.mark.cuda


def _build_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return configs.build(name, "cuda")


@pytest.fixture
def problem():
    return _build_on_card("darcy_da_fused")


@pytest.fixture
def warm_problem():
    return _build_on_card("darcy_pcn_warm")


def test_misfit_kernel_matches_plain(problem):
    g = torch.Generator().manual_seed(0)
    U = problem.prior.sample(g, 512).T.contiguous()
    for pot in (problem.batched_potential_fn, problem.batched_surrogate_fn):
        name = pot.kernel_label  # the exact level: darcy_misfit_warp_kernel[n=16]
        before = _build.launch_counts[name]
        got = pot(U)
        assert _build.launch_counts[name] == before + 1
        ref = pot._forward_plain(U)
        rel = ((got - ref).abs() / ref.abs()).cpu()
        # bf16 rounding flips: see tests/test_torch_darcy.py
        assert float(rel.median()) <= 2e-6
        assert float((rel <= 1e-5).double().mean()) >= 0.80
        assert float(rel.max()) <= 5e-3


@pytest.mark.parametrize("record", [False, True])
def test_fused_kernel_matches_plain(problem, record):
    g = torch.Generator().manual_seed(1)
    pos = problem.init_positions(g, 512).cuda()
    exact, surr = problem.batched_potential_fn, problem.batched_surrogate_fn
    args = (exact, surr, pos, problem.prior.mean, problem.prior.scale, 0.35, 3)
    # the plain loop's solves are plain too (a module given CUDA tensors
    # would launch its kernel)
    plain_args = (exact._forward_plain, surr._forward_plain, *args[2:])
    kw = dict(n_steps=4, subchain_len=6, block_chains=128)
    if record:
        got = da.fused_da_pcn_chain_recorded(*args, thin=2, **kw)
        ref = da._run_plain_recorded(*plain_args, thin=2, **kw)
        assert got[2].shape == ref[2].shape == (2, 512, 64)
    else:
        got = da.fused_da_pcn_chain(*args, **kw)
        ref = da._run_plain(*plain_args, **kw)
    dev = (got[0] - ref[0]).abs().max(dim=1).values
    assert float((dev <= 1e-4).double().mean()) >= 0.99
    assert abs(float(got[1].mean()) - float(ref[1].mean())) <= 1e-2


def test_kernel_refuses_plain_callables(problem):
    pos = torch.zeros(64, 64, device="cuda")
    with pytest.raises(TypeError, match="DarcyMisfit"):
        da.fused_da_pcn_chain(lambda U: U.sum(0), problem.batched_surrogate_fn,
                              pos, problem.prior.mean, problem.prior.scale,
                              0.35, 0, n_steps=1, block_chains=64)


def _rel(got, ref):
    return ((got - ref).abs() / ref.abs()).cpu()


def test_jacobi_misfit_kernel_matches_plain(warm_problem):
    """The cold Jacobi-48 misfit of the pCN and ESS paths: f32 only."""
    pot = warm_problem.batched_potential_fn
    U = warm_problem.prior.sample(torch.Generator().manual_seed(0), 512).T.contiguous()
    rel = _rel(pot(U), pot._forward_plain(U))
    assert float((rel <= 1e-5).double().mean()) >= 0.99
    assert float(rel.max()) <= 1e-4


def test_warm_misfit_kernel_matches_plain(warm_problem):
    """(Φ, x) from x0 = 0 and from that solution after a pCN-sized move, a
    draw a warp on the warm pCN's level (darcy_misfit_warm_warp_kernel);
    bf16 rounding flips as in tests/test_torch_darcy_warm.py. From x0 = 0
    against the plain version in f64 with the same bf16 roundings
    (float64_twin): four CG iterations from zero stop unconverged, where f32
    summation order alone moves Φ, the f32 twin's as much as the kernel's."""
    warm, aux_dim = warm_problem.batched_warm_potential
    name = warm.warm_kernel_label
    assert name == "darcy_misfit_warm_warp_kernel[n=16]"
    g = torch.Generator().manual_seed(1)
    U = warm_problem.prior.sample(g, 512).T.contiguous()
    U2 = (0.9968 * U + 0.08 * warm_problem.prior.sample(g, 512).T).contiguous()
    before = _build.launch_counts[name]
    phi1, x1 = warm(U, torch.zeros(aux_dim, 512, device="cuda"))
    phi2, x2 = warm(U2, x1)
    assert _build.launch_counts[name] == before + 2
    ref1 = warm.float64_twin()._forward_warm_plain(
        U.double(), torch.zeros(aux_dim, 512, dtype=torch.float64, device="cuda"))
    ref2 = warm._forward_warm_plain(U2, x1)
    rel1, rel2 = _rel(phi1, ref1[0]), _rel(phi2, ref2[0])
    assert float(rel1.median()) <= 2e-5 and float(rel1.max()) <= 5e-3
    assert float((rel1 <= 1e-4).double().mean()) >= 0.90
    assert float(rel2.median()) <= 2e-6 and float(rel2.max()) <= 5e-3
    assert float((rel2 <= 1e-5).double().mean()) >= 0.80
    for x, ref in ((x1, ref1[1]), (x2, ref2[1])):
        err = (x - ref).abs().max(dim=0).values / ref.abs().max(dim=0).values
        assert float(err.max()) <= 5e-3


@pytest.mark.parametrize("recorded", [False, True])
@pytest.mark.parametrize("kind", ["pcn", "pcn_warm", "ess"])
def test_single_level_kernel_matches_plain(warm_problem, kind, recorded):
    pos = warm_problem.init_positions(torch.Generator().manual_seed(2), 512).cuda()
    pm, ps = warm_problem.prior.mean, warm_problem.prior.scale
    kw = {"thin": 2} if recorded else {}
    pot = warm_problem.batched_potential_fn
    plain_pot = pot._forward_plain  # the plain loop's solves are plain too
    if kind == "ess":
        args = (pos, pm, ps, 3, 4, 6, 128)
        got = fused_ess._launch(pot, *args, **kw)
        ref = fused_ess._run_plain(plain_pot, *args, **kw)
    else:
        if kind == "pcn_warm":
            pot, kw["aux_dim"] = warm_problem.batched_warm_potential
            plain_pot = pot._forward_warm_plain
        args = (pos, pm, ps, 0.08, 3, 4, 128)
        got = fused_pcn._launch(pot, *args, **kw)
        ref = fused_pcn._run_plain(plain_pot, *args, **kw)
    if recorded:
        assert got[2].shape == ref[2].shape == (2, 512, 64)
        assert torch.equal(got[2][-1], got[0])
    dev = (got[0] - ref[0]).abs().max(dim=1).values
    assert float((dev <= 1e-4).double().mean()) >= 0.99
    assert abs(float(got[1].mean()) - float(ref[1].mean())) <= 1e-2


def test_single_level_kernels_refuse_plain_callables(warm_problem):
    pos = torch.zeros(64, 64, device="cuda")
    pm, ps = warm_problem.prior.mean, warm_problem.prior.scale
    phi = lambda U: U.sum(0)
    with pytest.raises(TypeError, match="DarcyMisfit"):
        fused_pcn.fused_pcn_chain(phi, pos, pm, ps, 0.08, 0, n_steps=1,
                                  block_chains=64)
    with pytest.raises(TypeError, match="DarcyMisfitWarm"):
        fused_pcn.fused_pcn_chain_warm(lambda U, x: (U.sum(0), x), pos, pm, ps,
                                       0.08, 0, n_steps=1, aux_dim=256,
                                       block_chains=64)
    with pytest.raises(TypeError, match="DarcyMisfit"):
        fused_ess.fused_ess_chain(phi, pos, pm, ps, 0, n_steps=1,
                                  block_chains=64)


@pytest.fixture
def mala_warm_problem():
    return _build_on_card("darcy_mala_warm")


def _col_err(got, ref):
    """Per draw: the largest deviation over the rows, relative to the
    draw's largest reference entry."""
    return ((got - ref).abs().max(dim=0).values / ref.abs().max(dim=0).values).cpu()


def test_grad_misfit_kernel_matches_plain(mala_warm_problem):
    """Φ and ∇Φ of the cold Jacobi-48 adjoint pair (a draw a warp,
    darcy_misfit_grad_warp_kernel): f32 only, so only the order of the sums
    differs."""
    pot = mala_warm_problem.batched_potential_fn
    U = mala_warm_problem.prior.sample(torch.Generator().manual_seed(0), 512).T.contiguous()
    name = pot.grad_kernel_label
    assert name == "darcy_misfit_grad_warp_kernel[n=16]"
    before = _build.launch_counts[name]
    phi, grad = pot.value_and_grad(U)
    assert _build.launch_counts[name] == before + 1
    phi_ref, grad_ref = pot._value_and_grad_plain(U)[:2]
    rel = _rel(phi, phi_ref)
    assert float((rel <= 1e-5).double().mean()) >= 0.99 and float(rel.max()) <= 1e-4
    assert float(_col_err(grad, grad_ref).max()) <= 1e-3
    # through autograd: the backward is the same kernel's gradient
    Ug = U.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(pot(Ug).sum(), Ug)
    assert torch.equal(g, grad)


def test_grad_warm_misfit_kernel_matches_plain(mala_warm_problem):
    """(Φ, ∇Φ, aux) of the dst / 6 + 6 CG pair (a draw a warp,
    darcy_misfit_grad_warm_warp_kernel) from aux0 = 0 and from that aux after
    a MALA-sized move; bf16 rounding flips as in
    tests/test_torch_darcy_warm.py."""
    pag, aux_dim = mala_warm_problem.batched_warm_potential
    g = torch.Generator().manual_seed(1)
    U = mala_warm_problem.prior.sample(g, 512).T.contiguous()
    U2 = (U + 0.012 * mala_warm_problem.prior.sample(g, 512).T).contiguous()
    zeros = torch.zeros(aux_dim, 512, device="cuda")
    name = pag.grad_warm_kernel_label
    assert name == "darcy_misfit_grad_warm_warp_kernel[n=16]"
    before = _build.launch_counts[name]
    out1 = pag(U, zeros)
    out2 = pag(U2, out1[2])
    assert _build.launch_counts[name] == before + 2
    N = aux_dim // 2
    for got, ref in ((out1, pag._value_and_grad_plain(U, zeros[:N], zeros[N:])),
                     (out2, pag._value_and_grad_plain(U2, out1[2][:N], out1[2][N:]))):
        rel = _rel(got[0], ref[0])
        assert float(rel.median()) <= 2e-5 and float(rel.max()) <= 5e-3
        assert float(_col_err(got[1], ref[1]).median()) <= 1e-4
        assert float(_col_err(got[1], ref[1]).max()) <= 2e-2
        assert float(_col_err(got[2][:N], ref[2]).max()) <= 5e-3
        assert float(_col_err(got[2][N:], ref[3]).max()) <= 2e-2


def test_grad_warm_kernel_takes_a_spec_the_warp_rule_leaves(mala_warm_problem):
    """A 16² warm Jacobi / 48 + 48 CG pair (no config) stays on
    darcy_misfit_grad_kernel<true>, one draw a CTA, from aux0 = 0 (the cold
    pair's arithmetic) and from that aux after a MALA-sized move, and meets
    its plain twin under the cold pair's bounds: f32 only, so Φ within 1e-4
    and the gradient and solutions within 1e-3 of a draw's largest entry."""
    from ip_mcmc_tpu_torch.convert import darcy_mala_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    p = mala_warm_problem
    aux = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    pag, aux_dim = darcy_mala_warm_misfit_from_arrays(aux, p.data, 0.002, cg_iters=48,
                                                      precond="jacobi")
    pag = pag.cuda()
    name = pag.grad_warm_kernel_label
    assert name == "darcy_misfit_grad_warm_kernel"
    g = torch.Generator().manual_seed(41)
    U = p.prior.sample(g, 512).T.contiguous()
    U2 = (U + 0.012 * p.prior.sample(g, 512).T).contiguous()
    zeros = torch.zeros(aux_dim, 512, device="cuda")
    before = _build.launch_counts[name]
    out1 = pag(U, zeros)
    out2 = pag(U2, out1[2])
    assert _build.launch_counts[name] == before + 2
    N = aux_dim // 2
    for got, ref in ((out1, pag._value_and_grad_plain(U, zeros[:N], zeros[N:])),
                     (out2, pag._value_and_grad_plain(U2, out1[2][:N], out1[2][N:]))):
        assert float(_rel(got[0], ref[0]).max()) <= 1e-4
        assert float(_col_err(got[1], ref[1]).max()) <= 1e-3
        assert float(_col_err(got[2][:N], ref[2]).max()) <= 1e-3
        assert float(_col_err(got[2][N:], ref[3]).max()) <= 1e-3


def test_grad_warm_warp_kernel_on_a_ragged_width(mala_warm_problem):
    """darcy_mala_warm's warm pair on 13 draws: one CTA of 16 warps, 3
    spare leaving after the staging. A draw's warp needs no other, so (Φ,
    ∇Φ, aux) from aux0 = 0 and from the previous aux equal the first 13 of
    a 16-draw launch bit for bit."""
    pag, aux_dim = mala_warm_problem.batched_warm_potential
    g = torch.Generator().manual_seed(42)
    U = mala_warm_problem.prior.sample(g, 16).T.contiguous()
    aux0 = torch.zeros(aux_dim, 16, device="cuda")
    for _ in range(2):
        got, full = pag(U[:, :13].contiguous(), aux0[:, :13].contiguous()), pag(U, aux0)
        assert torch.equal(got[0], full[0][:13])
        assert all(torch.equal(a, b[:, :13]) for a, b in zip(got[1:], full[1:]))
        U = (U + 0.012 * mala_warm_problem.prior.sample(g, 16).T).contiguous()
        aux0 = full[2]


def test_grad_warm_warp_geometry_matches_the_kernel(mala_warm_problem):
    """ops/fused_mala.py misfit_grad_warm_warp_geometry and
    misfit_grad_warm_warp_takes give what the C function computes: the
    geometry of the warm MALA kernel's spec, cudaErrorNotSupported for the
    specs the rule leaves (warm Jacobi and dst_trunc pairs, the cold
    Jacobi misfit, the 32² misfits)."""
    import ctypes

    from ip_mcmc_tpu_torch.convert import darcy_mala_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    lib = _build.library()
    p = mala_warm_problem
    aux = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    left = [darcy_mala_warm_misfit_from_arrays(aux, p.data, 0.002, cg_iters=6, precond=pc,
                                               precond_modes=128)[0].cuda()
            for pc in ("jacobi", "dst_trunc")]
    pots = (p.batched_warm_potential[0], *left, p.batched_potential_fn, *_misfits32())
    taken = 0
    for pot in pots:
        for B in (4096, 13, 1, 0):
            out = (ctypes.c_int * 3)()
            status = lib.ipx_darcy_misfit_grad_warm_warp_geometry(ctypes.byref(pot.spec()), B,
                                                                  out)
            if fused_mala.misfit_grad_warm_warp_takes(**pot.spec_fields):
                assert status == 0 and tuple(out) == fused_mala.misfit_grad_warm_warp_geometry(
                    B, **pot.spec_fields)
                taken += 1
            else:
                assert "not supported" in lib.ipx_error_string(status).decode()
    assert taken == 4


@pytest.mark.parametrize("recorded", [False, True])
@pytest.mark.parametrize("kind", ["mala", "mala_warm", "fes"])
def test_gradient_and_ensemble_kernels_match_plain(mala_warm_problem, kind, recorded):
    p = mala_warm_problem
    pos = p.init_positions(torch.Generator().manual_seed(2), 512).cuda()
    pm, ps = p.prior.mean, p.prior.scale
    kw = {"thin": 2} if recorded else {}
    pot = p.batched_potential_fn
    if kind == "fes":
        args = (pos, pm, ps, 6, 3, 0.08, 2.0, 4, 128)
        got = fused_fes._launch(pot, *args, **kw)
        ref = fused_fes._run_plain(pot._forward_plain, *args, **kw)
    else:
        plain_pot = pot._forward_plain  # differentiable by the plain adjoint
        if kind == "mala_warm":
            pot, kw["aux_dim"] = p.batched_warm_potential
            plain_pot = pot._forward_warm_plain
        args = (pos, pm, ps, 0.012, 3, 4, 128)
        name = _scaffold_name(fused_mala.stem(kind == "mala_warm"), recorded)
        before = _build.launch_counts[name]
        got = fused_mala._launch(pot, *args, **kw)
        assert _build.launch_counts[name] == before + 1
        ref = fused_mala._run_plain(plain_pot, *args, **kw)
    if recorded:
        assert got[2].shape == ref[2].shape == (2, 512, 64)
        assert torch.equal(got[2][-1], got[0])
    elif kind == "fes":
        assert abs(float(got[2].mean()) - float(ref[2].mean())) <= 1e-2
    dev = (got[0] - ref[0]).abs().max(dim=1).values
    assert float((dev <= 1e-4).double().mean()) >= 0.99
    assert abs(float(got[1].mean()) - float(ref[1].mean())) <= 1e-2


def _scaffold_name(stem, recorded):
    return f"{stem}<{'true' if recorded else 'false'}>"


def test_gradient_and_ensemble_kernels_refuse_plain_callables(mala_warm_problem):
    pos = torch.zeros(64, 64, device="cuda")
    pm, ps = mala_warm_problem.prior.mean, mala_warm_problem.prior.scale
    phi = lambda U: U.sum(0)
    with pytest.raises(TypeError, match="DarcyMisfit"):
        fused_mala.fused_mala_chain(phi, pos, 0.01, 0, n_steps=1, block_chains=64,
                                    prior_mean=pm, prior_scale=ps)
    with pytest.raises(ValueError, match="prior_mean and prior_scale"):
        fused_mala.fused_mala_chain(mala_warm_problem.batched_potential_fn, pos,
                                    0.01, 0, n_steps=1, block_chains=64)
    with pytest.raises(TypeError, match="DarcyMisfitMalaWarm"):
        fused_mala.fused_mala_chain_warm(
            lambda U, a: (U.sum(0), U, a), pos, pm, ps, 0.01, 0, n_steps=1,
            aux_dim=512, block_chains=64)
    with pytest.raises(TypeError, match="DarcyMisfit"):
        fused_fes.fused_fes_chain(phi, pos, pm, ps, 6, 0, n_steps=1,
                                  block_chains=64)


# --- the Burgers path: K12, K13 and the Burgers instantiations of K4 / K6 ------


@pytest.fixture
def burgers_problem():
    return _build_on_card("burgers_da3_pcn")


def _burgers_levels(p):
    return p.batched_potential_fn, p.batched_mid_fn, p.batched_surrogate_fn


def test_burgers_misfit_kernel_matches_plain(burgers_problem):
    """Fine (128 cells / 154 steps), middle (128 / 52), coarse (64 / 26) and
    the three-segment misfit. The update is not contracted into an FMA, so
    from equal initial states kernel and plain give equal bits; the KL sum
    runs in another order, which moves an initial state by an ulp: Φ within
    1e-5 relative."""
    multitime = _build_on_card("burgers_multitime_pcn").batched_potential_fn
    U = burgers_problem.prior.sample(torch.Generator().manual_seed(0), 512).T.contiguous()
    for pot in (*_burgers_levels(burgers_problem), multitime):
        before = _build.launch_counts[pot.kernel_label]
        got = pot(U)
        assert _build.launch_counts[pot.kernel_label] == before + 1
        ref = pot._forward_plain(U)
        assert got.shape == ref.shape == (512,)
        assert float(_rel(got, ref).max()) <= 1e-5


def test_burgers_misfit_kernel_passes_nan_on(burgers_problem):
    pot = burgers_problem.batched_potential_fn
    U = burgers_problem.prior.sample(torch.Generator().manual_seed(1), 64).T.contiguous()
    U[5, 7] = float("nan")
    got = pot(U)
    assert bool(torch.isnan(got[7])) and int(torch.isnan(got).sum()) == 1


# --- K12 a draw a warp (burgers_misfit_warp_kernel) beside the kernel it
# replaced on the configs' levels (burgers_misfit_kernel, a draw a CTA)


def _burgers_misfit_levels(p):
    """The fine, middle and coarse levels and the multi-time one."""
    return (*_burgers_levels(p), _build_on_card("burgers_multitime_pcn").batched_potential_fn)


def _padded_burgers(pot):
    """``pot`` with a 17th KL mode of zeros: the rule leaves K = 17 to
    burgers_misfit_kernel, and fed U with a row of zeros the mode adds an
    exact zero to each cell's KL sum."""
    import copy

    padded = copy.deepcopy(pot)
    padded.basis = torch.cat([pot.basis, torch.zeros_like(pot.basis[:1])])
    padded.K = pot.K + 1
    return padded


@pytest.mark.parametrize("B", [2048, 2047, 13])
def test_burgers_misfit_warp_kernel_is_the_cta_kernel_bit_for_bit(burgers_problem, B):
    """At the four levels the kernel a draw a warp gives burgers_misfit_kernel's
    Φ bit for bit, that kernel running on the same level padded by a zero
    mode: at the configs' 2048 draws, and at 2047 and 13 (a ragged last CTA
    of 1 and of 3 spare warps)."""
    U = burgers_problem.prior.sample(torch.Generator().manual_seed(2), B).T.contiguous()
    U17 = torch.cat([U, torch.zeros_like(U[:1])])
    for pot in _burgers_misfit_levels(burgers_problem):
        padded = _padded_burgers(pot)
        assert pot.kernel_label.startswith("burgers_misfit_warp_kernel[")
        assert padded.kernel_label.startswith("burgers_misfit_kernel[")
        before = [_build.launch_counts[x.kernel_label] for x in (pot, padded)]
        got, old = pot(U), padded(U17)
        assert [_build.launch_counts[x.kernel_label] for x in (pot, padded)] == [
            c + 1 for c in before]
        assert got.shape == (B,) and torch.equal(got, old), pot.kernel_label


def test_burgers_misfit_warp_kernel_passes_nan_on(burgers_problem):
    """A NaN coefficient gives that draw's Φ NaN and no other draw's, on
    each level (the warps of a CTA share nothing but the staged level)."""
    U = burgers_problem.prior.sample(torch.Generator().manual_seed(3), 64).T.contiguous()
    U[5, 7] = float("nan")
    for pot in _burgers_misfit_levels(burgers_problem):
        got = pot(U)
        assert bool(torch.isnan(got[7])) and int(torch.isnan(got).sum()) == 1


def test_burgers_misfit_warp_geometry_matches_the_kernel(burgers_problem):
    """_burgers_warp.misfit_geometry (Python) gives what
    ipx_burgers_misfit_warp_geometry computes on the four levels at 2048,
    2047, 13, 1 and 0 draws; on levels the rule leaves (96 cells, 8 modes,
    a zero 17th mode) C says cudaErrorNotSupported and the mirror refuses."""
    import ctypes

    from ip_mcmc_tpu_torch.ops import _burgers_warp

    lib = _build.library()
    out = (ctypes.c_int * 3)()
    levels = _burgers_misfit_levels(burgers_problem)
    for pot in levels:
        for B in (2048, 2047, 13, 1, 0):
            assert lib.ipx_burgers_misfit_warp_geometry(ctypes.byref(pot.spec()), B, out) == 0
            assert tuple(out) == _burgers_warp.misfit_geometry(B, pot.n, pot.K), (pot.n, B)
    for pot in (_burgers_misfit(96), _burgers_misfit(128, n_modes=8),
                _padded_burgers(levels[0])):
        status = lib.ipx_burgers_misfit_warp_geometry(ctypes.byref(pot.spec()), 64, out)
        assert "not supported" in lib.ipx_error_string(status).decode()
        assert not _burgers_warp.misfit_takes(pot.n, pot.K)


def test_burgers_misfit_cta_kernel_takes_a_level_the_warp_kernel_leaves():
    """A 96-cell level runs on burgers_misfit_kernel, within 1e-5 of its
    plain version (the KL sum's order may move an initial state by an ulp,
    as in test_burgers_misfit_kernel_matches_plain)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    pot = _burgers_misfit(96)
    assert pot.kernel_label.startswith("burgers_misfit_kernel[n=96,")
    U = (0.5 * torch.randn(16, 512, generator=torch.Generator().manual_seed(4))).cuda()
    before = _build.launch_counts[pot.kernel_label]
    got = pot(U)
    assert _build.launch_counts[pot.kernel_label] == before + 1
    assert float(_rel(got, pot._forward_plain(U)).max()) <= 1e-5


@pytest.mark.parametrize("recorded", [False, True])
@pytest.mark.parametrize("kind", ["da3", "da", "pcn"])
def test_burgers_kernels_match_plain(burgers_problem, kind, recorded):
    from ip_mcmc_tpu_torch.ops import fused_da3_pcn as da3

    p = burgers_problem
    fine, mid, coarse = _burgers_levels(p)
    pos = p.init_positions(torch.Generator().manual_seed(2), 512).cuda()
    pm, ps = p.prior.mean, p.prior.scale
    kw = {"thin": 2} if recorded else {}
    if kind == "da3":
        name = da3.KERNEL
        args = (pos, pm, ps, 0.25, 3, 4, 3, 2, 128)
        got = da3._launch(fine, mid, coarse, *args, **kw)
        ref = da3._run_plain(fine._forward_plain, mid._forward_plain,
                             coarse._forward_plain, *args, **kw)
    elif kind == "da":
        name = da.BURGERS_KERNEL
        args = (pos, pm, ps, 0.15, 3)
        kw.update(n_steps=4, subchain_len=6, block_chains=128)
        got = da._launch(fine, coarse, *args, **kw)
        plain = da._run_plain_recorded if recorded else da._run_plain
        ref = plain(fine._forward_plain, coarse._forward_plain, *args, **kw)
    else:
        name = fused_pcn.BURGERS_KERNEL
        args = (pos, pm, ps, 0.15, 3, 4, 128)
        got = fused_pcn._launch(fine, *args, **kw)
        ref = fused_pcn._run_plain(fine._forward_plain, *args, **kw)
    assert _build.launch_counts[f"{name}<{'true' if recorded else 'false'}>"] >= 1
    if recorded:
        assert got[2].shape == ref[2].shape == (2, 512, 16)
        assert torch.equal(got[2][-1], got[0])
    elif kind != "pcn":  # inner (DA) or middle (DA3) acceptance
        assert abs(float(got[2].mean()) - float(ref[2].mean())) <= 1e-2
    dev = (got[0] - ref[0]).abs().max(dim=1).values
    assert float((dev <= 1e-4).double().mean()) >= 0.99
    assert abs(float(got[1].mean()) - float(ref[1].mean())) <= 1e-2
    assert 0.0 < float(got[1].mean()) < 1.0


def test_burgers_kernels_refuse_mixed_and_plain_potentials(burgers_problem, problem):
    from ip_mcmc_tpu_torch import ops

    fine, mid, coarse = _burgers_levels(burgers_problem)
    pos = torch.zeros(64, 16, device="cuda")
    pm, ps = burgers_problem.prior.mean, burgers_problem.prior.scale
    with pytest.raises(TypeError, match="one family"):
        da.fused_da_pcn_chain(fine, problem.batched_surrogate_fn, pos, pm, ps,
                              0.15, 0, n_steps=1, block_chains=64)
    with pytest.raises(TypeError, match="BurgersMisfit"):
        ops.fused_da3_pcn_chain(fine, lambda U: U.sum(0), coarse, pos, pm, ps,
                                0.25, 0, n_steps=1, block_chains=64)
    with pytest.raises(TypeError, match="DarcyMisfit"):
        fused_ess.fused_ess_chain(fine, pos, pm, ps, 0, n_steps=1,
                                  block_chains=64)


# --- the linear-Gaussian family: RWM (K14), dense pCN (K15), adaptive pCN (K16)


@pytest.fixture
def lingauss():
    """lingauss_pcn's misfit as a LinearGaussianPotential on the card, and
    its prior's KL spectrum."""
    from ip_mcmc_tpu_torch.convert import linear_gaussian_from_arrays

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    A, lam, y, sigma = configs.lingauss_arrays()
    return linear_gaussian_from_arrays(A, y, sigma).cuda(), torch.tensor(lam).float().cuda()


def _chains_agree(got, ref, steps):
    dev = (got[0] - ref[0]).abs().max(dim=1).values
    assert float((dev <= 1e-4).double().mean()) >= 0.99
    assert abs(float(got[1].mean()) - float(ref[1].mean())) <= 1e-2
    assert 0.0 < float(got[1].mean()) <= 1.0


def test_linear_gaussian_misfit_kernel_matches_plain(lingauss):
    """All f32, the row sums in another order: Φ within 1e-5 relative; the
    m = 0 potential is 0."""
    from ip_mcmc_tpu_torch.convert import linear_gaussian_from_arrays

    pot, lam = lingauss
    U = (torch.randn(32, 512, generator=torch.Generator().manual_seed(0)).cuda()
         * lam.sqrt()[:, None]).contiguous()
    before = _build.launch_counts[pot.kernel_label]
    got = pot(U)
    assert _build.launch_counts[pot.kernel_label] == before + 1
    assert float(_rel(got, pot._forward_plain(U)).max()) <= 1e-5
    # an upper-triangular A = L^T: the row-major layout matters
    g2 = configs.gauss2d_batched_potential().cuda()
    U2 = (10.0 * torch.randn(2, 512, generator=torch.Generator().manual_seed(1))).cuda()
    assert float(_rel(g2(U2), g2._forward_plain(U2)).max()) <= 1e-5
    zero = linear_gaussian_from_arrays(torch.zeros(0, 32).numpy(), [], 1.0).cuda()
    assert torch.equal(zero(U), torch.zeros(512, device="cuda"))


def _linear_misfit(m, d, seed):
    """A seeded linear-Gaussian misfit of m rows on d coordinates, σ 0.05,
    on the card."""
    from ip_mcmc_tpu_torch.convert import linear_gaussian_from_arrays

    r = np.random.default_rng(seed)
    return linear_gaussian_from_arrays(r.standard_normal((m, d)) / np.sqrt(d),
                                       0.1 * r.standard_normal(m), 0.05).cuda()


@pytest.mark.parametrize("recorded", [False, True])
@pytest.mark.parametrize("sampler", ["pcn", "ess", "fes", "mala", "da_pcn", "da3_pcn"])
def test_linear_family_fused_kernels_match_plain(lingauss, sampler, recorded):
    """The six samplers one chain a CTA on lingauss_pcn's misfit (the
    surrogate and middle levels: σ × 1.25 and × 1.1), each against its
    plain twin from the same start and seed: the chains within 1e-4, the
    mean rates within 1e-4; MALA's start value and gradient by its kernel.
    A d the takes-rule refuses raises before any launch."""
    from ip_mcmc_tpu_torch.convert import linear_gaussian_from_arrays
    from ip_mcmc_tpu_torch.ops import fused_da3_pcn

    pot, lam = lingauss
    A, _, y, sigma = configs.lingauss_arrays()
    surr = linear_gaussian_from_arrays(A, y, 1.25 * sigma).cuda()
    mid = linear_gaussian_from_arrays(A, y, 1.1 * sigma).cuda()
    g = torch.Generator().manual_seed(17)
    pos = (torch.randn(512, 32, generator=g).cuda() * lam.sqrt()).contiguous()
    pm, ps = torch.zeros(32), lam.sqrt()
    steps, block = 12, 128
    kw = {"thin": 2} if recorded else {}
    plain = pot._forward_plain
    runs = {
        "pcn": (fused_pcn.LINEAR_KERNEL,
                lambda: fused_pcn._launch(pot, pos, pm, ps, 0.2, 5, steps, block, **kw),
                lambda: fused_pcn._run_plain(plain, pos, pm, ps, 0.2, 5, steps, block, **kw)),
        "ess": (fused_ess.LINEAR_KERNEL,
                lambda: fused_ess._launch(pot, pos, pm, ps, 5, steps, 30, block, **kw),
                lambda: fused_ess._run_plain(plain, pos, pm, ps, 5, steps, 30, block, **kw)),
        "fes": (fused_fes.LINEAR_KERNEL,
                lambda: fused_fes._launch(pot, pos, pm, ps, 6, 5, 0.25, 2.0, steps, block,
                                          **kw),
                lambda: fused_fes._run_plain(plain, pos, pm, ps, 6, 5, 0.25, 2.0, steps,
                                             block, **kw)),
        "mala": (fused_mala.LINEAR_KERNEL,
                 lambda: fused_mala._launch(pot, pos, pm, ps, 0.02, 5, steps, block, **kw),
                 lambda: fused_mala._run_plain(plain, pos, pm, ps, 0.02, 5, steps, block,
                                               **kw)),
        "da_pcn": (da.LINEAR_KERNEL,
                   lambda: da._launch(pot, surr, pos, pm, ps, 0.2, 5, steps, 4, block, **kw),
                   (lambda: da._run_plain_recorded(plain, surr._forward_plain, pos, pm, ps,
                                                   0.2, 5, steps, 2, 4, block)) if recorded
                   else (lambda: da._run_plain(plain, surr._forward_plain, pos, pm, ps, 0.2,
                                               5, steps, 4, block))),
        "da3_pcn": (fused_da3_pcn.LINEAR_KERNEL,
                    lambda: fused_da3_pcn._launch(pot, mid, surr, pos, pm, ps, 0.2, 5, steps,
                                                  4, 2, block, **kw),
                    lambda: fused_da3_pcn._run_plain(plain, mid._forward_plain,
                                                     surr._forward_plain, pos, pm, ps, 0.2, 5,
                                                     steps, 4, 2, block, **kw)),
    }
    stem, kern, ref = runs[sampler]
    name = f"{stem}<{'true' if recorded else 'false'}>"
    start = (pot.grad_kernel_label if sampler == "mala" else pot.kernel_label)
    before = dict(_build.launch_counts)
    got = kern()
    if sampler == "fes":  # two launches a step, those of the recorded steps <true>
        both = [f"{stem}<false>", f"{stem}<true>"]
        assert (sum(_build.launch_counts[k] - before.get(k, 0) for k in both) == 2 * steps)
    else:
        assert _build.launch_counts[name] == before.get(name, 0) + 1
    levels = {"da_pcn": 2, "da3_pcn": 3}.get(sampler, 1)  # Φ0 of each level
    assert _build.launch_counts[start] == before.get(start, 0) + levels
    want = ref()
    dev = (got[0] - want[0]).abs().max(dim=1).values
    assert float((dev <= 1e-4).double().mean()) >= 0.99
    for a, b in zip(got[1:], want[1:]):
        if a.dim() == 1:
            assert abs(float(a.mean()) - float(b.mean())) <= 1e-4
        else:
            assert a.shape == b.shape == (steps // 2, 512, 32)
            assert float(((a - b).abs().max(dim=2).values <= 1e-4).double().mean()) >= 0.99
    if sampler == "mala":
        U = pos.T.contiguous()
        (phi, grad), (phi_ref, grad_ref) = pot.value_and_grad(U), pot._value_and_grad_plain(U)
        assert float(_rel(phi, phi_ref).max()) <= 1e-5
        w = (pot.data[:, None] - pot.A @ U) / pot.noise[:, None] ** 2
        assert float(((grad - grad_ref).abs() / (pot.A.abs().T @ w.abs())).max()) <= 1e-5
    short = pos[:, :31].contiguous()
    with pytest.raises(ValueError, match="linear-Gaussian levels with K = d"):
        if sampler in ("da_pcn", "da3_pcn"):
            da._launch(pot, surr, short, pm[:31], ps[:31], 0.2, 5, 2, 4, block)
        else:
            fused_pcn._launch(pot, short, pm[:31], ps[:31], 0.2, 5, 2, block)


@pytest.mark.parametrize("recorded", [False, True])
@pytest.mark.parametrize("kind", ["rwm", "rwm_prior", "rwm_darcy", "pcn_dense",
                                  "pcn_dense_full", "rwm_gauss2d", "rwm_d3", "rwm_m40",
                                  "pcn_dense_d3", "pcn_dense_m40", "pcn_dense_gauss2d"])
def test_linear_gaussian_kernels_match_plain(lingauss, warm_problem, kind, recorded):
    """Each sampler against its plain twin on the kernel the takes-rule
    picks: the group kernels on lingauss (d = 32, m = 16) and gauss2d (d =
    2: RWM with the prior, dense pCN with L = I); one chain a CTA on d = 3
    and on m = 40, which the rule leaves; Darcy RWM on its own kernel."""
    from ip_mcmc_tpu_torch.ops import fused_pcn_dense, fused_rwm

    pot, lam = lingauss
    g = torch.Generator().manual_seed(3)
    pos = (torch.randn(512, 32, generator=g).cuda() * lam.sqrt()).contiguous()
    if kind.endswith("m40"):
        pot = _linear_misfit(40, 32, seed=5)
    elif kind.endswith("d3"):
        pot = _linear_misfit(3, 3, seed=6)
        pos, lam = torch.randn(512, 3, generator=g).cuda(), torch.ones(3, device="cuda")
    elif kind.endswith("gauss2d"):
        pot = configs.gauss2d_batched_potential().cuda()
        pos, lam = (3.0 * torch.randn(512, 2, generator=g)).cuda(), torch.ones(2, device="cuda")
    kw = {"thin": 2} if recorded else {}
    steps, block = 8, 128
    if kind.startswith("pcn_dense"):
        d = pos.shape[1]
        name = fused_pcn_dense.stem(pot, d)
        assert name == ("fused_pcn_dense_kernel" if kind in ("pcn_dense_d3", "pcn_dense_m40")
                        else "fused_pcn_dense_group_kernel")
        chol = torch.diag(lam.sqrt())
        if kind == "pcn_dense_full":  # every entry below the diagonal nonzero
            G = torch.randn(32, 32, generator=g, dtype=torch.float64)
            D = torch.diag(lam.double().sqrt().cpu())
            chol = torch.linalg.cholesky(D @ (G @ G.T / 32 + 0.5 * torch.eye(32)) @ D)
            assert bool((chol.tril(-1)[tuple(torch.tril_indices(32, 32, -1))] != 0).all())
            chol = chol.float()
        args = (pos, torch.zeros(d), chol, 0.2, 5, steps, block)
        got = fused_pcn_dense._launch(pot, *args, **kw)
        ref = fused_pcn_dense._run_plain(pot._forward_plain, *args, **kw)
    else:
        prior = {}
        if kind == "rwm_darcy":
            pot = warm_problem.batched_potential_fn
            pos = warm_problem.init_positions(g, 512).cuda()
        if kind != "rwm":
            prior = dict(prior_mean=torch.zeros(pos.shape[1]),
                         prior_scale=torch.ones(pos.shape[1]))
        name = fused_rwm.stem(pot, pos.shape[1])
        assert name == {"rwm_darcy": "fused_rwm_darcy_kernel", "rwm_d3": "fused_rwm_kernel",
                        "rwm_m40": "fused_rwm_kernel"}.get(kind, "fused_rwm_group_kernel")
        args = (pos, 0.01 if kind == "rwm_darcy" else 0.05, 5, steps, block)
        got = fused_rwm._launch(pot, *args, **kw, **prior)
        ref = fused_rwm._run_plain(pot._forward_plain, *args, **kw, **prior)
    assert _build.launch_counts[f"{name}<{'true' if recorded else 'false'}>"] >= 1
    assert got[0].shape == ref[0].shape == pos.shape
    if recorded:
        assert got[2].shape == ref[2].shape == (steps // 2, 512, pos.shape[1])
        assert torch.equal(got[2][-1], got[0])
    _chains_agree(got, ref, steps)


def test_pcn_adapt_kernels_match_plain(lingauss):
    """The burn-in on the shipped spec's kernel (fused_pcn_adapt_group_kernel,
    one launch) against the plain loop: kernel and plain loop pool each
    block in the same order and update log β without FMA contraction, so β
    within 1e-5 relative (what differs is Φ's rounding), the chains within
    1e-4."""
    from ip_mcmc_tpu_torch.ops import fused_pcn_adapt

    pot, lam = lingauss
    pos = (torch.randn(512, 32, generator=torch.Generator().manual_seed(4)).cuda()
           * lam.sqrt()).contiguous()
    args = (pos, torch.zeros(32), lam.sqrt(), 0.5, 6, 20, 0.3, 0.5, 128)
    name = fused_pcn_adapt.GROUP_KERNEL
    assert fused_pcn_adapt.stem(pot, 32, 128, 512) == name
    before = _build.launch_counts[name]
    got = fused_pcn_adapt._launch(pot, *args)
    assert _build.launch_counts[name] == before + 1
    ref = fused_pcn_adapt._run_plain(pot._forward_plain, *args)
    _chains_agree(got, ref, 20)
    assert float(_rel(got[2], ref[2]).max()) <= 1e-5
    blocks = got[2].reshape(-1, 128)
    assert torch.equal(blocks, blocks[:, :1].expand_as(blocks))  # one β per block
    assert bool(((blocks[:, 0] - 0.5).abs() > 1e-3).all())  # moved from β0
    assert bool(((got[2] > 1e-4) & (got[2] < 0.999 + 1e-6)).all())


def _adapt_case(kind, lingauss):
    """(potential, positions, block) of a burn-in the group kernel takes:
    the shipped spec (2048 chains of lingauss in blocks of 256), a ragged
    one (300 in blocks of 100: spare chains on the last CTA of each
    cluster), and d = 2 (gauss2d, 1024 in blocks of 256: a CTA a block)."""
    pot, lam = lingauss
    g = torch.Generator().manual_seed(12)
    if kind == "gauss2d":
        pot = configs.gauss2d_batched_potential().cuda()
        return pot, (3.0 * torch.randn(1024, 2, generator=g)).cuda(), 256
    n, block = {"shipped": (2048, 256), "ragged": (300, 100)}[kind]
    return pot, (torch.randn(n, 32, generator=g).cuda() * lam.sqrt()).contiguous(), block


@pytest.mark.parametrize("kind", ["shipped", "ragged", "gauss2d"])
def test_pcn_adapt_group_equals_two_launches(lingauss, kind):
    """The one-launch burn-in against the parent's host loop (two launches
    a step) from the same start and seed: final chains, acceptance rates
    and β bit for bit, 60 steps. One launch a call through the entry
    point."""
    from ip_mcmc_tpu_torch import ops
    from ip_mcmc_tpu_torch.ops import fused_pcn_adapt

    pot, pos, block = _adapt_case(kind, lingauss)
    d = pos.shape[1]
    args = (pos, torch.zeros(d), torch.ones(d) if kind == "gauss2d" else lingauss[1].sqrt(),
            0.4, 13, 60, 0.234, 0.5, block)
    name = fused_pcn_adapt.GROUP_KERNEL
    counts = dict(_build.launch_counts)
    got = ops.fused_pcn_chain_adapt(pot, *args[:5], n_steps=60, target_accept=0.234,
                                    gain=0.5, block_chains=block)
    assert _build.launch_counts[name] == counts.get(name, 0) + 1
    assert _build.launch_counts["fused_pcn_adapt_kernel"] == counts.get(
        "fused_pcn_adapt_kernel", 0)
    ref = fused_pcn_adapt._launch_steps(pot, *args)
    for a, b, what in zip(got, ref, ("chains", "acceptance", "beta")):
        assert torch.equal(a, b), what
    assert 0.0 < float(got[1].mean()) < 1.0


def _adapt_c_geometry(pot, n, block, n_steps=1):
    """ipx_pcn_adapt_group_geometry on the card: (status, (G, warps, CTAs a
    cluster, CTAs)); the clusters the card holds at once must be 1 or more."""
    import ctypes

    from ip_mcmc_tpu_torch.ops import _scaffold

    pos = torch.zeros(n, pot.K, device="cuda")
    args, _ = _scaffold.chain_args(pos, torch.zeros(pot.K), torch.ones(pot.K), 0, n_steps,
                                   block)
    out, spec = (ctypes.c_int * 5)(), pot.spec()
    status = _build.library().ipx_pcn_adapt_group_geometry(
        ctypes.byref(spec), ctypes.byref(args), out)
    assert status != 0 or out[4] >= 1
    return status, tuple(out)[:4]


def test_pcn_adapt_group_geometry_matches_the_kernel(lingauss):
    """ops/fused_pcn_adapt.group_geometry (Python) gives what the group
    kernel's launch computes, and both leave the same specs."""
    from ip_mcmc_tpu_torch.ops import fused_pcn_adapt

    pot, _ = lingauss
    g2 = configs.gauss2d_batched_potential().cuda()
    for p, n, block in ((pot, 2048, 256), (pot, 300, 100), (pot, 14, 7), (pot, 0, 256),
                        (g2, 1024, 256), (g2, 1, 1), (_linear_misfit(32, 32, seed=7), 512, 128)):
        assert _adapt_c_geometry(p, n, block) == (0, fused_pcn_adapt.group_geometry(
            n, block, d=p.K, m=p.m)), (p.K, p.m, n, block)
    for p, n, block in ((_linear_misfit(40, 32, seed=8), 256, 256),
                        (_linear_misfit(3, 3, seed=8), 64, 64), (pot, 1024, 512),
                        (g2, 1024, 512), (pot, 512, 384)):
        assert _adapt_c_geometry(p, n, block)[0] == 801  # cudaErrorNotSupported
        assert not fused_pcn_adapt.group_takes(p.K, p.m, p.K, block, n)


@pytest.mark.parametrize("kind", ["m40", "block512"])
def test_pcn_adapt_left_specs_keep_two_launches_a_step(lingauss, kind):
    """A spec the group rule leaves (m = 40 > d; a block of 512, more than
    a cluster) runs the host loop: two launches a step, no group launch,
    and agrees with the plain loop."""
    from ip_mcmc_tpu_torch import ops
    from ip_mcmc_tpu_torch.ops import fused_pcn_adapt

    pot, lam = lingauss
    if kind == "m40":
        pot = _linear_misfit(40, 32, seed=9)
    pos = (torch.randn(1024, 32, generator=torch.Generator().manual_seed(14)).cuda()
           * lam.sqrt()).contiguous()
    block = 512 if kind == "block512" else 256
    assert fused_pcn_adapt.stem(pot, 32, block, 1024) == "fused_pcn_adapt_kernel"
    counts = dict(_build.launch_counts)
    got = ops.fused_pcn_chain_adapt(pot, pos, torch.zeros(32), lam.sqrt(), 0.4, 15,
                                    n_steps=10, target_accept=0.3, block_chains=block)
    for k in ("fused_pcn_adapt_kernel", "pcn_adapt_update_kernel"):
        assert _build.launch_counts[k] == counts.get(k, 0) + 10
    assert _build.launch_counts[fused_pcn_adapt.GROUP_KERNEL] == counts.get(
        fused_pcn_adapt.GROUP_KERNEL, 0)
    ref = fused_pcn_adapt._run_plain(pot._forward_plain, pos, torch.zeros(32), lam.sqrt(),
                                     0.4, 15, 10, 0.3, 0.5, block)
    _chains_agree(got, ref, 10)
    assert float(_rel(got[2], ref[2]).max()) <= 1e-5


def test_linear_gaussian_kernels_refuse_other_potentials(lingauss, burgers_problem):
    from ip_mcmc_tpu_torch import ops

    pot, lam = lingauss
    fine = burgers_problem.batched_potential_fn
    pos = torch.zeros(64, 16, device="cuda")
    with pytest.raises(TypeError, match="LinearGaussianPotential"):
        ops.fused_rwm_chain(fine, pos, 0.1, 0, n_steps=1, block_chains=64)
    with pytest.raises(TypeError, match="LinearGaussianPotential"):
        ops.fused_pcn_chain_dense(fine, pos, torch.zeros(16), torch.eye(16), 0.2, 0,
                                  n_steps=1, block_chains=64)
    with pytest.raises(TypeError, match="LinearGaussianPotential"):
        ops.fused_pcn_chain_adapt(lambda U: U.sum(0), pos, torch.zeros(16),
                                  torch.ones(16), 0.5, 0, n_steps=1, block_chains=64)


def _group_c_geometry(pot, n, block):
    """ipx_gaussian_group_geometry on the card: (status, (G, warps, CTAs))."""
    import ctypes

    from ip_mcmc_tpu_torch.ops import _scaffold

    pos = torch.zeros(n, pot.K, device="cuda")
    args, _ = _scaffold.chain_args(pos, torch.zeros(pot.K), torch.ones(pot.K), 0, 1, block)
    out, spec = (ctypes.c_int * 3)(), pot.spec()
    status = _build.library().ipx_gaussian_group_geometry(
        ctypes.byref(spec), ctypes.byref(args), out)
    return status, tuple(out)


def test_linear_group_geometry_matches_the_kernel(lingauss):
    """ops/_gaussian_group.geometry (Python) gives what the group kernels'
    launches compute, at the shipped widths, ragged, one chain and none."""
    from ip_mcmc_tpu_torch.ops import _gaussian_group

    pot, _ = lingauss
    g2 = configs.gauss2d_batched_potential().cuda()
    for p, n, block in ((g2, 8192, 1024), (g2, 1024, 512), (pot, 2048, 256), (g2, 13, 8),
                        (pot, 13, 8), (_linear_misfit(1, 2, seed=7), 1, 1), (pot, 0, 256)):
        assert _group_c_geometry(p, n, block) == (0, _gaussian_group.geometry(
            n, block, d=p.K, m=p.m)), (p.K, p.m, n, block)


def test_linear_group_rule_leaves_the_same_specs_in_c_and_python(lingauss):
    """d = 3, m = 40, d = 64, d = 16, d = 2 with m = 5: C refuses them to the group kernels
    (cudaErrorNotSupported), the mirror does not take them, and the entry
    points run them on the one-chain-a-CTA kernels, which agree with their
    twins."""
    from ip_mcmc_tpu_torch.ops import _gaussian_group, fused_pcn_dense, fused_rwm

    for m, d in ((3, 3), (40, 32), (16, 64), (8, 16), (5, 2)):
        pot = _linear_misfit(m, d, seed=8)
        assert _group_c_geometry(pot, 64, 64)[0] == 801  # cudaErrorNotSupported
        assert not _gaussian_group.takes(d, m, d)
        pos = torch.randn(64, d, generator=torch.Generator().manual_seed(9)).cuda()
        before = _build.launch_counts["fused_rwm_kernel<false>"]
        got = fused_rwm._launch(pot, pos, 0.02, 3, 4, 32)
        assert _build.launch_counts["fused_rwm_kernel<false>"] == before + 1
        _chains_agree(got, fused_rwm._run_plain(pot._forward_plain, pos, 0.02, 3, 4, 32), 4)
        before = _build.launch_counts["fused_pcn_dense_kernel<false>"]
        args = (pos, torch.zeros(d), 0.1 * torch.eye(d), 0.3, 3, 4, 32)
        got = fused_pcn_dense._launch(pot, *args)
        assert _build.launch_counts["fused_pcn_dense_kernel<false>"] == before + 1
        _chains_agree(got, fused_pcn_dense._run_plain(pot._forward_plain, *args), 4)


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("kind", ["rwm_gauss2d", "rwm_lingauss", "pcn_dense_lingauss",
                                  "pcn_dense_gauss2d"])
def test_linear_group_kernels_with_ragged_last_warp(lingauss, kind, record):
    """13 chains in blocks of 8: at d = 2 three spare groups in the one
    live warp, at d = 32 one CTA with three spare warps. Equal bit for bit
    to the first 13 of the kernel's own 16-chain run, within 1e-4 of the
    plain twin's."""
    from ip_mcmc_tpu_torch.ops import fused_pcn_dense, fused_rwm

    pot, lam = lingauss
    g = torch.Generator().manual_seed(10)
    kw = {"thin": 1} if record else {}
    if kind == "rwm_gauss2d":
        pot = configs.gauss2d_batched_potential().cuda()
        pos = (3.0 * torch.randn(16, 2, generator=g)).cuda()
        prior = dict(prior_mean=torch.zeros(2), prior_scale=torch.full((2,), 10.0))
        run = lambda x: fused_rwm._launch(pot, x, 1.0, 11, 5, 8, **prior, **kw)
        ref = fused_rwm._run_plain(pot._forward_plain, pos, 1.0, 11, 5, 8, **prior, **kw)
    elif kind == "rwm_lingauss":
        pos = (torch.randn(16, 32, generator=g).cuda() * lam.sqrt()).contiguous()
        run = lambda x: fused_rwm._launch(pot, x, 0.01, 11, 5, 8, **kw)
        ref = fused_rwm._run_plain(pot._forward_plain, pos, 0.01, 11, 5, 8, **kw)
    elif kind == "pcn_dense_gauss2d":
        pot = configs.gauss2d_batched_potential().cuda()
        pos = (3.0 * torch.randn(16, 2, generator=g)).cuda()
        args = (torch.zeros(2), torch.eye(2), 0.5, 11, 5, 8)
        run = lambda x: fused_pcn_dense._launch(pot, x, *args, **kw)
        ref = fused_pcn_dense._run_plain(pot._forward_plain, pos, *args, **kw)
    else:
        pos = (torch.randn(16, 32, generator=g).cuda() * lam.sqrt()).contiguous()
        args = (torch.zeros(32), torch.diag(lam.sqrt()), 0.2, 11, 5, 8)
        run = lambda x: fused_pcn_dense._launch(pot, x, *args, **kw)
        ref = fused_pcn_dense._run_plain(pot._forward_plain, pos, *args, **kw)
    got, full = run(pos[:13]), run(pos)
    for a, b in zip(got, full):
        assert torch.equal(a, b[:, :13] if a.dim() == 3 else b[:13])
    _chains_agree(got, tuple(t[:, :13] if t.dim() == 3 else t[:13] for t in ref), 5)


# --- K17 (Richardson) and the large Darcy grids --------------------------------


def test_misfit_spec_layout_matches_the_c_struct():
    """IpxMisfitSpec and its ctypes mirror: a field added on one side only
    would shift every field after it."""
    import ctypes

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    assert _build.library().ipx_misfit_spec_size() == ctypes.sizeof(_build.MisfitSpec)


@pytest.fixture
def richardson_problems():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return {v: configs.darcy_da_richardson(v, "cuda") for v in configs.RICHARDSON_VARIANTS}


def test_richardson_misfit_kernel_matches_plain(richardson_problems):
    """K17 on each surrogate of benchmarks/darcy_da_richardson.py: bf16
    rounding flips as in tests/test_torch_darcy_richardson.py (Richardson's
    recomputed residual b - Ax flips more roundings than CG's)."""
    g = torch.Generator().manual_seed(5)
    for variant, p in richardson_problems.items():
        surr = p.batched_surrogate_fn
        U = p.prior.sample(g, 512).T.contiguous()
        before = _build.launch_counts[surr.kernel_label]
        got = surr(U)
        assert _build.launch_counts[surr.kernel_label] == before + 1
        assert surr.kernel_label.endswith(",richardson]") == (variant != "cg3")
        rel = _rel(got, surr._forward_plain(U))
        assert float(rel.median()) <= 5e-5, variant
        assert float((rel <= 1e-4).double().mean()) >= 0.80, variant
        assert float(rel.max()) <= 5e-3, variant


@pytest.mark.parametrize("record", [False, True])
def test_da_kernel_with_richardson_surrogate_matches_plain(richardson_problems, record):
    p = richardson_problems["rich3_w0.9"]
    pos = p.init_positions(torch.Generator().manual_seed(6), 512).cuda()
    exact, surr = p.batched_potential_fn, p.batched_surrogate_fn
    args = (exact, surr, pos, p.prior.mean, p.prior.scale, 0.35, 3)
    plain_args = (exact._forward_plain, surr._forward_plain, *args[2:])
    kw = dict(n_steps=4, subchain_len=6, block_chains=128)
    name = f"fused_da_pcn_warp_kernel[surrogate=richardson]<{'true' if record else 'false'}>"
    before = _build.launch_counts[name]
    if record:
        got = da.fused_da_pcn_chain_recorded(*args, thin=2, **kw)
        ref = da._run_plain_recorded(*plain_args, thin=2, **kw)
    else:
        got = da.fused_da_pcn_chain(*args, **kw)
        ref = da._run_plain(*plain_args, **kw)
    assert _build.launch_counts[name] == before + 1
    _chains_agree(got, ref, 4)


def test_cg_kernels_refuse_a_richardson_misfit(richardson_problems):
    surr = richardson_problems["rich3_w0.9"].batched_surrogate_fn
    pos = torch.zeros(64, 64, device="cuda")
    with pytest.raises(TypeError, match="by CG"):
        fused_pcn.fused_pcn_chain(surr, pos, torch.zeros(64), torch.ones(64), 0.08, 0,
                                  n_steps=1, block_chains=64)
    with pytest.raises(TypeError, match="by CG"):
        da.fused_da_pcn_chain(surr, surr, pos, torch.zeros(64), torch.ones(64), 0.35, 0,
                              n_steps=1, block_chains=64)


@pytest.fixture(params=["darcy32_pcn_warm", "darcy64_pcn_warm"])
def large_problem(request):
    return _build_on_card(request.param)


def test_large_grid_misfit_kernels_match_plain(large_problem):
    """The cold misfit (32²: Jacobi-96, all f32; 64²: dst_trunc-256, 30 CG)
    and the warm dst_trunc misfit from x0 = 0 and from that solution after
    a pCN-sized move, several cells a thread (at 64² on the samplers'
    cluster level); bf16 rounding flips as in
    tests/test_torch_darcy_large.py."""
    p = large_problem
    g = torch.Generator().manual_seed(7)
    U = p.prior.sample(g, 256).T.contiguous()
    cold = p.batched_potential_fn
    rel = _rel(cold(U), cold._forward_plain(U))
    assert _build.launch_counts[cold.kernel_label] >= 1
    assert float(rel.max()) <= (1e-4 if cold.precond == "jacobi" else 5e-3)
    assert float(rel.median()) <= 2e-5
    warm, aux_dim = p.batched_warm_potential
    U2 = (0.9968 * U + 0.08 * p.prior.sample(g, 256).T).contiguous()
    x0 = torch.zeros(aux_dim, 256, device="cuda")
    for V in (U, U2):
        phi, x = warm(V, x0)
        ref_phi, ref_x = warm._forward_warm_plain(V, x0)
        assert float(_rel(phi, ref_phi).max()) <= 5e-3
        assert float(_rel(phi, ref_phi).median()) <= 2e-4
        assert float(_col_err(x, ref_x).max()) <= 5e-3
        x0 = ref_x


@pytest.mark.parametrize("recorded", [False, True])
def test_large_grid_warm_pcn_matches_plain(large_problem, recorded):
    p = large_problem
    warm, aux_dim = p.batched_warm_potential
    pos = p.init_positions(torch.Generator().manual_seed(8), 256).cuda()
    kw = {"thin": 2} if recorded else {}
    args = (pos, p.prior.mean, p.prior.scale, p.kernel_params["beta"], 3, 4, 128)
    got = fused_pcn._launch(warm, *args, aux_dim=aux_dim, **kw)
    ref = fused_pcn._run_plain(warm._forward_warm_plain, *args, aux_dim=aux_dim, **kw)
    stem = fused_pcn._darcy_stem(warm, True)  # 64²: the cluster kernel
    assert _build.launch_counts[f"{stem}<{'true' if recorded else 'false'}>"] >= 1
    if recorded:
        assert got[2].shape == ref[2].shape == (2, 256, p.dim)
        assert torch.equal(got[2][-1], got[0])
    _chains_agree(got, ref, 4)
    # the cold kernel on the same grid
    cold = p.batched_potential_fn
    got = fused_pcn._launch(cold, *args, **kw)
    ref = fused_pcn._run_plain(cold._forward_plain, *args, **kw)
    _chains_agree(got, ref, 4)


def test_grids_beyond_64_are_refused():
    """No layout takes more than 64 x 64 cells: the launch is refused
    (cudaErrorInvalidValue), and the wrapper raises."""
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays, darcy_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    aux = darcy.darcy_aux(n_grid=72, n_modes_per_dim=4)
    y = torch.zeros(16).numpy()
    U = torch.zeros(16, 4, device="cuda")
    with pytest.raises(RuntimeError, match="launch failed"):
        darcy_misfit_from_arrays(aux, y, 0.01, cg_iters=2).cuda()(U)
    warm, aux_dim = darcy_warm_misfit_from_arrays(aux, y, 0.01, cg_iters=2)
    with pytest.raises(RuntimeError, match="launch failed"):
        warm.cuda()(U, torch.zeros(aux_dim, 4, device="cuda"))


@pytest.fixture
def darcy64_da():
    return _build_on_card("darcy64_da_fused")


def test_darcy64_da_misfit_kernels_match_plain(darcy64_da):
    """The exact misfit (64², dst_trunc-256, 16 CG, on the samplers' cluster
    level) and the surrogate (32², dst_trunc-128, 3 CG, Layout32) of
    darcy64_da_fused;
    bf16 rounding flips as in tests/test_torch_darcy64_da.py."""
    p = darcy64_da
    U = p.prior.sample(torch.Generator().manual_seed(10), 256).T.contiguous()
    for pot in (p.batched_potential_fn, p.batched_surrogate_fn):
        before = _build.launch_counts[pot.kernel_label]
        rel = _rel(pot(U), pot._forward_plain(U))
        assert _build.launch_counts[pot.kernel_label] == before + 1
        assert float(rel.median()) <= 2e-4, pot.n
        assert float((rel <= 1e-3).double().mean()) >= 0.90, pot.n
        assert float(rel.max()) <= 5e-3, pot.n


@pytest.mark.parametrize("record", [False, True])
def test_da_kernel_at_64_with_32_surrogate_matches_plain(darcy64_da, record):
    """The 64² DA kernel (fused_da_pcn_cluster_kernel): one chain a CTA of
    ClusterDesign's layout, the 32² surrogate on the same threads, the
    chains of a thread-block cluster sharing each read of the factors."""
    p = darcy64_da
    pos = p.init_positions(torch.Generator().manual_seed(11), 256).cuda()
    exact, surr = p.batched_potential_fn, p.batched_surrogate_fn
    args = (exact, surr, pos, p.prior.mean, p.prior.scale, p.kernel_params["beta"], 3)
    plain_args = (exact._forward_plain, surr._forward_plain, *args[2:])
    kw = dict(n_steps=2, subchain_len=8, block_chains=128)
    name = f"fused_da_pcn_cluster_kernel<{'true' if record else 'false'}>"
    before = _build.launch_counts[name]
    if record:
        got = da.fused_da_pcn_chain_recorded(*args, thin=1, **kw)
        ref = da._run_plain_recorded(*plain_args, thin=1, **kw)
        assert got[2].shape == ref[2].shape == (2, 256, p.dim)
        assert torch.equal(got[2][-1], got[0])
    else:
        got = da.fused_da_pcn_chain(*args, **kw)
        ref = da._run_plain(*plain_args, **kw)
        assert 0.0 < float(got[2].mean()) < 1.0
        assert abs(float(got[2].mean()) - float(ref[2].mean())) <= 1e-2
    assert _build.launch_counts[name] == before + 1
    _chains_agree(got, ref, 2)


def _da_misfit(y, n, **kw):
    """A dst_trunc-64 / 3 CG misfit on an n² grid with 144 KL modes."""
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    aux = darcy.darcy_aux(n_grid=n, n_modes_per_dim=12, alpha=2.0, field_scale=10.0)
    return darcy_misfit_from_arrays(aux, y, 0.002, cg_iters=3, precond="dst_trunc",
                                    precond_modes=64, **kw).cuda()


def test_da_kernel_refuses_other_grid_pairs(darcy64_da):
    """The DA kernels take both levels up to 16² and a 33²–64² exact grid
    with a 17²–32² CG surrogate; any other pair of grids (a 64² exact grid
    with a 16² surrogate, a 16² exact grid with a finer 32² surrogate, a 32²
    exact grid) or a Richardson surrogate at 32² is refused by the kernel
    (cudaErrorNotSupported), the rule says none in C and in Python, and the
    wrapper raises."""
    import ctypes

    p = darcy64_da
    exact, surr = p.batched_potential_fn, p.batched_surrogate_fn
    y = surr.data.cpu().numpy()
    pos = p.init_positions(torch.Generator().manual_seed(12), 128).cuda()
    pairs = [(exact, _da_misfit(y, 16)), (_da_misfit(y, 16), surr), (_da_misfit(y, 32), surr),
             (exact, _da_misfit(y, 32, solver="richardson", omega=0.9))]
    lib = _build.library()
    for e, s in pairs:
        with pytest.raises(RuntimeError, match="launch failed.*not supported"):
            da.fused_da_pcn_chain(e, s, pos, p.prior.mean, p.prior.scale, 0.4, 0,
                                  n_steps=1, subchain_len=2, block_chains=128)
        assert da.route(e.spec_fields, s.spec_fields, 144) is None
        assert lib.ipx_da_pcn_route(ctypes.byref(e.spec()), ctypes.byref(s.spec()), 144) == 0


@pytest.mark.parametrize("record", [False, True])
def test_da_kernel_takes_the_pairs_the_cluster_kernel_leaves(darcy64_da, record):
    """An exact grid of the 64² class that is not 64² (40²) with the 32²
    surrogate: one chain a CTA (fused_da_pcn_kernel[layout64]), 128 chains,
    one outer step of k = 2, against the plain twin."""
    p = darcy64_da
    surr = p.batched_surrogate_fn
    exact = _da_misfit(surr.data.cpu().numpy(), 40)
    pos = p.init_positions(torch.Generator().manual_seed(12), 128).cuda()
    name = _scaffold_name("fused_da_pcn_kernel[layout64]", record)
    assert da._darcy_stem(exact, surr) == "fused_da_pcn_kernel[layout64]"
    args = (exact, surr, pos, p.prior.mean, p.prior.scale, 0.4, 3)
    plain = (exact._forward_plain, surr._forward_plain, *args[2:])
    kw = dict(subchain_len=2, block_chains=128)
    before = _build.launch_counts[name]
    if record:
        got = da.fused_da_pcn_chain_recorded(*args, n_steps=1, thin=1, **kw)
        ref = da._run_plain_recorded(*plain, n_steps=1, thin=1, **kw)
    else:
        got = da.fused_da_pcn_chain(*args, n_steps=1, **kw)
        ref = da._run_plain(*plain, n_steps=1, **kw)
    assert _build.launch_counts[name] == before + 1
    dev = (got[0] - ref[0]).abs().max(dim=1).values
    assert float((dev <= 1e-4).double().mean()) >= 0.99
    assert abs(float(got[1].mean()) - float(ref[1].mean())) <= 1e-2


# --- the 16² DA kernel: one warp per chain (fused_da_pcn_warp_kernel) ----------


def _da16(name):
    p = _build_on_card("darcy_da_fused")
    if name != "darcy_da_fused":  # a surrogate of benchmarks/darcy_da_richardson.py
        p = configs.darcy_da_richardson(name, "cuda")
    return p, p.batched_potential_fn, p.batched_surrogate_fn


@pytest.mark.parametrize("record", [False, True])
def test_da16_kernel_with_ragged_last_cta_matches_plain(record):
    """13 chains in blocks of 8: two CTAs of 8 warps, the last with 3 spare
    warps that store nothing. Chain c's draws depend on its block and lane
    only, so the plain loop over 16 chains gives the 13 chains' reference."""
    p, exact, surr = _da16("darcy_da_fused")
    pos = p.init_positions(torch.Generator().manual_seed(21), 16).cuda()
    plain = (exact._forward_plain, surr._forward_plain)
    args = (p.prior.mean, p.prior.scale, 0.35, 9)
    kw = dict(n_steps=3, subchain_len=6, block_chains=8)
    thin = 1 if record else None
    got = da._launch(exact, surr, pos[:13], *args, kw["n_steps"], kw["subchain_len"], 8,
                     thin=thin)
    if record:
        ref = da._run_plain_recorded(*plain, pos, *args, thin=1, **kw)
        assert got[2].shape == (3, 13, 64)
        assert torch.equal(got[2][-1], got[0])
        rec = (got[2] - ref[2][:, :13]).abs().amax(dim=(0, 2))
        assert float((rec <= 1e-4).double().mean()) >= 0.99
    else:
        ref = da._run_plain(*plain, pos, *args, **kw)
        assert abs(float(got[2].mean()) - float(ref[2][:13].mean())) <= 1e-2
    _chains_agree(got, tuple(r[:13] for r in ref[:2]), 3)


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("name", ["darcy_da_fused", "rich3_w0.9"])
def test_da16_kernel_at_full_width_matches_plain(name, record):
    """4096 chains in blocks of 512 (512 CTAs of 8 warps), with the CG and
    the rich3 Richardson surrogate, plain and recorded."""
    p, exact, surr = _da16(name)
    pos = p.init_positions(torch.Generator().manual_seed(22), 4096).cuda()
    args = (exact, surr, pos, p.prior.mean, p.prior.scale, 0.35, 13)
    plain_args = (exact._forward_plain, surr._forward_plain, *args[2:])
    kw = dict(n_steps=2, subchain_len=8, block_chains=512)
    stem = da._darcy_stem(exact, surr)
    name = f"{stem}<{'true' if record else 'false'}>"
    before = _build.launch_counts[name]
    if record:
        got = da.fused_da_pcn_chain_recorded(*args, thin=1, **kw)
        ref = da._run_plain_recorded(*plain_args, thin=1, **kw)
        assert float(((got[2] - ref[2]).abs().amax(dim=2) <= 1e-4).double().mean()) >= 0.99
    else:
        got = da.fused_da_pcn_chain(*args, **kw)
        ref = da._run_plain(*plain_args, **kw)
        assert 0.0 < float(got[2].mean()) < 1.0
        assert abs(float(got[2].mean()) - float(ref[2].mean())) <= 1e-2
    assert _build.launch_counts[name] == before + 1
    _chains_agree(got, ref, 2)


def test_da16_geometry_matches_the_kernel():
    """warp_geometry (Python) gives what the kernel's launch computes."""
    import ctypes

    p, exact, surr = _da16("darcy_da_fused")
    lib = _build.library()
    es, ss = exact.spec(), surr.spec()
    for n, block in ((4096, 512), (13, 8), (13, 13), (20, 4), (12, 6)):
        pos = torch.zeros(n, 64, device="cuda")
        args, _ = da._scaffold.chain_args(pos, p.prior.mean, p.prior.scale, 0, 1, block)
        out = (ctypes.c_int * 3)()
        assert lib.ipx_da_pcn_warp_geometry(ctypes.byref(es), ctypes.byref(ss),
                                            ctypes.byref(args), out) == 0
        ctas, w, smem = da.warp_geometry(n, block, exact_modes=exact.modes,
                                         surr_modes=surr.modes)
        assert (out[0], out[1], out[2]) == (w, ctas, smem), (n, block)


def test_da16_kernel_refuses_what_it_does_not_take():
    """d other than 64 (a KL basis of 36 modes), an 8² exact level: the warp
    kernel's geometry refuses them (cudaErrorNotSupported; the Python mirror
    raises). The first pair runs one chain a CTA
    (fused_da_pcn_kernel[layout16]); the second, a surrogate finer than its
    exact grid, is refused by the rule and the wrapper raises."""
    import ctypes

    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    p, exact, surr = _da16("darcy_da_fused")
    y = surr.data.cpu().numpy()

    def misfit(n, per_dim):
        aux = darcy.darcy_aux(n_grid=n, n_modes_per_dim=per_dim, alpha=2.0, field_scale=10.0)
        return darcy_misfit_from_arrays(aux, y, 0.002, cg_iters=3, precond="dst_trunc",
                                        precond_modes=64).cuda()

    lib = _build.library()
    for e, s, why in ((misfit(16, 6), misfit(8, 6), "d = 64"),
                      (misfit(8, 8), surr, "16x16 exact grid")):
        d = e.K
        pos = torch.zeros(16, d, device="cuda")
        mean, scale = torch.zeros(d), torch.ones(d)
        with pytest.raises(ValueError, match=why):
            da.warp_geometry(16, 16, exact_n=e.n, exact_modes=e.modes, surr_n=s.n,
                             surr_modes=s.modes, d=d)
        if s.n <= e.n:
            name = "fused_da_pcn_kernel[layout16]<false>"
            before = _build.launch_counts[name]
            out = da.fused_da_pcn_chain(e, s, pos, mean, scale, 0.35, 0, n_steps=1,
                                        subchain_len=2, block_chains=16)
            assert _build.launch_counts[name] == before + 1
            assert bool(torch.isfinite(out[0]).all())
        else:
            with pytest.raises(RuntimeError, match="launch failed.*not supported"):
                da.fused_da_pcn_chain(e, s, pos, mean, scale, 0.35, 0, n_steps=1,
                                      subchain_len=2, block_chains=16)
        args, _ = da._scaffold.chain_args(pos, mean, scale, 0, 1, 16)
        out = (ctypes.c_int * 3)()
        status = lib.ipx_da_pcn_warp_geometry(ctypes.byref(e.spec()), ctypes.byref(s.spec()),
                                              ctypes.byref(args), out)
        assert "not supported" in lib.ipx_error_string(status).decode()


# --- the 64² cluster kernels (fused_da_pcn_cluster_kernel, ---------------------
# --- fused_pcn_warm_cluster_kernel): ragged widths, geometry, refusals ----------


def _cluster_runs(config, record):
    """(kernel on n chains, plain twin on 16) for the 64² DA or warm pCN
    kernel in blocks of 8, 3 steps."""
    p = _build_on_card(config)
    pos = p.init_positions(torch.Generator().manual_seed(23), 16).cuda()
    thin = 1 if record else None
    if config == "darcy64_da_fused":
        exact, surr = p.batched_potential_fn, p.batched_surrogate_fn
        args = (p.prior.mean, p.prior.scale, p.kernel_params["beta"], 9, 3, 4, 8)
        kern = lambda n: da._launch(exact, surr, pos[:n], *args, thin=thin)  # noqa: E731
        plain = (exact._forward_plain, surr._forward_plain)
        if record:
            ref = da._run_plain_recorded(*plain, pos, *args[:5], 1, args[5], args[6])
        else:
            ref = da._run_plain(*plain, pos, *args)
    else:
        warm, aux_dim = p.batched_warm_potential
        args = (p.prior.mean, p.prior.scale, p.kernel_params["beta"], 9, 3, 8)
        kern = lambda n: fused_pcn._launch(warm, pos[:n], *args, thin=thin,  # noqa: E731
                                           aux_dim=aux_dim)
        ref = fused_pcn._run_plain(warm._forward_warm_plain, pos, *args, thin=thin,
                                   aux_dim=aux_dim)
    return kern, ref


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("config", ["darcy64_da_fused", "darcy64_pcn_warm", "darcy32_pcn_warm"])
def test_cluster_kernel_with_ragged_last_cluster(config, record):
    """13 chains: two clusters of 8 CTAs, the last with 3 spare CTAs that run
    on zeros and store nothing. A chain's draws and its columns of the
    cluster's products depend on it alone, so the 13 chains equal the first
    13 of the kernel's 16-chain run bit for bit, and agree with the plain
    twin's."""
    kern, ref = _cluster_runs(config, record)
    got, full = kern(13), kern(16)
    for g, f in zip(got, full):
        assert torch.equal(g, f[:, :13] if g.dim() == 3 else f[:13])
    if record:
        assert got[2].shape == (3, 13, got[0].shape[1]) and torch.equal(got[2][-1], got[0])
        rec = (got[2] - ref[2][:, :13]).abs().amax(dim=(0, 2))
        assert float((rec <= 1e-4).double().mean()) >= 0.99
    _chains_agree(got, tuple(r[:13] for r in ref[:2]), 3)


def test_cluster_geometry_matches_the_kernel():
    """ops/_cluster.py cluster_geometry gives what the C launch computes,
    for the 64² DA kernel (with its surrogate) and warm pCN kernel, and for
    the 32² warm pCN kernel."""
    import ctypes

    from ip_mcmc_tpu_torch.ops import _cluster

    da_p = _build_on_card("darcy64_da_fused")
    pcn_p = _build_on_card("darcy64_pcn_warm")
    p32 = _build_on_card("darcy32_pcn_warm")
    lib = _build.library()
    warm = pcn_p.batched_warm_potential[0]
    for p, exact, surr in ((da_p, da_p.batched_potential_fn, da_p.batched_surrogate_fn),
                           (pcn_p, warm, None), (p32, p32.batched_warm_potential[0], None)):
        for n, block in ((p.n_chains, 128), (13, 8), (16, 4), (1, 128), (0, 128)):
            pos = torch.zeros(n, p.dim, device="cuda")
            args, _ = da._scaffold.chain_args(pos, p.prior.mean, p.prior.scale, 0, 1, block)
            out = (ctypes.c_int * 4)()
            es = exact.spec()
            ss = None if surr is None else ctypes.byref(surr.spec())
            assert lib.ipx_darcy_cluster_geometry(ctypes.byref(es), ss, ctypes.byref(args),
                                                  out) == 0
            kw = dict(d=p.dim, exact_n=exact.n, exact_modes=exact.modes,
                      surr_n=None if surr is None else surr.n,
                      surr_modes=128 if surr is None else surr.modes)
            assert tuple(out) == _cluster.cluster_geometry(n, block, **kw), (n, block)


def test_cluster_kernels_refuse_what_they_do_not_take():
    """A 64² warm misfit with Jacobi (no modes) or with modes not a multiple
    of 16: the warm pCN cluster kernel's geometry refuses it
    (cudaErrorNotSupported), and the rule sends it one chain a CTA
    (fused_pcn_warm_kernel[layout64]), which runs it."""
    import ctypes

    from ip_mcmc_tpu_torch.convert import darcy_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    p = _build_on_card("darcy64_pcn_warm")
    aux = darcy.darcy_aux(n_grid=64, n_modes_per_dim=12, alpha=2.0, field_scale=10.0)
    y = p.batched_potential_fn.data.cpu().numpy()
    lib = _build.library()
    pos = p.init_positions(torch.Generator().manual_seed(24), 16).cuda()
    name = "fused_pcn_warm_kernel[layout64]<false>"
    for kw in (dict(precond="jacobi"), dict(precond="dst_trunc", precond_modes=100)):
        warm, aux_dim = darcy_warm_misfit_from_arrays(aux, y, 0.002, cg_iters=4, **kw)
        warm = warm.cuda()
        before = _build.launch_counts[name]
        out = fused_pcn.fused_pcn_chain_warm(warm, pos, p.prior.mean, p.prior.scale, 0.06, 0,
                                             n_steps=1, aux_dim=aux_dim, block_chains=16)
        assert _build.launch_counts[name] == before + 1
        assert bool(torch.isfinite(out[0]).all())
        args, _ = da._scaffold.chain_args(pos, p.prior.mean, p.prior.scale, 0, 1, 16)
        out = (ctypes.c_int * 4)()
        status = lib.ipx_darcy_cluster_geometry(ctypes.byref(warm.spec()), None,
                                                ctypes.byref(args), out)
        assert "not supported" in lib.ipx_error_string(status).decode()


def test_cluster32_kernel_refuses_what_it_does_not_take():
    """A 32² warm misfit with Jacobi (no modes) or with modes not a multiple
    of 16, and a grid of the 32² class that is not 32² (24²): the 32² warm
    pCN cluster kernel's geometry refuses them (cudaErrorNotSupported), and
    the rule sends them one chain a CTA (fused_pcn_warm_kernel[layout32]),
    which runs them."""
    import ctypes

    from ip_mcmc_tpu_torch.convert import darcy_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    p = _build_on_card("darcy32_pcn_warm")
    y = p.batched_potential_fn.data.cpu().numpy()
    lib = _build.library()
    pos = p.init_positions(torch.Generator().manual_seed(25), 16).cuda()
    for n, kw in ((32, dict(precond="jacobi")), (32, dict(precond="dst_trunc", precond_modes=100)),
                  (24, dict(precond="dst_trunc", precond_modes=128))):
        aux = darcy.darcy_aux(n_grid=n, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
        warm, aux_dim = darcy_warm_misfit_from_arrays(aux, y, 0.002, cg_iters=4, **kw)
        warm = warm.cuda()
        name = "fused_pcn_warm_kernel[layout32]<false>"
        before = _build.launch_counts[name]
        out = fused_pcn.fused_pcn_chain_warm(warm, pos, p.prior.mean, p.prior.scale, 0.08, 0,
                                             n_steps=1, aux_dim=aux_dim, block_chains=16)
        assert _build.launch_counts[name] == before + 1
        assert bool(torch.isfinite(out[0]).all())
        args, _ = da._scaffold.chain_args(pos, p.prior.mean, p.prior.scale, 0, 1, 16)
        out = (ctypes.c_int * 4)()
        status = lib.ipx_darcy_cluster_geometry(ctypes.byref(warm.spec()), None,
                                                ctypes.byref(args), out)
        assert "not supported" in lib.ipx_error_string(status).decode()


# --- the standalone 64² misfits on the samplers' cluster level ----------------
# --- (darcy_misfit_cluster_kernel, darcy_misfit_warm_cluster_kernel) ----------


def _misfit_rel_ok(phi, ref):
    """chip_smoke.py's LARGE_BF16_TOL: bf16 rounding flips, summed on the
    tensor cores in another order than the plain twin's products."""
    rel = _rel(phi, ref)
    assert float(rel.median()) <= 2e-4
    assert float((rel <= 1e-3).double().mean()) >= 0.90
    assert float(rel.max()) <= 5e-3


def test_misfit_cluster_kernel_on_a_ragged_width(darcy64_da):
    """darcy64_da_fused's exact misfit on 13 draws: two clusters of 8 CTAs,
    3 spare. A draw's columns of the cluster's products depend on it
    alone, so Φ equals the first 13 of a 16-draw launch bit for bit and
    agrees with the plain twin."""
    pot = darcy64_da.batched_potential_fn
    U = darcy64_da.prior.sample(torch.Generator().manual_seed(30), 16).T.contiguous()
    assert pot.kernel_label == "darcy_misfit_cluster_kernel[n=64]"
    before = _build.launch_counts[pot.kernel_label]
    got, full = pot(U[:, :13].contiguous()), pot(U)
    assert _build.launch_counts[pot.kernel_label] == before + 2
    assert torch.equal(got, full[:13])
    _misfit_rel_ok(got, pot._forward_plain(U[:, :13]))


def test_misfit_warm_cluster_kernel_on_a_ragged_width():
    """darcy64_pcn_warm's warm misfit on 13 draws, from x0 = 0 and from the
    previous solution after a pCN-sized move: (Φ, x) equal the first 13 of
    a 16-draw launch bit for bit and agree with the plain twin."""
    p = _build_on_card("darcy64_pcn_warm")
    warm, aux_dim = p.batched_warm_potential
    assert warm.warm_kernel_label == "darcy_misfit_warm_cluster_kernel"
    g = torch.Generator().manual_seed(31)
    U = p.prior.sample(g, 16).T.contiguous()
    U2 = (0.9982 * U + 0.06 * p.prior.sample(g, 16).T).contiguous()
    x0 = torch.zeros(aux_dim, 16, device="cuda")
    before = _build.launch_counts[warm.warm_kernel_label]
    for V in (U, U2):
        (phi, x), (phi16, x16) = warm(V[:, :13].contiguous(), x0[:, :13].contiguous()), warm(V, x0)
        assert torch.equal(phi, phi16[:13]) and torch.equal(x, x16[:, :13])
        ref_phi, ref_x = warm._forward_warm_plain(V[:, :13], x0[:, :13])
        _misfit_rel_ok(phi, ref_phi)
        assert float(_col_err(x, ref_x).max()) <= 5e-3
        x0 = x16
    assert _build.launch_counts[warm.warm_kernel_label] == before + 4


def test_misfit_cluster_geometry_matches_the_kernel():
    """ops/_cluster.py misfit_cluster_geometry and misfit_cluster_takes give
    what the C function computes: the geometry of the specs it takes (64²
    and 32²), and cudaErrorNotSupported for those it leaves to the layouts'
    kernels."""
    import ctypes

    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy
    from ip_mcmc_tpu_torch.ops import _cluster

    da_p = _build_on_card("darcy64_da_fused")
    pcn_p = _build_on_card("darcy64_pcn_warm")
    aux = darcy.darcy_aux(n_grid=64, n_modes_per_dim=12, alpha=2.0, field_scale=10.0)
    jacobi = darcy_misfit_from_arrays(aux, pcn_p.data, 0.002, cg_iters=16).cuda()
    lib = _build.library()
    pots = (da_p.batched_potential_fn, da_p.batched_surrogate_fn, pcn_p.batched_potential_fn,
            pcn_p.batched_warm_potential[0], jacobi, *_misfits32())
    for pot in pots:
        kw = pot.spec_fields
        for B in (1024, 2048, 4096, 13, 1, 0):
            out = (ctypes.c_int * 4)()
            status = lib.ipx_darcy_misfit_cluster_geometry(ctypes.byref(pot.spec()), B, out)
            if _cluster.misfit_cluster_takes(**kw):
                assert status == 0 and tuple(out) == _cluster.misfit_cluster_geometry(B, **kw)
            else:
                assert "not supported" in lib.ipx_error_string(status).decode()


def test_layout64_misfits_take_a_spec_the_cluster_leaves():
    """A 64² dst_trunc-256 misfit on a finer prior, K = 196 (above the
    cluster layout's 144), cold (16 CG) and warm (4 CG from x0 = 0), stays
    on the Layout64 kernels (one draw a CTA) and meets its twin under the
    bound of the 64² rows."""
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays, darcy_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    p = _build_on_card("darcy64_pcn_warm")
    aux = darcy.darcy_aux(n_grid=64, n_modes_per_dim=14, alpha=2.0, field_scale=10.0)
    kw = dict(precond="dst_trunc", precond_modes=256)
    cold = darcy_misfit_from_arrays(aux, p.data, 0.002, cg_iters=16, **kw).cuda()
    warm, aux_dim = darcy_warm_misfit_from_arrays(aux, p.data, 0.002, cg_iters=4, **kw)
    warm = warm.cuda()
    assert cold.K == 196 and not cold.on_cluster and not warm.on_cluster
    U = torch.randn(196, 64, generator=torch.Generator().manual_seed(32)).cuda()
    before = (_build.launch_counts["darcy_misfit_kernel[n=64]"],
              _build.launch_counts["darcy_misfit_warm_kernel"])
    _misfit_rel_ok(cold(U), cold._forward_plain(U))
    x0 = torch.zeros(aux_dim, 64, device="cuda")
    phi, x = warm(U, x0)
    ref_phi, ref_x = warm._forward_warm_plain(U, x0)
    _misfit_rel_ok(phi, ref_phi)
    assert float(_col_err(x, ref_x).max()) <= 5e-3
    assert (_build.launch_counts["darcy_misfit_kernel[n=64]"],
            _build.launch_counts["darcy_misfit_warm_kernel"]) == (before[0] + 1, before[1] + 1)


# --- the standalone 32² misfits on the 32² warm pCN's cluster level -----------
# --- (darcy_misfit_warm_cluster32_kernel, darcy_misfit_cluster32_kernel) -------


def _misfits32():
    """darcy32_pcn_warm's warm misfit, its cold Jacobi misfit (a spec the
    cluster level leaves), darcy64_da_fused's 32² surrogate (K 144: the 64²
    DA kernel's surrogate level) and a cold dst_trunc-128 / 16 CG misfit on
    the 32² level."""
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    p = _build_on_card("darcy32_pcn_warm")
    aux = darcy.darcy_aux(n_grid=32, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    cold = darcy_misfit_from_arrays(aux, p.data, 0.002, cg_iters=16, precond="dst_trunc",
                                    precond_modes=128).cuda()
    surr = _build_on_card("darcy64_da_fused").batched_surrogate_fn
    return p.batched_warm_potential[0], p.batched_potential_fn, surr, cold


def test_misfit_warm_cluster32_kernel_on_a_ragged_width():
    """darcy32_pcn_warm's warm misfit on 13 draws, from x0 = 0 and from the
    previous solution after a pCN-sized move: (Φ, x) equal the first 13 of
    a 16-draw launch bit for bit (two clusters of 8, 3 spare CTAs) and
    agree with the plain twin under the 32² bound."""
    p = _build_on_card("darcy32_pcn_warm")
    warm, aux_dim = p.batched_warm_potential
    assert warm.warm_kernel_label == "darcy_misfit_warm_cluster32_kernel"
    g = torch.Generator().manual_seed(34)
    U = p.prior.sample(g, 16).T.contiguous()
    U2 = (0.9968 * U + 0.08 * p.prior.sample(g, 16).T).contiguous()
    x0 = torch.zeros(aux_dim, 16, device="cuda")
    before = _build.launch_counts[warm.warm_kernel_label]
    for V in (U, U2):
        (phi, x), (phi16, x16) = warm(V[:, :13].contiguous(), x0[:, :13].contiguous()), warm(V, x0)
        assert torch.equal(phi, phi16[:13]) and torch.equal(x, x16[:, :13])
        ref_phi, ref_x = warm._forward_warm_plain(V[:, :13], x0[:, :13])
        _misfit_rel_ok(phi, ref_phi)
        assert float(_col_err(x, ref_x).max()) <= 5e-3
        x0 = x16
    assert _build.launch_counts[warm.warm_kernel_label] == before + 4


def test_misfit_surr_cluster_kernel_on_a_ragged_width():
    """darcy64_da_fused's 32² surrogate on 13 draws: two clusters of 8
    CTAs, 3 spare. A draw's columns of the cluster's products depend on it
    alone, so Φ* equals the first 13 of a 16-draw launch bit for bit and
    agrees with the plain twin."""
    p = _build_on_card("darcy64_da_fused")
    surr = p.batched_surrogate_fn
    assert surr.kernel_label == "darcy_misfit_surr_cluster_kernel[n=32]"
    U = p.prior.sample(torch.Generator().manual_seed(43), 16).T.contiguous()
    before = _build.launch_counts[surr.kernel_label]
    got, full = surr(U[:, :13].contiguous()), surr(U)
    assert _build.launch_counts[surr.kernel_label] == before + 2
    assert torch.equal(got, full[:13])
    _misfit_rel_ok(got, surr._forward_plain(U[:, :13]))


def test_misfit_cluster32_kernel_matches_plain():
    """The cold twin on the 32² level (dst_trunc-128 / 16 CG, no config's
    cold misfit) against its plain version, and on a ragged 13 draws equal
    to the first 13 of a 16-draw launch bit for bit."""
    cold = _misfits32()[3]
    assert cold.kernel_label == "darcy_misfit_cluster32_kernel[n=32]"
    U = torch.randn(64, 256, generator=torch.Generator().manual_seed(35)).cuda()
    before = _build.launch_counts[cold.kernel_label]
    _misfit_rel_ok(cold(U), cold._forward_plain(U))
    got, full = cold(U[:, :13].contiguous()), cold(U[:, :16].contiguous())
    assert torch.equal(got, full[:13])
    assert _build.launch_counts[cold.kernel_label] == before + 3


# --- the standalone 16² exact misfit a draw a warp (darcy_misfit_warp_kernel) --


def test_misfit_warp_kernel_on_a_ragged_width(problem):
    """darcy_da_fused's exact misfit on 13 draws: one CTA of 16 warps, 3
    spare running on zeros. A draw's column of the CTA's products depends
    on it alone, so Φ equals the first 13 of a 16-draw launch bit for bit;
    against the plain twin under the bound of the 16² misfits."""
    pot = problem.batched_potential_fn
    assert pot.kernel_label == "darcy_misfit_warp_kernel[n=16]"
    U = problem.prior.sample(torch.Generator().manual_seed(36), 512).T.contiguous()
    before = _build.launch_counts[pot.kernel_label]
    got, full = pot(U[:, :13].contiguous()), pot(U[:, :16].contiguous())
    assert torch.equal(got, full[:13])
    rel = _rel(pot(U), pot._forward_plain(U))
    assert float(rel.median()) <= 2e-6
    assert float((rel <= 1e-5).double().mean()) >= 0.80
    assert float(rel.max()) <= 5e-3
    assert _build.launch_counts[pot.kernel_label] == before + 3


def test_misfit_warp_geometry_matches_the_kernel(problem):
    """ops/fused_da_pcn.py misfit_warp_geometry and misfit_warp_takes give
    what the C function computes: the geometry of the specs it takes (the
    DA kernel's exact level and its 8² surrogate level, CG and Richardson),
    cudaErrorNotSupported for the others."""
    import ctypes

    lib = _build.library()
    rich = configs.darcy_da_richardson("rich3_w0.9", "cuda")
    pots = (problem.batched_potential_fn, problem.batched_surrogate_fn,
            rich.batched_potential_fn, rich.batched_surrogate_fn,
            _build_on_card("darcy_ess_fused").batched_potential_fn, *_misfits32())
    taken = 0
    for pot in pots:
        for B in (4096, 13, 1, 0):
            out = (ctypes.c_int * 3)()
            status = lib.ipx_darcy_misfit_warp_geometry(ctypes.byref(pot.spec()), B, out)
            if da.misfit_warp_takes(**pot.spec_fields):
                assert status == 0 and tuple(out) == da.misfit_warp_geometry(B, **pot.spec_fields)
                taken += 1
            else:
                assert "not supported" in lib.ipx_error_string(status).decode()
    assert taken == 4 * 4


def test_layout_misfits_take_the_specs_the_rules_leave():
    """The specs the warp, slice and 32² cluster rules leave still launch
    the one-draw-a-CTA kernels of their layout: a 16² Jacobi misfit with K
    36 (the 16² Jacobi / 48 CG misfit of ESS, cold pCN and FES, K 64, goes
    to the slice kernel a draw a warp, held here under the same bound); 16²
    dst_trunc-160 (more modes than the warp kernel stages) and 16²
    Richardson; 8² misfits with K 36 (CG and Richardson: the 8² surrogates
    of the DA runs, K 64, go to the warp kernel); darcy32_pcn_warm's
    cold Jacobi misfit (and darcy64_da_fused's 32² surrogate, K 144, which
    the 64² DA kernel's surrogate level takes, held here under the same
    bound); a 32² warm Jacobi / 16 CG misfit, from x0 = 0
    and from the previous solution. Each meets its twin under its bound
    (bf16 preconditioners: chip_smoke.py's largest relative error, 5e-3;
    Jacobi: f32 only, 1e-4; the 32² warm Jacobi solve stops unconverged,
    where f32 rounding alone moves Φ by up to ~1e-3: chip_smoke.py's
    UNCONVERGED_32_TOL, the 32² bounds)."""
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays, darcy_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    p = _build_on_card("darcy_da_fused")
    _, jacobi32, surr32, _ = _misfits32()
    aux16 = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8)
    dst160 = darcy_misfit_from_arrays(aux16, p.data, 0.002, cg_iters=12, precond="dst_trunc",
                                      precond_modes=160).cuda()
    rich16 = darcy_misfit_from_arrays(aux16, p.data, 0.002, cg_iters=3, precond="dst_trunc",
                                      precond_modes=128, solver="richardson", omega=0.9).cuda()
    ess = _build_on_card("darcy_ess_fused")
    k36 = darcy_misfit_from_arrays(darcy.darcy_aux(n_grid=16, n_modes_per_dim=6, alpha=2.0,
                                                   field_scale=10.0),
                                   ess.data, 0.002).cuda()
    left8 = _specs8_left()
    cases = ((ess.batched_potential_fn, "darcy_misfit_slice_kernel[n=16]", 1e-4),
             (k36, "darcy_misfit_kernel[n=16]", 1e-4),
             (dst160, "darcy_misfit_kernel[n=16]", 5e-3),
             (rich16, "darcy_misfit_kernel[n=16,richardson]", 5e-3),
             (left8["8x8 K36"], "darcy_misfit_kernel[n=8]", 5e-3),
             (left8["8x8 K36 richardson"], "darcy_misfit_kernel[n=8,richardson]", 5e-3),
             (jacobi32, "darcy_misfit_kernel[n=32]", 1e-4),
             (surr32, "darcy_misfit_surr_cluster_kernel[n=32]", 5e-3))
    g = torch.Generator().manual_seed(37)
    for pot, label, max_rel in cases:
        assert pot.kernel_label == label
        U = torch.randn(pot.K, 128, generator=g).cuda()
        before = _build.launch_counts[label]
        rel = _rel(pot(U), pot._forward_plain(U))
        assert _build.launch_counts[label] == before + 1
        assert float(rel.max()) <= max_rel, label

    p32 = _build_on_card("darcy32_pcn_warm")
    aux32 = darcy.darcy_aux(n_grid=32, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    warm, aux_dim = darcy_warm_misfit_from_arrays(aux32, p32.data, 0.002, cg_iters=16,
                                                  precond="jacobi")
    warm = warm.cuda()
    label = "darcy_misfit_warm_kernel"
    assert warm.warm_kernel_label == label
    U = p32.prior.sample(g, 128).T.contiguous()
    U2 = (0.9968 * U + 0.08 * p32.prior.sample(g, 128).T).contiguous()
    x0 = torch.zeros(aux_dim, 128, device="cuda")
    before = _build.launch_counts[label]
    for V in (U, U2):
        phi, x = warm(V, x0)
        ref_phi, ref_x = warm._forward_warm_plain(V, x0)
        _misfit_rel_ok(phi, ref_phi)
        assert float(_col_err(x, ref_x).max()) <= 5e-3
        x0 = x
    assert _build.launch_counts[label] == before + 2


# --- the standalone 16² Jacobi misfits a draw a warp --------------------------
# (darcy_misfit_slice_kernel, darcy_misfit_grad_warp_kernel)


def test_misfit_slice_kernel_matches_plain(warm_problem):
    """The 16² Jacobi / 48 CG misfit (Φ0 of ESS, cold pCN and FES; here
    darcy_pcn_warm's cold one) a draw a warp: f32 only, so only the order of
    the sums differs from the plain twin."""
    pot = warm_problem.batched_potential_fn
    assert pot.kernel_label == "darcy_misfit_slice_kernel[n=16]"
    U = warm_problem.prior.sample(torch.Generator().manual_seed(38), 512).T.contiguous()
    before = _build.launch_counts[pot.kernel_label]
    rel = _rel(pot(U), pot._forward_plain(U))
    assert _build.launch_counts[pot.kernel_label] == before + 1
    assert float((rel <= 1e-5).double().mean()) >= 0.99 and float(rel.max()) <= 1e-4


def test_misfit_slice_kernels_on_a_ragged_width(warm_problem):
    """13 draws: one CTA, its other warps spare, solving nothing. A draw's
    warp needs no other, so Φ (and the gradient) equal the first 13 of a
    16-draw launch bit for bit."""
    pot = warm_problem.batched_potential_fn
    U = warm_problem.prior.sample(torch.Generator().manual_seed(39), 16).T.contiguous()
    U13 = U[:, :13].contiguous()
    assert torch.equal(pot(U13), pot(U)[:13])
    (phi, g), (phi16, g16) = pot.value_and_grad(U13), pot.value_and_grad(U)
    assert torch.equal(phi, phi16[:13]) and torch.equal(g, g16[:, :13])


def test_misfit_slice_geometry_matches_the_kernel(warm_problem):
    """ops/fused_da_pcn.py misfit_slice_geometry / misfit_slice_takes and
    ops/fused_mala.py misfit_grad_warp_geometry / misfit_grad_warp_takes give
    what the C functions compute: the geometry of the Jacobi spec they take,
    cudaErrorNotSupported for the specs they leave."""
    import ctypes

    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    lib = _build.library()
    p = _build_on_card("darcy_da_fused")
    rich = configs.darcy_da_richardson("rich3_w0.9", "cuda")
    k36 = darcy_misfit_from_arrays(darcy.darcy_aux(n_grid=16, n_modes_per_dim=6, alpha=2.0,
                                                   field_scale=10.0),
                                   warm_problem.data, 0.002).cuda()
    pots = (warm_problem.batched_potential_fn, p.batched_potential_fn, p.batched_surrogate_fn,
            rich.batched_potential_fn, rich.batched_surrogate_fn, k36, *_misfits32())
    rules = ((lib.ipx_darcy_misfit_slice_geometry, da.misfit_slice_takes,
              da.misfit_slice_geometry),
             (lib.ipx_darcy_misfit_grad_warp_geometry, fused_mala.misfit_grad_warp_takes,
              fused_mala.misfit_grad_warp_geometry))
    for c_geometry, takes, geometry in rules:
        taken = 0
        for pot in pots:
            for B in (4096, 13, 1, 0):
                out = (ctypes.c_int * 3)()
                status = c_geometry(ctypes.byref(pot.spec()), B, out)
                if takes(**pot.spec_fields):
                    assert status == 0 and tuple(out) == geometry(B, **pot.spec_fields)
                    taken += 1
                else:
                    assert "not supported" in lib.ipx_error_string(status).decode()
        assert taken == 4


def test_grad_kernel_takes_a_spec_the_warp_rule_leaves(problem):
    """A 16² dst_trunc-128 / 12 CG gradient (the DA exact level's spec, no
    config) stays on darcy_misfit_grad_kernel, one draw a CTA, and meets
    its plain twin under chip_smoke.py's bf16 bounds (BF16_TOL,
    GRAD_BF16_TOL: the preconditioner's bf16 roundings flip)."""
    pot = problem.batched_potential_fn
    name = pot.grad_kernel_label
    assert name == "darcy_misfit_grad_kernel[n=16]"
    U = problem.prior.sample(torch.Generator().manual_seed(40), 512).T.contiguous()
    before = _build.launch_counts[name]
    phi, grad = pot.value_and_grad(U)
    assert _build.launch_counts[name] == before + 1
    phi_ref, grad_ref = pot._value_and_grad_plain(U)[:2]
    rel, err = _rel(phi, phi_ref), _col_err(grad, grad_ref)
    assert float(rel.median()) <= 2e-6 and float(rel.max()) <= 5e-3
    assert float((rel <= 1e-5).double().mean()) >= 0.80
    assert float(err.median()) <= 1e-4 and float(err.max()) <= 5e-2
    assert float((err <= 1e-3).double().mean()) >= 0.90


# --- elliptical slice sampling: one warp per chain (fused_ess_warp_kernel) -----


@pytest.mark.parametrize("record", [False, True])
def test_ess_warp_kernel_with_ragged_last_cta(warm_problem, record):
    """13 chains in blocks of 8: two CTAs of 8 warps, the last with 3 spare
    warps that run on zeros and store nothing. The 13 chains equal the first
    13 of the kernel's 16-chain run bit for bit and agree with the plain
    twin's."""
    pot = warm_problem.batched_potential_fn
    pm, ps = warm_problem.prior.mean, warm_problem.prior.scale
    pos = warm_problem.init_positions(torch.Generator().manual_seed(26), 16).cuda()
    thin = 1 if record else None
    name = f"{fused_ess.KERNEL}<{'true' if record else 'false'}>"
    before = _build.launch_counts[name]
    got, full = (fused_ess._launch(pot, pos[:n], pm, ps, 9, 3, 6, 8, thin=thin) for n in (13, 16))
    assert _build.launch_counts[name] == before + 2
    for g, f in zip(got, full):
        assert torch.equal(g, f[:, :13] if g.dim() == 3 else f[:13])
    ref = fused_ess._run_plain(pot._forward_plain, pos, pm, ps, 9, 3, 6, 8, thin=thin)
    if record:
        assert got[2].shape == (3, 13, 64) and torch.equal(got[2][-1], got[0])
        rec = (got[2] - ref[2][:, :13]).abs().amax(dim=(0, 2))
        assert float((rec <= 1e-4).double().mean()) >= 0.99
    _chains_agree(got, tuple(r[:13] for r in ref[:2]), 3)


def test_ess_warp_geometry_matches_the_kernel(warm_problem):
    """fused_ess.warp_geometry (Python) gives what the kernel's launch
    computes."""
    import ctypes

    pot = warm_problem.batched_potential_fn
    lib = _build.library()
    for n, block in ((4096, 256), (13, 8), (13, 13), (20, 4), (0, 256)):
        pos = torch.zeros(n, 64, device="cuda")
        args, _ = da._scaffold.chain_args(pos, warm_problem.prior.mean, warm_problem.prior.scale,
                                          0, 1, block)
        out = (ctypes.c_int * 3)()
        assert lib.ipx_ess_warp_geometry(ctypes.byref(pot.spec()), ctypes.byref(args), 6,
                                         out) == 0
        ctas, w, smem = fused_ess.warp_geometry(n, block)
        assert (out[0], out[1], out[2]) == (w, ctas, smem), (n, block)


def test_ess_warp_kernel_refuses_what_it_does_not_take(problem):
    """A dst_trunc misfit (darcy_da_fused's exact level) and a 32² Jacobi
    misfit: the warp kernel's geometry function refuses them
    (cudaErrorNotSupported). The first runs one chain a CTA
    (fused_ess_kernel); the second, above 16², is refused by the rule and
    the wrapper raises."""
    import ctypes

    big = _build_on_card("darcy32_pcn_warm").batched_potential_fn
    lib = _build.library()
    pos = problem.init_positions(torch.Generator().manual_seed(27), 16).cuda()
    pm, ps = problem.prior.mean, problem.prior.scale
    for pot in (problem.batched_potential_fn, big):
        if pot is big:
            with pytest.raises(RuntimeError, match="launch failed.*not supported"):
                fused_ess.fused_ess_chain(pot, pos, pm, ps, 0, n_steps=1, max_shrink=2,
                                          block_chains=16)
        else:
            before = _build.launch_counts["fused_ess_kernel<false>"]
            fused_ess.fused_ess_chain(pot, pos, pm, ps, 0, n_steps=1, max_shrink=2,
                                      block_chains=16)
            assert _build.launch_counts["fused_ess_kernel<false>"] == before + 1
        args, _ = da._scaffold.chain_args(pos, pm, ps, 0, 1, 16)
        out = (ctypes.c_int * 3)()
        status = lib.ipx_ess_warp_geometry(ctypes.byref(pot.spec()), ctypes.byref(args), 2, out)
        assert "not supported" in lib.ipx_error_string(status).decode()


# --- the three-level Burgers DA: one warp per chain (fused_da3_pcn_warp_kernel)


def _da3_args(p, n):
    return (p.prior.mean, p.prior.scale, p.kernel_params["beta"], 9, 3, 2, 3, n)


@pytest.mark.parametrize("record", [False, True])
def test_da3_warp_kernel_with_ragged_last_cta(burgers_problem, record):
    """13 chains in blocks of 8: two CTAs of 8 warps, the last with 3 spare
    warps that run on zeros and store nothing. The 13 chains equal the first
    13 of the kernel's 16-chain run bit for bit and agree with the plain
    twin's."""
    from ip_mcmc_tpu_torch.ops import fused_da3_pcn as da3

    p = burgers_problem
    levels = _burgers_levels(p)
    pos = p.init_positions(torch.Generator().manual_seed(28), 16).cuda()
    thin = 1 if record else None
    name = f"{da3.KERNEL}<{'true' if record else 'false'}>"
    before = _build.launch_counts[name]
    got, full = (da3._launch(*levels, pos[:n], *_da3_args(p, 8), thin=thin) for n in (13, 16))
    assert _build.launch_counts[name] == before + 2
    for g, f in zip(got, full):
        assert torch.equal(g, f[:, :13] if g.dim() == 3 else f[:13])
    ref = da3._run_plain(*(lv._forward_plain for lv in levels), pos, *_da3_args(p, 8),
                         thin=thin)
    if record:
        assert got[2].shape == (3, 13, 16) and torch.equal(got[2][-1], got[0])
        rec = (got[2] - ref[2][:, :13]).abs().amax(dim=(0, 2))
        assert float((rec <= 1e-4).double().mean()) >= 0.99
    else:
        assert abs(float(got[2].mean()) - float(ref[2][:13].mean())) <= 1e-2
    _chains_agree(got, tuple(r[:13] for r in ref[:2]), 3)


def test_da3_warp_chain_at_d16_draws_the_normals_of_make_chain_ctx(burgers_problem):
    """run_warp_chain<RECORD, 16>: lane t < 16 draws coordinate t of the
    (16, block) normal with Box-Muller rows t and t - 8 paired, as
    make_chain_ctx's chain does. With beta 1 one inner step proposes
    mean + scale * xi, so every chain that moved in one outer step of one
    inner step (k_inner = k_mid = 1) sits at the plain twin's proposal."""
    from ip_mcmc_tpu_torch.ops import fused_da3_pcn as da3

    p = burgers_problem
    levels = _burgers_levels(p)
    pos = p.init_positions(torch.Generator().manual_seed(29), 2048).cuda()
    args = (p.prior.mean, p.prior.scale, 1.0, 5, 1, 1, 1, 512)
    got = da3._launch(*levels, pos, *args)
    ref = da3._run_plain(*(lv._forward_plain for lv in levels), pos, *args)
    moved = (got[0] != pos).any(dim=1) & (ref[0] != pos).any(dim=1)
    assert int(moved.sum()) >= 20
    assert float((got[0][moved] - ref[0][moved]).abs().max()) <= 1e-5
    assert float((got[0] - ref[0]).abs().amax(dim=1).le(1e-5).double().mean()) >= 0.99


def test_da3_warp_geometry_matches_the_kernel(burgers_problem):
    """fused_da3_pcn.warp_geometry (Python) gives what the kernel's launch
    computes."""
    import ctypes

    from ip_mcmc_tpu_torch.ops import fused_da3_pcn as da3

    p = burgers_problem
    specs = [lv.spec() for lv in _burgers_levels(p)]
    lib = _build.library()
    for n, block in ((2048, 512), (13, 8), (13, 13), (20, 4), (0, 512)):
        pos = torch.zeros(n, 16, device="cuda")
        args, _ = da._scaffold.chain_args(pos, p.prior.mean, p.prior.scale, 0, 1, block)
        out = (ctypes.c_int * 3)()
        assert lib.ipx_da3_warp_geometry(*(ctypes.byref(s) for s in specs),
                                         ctypes.byref(args), 8, 24, out) == 0
        ctas, w, smem = da3.warp_geometry(n, block)
        assert (out[0], out[1], out[2]) == (w, ctas, smem), (n, block)


def test_da3_warp_kernel_refuses_what_it_does_not_take(burgers_problem):
    """A level of 32 cells and a prior of 8 modes: the warp kernel's
    geometry function refuses them (cudaErrorNotSupported), and the rule
    sends them one chain a CTA (fused_da3_pcn_kernel), which runs them; a
    level of 256 cells, above the CTA's 128, is refused by the rule and the
    wrapper raises."""
    import ctypes

    from ip_mcmc_tpu_torch.configs import burgers_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import burgers
    from ip_mcmc_tpu_torch.ops import fused_da3_pcn as da3

    p = burgers_problem
    fine, mid, coarse = _burgers_levels(p)
    lib = _build.library()

    def small(n_cells, n_modes):
        aux = burgers.burgers_aux(n_cells=n_cells, n_modes=n_modes, alpha=1.5, field_scale=1.0,
                                  t_final=0.2)
        m = len(aux["obs_indices"])
        return burgers_misfit_from_arrays(aux, np.zeros(m, np.float32), 0.02).cuda()

    for levels, d in (((fine, mid, small(32, 16)), 16),
                      ((small(128, 8), small(128, 8), small(64, 8)), 8)):
        pos = torch.zeros(16, d, device="cuda")
        pm, ps = torch.zeros(d, device="cuda"), torch.ones(d, device="cuda")
        before = _build.launch_counts["fused_da3_pcn_kernel<false>"]
        out = da3.fused_da3_pcn_chain(*levels, pos, pm, ps, 0.25, 0, n_steps=1, k_inner=1,
                                      k_mid=1, block_chains=16)
        assert _build.launch_counts["fused_da3_pcn_kernel<false>"] == before + 1
        assert bool(torch.isfinite(out[0]).all())
        args, _ = da._scaffold.chain_args(pos, pm, ps, 0, 1, 16)
        out = (ctypes.c_int * 3)()
        status = lib.ipx_da3_warp_geometry(*(ctypes.byref(lv.spec()) for lv in levels),
                                           ctypes.byref(args), 1, 1, out)
        assert "not supported" in lib.ipx_error_string(status).decode()
    pos = torch.zeros(16, 16, device="cuda")
    pm, ps = torch.zeros(16, device="cuda"), torch.ones(16, device="cuda")
    with pytest.raises(RuntimeError, match="launch failed.*not supported"):
        da3.fused_da3_pcn_chain(small(256, 16), mid, small(64, 16), pos, pm, ps, 0.25, 0,
                                n_steps=1, k_inner=1, k_mid=1, block_chains=16)


# --- the Burgers DA and pCN one chain a warp (fused_da_pcn_burgers_warp_kernel,
# fused_pcn_burgers_warp_kernel) and the one-chain-a-CTA kernels they leave


def _burgers_misfit(n_cells, n_modes=16, m=16, obs_times=None, seed=0):
    """A Burgers misfit on the card at ``n_cells`` cells (t = 0.2, m
    observed cells), its data the plain forward at numpy-drawn coefficients
    plus numpy noise."""
    from ip_mcmc_tpu_torch.configs import burgers_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import burgers

    obs = np.linspace(0, n_cells - 1, m).round().astype(int)
    aux = burgers.burgers_aux(n_cells=n_cells, n_modes=n_modes, alpha=1.5, field_scale=1.0,
                              t_final=0.2, obs_indices=obs, obs_times=obs_times,
                              mean_profile=np.sin(2 * np.pi * (np.arange(n_cells) + 0.5)
                                                  / n_cells))
    r = np.random.default_rng(seed)
    truth = burgers_misfit_from_arrays(aux, np.zeros(m * len(aux["segment_steps"])), 0.02)
    u = torch.from_numpy(r.standard_normal((n_modes, 1)).astype(np.float32))
    y = torch.cat([s[obs, 0] for s in truth.final_states(u)]).numpy()
    y = (y + 0.02 * r.standard_normal(y.shape)).astype(np.float32)
    return burgers_misfit_from_arrays(aux, y, 0.02).cuda()


def _burgers_run(kind, pots, pos, thin, block):
    """(kernel outputs, plain twin's) of the Burgers DA (``pots``: exact,
    surrogate) or pCN (``pots``: one misfit) from ``pos``, 3 steps."""
    pm = torch.zeros(pos.shape[1], device="cuda")
    ps = torch.ones(pos.shape[1], device="cuda")
    kw = {"thin": thin} if thin else {}
    plain = tuple(p._forward_plain for p in pots)
    if kind == "da":
        kw.update(n_steps=3, subchain_len=4, block_chains=block)
        run_plain = da._run_plain_recorded if thin else da._run_plain
        return (da._launch(*pots, pos, pm, ps, 0.15, 31, **kw),
                run_plain(*plain, pos, pm, ps, 0.15, 31, **kw))
    args = (pm, ps, 0.15, 33, 3, block)
    return (fused_pcn._launch(*pots, pos, *args, **kw),
            fused_pcn._run_plain(*plain, pos, *args, **kw))


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("kind", ["da", "pcn", "pcn_multitime"])
def test_burgers_warp_kernels_with_ragged_last_cta(burgers_problem, kind, record):
    """13 chains in blocks of 8: two CTAs of 8 warps, the last with 3 spare
    warps that run on zeros and store nothing. The 13 chains equal the first
    13 of the kernel's 16-chain run bit for bit and agree with the plain
    twin's (within 1e-4 on 99 % of chains, acceptance within 0.01)."""
    p = burgers_problem
    if kind == "da":
        pots, name = (p.batched_potential_fn, p.batched_surrogate_fn), da.BURGERS_KERNEL
    else:
        config = "burgers_multitime_pcn" if kind == "pcn_multitime" else "burgers_pcn"
        pots, name = (_build_on_card(config).batched_potential_fn,), fused_pcn.BURGERS_KERNEL
    pos = p.init_positions(torch.Generator().manual_seed(30), 16).cuda()
    thin = 1 if record else None
    name = f"{name}<{'true' if record else 'false'}>"
    before = _build.launch_counts[name]
    (got, ref), (full, _) = (_burgers_run(kind, pots, pos[:n], thin, 8) for n in (13, 16))
    assert _build.launch_counts[name] == before + 2
    for g, f in zip(got, full):
        assert torch.equal(g, f[:, :13] if g.dim() == 3 else f[:13])
    if record:
        assert got[2].shape == (3, 13, 16) and torch.equal(got[2][-1], got[0])
        rec = (got[2] - ref[2]).abs().amax(dim=(0, 2))
        assert float((rec <= 1e-4).double().mean()) >= 0.99
    elif kind == "da":
        assert abs(float(got[2].mean()) - float(ref[2].mean())) <= 1e-2
    _chains_agree(got, ref, 3)


def test_burgers_warp_geometry_matches_the_kernel(burgers_problem):
    """fused_da_pcn.burgers_warp_geometry and fused_pcn.burgers_warp_geometry
    (Python) give what the kernels' launches compute, on the configs' levels
    and on 64-cell ones."""
    import ctypes

    p = burgers_problem
    fine, coarse = p.batched_potential_fn, p.batched_surrogate_fn
    lib = _build.library()
    for n, block in ((2048, 512), (13, 8), (13, 13), (20, 4), (0, 512)):
        pos = torch.zeros(n, 16, device="cuda")
        args, _ = da._scaffold.chain_args(pos, p.prior.mean, p.prior.scale, 0, 1, block)
        for exact, surr in ((fine, coarse), (coarse, coarse), (coarse, fine)):
            out = (ctypes.c_int * 3)()
            assert lib.ipx_da_pcn_burgers_warp_geometry(
                ctypes.byref(exact.spec()), ctypes.byref(surr.spec()), ctypes.byref(args), 16,
                out) == 0
            ctas, w, smem = da.burgers_warp_geometry(n, block, cells=(exact.n, surr.n))
            assert tuple(out) == (w, ctas, smem), (n, block, exact.n, surr.n)
        for pot in (fine, coarse):
            out = (ctypes.c_int * 3)()
            assert lib.ipx_pcn_burgers_warp_geometry(ctypes.byref(pot.spec()),
                                                     ctypes.byref(args), out) == 0
            ctas, w, smem = fused_pcn.burgers_warp_geometry(n, block, cells=pot.n)
            assert tuple(out) == (w, ctas, smem), (n, block, pot.n)


@pytest.mark.parametrize("kind", ["da", "pcn"])
def test_burgers_cta_kernels_take_what_the_warp_kernels_leave(kind):
    """A 96-cell level and a prior of 8 modes: the warp kernels' geometry
    refuses them (cudaErrorNotSupported), the entry points run them on the
    one-chain-a-CTA kernels, which agree with their twins."""
    import ctypes

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    lib = _build.library()
    # each surrogate observes the same truth as its exact level (the seed)
    for level, surr, d in ((_burgers_misfit(96, seed=1), _burgers_misfit(64, seed=1), 16),
                           (_burgers_misfit(128, n_modes=8), _burgers_misfit(64, n_modes=8), 8)):
        pots = (level, surr) if kind == "da" else (level,)
        pos = (0.5 * torch.randn(64, d, generator=torch.Generator().manual_seed(31))).cuda()
        args, _ = da._scaffold.chain_args(pos, torch.zeros(d, device="cuda"),
                                          torch.ones(d, device="cuda"), 0, 1, 32)
        out = (ctypes.c_int * 3)()
        specs = [ctypes.byref(p.spec()) for p in pots]
        status = (lib.ipx_da_pcn_burgers_warp_geometry(*specs, ctypes.byref(args), 4, out)
                  if kind == "da" else
                  lib.ipx_pcn_burgers_warp_geometry(*specs, ctypes.byref(args), out))
        assert "not supported" in lib.ipx_error_string(status).decode()
        stem = (da._burgers_stem(*pots, d) if kind == "da"
                else fused_pcn._burgers_stem(pots[0], d))
        assert stem == {"da": "fused_da_pcn_burgers_kernel", "pcn": "fused_pcn_burgers_kernel"}[kind]
        for thin in (None, 1):
            name = f"{stem}<{'false' if thin is None else 'true'}>"
            before = _build.launch_counts[name]
            got, ref = _burgers_run(kind, pots, pos, thin, 32)
            assert _build.launch_counts[name] == before + 1
            _chains_agree(got, ref, 3)


@pytest.mark.parametrize("kind", ["da", "pcn"])
def test_burgers_warp_kernels_on_64_cells_and_100_observations(kind):
    """Levels of 64 cells only, 100 observations: the warp solve adds Φ in
    the order of the one-chain-a-CTA kernel's CTA of 64 threads (C = 2, T =
    64), and the chains agree with the twin's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    level = _burgers_misfit(64, m=100, seed=2)
    pots = (level, level) if kind == "da" else (level,)
    assert (da._burgers_stem(*pots) if kind == "da" else fused_pcn._burgers_stem(level)) == (
        da.BURGERS_KERNEL if kind == "da" else fused_pcn.BURGERS_KERNEL)
    pos = (0.5 * torch.randn(256, 16, generator=torch.Generator().manual_seed(32))).cuda()
    got, ref = _burgers_run(kind, pots, pos, None, 64)
    _chains_agree(got, ref, 3)


# --- the functional ensemble sampler: one warp per chain (fused_fes_warp_kernel)


@pytest.mark.parametrize("record", [False, True])
def test_fes_warp_kernel_on_a_ragged_count_of_ensembles(warm_problem, record):
    """Three ensembles of 8: a launch runs the 12 chains of one parity in two
    CTAs of 8 warps, the last with 4 spare warps, which return. The first
    two ensembles equal a run of those two alone bit for bit and agree with
    the plain twin's."""
    pot = warm_problem.batched_potential_fn
    pm, ps = warm_problem.prior.mean, warm_problem.prior.scale
    pos = warm_problem.init_positions(torch.Generator().manual_seed(30), 24).cuda()
    kw = {"thin": 1} if record else {}
    name = f"{fused_fes.KERNEL}<{'true' if record else 'false'}>"
    before = _build.launch_counts[name]
    args = (pm, ps, 8, 9, 0.08, 2.0, 3, 8)
    got, part = (fused_fes._launch(pot, pos[:n], *args, **kw) for n in (24, 16))
    assert _build.launch_counts[name] == before + 2 * 3 * 2
    for g, f in zip(got, part):
        assert torch.equal(g[:, :16] if g.dim() == 3 else g[:16], f)
    ref = fused_fes._run_plain(pot._forward_plain, pos, *args, **kw)
    if record:
        assert got[2].shape == (3, 24, 64) and torch.equal(got[2][-1], got[0])
        rec = (got[2] - ref[2]).abs().amax(dim=(0, 2))
        assert float((rec <= 1e-4).double().mean()) >= 0.99
    else:
        assert abs(float(got[2].mean()) - float(ref[2].mean())) <= 1e-2
    _chains_agree(got, ref, 3)


def test_fes_warp_geometry_matches_the_kernel(warm_problem):
    """fused_fes.warp_geometry (Python) gives what the kernel's launch
    computes."""
    import ctypes

    pot = warm_problem.batched_potential_fn
    lib = _build.library()
    for n, block in ((4096, 256), (24, 8), (12, 6), (0, 256)):
        pos = torch.zeros(n, 64, device="cuda")
        args, _ = da._scaffold.chain_args(pos, warm_problem.prior.mean,
                                          warm_problem.prior.scale, 0, 1, block)
        out = (ctypes.c_int * 3)()
        assert lib.ipx_fes_warp_geometry(ctypes.byref(pot.spec()), ctypes.byref(args), 8,
                                         out) == 0
        ctas, w, smem = fused_fes.warp_geometry(n, block)
        assert (out[0], out[1], out[2]) == (w, ctas, smem), (n, block)


def test_fes_warp_kernel_refuses_what_it_does_not_take(problem):
    """A dst_trunc misfit (darcy_da_fused's exact level) and a 32² Jacobi
    misfit: the warp kernel's geometry function refuses them
    (cudaErrorNotSupported). The first runs one chain a CTA
    (fused_fes_kernel, two launches a step); the second, above 16², is
    refused by the rule and the wrapper raises. An odd ensemble or a ragged
    last one: the entry point raises, the geometry function returns
    cudaErrorInvalidValue."""
    import ctypes

    big = _build_on_card("darcy32_pcn_warm").batched_potential_fn
    lib = _build.library()
    pos = problem.init_positions(torch.Generator().manual_seed(31), 16).cuda()
    pm, ps = problem.prior.mean, problem.prior.scale
    out = (ctypes.c_int * 3)()
    for pot in (problem.batched_potential_fn, big):
        if pot is big:
            with pytest.raises(RuntimeError, match="launch failed.*not supported"):
                fused_fes.fused_fes_chain(pot, pos, pm, ps, 8, 0, n_steps=1, block_chains=16)
        else:
            before = _build.launch_counts["fused_fes_kernel<false>"]
            fused_fes.fused_fes_chain(pot, pos, pm, ps, 8, 0, n_steps=1, block_chains=16)
            assert _build.launch_counts["fused_fes_kernel<false>"] == before + 2
        args, _ = da._scaffold.chain_args(pos, pm, ps, 0, 1, 16)
        status = lib.ipx_fes_warp_geometry(ctypes.byref(pot.spec()), ctypes.byref(args), 8, out)
        assert "not supported" in lib.ipx_error_string(status).decode()
    jacobi = _build_on_card("darcy_pcn_warm").batched_potential_fn
    with pytest.raises(ValueError, match="must be even"):
        fused_fes.fused_fes_chain(jacobi, pos[:15], pm, ps, 8, 0, n_steps=1, block_chains=5)
    for n, block in ((15, 5), (12, 8)):
        args, _ = da._scaffold.chain_args(pos[:n], pm, ps, 0, 1, block)
        status = lib.ipx_fes_warp_geometry(ctypes.byref(jacobi.spec()), ctypes.byref(args), 8,
                                           out)
        assert "invalid argument" in lib.ipx_error_string(status).decode()


# --- MALA: one warp per chain (fused_mala_warp_kernel<RECORD, PRECOND>) ---------


def _mala_pots(p, warm):
    """(the potential the kernel takes, its plain version, extra arguments)."""
    if warm:
        pag, aux_dim = p.batched_warm_potential
        return pag, pag._forward_warm_plain, {"aux_dim": aux_dim}
    pot = p.batched_potential_fn
    return pot, pot._forward_plain, {}


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("warm", [False, True])
def test_mala_warp_kernel_with_ragged_last_cta(mala_warm_problem, warm, record):
    """13 chains in blocks of 8: two CTAs of 8 warps, the last with 3 spare
    warps that run on zeros and store nothing. The 13 chains equal the first
    13 of the kernel's 16-chain run bit for bit and agree with the plain
    twin's."""
    p = mala_warm_problem
    pot, plain, kw = _mala_pots(p, warm)
    pm, ps = p.prior.mean, p.prior.scale
    pos = p.init_positions(torch.Generator().manual_seed(28), 16).cuda()
    if record:
        kw = dict(kw, thin=1)
    name = _scaffold_name(fused_mala.stem(warm), record)
    before = _build.launch_counts[name]
    got, full = (fused_mala._launch(pot, pos[:n], pm, ps, 0.012, 9, 3, 8, **kw)
                 for n in (13, 16))
    assert _build.launch_counts[name] == before + 2
    for g, f in zip(got, full):
        assert torch.equal(g, f[:, :13] if g.dim() == 3 else f[:13])
    ref = fused_mala._run_plain(plain, pos, pm, ps, 0.012, 9, 3, 8, **kw)
    if record:
        assert got[2].shape == (3, 13, 64) and torch.equal(got[2][-1], got[0])
        rec = (got[2] - ref[2][:, :13]).abs().amax(dim=(0, 2))
        assert float((rec <= 1e-4).double().mean()) >= 0.99
    _chains_agree(got, tuple(r[:13] for r in ref[:2]), 3)


def test_mala_warp_geometry_matches_the_kernel(mala_warm_problem):
    """fused_mala.warp_geometry (Python) gives what the kernel's launch
    computes, cold and warm."""
    import ctypes

    p = mala_warm_problem
    lib = _build.library()
    for warm in (False, True):
        pot = _mala_pots(p, warm)[0]
        for n, block in ((4096, 256), (13, 8), (13, 13), (20, 4), (0, 256)):
            pos = torch.zeros(n, 64, device="cuda")
            args, _ = da._scaffold.chain_args(pos, p.prior.mean, p.prior.scale, 0, 1, block)
            out = (ctypes.c_int * 3)()
            assert lib.ipx_mala_warp_geometry(ctypes.byref(pot.spec()), ctypes.byref(args),
                                              int(warm), out) == 0
            ctas, w, smem = fused_mala.warp_geometry(n, block, warm=warm)
            assert (out[0], out[1], out[2]) == (w, ctas, smem), (warm, n, block)


def test_mala_warp_kernel_refuses_what_it_does_not_take(problem):
    """A dst_trunc misfit (darcy_da_fused's exact level) and a 32² Jacobi
    misfit: the C geometry function of the warp kernel says "not
    supported", as it does for the cold Jacobi misfit given to the warm
    kernel. The first runs one chain a CTA (fused_mala_kernel); for the
    second, above 16², the entry point raises ValueError (the rule's
    mirror) before any launch."""
    import ctypes

    big = _build_on_card("darcy32_pcn_warm").batched_potential_fn
    jacobi = _build_on_card("darcy_pcn_warm").batched_potential_fn
    lib = _build.library()
    pos = problem.init_positions(torch.Generator().manual_seed(29), 16).cuda()
    pm, ps = problem.prior.mean, problem.prior.scale
    out = (ctypes.c_int * 3)()
    for pot in (problem.batched_potential_fn, big):
        before = dict(_build.launch_counts)
        if pot is big:
            with pytest.raises(ValueError, match="MALA kernels take"):
                fused_mala.fused_mala_chain(pot, pos, 0.01, 0, n_steps=1, block_chains=16,
                                            prior_mean=pm, prior_scale=ps)
            assert dict(_build.launch_counts) == before
        else:
            fused_mala.fused_mala_chain(pot, pos, 0.01, 0, n_steps=1, block_chains=16,
                                        prior_mean=pm, prior_scale=ps)
            assert (_build.launch_counts["fused_mala_kernel<false>"]
                    == before.get("fused_mala_kernel<false>", 0) + 1)
        args, _ = da._scaffold.chain_args(pos, pm, ps, 0, 1, 16)
        status = lib.ipx_mala_warp_geometry(ctypes.byref(pot.spec()), ctypes.byref(args), 0,
                                            out)
        assert "not supported" in lib.ipx_error_string(status).decode()
    args, _ = da._scaffold.chain_args(pos, pm, ps, 0, 1, 16)
    status = lib.ipx_mala_warp_geometry(ctypes.byref(jacobi.spec()), ctypes.byref(args), 1, out)
    assert "not supported" in lib.ipx_error_string(status).decode()


# --- the standalone 16² warm misfit and the 8² surrogate a draw a warp ---------
# (darcy_misfit_warm_warp_kernel, darcy_misfit_warp_kernel<8, SOLVER>)

WARM_WARP = "darcy_misfit_warm_warp_kernel[n=16]"
SURR_WARP = {"cg": "darcy_misfit_warp_kernel[n=8]",
             "richardson": "darcy_misfit_warp_kernel[n=8,richardson]"}


def _warm_pair(p, n, seed):
    """(U, U2 a pCN move away, zeros) for ``n`` draws of ``p``'s prior."""
    g = torch.Generator().manual_seed(seed)
    U = p.prior.sample(g, n).T.contiguous()
    U2 = (0.9968 * U + 0.08 * p.prior.sample(g, n).T).contiguous()
    return U, U2, torch.zeros(p.batched_warm_potential[1], n, device="cuda")


def test_misfit_warm_warp_kernel_matches_plain_at_full_width(warm_problem):
    """darcy_pcn_warm's warm misfit (dst_trunc-64 / 4 CG) at its 4096 draws
    under chip_smoke.py's bounds: from x0 = 0 against the plain version in
    f64 with the same bf16 roundings (BF16_COLD_START_TOL: four CG
    iterations from zero stop unconverged, where f32 summation order alone
    moves Φ, the f32 twin's as much as the tensor cores'), and from that
    solution after a pCN move against the f32 twin (BF16_TOL)."""
    warm = warm_problem.batched_warm_potential[0]
    assert warm.warm_kernel_label == WARM_WARP
    U, U2, zeros = _warm_pair(warm_problem, 4096, 44)
    before = _build.launch_counts[WARM_WARP]
    phi1, x1 = warm(U, zeros)
    phi2, x2 = warm(U2, x1)
    assert _build.launch_counts[WARM_WARP] == before + 2
    f64 = warm.float64_twin()._forward_warm_plain(U.double(), zeros.double())
    for (phi, x), ref, (median, rtol, frac) in (
            ((phi1, x1), f64, (2e-5, 1e-4, 0.90)),
            ((phi2, x2), warm._forward_warm_plain(U2, x1), (2e-6, 1e-5, 0.80))):
        rel = _rel(phi, ref[0])
        assert float(rel.median()) <= median and float(rel.max()) <= 5e-3
        assert float((rel <= rtol).double().mean()) >= frac
        assert float(_col_err(x, ref[1]).max()) <= 5e-3


@pytest.mark.parametrize("B", [4091, 1, 0])
def test_misfit_warm_warp_kernel_on_ragged_widths(warm_problem, B):
    """B draws of a 4096-draw batch: the last CTA's spare warps solve u = 0
    from x = 0 and write nothing; a draw's column of the CTA's products
    depends on it alone, so (Φ, x) equal the first B of the 4096-draw launch
    bit for bit, from x0 = 0 and from the previous solution."""
    warm = warm_problem.batched_warm_potential[0]
    U, U2, x0 = _warm_pair(warm_problem, 4096, 45)
    for V in (U, U2):
        full = warm(V, x0)
        got = warm(V[:, :B].contiguous(), x0[:, :B].contiguous())
        assert got[0].shape == (B,) and got[1].shape == (warm.aux_dim, B)
        assert torch.equal(got[0], full[0][:B]) and torch.equal(got[1], full[1][:, :B])
        x0 = full[1]


def _warm_modes(p, modes):
    """A 16² dst_trunc / 4 CG warm misfit of ``modes`` modes on ``p``'s data
    (no config: darcy_pcn_warm's is 64)."""
    from ip_mcmc_tpu_torch.convert import darcy_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    aux = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    return darcy_warm_misfit_from_arrays(aux, p.data, 0.002, cg_iters=4, precond="dst_trunc",
                                         precond_modes=modes)[0].cuda()


@pytest.mark.parametrize("modes", [48, 112])
def test_misfit_warm_warp_kernel_on_other_mode_counts(warm_problem, modes):
    """The warm rule takes a multiple of 16 modes up to 112: at 48 and at
    112 (the most the CTA's shared memory holds) the kernel launches with
    the geometry its Python mirror gives and meets its twin, from x0 = 0 and
    from the previous solution, under the bound of the one-draw-a-CTA
    kernel's bf16 specs (5e-3)."""
    import ctypes

    warm = _warm_modes(warm_problem, modes)
    assert warm.warm_kernel_label == WARM_WARP
    out = (ctypes.c_int * 3)()
    status = _build.library().ipx_darcy_misfit_warm_warp_geometry(ctypes.byref(warm.spec()),
                                                                  1024, out)
    assert status == 0 and tuple(out) == fused_pcn.misfit_warm_warp_geometry(
        1024, **warm.spec_fields)
    U, U2, x0 = _warm_pair(warm_problem, 1024, 51)
    before = _build.launch_counts[WARM_WARP]
    for V in (U, U2):
        phi, x = warm(V, x0)
        ref_phi, ref_x = warm._forward_warm_plain(V, x0)
        assert bool(torch.isfinite(phi).all())
        assert float(_rel(phi, ref_phi).max()) <= 5e-3
        assert float(_col_err(x, ref_x).max()) <= 5e-3
        x0 = x
    assert _build.launch_counts[WARM_WARP] == before + 2


def _warm_specs_left(p):
    """16² warm misfits the warm warp rule leaves: dense dst / 4 CG, Jacobi /
    16 CG, dst_trunc-128 (above 112 modes); and darcy32_pcn_warm's warm
    misfit (the 32² cluster level)."""
    from ip_mcmc_tpu_torch.convert import darcy_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    aux = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    left = [darcy_warm_misfit_from_arrays(aux, p.data, 0.002, cg_iters=it, precond=pc,
                                          precond_modes=128)[0].cuda()
            for pc, it in (("dst", 4), ("jacobi", 16), ("dst_trunc", 4))]
    return (*left, _build_on_card("darcy32_pcn_warm").batched_warm_potential[0])


def test_misfit_warm_warp_rule_and_geometry_match_the_kernel(warm_problem):
    """ops/fused_pcn.py misfit_warm_warp_takes and misfit_warm_warp_geometry
    give what the C function computes: the geometry of darcy_pcn_warm's warm
    misfit at 4096, 13, 1 and 0 draws, cudaErrorNotSupported for the warm
    specs the rule leaves and for the cold misfits."""
    import ctypes

    lib = _build.library()
    warm = warm_problem.batched_warm_potential[0]
    left = (*_warm_specs_left(warm_problem), warm_problem.batched_potential_fn,
            _build_on_card("darcy_da_fused").batched_potential_fn)
    out = (ctypes.c_int * 3)()
    for B in (4096, 13, 1, 0):
        status = lib.ipx_darcy_misfit_warm_warp_geometry(ctypes.byref(warm.spec()), B, out)
        assert status == 0 and fused_pcn.misfit_warm_warp_takes(**warm.spec_fields)
        assert tuple(out) == fused_pcn.misfit_warm_warp_geometry(B, **warm.spec_fields)
    for pot in left:
        status = lib.ipx_darcy_misfit_warm_warp_geometry(ctypes.byref(pot.spec()), 64, out)
        assert "not supported" in lib.ipx_error_string(status).decode()
        assert not fused_pcn.misfit_warm_warp_takes(**pot.spec_fields)


def test_warm_kernel_takes_the_warm_specs_the_warp_rule_leaves(warm_problem):
    """The 16² warm specs the rule leaves go to darcy_misfit_warm_kernel
    (one draw a CTA; the dense dst one to darcy_misfit_warm_dst_warp_kernel,
    a draw a warp) and meet their twins from x0 = 0 and from the previous
    solution: bf16 preconditioners under 5e-3, Jacobi f32 only under 1e-4."""
    g = torch.Generator().manual_seed(46)
    labels = ("darcy_misfit_warm_dst_warp_kernel[n=16]", "darcy_misfit_warm_kernel",
              "darcy_misfit_warm_kernel")
    for pot, max_rel, label in zip(_warm_specs_left(warm_problem)[:3], (5e-3, 1e-4, 5e-3),
                                   labels):
        assert pot.warm_kernel_label == label
        U = warm_problem.prior.sample(g, 256).T.contiguous()
        x0 = torch.zeros(pot.aux_dim, 256, device="cuda")
        before = _build.launch_counts[label]
        for _ in range(2):
            phi, x = pot(U, x0)
            ref_phi, ref_x = pot._forward_warm_plain(U, x0)
            assert float(_rel(phi, ref_phi).max()) <= max_rel, pot.precond
            assert float(_col_err(x, ref_x).max()) <= max(max_rel, 1e-3), pot.precond
            U, x0 = (0.9968 * U + 0.08 * warm_problem.prior.sample(g, 256).T).contiguous(), x
        assert _build.launch_counts[label] == before + 2


def _surrogates():
    """{variant: (exact, surrogate)} of darcy_da_fused (cg3's spec) and the
    three Richardson runs."""
    p = _build_on_card("darcy_da_fused")
    rich = {v: configs.darcy_da_richardson(v, "cuda")
            for v in configs.RICHARDSON_VARIANTS if v != "cg3"}
    return {"darcy_da_fused": (p.batched_potential_fn, p.batched_surrogate_fn),
            **{v: (q.batched_potential_fn, q.batched_surrogate_fn) for v, q in rich.items()}}


def test_misfit_surr_warp_kernel_matches_plain_at_full_width():
    """The 8² surrogates at 4096 draws a draw a warp against the plain twin:
    CG under BF16_TOL, Richardson under RICH_BF16_TOL (chip_smoke.py's)."""
    surrogates = _surrogates()
    g = torch.Generator().manual_seed(47)
    for name, (_, surr) in surrogates.items():
        label = SURR_WARP[surr.solver]
        assert surr.kernel_label == label
        U = torch.randn(64, 4096, generator=g).cuda()
        before = _build.launch_counts[label]
        rel = _rel(surr(U), surr._forward_plain(U))
        assert _build.launch_counts[label] == before + 1
        median, rtol = (2e-6, 1e-5) if surr.solver == "cg" else (5e-5, 1e-4)
        assert float(rel.median()) <= median and float(rel.max()) <= 5e-3, name
        assert float((rel <= rtol).double().mean()) >= 0.80, name


@pytest.mark.parametrize("B", [4091, 1, 0])
def test_misfit_surr_warp_kernel_on_ragged_widths(B):
    """B draws of a 4096-draw batch, CG and Richardson: the spare warps of
    the last CTA run on zeros; Φ* equals the first B of the 4096-draw
    launch bit for bit."""
    surrogates = _surrogates()
    U = torch.randn(64, 4096, generator=torch.Generator().manual_seed(48)).cuda()
    for name, (_, surr) in surrogates.items():
        got, full = surr(U[:, :B].contiguous()), surr(U)
        assert got.shape == (B,) and torch.equal(got, full[:B]), name


def _specs8_left():
    """Cold misfits the warp rule leaves: on darcy_da_fused's surrogate
    observations and data, 8² with K 36 (CG and Richardson); on its exact
    data, 12² dst_trunc-64 / 3 CG and 16² Richardson."""
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    _build_on_card("darcy_da_fused")
    fx = np.load(configs.FIXTURE)

    def misfit(n_grid, modes_per_dim, surrogate=False, **kw):
        obs = {"obs_indices": fx["obs_coarse"]} if surrogate else {}
        aux = darcy.darcy_aux(n_grid=n_grid, n_modes_per_dim=modes_per_dim, alpha=2.0,
                              field_scale=10.0, **obs)
        y, sigma = (fx["y_surr"], fx["surr_scale"]) if surrogate else (fx["y"], 0.002)
        kw = {"cg_iters": 3, "precond": "dst_trunc", "precond_modes": 64, **kw}
        return darcy_misfit_from_arrays(aux, y, sigma, **kw).cuda()

    return {"8x8 K36": misfit(8, 6, True),
            "8x8 K36 richardson": misfit(8, 6, True, solver="richardson", omega=0.9),
            "12x12": misfit(12, 8),
            "16x16 richardson": misfit(16, 8, precond_modes=128, solver="richardson",
                                       omega=0.9)}


def test_misfit_warp_rule_and_geometry_match_the_kernel_at_8():
    """ops/fused_da_pcn.py misfit_warp_takes and misfit_warp_geometry give
    what the C function computes on the four shipped 8² surrogates (4096,
    13, 1, 0 draws), and both leave the same specs (_specs8_left)."""
    import ctypes

    surrogates = _surrogates()
    lib = _build.library()
    out = (ctypes.c_int * 3)()
    for _, surr in surrogates.values():
        for B in (4096, 13, 1, 0):
            status = lib.ipx_darcy_misfit_warp_geometry(ctypes.byref(surr.spec()), B, out)
            assert status == 0 and da.misfit_warp_takes(**surr.spec_fields)
            assert tuple(out) == da.misfit_warp_geometry(B, **surr.spec_fields)
    for name, pot in _specs8_left().items():
        status = lib.ipx_darcy_misfit_warp_geometry(ctypes.byref(pot.spec()), 64, out)
        assert "not supported" in lib.ipx_error_string(status).decode(), name
        assert not da.misfit_warp_takes(**pot.spec_fields), name


def _jacobi8():
    """8² Jacobi / 3 iteration surrogates on darcy_da_fused's surrogate data,
    K 64, by CG and by Richardson (ω 0.9): specs the 8² branch of the warp
    rule takes that no config uses."""
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    _build_on_card("darcy_da_fused")
    fx = np.load(configs.FIXTURE)
    aux = darcy.darcy_aux(n_grid=8, n_modes_per_dim=8, alpha=2.0, field_scale=10.0,
                          obs_indices=fx["obs_coarse"])
    return {solver: darcy_misfit_from_arrays(aux, fx["y_surr"], fx["surr_scale"], cg_iters=3,
                                             precond="jacobi", solver=solver,
                                             **({"omega": 0.9} if solver == "richardson"
                                                else {})).cuda()
            for solver in ("cg", "richardson")}


@pytest.mark.parametrize("solver", ["cg", "richardson"])
def test_misfit_surr_warp_kernel_on_a_jacobi_surrogate(solver):
    """The 8² branch takes a Jacobi surrogate too (the DA kernel's 8² level
    solves one): the C geometry equals the mirror's, the kernel launches a
    draw a warp and meets its twin at 4096 draws under chip_smoke.py's
    bounds for f32-only solves (F32_TOL; Richardson: RICH_BF16_TOL, its
    residual recomputed as b - Ax)."""
    import ctypes

    pot = _jacobi8()[solver]
    label = SURR_WARP[solver]
    assert pot.kernel_label == label and da.misfit_warp_takes(**pot.spec_fields)
    out = (ctypes.c_int * 3)()
    for B in (4096, 13):
        status = _build.library().ipx_darcy_misfit_warp_geometry(ctypes.byref(pot.spec()), B, out)
        assert status == 0 and tuple(out) == da.misfit_warp_geometry(B, **pot.spec_fields)
    U = torch.randn(64, 4096, generator=torch.Generator().manual_seed(52)).cuda()
    before = _build.launch_counts[label]
    rel = _rel(pot(U), pot._forward_plain(U))
    assert _build.launch_counts[label] == before + 1
    median, rtol, frac, max_rel = ((2e-6, 1e-5, 0.99, 1e-4) if solver == "cg"
                                   else (5e-5, 1e-4, 0.80, 5e-3))
    assert float(rel.median()) <= median and float(rel.max()) <= max_rel
    assert float((rel <= rtol).double().mean()) >= frac


def test_layout16_kernel_takes_the_specs_the_warp_rule_leaves_at_8_to_16():
    """The cold specs of _specs8_left stay on darcy_misfit_kernel (one draw a
    CTA of Layout16, by their solver) and meet their twins under 5e-3."""
    g = torch.Generator().manual_seed(49)
    for name, pot in _specs8_left().items():
        tag = ",richardson" if pot.solver == "richardson" else ""
        label = f"darcy_misfit_kernel[n={pot.n}{tag}]"
        assert pot.kernel_label == label, name
        U = torch.randn(pot.K, 256, generator=g).cuda()
        before = _build.launch_counts[label]
        rel = _rel(pot(U), pot._forward_plain(U))
        assert _build.launch_counts[label] == before + 1
        assert float(rel.max()) <= 5e-3, name


def test_warm16_and_surr8_equal_their_samplers_own_solves(warm_problem):
    """Each standalone misfit a draw a warp equals its sampler's own first
    solve of the same u bit for bit: the warm misfit (darcy_pcn_warm's 64
    modes, and 48 and 112) K7's warm solve from x0 = 0, (Φ, x); each 8²
    surrogate the DA kernel's first surrogate solve (CG and Richardson).
    The samplers are copies patched to write that solve
    (scripts/measure_misfit_warm16_surr8_design.py), run one step at beta =
    0 under a zero prior mean."""
    import importlib.util
    import pathlib
    import sys

    scripts = pathlib.Path(__file__).resolve().parent.parent / "scripts"
    sys.path.insert(0, str(scripts))
    try:
        spec = importlib.util.spec_from_file_location(
            "measure_misfit_warm16_surr8_design", scripts / "measure_misfit_warm16_surr8_design.py")
        design = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(design)
    finally:
        sys.path.remove(str(scripts))
    _build.library()
    warm = warm_problem.batched_warm_potential[0]
    U = warm_problem.prior.sample(torch.Generator().manual_seed(50), 1024).T.contiguous()
    pairs = _surrogates()
    lib = design.first_solve_library(_build)
    (phi_k7, x_k7), sps = design.sampler_first_solves(_build, lib, warm, U, list(pairs.values()))
    zeros = torch.zeros(warm.aux_dim, U.shape[1], device="cuda")
    phi, x = warm(U, zeros)
    assert torch.equal(phi, phi_k7) and torch.equal(x, x_k7)
    for (name, (_, surr)), sp in zip(pairs.items(), sps):
        assert torch.equal(surr(U), sp), name
    for modes in (48, 112):
        other = _warm_modes(warm_problem, modes)
        (phi_k7, x_k7), _ = design.sampler_first_solves(_build, lib, other, U, [])
        phi, x = other(U, zeros)
        assert torch.equal(phi, phi_k7) and torch.equal(x, x_k7), modes


# --- the 16² dense-dst warm misfit a draw a warp (darcy_smc_warm) -------------


@pytest.fixture
def smc_warm_problem():
    return _build_on_card("darcy_smc_warm")


def test_warm_dst_warp_kernel_is_the_cta_kernel_bit_for_bit(smc_warm_problem):
    """darcy_smc_warm's dense dst / 6 CG misfit on darcy_misfit_warm_dst_warp_kernel
    against the one-draw-a-CTA darcy_misfit_warm_kernel it replaces
    (forward_layout), at 4096 draws from x0 = 0 and from the solution after
    a mutation-sized move: (Φ, x) bit for bit (warm MALA's level keeps the
    CTA's sum orders and bf16 roundings)."""
    warm, aux_dim = smc_warm_problem.batched_warm_potential
    assert warm.warm_kernel_label == "darcy_misfit_warm_dst_warp_kernel[n=16]"
    g = torch.Generator().manual_seed(60)
    U = smc_warm_problem.prior.sample(g, 4096).T.contiguous()
    U2 = (0.989 * U + 0.15 * smc_warm_problem.prior.sample(g, 4096).T).contiguous()
    x0 = torch.zeros(aux_dim, 4096, device="cuda")
    before = _build.launch_counts[warm.warm_kernel_label]
    for u in (U, U2):
        phi, x = warm(u, x0)
        phi_ref, x_ref = warm.forward_layout(u, x0)
        assert torch.equal(phi, phi_ref) and torch.equal(x, x_ref)
        x0 = x
    assert _build.launch_counts[warm.warm_kernel_label] == before + 2


def test_warm_dst_warp_kernel_on_a_ragged_width(smc_warm_problem):
    """13 draws: one CTA, 3 spare warps; the first 13 of a 16-draw launch."""
    warm, aux_dim = smc_warm_problem.batched_warm_potential
    U = smc_warm_problem.prior.sample(torch.Generator().manual_seed(61), 16).T.contiguous()
    x0 = torch.zeros(aux_dim, 16, device="cuda")
    got, full = warm(U[:, :13].contiguous(), x0[:, :13].contiguous()), warm(U, x0)
    assert torch.equal(got[0], full[0][:13]) and torch.equal(got[1], full[1][:, :13])


def test_warm_dst_warp_geometry_matches_the_kernel(smc_warm_problem):
    """ops/fused_pcn.py misfit_warm_dst_warp_geometry and
    misfit_warm_dst_warp_takes give what the C function computes:
    cudaErrorNotSupported (801) for a Jacobi and a dst_trunc warm spec."""
    import ctypes

    from ip_mcmc_tpu_torch.convert import darcy_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    lib = _build.library()
    aux = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    left = [darcy_warm_misfit_from_arrays(aux, smc_warm_problem.data, 0.002, cg_iters=6,
                                          precond=pc, precond_modes=64)[0].cuda()
            for pc in ("jacobi", "dst_trunc")]
    for pot in (smc_warm_problem.batched_warm_potential[0], *left):
        for B in (4096, 13, 1, 0):
            out = (ctypes.c_int * 3)()
            spec = pot.spec()
            status = lib.ipx_darcy_misfit_warm_dst_warp_geometry(ctypes.byref(spec), B, out)
            if fused_pcn.misfit_warm_dst_warp_takes(**pot.spec_fields):
                assert status == 0 and tuple(out) == fused_pcn.misfit_warm_dst_warp_geometry(
                    B, **pot.spec_fields)
            else:
                assert status == 801


# --- the Lotka-Volterra misfit and gradient (lv_misfit_grad_kernel) ----------


@pytest.fixture
def ode_problem():
    return _build_on_card("ode_mala")


def test_lv_kernel_matches_plain(ode_problem):
    """Φ and ∇Φ of 1024 chains (prior draws, half doubled) in one launch
    against the plain version (autograd through the RK4 loop on the card):
    Φ within 1e-4 relative, ∇Φ within 1e-3 of each chain's largest entry;
    and against the kernel's algorithm in PyTorch (adjoint_reference, the
    same f32 arithmetic up to the contraction of products into sums)."""
    from ip_mcmc_tpu_torch.ops import lv_rk4

    pot = ode_problem.potential_fn
    th = ode_problem.prior.sample(torch.Generator().manual_seed(62), 1024)
    th[512:] *= 2.0
    before = _build.launch_counts[lv_rk4.KERNEL]
    phi, grad = lv_rk4.misfit_and_grad(th, pot.spec)
    assert _build.launch_counts[lv_rk4.KERNEL] == before + 1
    for ref_phi, ref_grad in (pot.plain_value_and_grad(th),
                              lv_rk4.adjoint_reference(th, pot.spec)):
        assert float(_rel(phi, ref_phi).max()) <= 1e-4
        assert float(_col_err(grad.T, ref_grad.T).max()) <= 1e-3


def test_lv_kernel_through_autograd(ode_problem):
    """log π's gradient (base.value_and_grad) is the kernel's, one launch a
    gradient; a second derivative raises; a ragged width and (..., 4)
    batches reshape."""
    from ip_mcmc_tpu_torch.kernels import base
    from ip_mcmc_tpu_torch.ops import lv_rk4

    pot = ode_problem.potential_fn
    th = ode_problem.prior.sample(torch.Generator().manual_seed(63), 77)
    before = _build.launch_counts[lv_rk4.KERNEL]
    _, g = base.value_and_grad(ode_problem.log_density_fn)(th)
    assert _build.launch_counts[lv_rk4.KERNEL] == before + 1
    phi, grad = lv_rk4.misfit_and_grad(th, pot.spec)
    assert torch.allclose(g, -grad - th / 0.09, rtol=1e-6, atol=1e-6)
    assert torch.equal(pot(th.reshape(7, 11, 4)), phi.reshape(7, 11))
    x = th.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(pot(x).sum(), x, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gx.sum(), x)


# --- the one-chain-a-CTA kernels of the specs the Hopper designs leave ----------
# (each sampler's takes-rule: ess_route, fes_route, mala_route, da_route,
# pcn_route, da3_route, and their Python mirrors ``route``)


def _restored_case(name):
    """(kernel stem, launches a step or None for one a call, kern(steps,
    thin), plain(steps, thin)) of a spec of chip_smoke.py's phase at 64
    chains (the Burgers and 48² ones at 32)."""
    from chip_smoke import mala_warm_jacobi, synthetic_burgers, synthetic_darcy

    from ip_mcmc_tpu_torch.ops import fused_da3_pcn as da3

    g = torch.Generator().manual_seed(61)
    if name in ("ess", "ess36", "fes", "mala", "mala_warm", "da16"):
        p = _build_on_card("darcy_da_fused")
        pot = p.batched_potential_fn  # 16² dst_trunc-128, 12 CG
        if name == "ess36":
            pot = synthetic_darcy(12, 6, seed=41, cg_iters=48)
        if name == "mala_warm":
            pot = mala_warm_jacobi(_build_on_card("darcy_mala_warm"))
        d = pot.K
        pos = torch.randn(64, d, generator=g).cuda()
        pm, ps = torch.zeros(d, device="cuda"), torch.ones(d, device="cuda")
        plain = pot._forward_warm_plain if name == "mala_warm" else pot._forward_plain
        if name in ("ess", "ess36"):
            return ("fused_ess_kernel", None,
                    lambda s, t: fused_ess._launch(pot, pos, pm, ps, 5, s, 6, 32, thin=t),
                    lambda s, t: fused_ess._run_plain(plain, pos, pm, ps, 5, s, 6, 32, thin=t))
        if name == "fes":
            a = (pos, pm, ps, 8, 5, 0.08, 2.0)
            return ("fused_fes_kernel", 2,
                    lambda s, t: fused_fes._launch(pot, *a, s, 32, thin=t),
                    lambda s, t: fused_fes._run_plain(plain, *a, s, 32, thin=t))
        if name in ("mala", "mala_warm"):
            kw = {"aux_dim": pot.aux_dim} if name == "mala_warm" else {}
            stem = "fused_mala_warm_kernel" if kw else "fused_mala_kernel"
            return (stem, None,
                    lambda s, t: fused_mala._launch(pot, pos, pm, ps, 0.012, 5, s, 32, thin=t,
                                                    **kw),
                    lambda s, t: fused_mala._run_plain(plain, pos, pm, ps, 0.012, 5, s, 32,
                                                       thin=t, **kw))
        surr = synthetic_darcy(12, 8, seed=42, cg_iters=3)
        return _da_case("fused_da_pcn_kernel[layout16]", pot, surr, pos, pm, ps)
    if name == "da64":
        exact = synthetic_darcy(48, 12, seed=43, cg_iters=16, precond="dst_trunc",
                                precond_modes=256)
        surr = synthetic_darcy(24, 12, seed=44, cg_iters=3, precond="dst_trunc",
                               precond_modes=128)
        pos = torch.randn(32, 144, generator=g).cuda()
        pm, ps = torch.zeros(144, device="cuda"), torch.ones(144, device="cuda")
        return _da_case("fused_da_pcn_kernel[layout64]", exact, surr, pos, pm, ps)
    if name.startswith("pcn"):
        n = int(name[3:])
        kw = dict(cg_iters=16) if n == 32 else dict(cg_iters=4, precond="dst_trunc",
                                                     precond_modes=128 if n < 48 else 256)
        pot = synthetic_darcy(n, 8 if n < 48 else 12, seed=45, kind="warm", **kw)
        d = pot.K
        pos = torch.randn(64 if n < 48 else 32, d, generator=g).cuda()
        pm, ps = torch.zeros(d, device="cuda"), torch.ones(d, device="cuda")
        stem = f"fused_pcn_warm_kernel[layout{32 if n <= 32 else 64}]"
        return (stem, None,
                lambda s, t: (fused_pcn.fused_pcn_chain_warm_recorded(
                    pot, pos, pm, ps, 0.08, 5, n_steps=s, thin=t, aux_dim=pot.aux_dim,
                    block_chains=32) if t else fused_pcn.fused_pcn_chain_warm(
                    pot, pos, pm, ps, 0.08, 5, n_steps=s, aux_dim=pot.aux_dim,
                    block_chains=32)),
                lambda s, t: fused_pcn._run_plain(pot._forward_warm_plain, pos, pm, ps, 0.08,
                                                  5, s, 32, thin=t, aux_dim=pot.aux_dim))
    levels = synthetic_burgers(96, 32, seed=48)
    pos = torch.randn(32, 32, generator=g).cuda()
    pm, ps = torch.zeros(32, device="cuda"), torch.ones(32, device="cuda")
    a = (*levels, pos, pm, ps, 0.25, 5)
    pa = (*(lv._forward_plain for lv in levels), *a[3:])
    return ("fused_da3_pcn_kernel", None,
            lambda s, t: da3._launch(*a, s, 2, 2, 32, thin=t),
            lambda s, t: da3._run_plain(*pa, s, 2, 2, 32, thin=t))


def _da_case(stem, exact, surr, pos, pm, ps):
    assert da._darcy_stem(exact, surr) == stem
    a = (exact, surr, pos, pm, ps, 0.3, 5)
    pa = (exact._forward_plain, surr._forward_plain, *a[2:])
    kw = dict(subchain_len=3, block_chains=32)

    def kern(s, t):
        if t:
            return da.fused_da_pcn_chain_recorded(*a, n_steps=s, thin=t, **kw)
        return da.fused_da_pcn_chain(*a, n_steps=s, **kw)

    def plain(s, t):
        if t:
            return da._run_plain_recorded(*pa, n_steps=s, thin=t, **kw)
        return da._run_plain(*pa, n_steps=s, **kw)
    return stem, None, kern, plain


RESTORED = ["ess", "ess36", "fes", "mala", "mala_warm", "da16", "da64", "pcn24", "pcn32",
            "pcn48", "da3"]
# the specs whose preconditioner rounds its inputs to bf16 (dst_trunc)
BF16_SPECS = ("ess", "fes", "mala", "da16", "da64", "pcn24", "pcn48")


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("name", RESTORED)
def test_restored_cta_kernels_match_plain(name, record):
    """Each spec of chip_smoke.py's phase of the one-chain-a-CTA kernels, at
    32 or 64 chains and 2 steps: the rule's kernel launched (its count), and
    within 1e-4 of the plain twin on 99 % of chains (with bf16
    preconditioner inputs 95 %: a rounding flip can turn one MH decision
    and part a chain, one of 64 here; chip_smoke.py holds 99 % of 4096),
    the mean acceptance within 1e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    stem, per_step, kern, plain = _restored_case(name)
    thin = 1 if record else None
    key = _scaffold_name(stem, record)
    before = _build.launch_counts[key]
    got, ref = kern(2, thin), plain(2, thin)
    assert _build.launch_counts[key] == before + (2 * per_step if per_step else 1)
    least = 0.95 if name in BF16_SPECS else 0.99
    if record:
        rec = (got[2] - ref[2]).abs().amax(dim=(0, 2))
        assert float((rec <= 1e-4).double().mean()) >= least
    dev = (got[0] - ref[0]).abs().max(dim=1).values
    assert float((dev <= 1e-4).double().mean()) >= least
    assert abs(float(got[1].mean()) - float(ref[1].mean())) <= 1e-2


def test_routes_agree_in_c_and_python():
    """For every new rule, the C route (ipx_*_route) and its Python mirror
    (``route``) send the shipped specs, the opened ones and the refused ones
    to the same kernel."""
    import ctypes

    from chip_smoke import synthetic_burgers, synthetic_darcy

    from ip_mcmc_tpu_torch.ops import _scaffold
    from ip_mcmc_tpu_torch.ops import fused_da3_pcn as da3

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    code = {v: k for k, v in _scaffold.ROUTES.items()}
    lib = _build.library()
    ref = lambda p: ctypes.byref(p.spec())
    shipped = {c: _build_on_card(c) for c in ("darcy_da_fused", "darcy_pcn_warm",
                                              "darcy32_pcn_warm", "darcy64_pcn_warm",
                                              "darcy64_da_fused", "darcy_mala_warm",
                                              "darcy_pcn_4096", "burgers_da3_pcn")}
    jac16 = shipped["darcy_pcn_4096"].batched_potential_fn
    dst16 = shipped["darcy_da_fused"].batched_potential_fn
    cold = [jac16, dst16, synthetic_darcy(12, 6, seed=1, cg_iters=4),
            synthetic_darcy(8, 4, seed=2, cg_iters=4, precond="dst_trunc", precond_modes=32),
            synthetic_darcy(24, 8, seed=3, cg_iters=4)]
    for pot in cold:
        f = pot.spec_fields
        for d in (pot.K, pot.K - 1):
            assert lib.ipx_ess_route(ref(pot), d) == code[fused_ess.route(**f, d=d)], (f, d)
            assert lib.ipx_fes_route(ref(pot), d) == code[fused_fes.route(**f, d=d)], (f, d)
            assert lib.ipx_mala_route(ref(pot), d, 0) == code[fused_mala.route(False, **f, d=d)]
            assert lib.ipx_pcn_route(ref(pot), d, 0) == code[fused_pcn.route(False, **f, d=d)]
    warm = [shipped["darcy_pcn_warm"].batched_warm_potential[0],
            shipped["darcy32_pcn_warm"].batched_warm_potential[0],
            shipped["darcy64_pcn_warm"].batched_warm_potential[0],
            synthetic_darcy(24, 8, seed=4, kind="warm", cg_iters=4, precond="dst_trunc",
                            precond_modes=128),
            synthetic_darcy(32, 8, seed=5, kind="warm", cg_iters=4),
            synthetic_darcy(48, 12, seed=6, kind="warm", cg_iters=4),
            synthetic_darcy(72, 12, seed=7, kind="warm", cg_iters=2)]
    for pot in warm:
        f = pot.spec_fields
        for d in (pot.K, pot.K - 1):
            assert lib.ipx_pcn_route(ref(pot), d, 1) == code[fused_pcn.route(True, **f, d=d)]
    mala_warm = [shipped["darcy_mala_warm"].batched_warm_potential[0],
                 synthetic_darcy(16, 8, seed=8, kind="mala", cg_iters=4),
                 synthetic_darcy(20, 8, seed=9, kind="mala", cg_iters=4, precond="dst")]
    for pot in mala_warm:
        f = pot.spec_fields
        assert lib.ipx_mala_route(ref(pot), pot.K, 1) == code[fused_mala.route(True, **f,
                                                                               d=pot.K)]
    p64 = shipped["darcy64_da_fused"]
    y = p64.batched_surrogate_fn.data.cpu().numpy()
    pairs = [(dst16, shipped["darcy_da_fused"].batched_surrogate_fn),
             (p64.batched_potential_fn, p64.batched_surrogate_fn),
             (dst16, synthetic_darcy(12, 8, seed=10, cg_iters=3)),
             (_da_misfit(y, 40), p64.batched_surrogate_fn),
             (_da_misfit(y, 16), _da_misfit(y, 32)), (_da_misfit(y, 32), _da_misfit(y, 32)),
             (p64.batched_potential_fn, _da_misfit(y, 32, solver="richardson", omega=0.9))]
    for e, s_ in pairs:
        for d in (e.K, e.K - 1):
            assert (lib.ipx_da_pcn_route(ref(e), ref(s_), d)
                    == code[da.route(e.spec_fields, s_.spec_fields, d)]), (e.n, s_.n, d)
    p3 = shipped["burgers_da3_pcn"]
    for levels, d in ((_burgers_levels(p3), 16), (synthetic_burgers(96, 32, seed=11), 32),
                      (synthetic_burgers(96, 32, seed=11), 16)):
        assert (lib.ipx_da3_route(*(ref(lv) for lv in levels), d)
                == code[da3.route([(lv.n, lv.K) for lv in levels], d)])
    # the linear-Gaussian specs of the six samplers: lingauss_pcn's, m above
    # d, the widest d a CTA takes, m = 0; each at K = d and K = d - 1
    lin = [_linear_misfit(16, 32, seed=12), _linear_misfit(40, 32, seed=13),
           _linear_misfit(2, 256, seed=14), _linear_misfit(0, 4, seed=15)]
    for pot in lin:
        for d in (pot.K, pot.K - 1):
            want = code[_scaffold.linear_route(d, pot)]
            for fn in (lib.ipx_pcn_linear_route, lib.ipx_ess_linear_route,
                       lib.ipx_fes_linear_route, lib.ipx_mala_linear_route):
                assert fn(ref(pot), d) == want, (fn, pot.m, pot.K, d)
            assert (lib.ipx_da_pcn_linear_route(ref(pot), ref(lin[0]), d)
                    == code[_scaffold.linear_route(d, pot, lin[0])])
            assert (lib.ipx_da3_linear_route(ref(lin[0]), ref(pot), ref(pot), d)
                    == code[_scaffold.linear_route(d, lin[0], pot, pot)])
