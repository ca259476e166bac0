"""The port's fused delayed-acceptance pCN (ip_mcmc_tpu_torch/ops/fused_da_pcn.py,
plain loop on the CPU) against the JAX Pallas kernel in interpret mode, on
the darcy_da_fused potentials; and the algorithm properties of
tests/test_fused_da.py on analytic targets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import ops as jops
from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

torch.set_num_threads(1)

N, D, BLOCK, K, OUTER, SEED = 64, 64, 32, 4, 2, 5


@pytest.fixture(scope="module")
def potentials():
    """The darcy_da_fused exact and surrogate misfits, JAX and port, from
    the same frozen arrays (tests/test_torch_slice.py holds the fixture
    against a fresh JAX config build)."""
    fx = np.load(configs.FIXTURE)
    _, aux16 = jdarcy.make_darcy_forward(n_grid=16, n_modes_per_dim=8,
                                         alpha=2.0, field_scale=10.0)
    _, aux8 = jdarcy.make_darcy_forward(n_grid=8, n_modes_per_dim=8, alpha=2.0,
                                        field_scale=10.0,
                                        obs_indices=fx["obs_coarse"])
    jax_pots = (
        jdarcy.make_batched_misfit(aux16, fx["y"], 0.002, cg_iters=12,
                                   precond="dst_trunc", precond_modes=128),
        jdarcy.make_batched_misfit(aux8, fx["y_surr"], fx["surr_scale"],
                                   cg_iters=3, precond="dst_trunc",
                                   precond_modes=64),
    )
    p = configs.build("darcy_da_fused", "cpu")
    return jax_pots, (p.batched_potential_fn, p.batched_surrogate_fn)


def _positions():
    return np.random.default_rng(7).standard_normal((N, D)).astype(np.float32)


def _agreeing(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1) <= 1e-4


def test_da_chain_matches_jax(potentials):
    """Same positions, seed and stream: at least 62 of 64 chains end within
    1e-4 of JAX's (a rounding flip in a bf16 preconditioner input can turn
    one MH decision), and those chains took the same decisions."""
    (je, js), (te, ts) = potentials
    pos, pm, ps = _positions(), np.zeros(D, np.float32), np.ones(D, np.float32)
    fj, aj, ij = jops.fused_da_pcn_chain(
        je, js, jnp.asarray(pos), pm, ps, 0.35, SEED, n_steps=OUTER,
        subchain_len=K, block_chains=BLOCK)
    ft, at, it = da.fused_da_pcn_chain(
        te, ts, torch.from_numpy(pos), pm, ps, 0.35, SEED, n_steps=OUTER,
        subchain_len=K, block_chains=BLOCK)
    assert ft.shape == (N, D) and at.shape == it.shape == (N,)
    ok = _agreeing(ft, fj)
    assert ok.sum() >= 62
    np.testing.assert_array_equal(at.numpy()[ok], np.asarray(aj)[ok])
    np.testing.assert_array_equal(it.numpy()[ok], np.asarray(ij)[ok])


def test_da_chain_recorded_matches_jax(potentials):
    (je, js), (te, ts) = potentials
    pos, pm, ps = _positions(), np.zeros(D, np.float32), np.ones(D, np.float32)
    fj, aj, sj = jops.fused_da_pcn_chain_recorded(
        je, js, jnp.asarray(pos), pm, ps, 0.35, SEED + 1, n_steps=OUTER,
        thin=1, subchain_len=K, block_chains=BLOCK)
    ft, at, st = da.fused_da_pcn_chain_recorded(
        te, ts, torch.from_numpy(pos), pm, ps, 0.35, SEED + 1, n_steps=OUTER,
        thin=1, subchain_len=K, block_chains=BLOCK)
    assert st.shape == np.asarray(sj).shape == (OUTER, N, D)
    ok = _agreeing(ft, fj) & _agreeing(st, sj).all(axis=0)
    assert ok.sum() >= 62
    np.testing.assert_array_equal(at.numpy()[ok], np.asarray(aj)[ok])


def test_recorded_final_equals_plain_final(potentials):
    _, (te, ts) = potentials
    pos = torch.from_numpy(_positions())
    args = (te, ts, pos, torch.zeros(D), torch.ones(D), 0.35, 9)
    f1, a1, _ = da.fused_da_pcn_chain(*args, n_steps=4, subchain_len=3,
                                      block_chains=BLOCK)
    f2, a2, s2 = da.fused_da_pcn_chain_recorded(*args, n_steps=4, thin=2,
                                                subchain_len=3,
                                                block_chains=BLOCK)
    assert torch.equal(f1, f2) and torch.equal(a1, a2)
    assert s2.shape == (2, N, D) and torch.equal(s2[-1], f2)


# --- algorithm properties on an analytic target (tests/test_fused_da.py) ---

DA = 4
PREC = torch.linspace(0.5, 2.0, DA)  # posterior precision = 1 + PREC
PM, PS = torch.zeros(DA), torch.ones(DA)


def phi_exact(U):  # (d, block) -> (block,)
    return 0.5 * torch.sum(PREC[:, None] * U * U, dim=0)


def test_exact_posterior_with_biased_surrogate():
    """A deliberately wrong surrogate still yields the exact posterior."""

    def surr(U):
        return 0.8 * phi_exact(U + 0.3) + 1.7

    g = torch.Generator().manual_seed(0)
    pos = torch.randn(512, DA, generator=g)
    n_steps = 400
    _, _, samples = da.fused_da_pcn_chain_recorded(
        phi_exact, surr, pos, PM, PS, 0.3, 3, n_steps=n_steps, thin=1,
        subchain_len=4, block_chains=256)
    flat = samples[n_steps // 4:].reshape(-1, DA).numpy()
    np.testing.assert_allclose(flat.mean(axis=0), np.zeros(DA), atol=0.06)
    np.testing.assert_allclose(flat.var(axis=0), 1.0 / (1.0 + PREC.numpy()),
                               rtol=0.12)


def test_perfect_surrogate_always_accepts_correction():
    g = torch.Generator().manual_seed(1)
    pos = torch.randn(256, DA, generator=g)
    _, acc, inner = da.fused_da_pcn_chain(
        phi_exact, phi_exact, pos, PM, PS, 0.3, 5, n_steps=100,
        subchain_len=3, block_chains=256)
    np.testing.assert_allclose(acc.numpy(), 1.0, atol=1e-6)
    assert 0.3 < float(inner.mean()) < 1.0


def test_shape_checks_and_kernel_potential_type():
    pos = torch.zeros(48, DA)
    with pytest.raises(ValueError, match="multiple of block_chains"):
        da.fused_da_pcn_chain(phi_exact, phi_exact, pos, PM, PS, 0.3, 0,
                              n_steps=2, block_chains=32)
    with pytest.raises(ValueError, match="multiple of thin"):
        da.fused_da_pcn_chain_recorded(phi_exact, phi_exact, pos, PM, PS, 0.3,
                                       0, n_steps=3, thin=2, block_chains=16)
    # the CUDA kernel takes DarcyMisfit specs only; it refuses a callable
    # before touching any device
    with pytest.raises(TypeError, match="DarcyMisfit"):
        da._launch(phi_exact, phi_exact, pos, PM, PS, 0.3, 0, 2, 4, 16)


# --- the Burgers instantiation of K4 ------------------------------------------


@pytest.fixture(scope="module")
def burgers_levels():
    from test_torch_burgers import small_burgers_levels

    return small_burgers_levels()


@pytest.mark.parametrize("recorded", [False, True])
def test_burgers_da_chain_matches_jax(burgers_levels, recorded):
    """Fine (32 cells / 10 steps) corrected, coarse (16 / 2) inside, d = 16,
    two blocks. Every input is f32 and the misfits agree to ~1e-6
    (tests/test_torch_burgers.py): at least 62 of 64 chains end within 1e-4
    of JAX's, with the same outer and inner decisions."""
    (jf, _, jc), (tf, _, tc) = burgers_levels
    pos = np.random.default_rng(8).standard_normal((N, 16)).astype(np.float32)
    pm, ps = np.zeros(16, np.float32), np.ones(16, np.float32)
    kw = dict(n_steps=3, subchain_len=K, block_chains=BLOCK)
    if recorded:
        kw["thin"] = 1
        jfn, tfn = jops.fused_da_pcn_chain_recorded, da.fused_da_pcn_chain_recorded
    else:
        jfn, tfn = jops.fused_da_pcn_chain, da.fused_da_pcn_chain
    fj, aj, xj = jfn(jf, jc, jnp.asarray(pos), pm, ps, 0.15, SEED, **kw)
    ft, at, xt = tfn(tf, tc, torch.from_numpy(pos), pm, ps, 0.15, SEED, **kw)
    ok = _agreeing(ft, fj)
    if recorded:
        assert xt.shape == np.asarray(xj).shape == (3, N, 16)
        ok &= _agreeing(xt, xj).all(axis=0)
    else:  # inner acceptance: a count over n_steps * k
        np.testing.assert_array_equal(np.rint(xt.numpy()[ok] * 3 * K),
                                      np.rint(np.asarray(xj)[ok] * 3 * K))
    assert ok.sum() >= 62
    np.testing.assert_array_equal(np.rint(at.numpy()[ok] * 3),
                                  np.rint(np.asarray(aj)[ok] * 3))
    assert 0.0 < float(at.mean()) < 1.0


def test_kernel_refuses_potentials_of_two_families(potentials, burgers_levels):
    """One launch runs one family's instantiation: a Darcy misfit beside a
    Burgers one raises before any device is touched."""
    _, (darcy_exact, _) = potentials
    _, (fine, _, coarse) = burgers_levels
    pos = torch.zeros(32, 16)
    with pytest.raises(TypeError, match="one family"):
        da._launch(fine, darcy_exact, pos, torch.zeros(16), torch.ones(16),
                   0.15, 0, 2, 4, 16)
    from ip_mcmc_tpu_torch.ops import _scaffold
    assert _scaffold.require_family(
        {"potential_fn": fine, "surrogate_fn": coarse},
        families=("darcy", "burgers")) == "burgers"
    assert _scaffold.require_family({"potential_fn": darcy_exact}) == "darcy"
    with pytest.raises(TypeError, match="DarcyMisfit potentials only"):
        _scaffold.require_family({"potential_fn": fine})


# --- the 16x16 kernel's launch geometry (csrc/fused_da_pcn.cu) ------------------


def _levels(name):
    p = (configs.build(name, "cpu") if name == "darcy_da_fused"
         else configs.darcy_da_richardson(name, "cpu"))
    e, s = p.batched_potential_fn, p.batched_surrogate_fn
    return dict(exact_n=e.n, exact_modes=e.modes, surr_n=s.n, surr_modes=s.modes,
                d=e.K), s.solver


@pytest.mark.parametrize("name", ["darcy_da_fused", "rich3_w0.9"])
def test_warp_geometry_fits_the_card_for_both_surrogate_solvers(name):
    """The shipped path (4096 chains in blocks of 512) at both surrogate
    solves: W chains a CTA dividing block_chains, every chain in a CTA, the
    shared memory within the 232,448 bytes a CTA of the H100 may take; the
    exact level's factors staged would fit too at the shipped W."""
    levels, solver = _levels(name)
    assert solver == ("cg" if name == "darcy_da_fused" else "richardson")
    ctas, w, smem = da.warp_geometry(4096, 512, **levels)
    assert w == da.WARP_CHAINS and 512 % w == 0 and ctas * w == 4096
    assert smem <= da.MAX_SMEM_BYTES
    staged = da.warp_geometry(4096, 512, exact_staged=True, **levels)[2]
    assert smem < staged <= da.MAX_SMEM_BYTES


@pytest.mark.parametrize("n, block, want_w, want_ctas",
                         [(13, 8, 8, 2), (13, 13, 1, 13), (20, 4, 4, 5), (12, 6, 2, 6),
                          (0, 8, 8, 0), (4096, 512, 8, 512)])
def test_warp_geometry_ragged_and_dividing(n, block, want_w, want_ctas):
    """W is the largest power of two up to the shipped 8 that divides
    block_chains, and a ragged n gets a last CTA of spare warps."""
    ctas, w, _ = da.warp_geometry(n, block)
    assert (w, ctas) == (want_w, want_ctas)
    assert block % w == 0 and (ctas - 1) * w < max(n, 1) <= ctas * w or n == 0


def test_warp_geometry_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="d = 64"):
        da.warp_geometry(64, 64, d=36)
    with pytest.raises(ValueError, match="16x16 exact grid"):
        da.warp_geometry(64, 64, exact_n=8)
    with pytest.raises(ValueError, match="multiple of 16"):
        da.warp_geometry(64, 64, exact_modes=100)
    with pytest.raises(ValueError, match="232448"):
        da.warp_geometry(64, 64, chains=16, exact_staged=True)


# --- a pair the card runs one chain a CTA (fused_da_pcn_kernel[layout16]) ----


def test_da_chain_on_an_8_6_pair_matches_jax():
    """An 8×8 Jacobi exact level (12 CG) with a 6×6 Jacobi surrogate (3 CG),
    16 KL modes, 64 chains: every input f32, so at least 62 chains end within
    1e-4 of JAX's with the same outer and inner acceptance."""
    from test_torch_fused_pcn import NOISE, small_darcy

    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    aux_j, aux_t, y = small_darcy()
    _, aux6_j = jdarcy.make_darcy_forward(n_grid=6, n_modes_per_dim=4, alpha=2.0,
                                          field_scale=10.0)
    aux6_t = darcy.darcy_aux(n_grid=6, n_modes_per_dim=4, alpha=2.0, field_scale=10.0)
    je, js = (jdarcy.make_batched_misfit(aux_j, y, NOISE, cg_iters=12),
              jdarcy.make_batched_misfit(aux6_j, y, 0.01, cg_iters=3))
    te, ts = (darcy_misfit_from_arrays(aux_t, y, NOISE, cg_iters=12),
              darcy_misfit_from_arrays(aux6_t, y, 0.01, cg_iters=3))
    assert da.route(te.spec_fields, ts.spec_fields, 16) == "cta"
    d = 16
    pos = (0.3 * np.random.default_rng(17).standard_normal((N, d))).astype(np.float32)
    pm, ps = np.zeros(d, np.float32), np.ones(d, np.float32)
    kw = dict(n_steps=2, subchain_len=3, block_chains=BLOCK)
    fj, aj, ij = jops.fused_da_pcn_chain(je, js, jnp.asarray(pos), pm, ps, 0.2, SEED, **kw)
    ft, at, it = da.fused_da_pcn_chain(te, ts, torch.from_numpy(pos), pm, ps, 0.2, SEED, **kw)
    ok = _agreeing(ft, fj)
    assert ok.sum() >= 62
    np.testing.assert_array_equal(at.numpy()[ok], np.asarray(aj)[ok])
    np.testing.assert_array_equal(it.numpy()[ok], np.asarray(ij)[ok])
    assert 0.0 < float(it.mean()) < 1.0


def _f(n, K=64, precond="dst_trunc", modes=64, solver="cg"):
    return dict(n=n, K=K, precond=precond, modes=modes, solver=solver)


# the takes-rule (``da_route``'s mirror): exact, surrogate, d, the kernel
ROUTES = [
    (_f(16, modes=128), _f(8), 64, "warp"),  # darcy_da_fused
    (_f(16, modes=128), _f(8, solver="richardson"), 64, "warp"),  # a rich3 run
    (_f(64, K=144, modes=256), _f(32, K=144, modes=128), 144, "cluster"),  # darcy64_da_fused
    (_f(16), _f(12, precond="jacobi", modes=0), 64, "cta"),
    (_f(16), _f(12, precond="jacobi", modes=0, solver="richardson"), 64, "cta"),
    (_f(16, K=36), _f(8, K=36), 36, "cta"),
    (_f(8, K=16, precond="jacobi", modes=0), _f(6, K=16, precond="jacobi", modes=0), 16,
     "cta"),
    (_f(48, K=144, modes=256), _f(24, K=144, modes=128), 144, "cta"),
    (_f(64, K=144, precond="jacobi", modes=0), _f(32, K=144, modes=128), 144, "cta"),
    (_f(64, K=144, modes=100), _f(32, K=144, modes=128), 144, "cta"),
    (_f(8), _f(16), 64, None),  # a surrogate finer than its exact grid
    (_f(64, K=144, modes=256), _f(32, K=144, solver="richardson"), 144, None),
    (_f(64, K=144, modes=256), _f(16, K=144), 144, None),
    (_f(32, K=144), _f(16, K=144), 144, None),
    (_f(72, K=144), _f(32, K=144), 144, None),
    (_f(16), _f(8, K=36), 64, None),  # K != d
]


@pytest.mark.parametrize("exact, surr, d, kernel", ROUTES)
def test_route_sends_each_pair_to_its_kernel(exact, surr, d, kernel):
    """Shipped pairs go to the warp and cluster kernels, the rest of the two
    domains one chain a CTA, other pairs nowhere; ``warp_takes`` is the warp
    route."""
    assert da.route(exact, surr, d) == kernel
    assert da.warp_takes(exact, surr, d) == (kernel == "warp")
