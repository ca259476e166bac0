"""Named configurations of the port (mirrors ``ip_mcmc_tpu/configs``).

Ported so far: on the 16×16 Darcy problem ``darcy_da_fused``,
``darcy_pcn_4096`` (its fused and its scan path), ``darcy_da_pcn`` (scan
delayed acceptance on the single-particle forward), ``darcy_pcn_warm``,
``darcy_ess_fused``, ``darcy_fes_fused``, ``darcy_mala_fused`` and
``darcy_mala_warm``, and the builder ``darcy_da_richardson(variant)``
(``benchmarks/darcy_da_richardson.py``'s DA runs; JAX registers no config
for them); on the 32×32 and 64×64 grids ``darcy32_pcn_warm``,
``darcy64_pcn_warm``, ``darcy64_da_fused`` (64×64 exact, 32×32
surrogate) and ``darcy64_pcn`` (the scan path); on the 128-cell Burgers
initial-data inversion ``burgers_pcn`` and ``burgers_multitime_pcn``
(their scan and fused paths), ``burgers_da_pcn`` and ``burgers_da3_pcn``;
on the scan path BASELINE configs 1 and 2, ``gauss2d_rwm`` (RWM on a 2-D
Gaussian) and ``lingauss_pcn`` (pCN on a linear-Gaussian inverse problem),
with ``lingauss_elliptical`` and ``lingauss_fes`` on the same problem;
BASELINE config 3a ``ode_mala``, 3b ``ode_nuts``, ``ode_hmc`` and
``ode_chees`` (Lotka–Volterra log-rates, RK4; the misfit and its gradient
one kernel on the card); ``multimodal_pt`` and ``multimodal_pt_mala`` (parallel tempering on a
bimodal target); BASELINE config 5 ``darcy_smc`` (tempered SMC on the
single-particle forward) and ``darcy_smc_warm`` (its batched mutation on the
warm dense-``dst`` misfit); ADVI: ``lingauss_advi``, ``darcy_advi`` and the
VI warm start ``darcy_advi_warmstart``; delayed acceptance on POD
surrogates, ``darcy_da_pod`` and ``darcy_da_pod_online`` (enriched during
burn-in); on the composed ('chains', 'model') mesh ``darcy_composed_pcn``,
``darcy_composed_mala`` and ``darcy_composed_ess`` (``parallel/composed.py``):
all 36 of the JAX package's configs. The
deterministic constants (KL bases, means, observation cells, sources, time
steps, preconditioner factors, the numpy-drawn forward matrix) are computed
here in numpy; the arrays the JAX configs draw with JAX keys (the data, the
truths, the surrogates' calibrations, the POD snapshots' prior draws) are
read from the committed fixtures ``darcy16_da.npz``,
``darcy16_richardson.npz``, ``darcy32.npz``, ``darcy64.npz``,
``darcy64_da.npz``, ``burgers128.npz``, ``lingauss32.npz``, ``lv.npz`` and
``darcy16_pod.npz`` (written by
``scripts/freeze_torch_fixtures.py``).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable, Optional

import numpy as np
import torch

from ip_mcmc_tpu_torch import distributions as dist
from ip_mcmc_tpu_torch import potentials
from ip_mcmc_tpu_torch.convert import (
    burgers_misfit_from_arrays,
    darcy_mala_warm_misfit_from_arrays,
    darcy_misfit_from_arrays,
    darcy_warm_misfit_from_arrays,
    linear_gaussian_from_arrays,
)
from ip_mcmc_tpu_torch.models import burgers, darcy, kl, linear, ode

_HERE = pathlib.Path(__file__).resolve().parent
FIXTURE = _HERE / "darcy16_da.npz"
RICHARDSON_FIXTURE = _HERE / "darcy16_richardson.npz"
DARCY32_FIXTURE = _HERE / "darcy32.npz"
DARCY64_FIXTURE = _HERE / "darcy64.npz"
DARCY64_DA_FIXTURE = _HERE / "darcy64_da.npz"
BURGERS_FIXTURE = _HERE / "burgers128.npz"
LINGAUSS_FIXTURE = _HERE / "lingauss32.npz"
LV_FIXTURE = _HERE / "lv.npz"
POD_FIXTURE = _HERE / "darcy16_pod.npz"


@dataclasses.dataclass
class Problem:
    name: str
    dim: int
    prior: dist.DiagGaussian
    # rwm pcn elliptical da_pcn fes mala hmc nuts chees pt smc vi, and the
    # composed mesh's pcn_composed mala_composed ess_composed
    kernel: str
    kernel_params: dict
    n_chains: int
    n_samples: int
    burn_in: int
    thin: int = 1
    data: Optional[np.ndarray] = None
    truth: Optional[np.ndarray] = None
    # the closed-form posterior mean, where the posterior has one: the scan
    # path then reports mean_error_vs_exact against it
    exact_mean: Optional[np.ndarray] = None
    notes: str = ""
    # the scan path's Φ: (n, d) -> (n,), chains first (None: the config's
    # single-particle forward model is not ported)
    potential_fn: Optional[Callable] = None
    batched_potential_fn: Optional[Callable] = None  # (d, B) -> (B,)
    surrogate_potential_fn: Optional[Callable] = None  # scan da_pcn Φ*, (n, d) -> (n,)
    batched_surrogate_fn: Optional[Callable] = None  # fused da_pcn Φ*
    batched_mid_fn: Optional[Callable] = None  # 3-level DA middle level
    # fused warm pCN: (module (U, x0) -> (Φ, x), aux_dim); fused warm MALA:
    # (module (U, aux0) -> (Φ, ∇Φ, aux), aux_dim)
    batched_warm_potential: Optional[tuple] = None
    # (generator, n) -> (n, d) chain starts in place of prior draws (the VI
    # and POD-enrichment warm starts install one)
    init_positions_fn: Optional[Callable] = None
    # online POD enrichment: positions (n, d) -> (new surrogate, stats)
    surrogate_enrich_fn: Optional[Callable] = None

    @property
    def log_density_fn(self):
        return potentials.posterior_log_density(self.potential_fn, self.prior)

    def init_positions(self, generator: torch.Generator, n=None):
        """(n, d) prior draws from ``generator`` (host-side, so a seed gives
        the same start on every device; they differ from the JAX package's
        threefry draws by construction), or ``init_positions_fn``'s."""
        n = n or self.n_chains
        if self.init_positions_fn is not None:
            return self.init_positions_fn(generator, n)
        return self.prior.sample(generator, n)


REGISTRY: dict = {}


def register(fn):
    REGISTRY[fn.__name__] = fn
    return fn


def build(name: str, device) -> Problem:
    """Build a named Problem with its tensors on ``device``."""
    if name not in REGISTRY:
        raise KeyError(f"unknown config '{name}'; have {sorted(REGISTRY)}")
    return REGISTRY[name](torch.device(device))


# --- the analytic and linear-Gaussian configs (the scan path) -----------------

GAUSS2D_MEAN = np.array([1.0, -0.5], np.float32)
GAUSS2D_COV = np.array([[2.0, 0.8], [0.8, 1.0]], np.float32)


@register
def gauss2d_rwm(device) -> Problem:
    """BASELINE config 1: RWM, 2D Gaussian posterior, analytic likelihood."""
    mean = torch.tensor(GAUSS2D_MEAN, device=device)
    target = dist.Gaussian.from_covariance(mean, torch.tensor(GAUSS2D_COV))
    prior = dist.DiagGaussian(mean=torch.zeros(2, device=device),
                              scale=10.0 * torch.ones(2, device=device))
    return Problem(
        name="gauss2d_rwm",
        dim=2,
        prior=prior,
        kernel="rwm",
        kernel_params={"step_size": 1.0, "adapt": True},
        n_chains=1024,
        n_samples=1000,
        burn_in=500,
        truth=GAUSS2D_MEAN.copy(),
        notes="analytic target; truth = exact posterior mean (≈, flat prior)",
        potential_fn=potentials.analytic_potential(target.log_prob),
    )


def gauss2d_batched_potential():
    """The JAX config's ``phi_batched``, ½ (U − m)ᵀ Σ⁻¹ (U − m) for a
    (2, B) batch, as a ``LinearGaussianPotential``: A = Lᵀ with Σ⁻¹ = L Lᵀ,
    c = m, y = 0, σ = 1. The JAX config builds that closure and attaches it
    to nothing, so ``gauss2d_rwm`` has no batched potential; a caller sets
    this one as ``batched_potential_fn`` (with ``fused``) to run the fused
    RWM branch on the same target."""
    prec = np.linalg.inv(GAUSS2D_COV.astype(np.float64))
    return linear_gaussian_from_arrays(np.linalg.cholesky(prec).T, np.zeros(2),
                                       1.0, center=GAUSS2D_MEAN)


def lingauss_arrays():
    """The constants of ``lingauss_pcn``: A (16, 32) from
    ``default_rng(42)``, the prior's KL spectrum λ (32,), y (16,) (frozen:
    drawn with JAX keys 100 and 101) and the noise scale."""
    d, m = 32, 16
    lam = kl.laplacian_eigenvalues(d, alpha=1.0, scale=4.0)
    rng = np.random.default_rng(42)
    A = (rng.standard_normal((m, d)) / np.sqrt(d)).astype(np.float32)
    return A, lam, np.load(LINGAUSS_FIXTURE)["y"], 0.05


@register
def lingauss_pcn(device) -> Problem:
    """BASELINE config 2: pCN, linear-Gaussian IP, KL-truncated GP prior."""
    A, lam, y, sigma = lingauss_arrays()
    m, d = A.shape
    prior = dist.gaussian_kl_prior(lam, device=device)
    noise = dist.DiagGaussian(mean=torch.zeros(m, device=device),
                              scale=sigma * torch.ones(m, device=device))
    phi = potentials.misfit_potential(
        linear.make_forward(torch.tensor(A, device=device)),
        torch.tensor(y, device=device), noise)
    exact_mean, _ = linear.conjugate_posterior(A, np.zeros(d), lam,
                                               sigma**2 * np.ones(m), y)
    return Problem(
        name="lingauss_pcn",
        dim=d,
        prior=prior,
        kernel="pcn",
        kernel_params={"beta": 0.2, "adapt": True},
        n_chains=2048,
        n_samples=1000,
        burn_in=500,
        data=y,
        truth=exact_mean,
        exact_mean=exact_mean,
        notes="closed-form posterior available (conjugate)",
        potential_fn=phi,
    )


@register
def lingauss_elliptical(device) -> Problem:
    """Elliptical slice sampling (tuning-free) on the config-2 problem."""
    p = lingauss_pcn(device)
    p.name = "lingauss_elliptical"
    p.kernel = "elliptical"
    p.kernel_params = {}
    return p


@register
def lingauss_fes(device) -> Problem:
    """Functional ensemble sampler on the config-2 problem: affine-invariant
    stretch moves on the 6 leading KL modes + pCN complement (Coullon–Webber
    2020)."""
    p = lingauss_pcn(device)
    p.name = "lingauss_fes"
    p.kernel = "fes"
    p.kernel_params = {"n_low_modes": 6, "pcn_beta": 0.25}
    return p


# --- the Lotka–Volterra ODE (the gradient samplers) ----------------------------

LV_Y0 = np.array([1.0, 0.5], np.float32)
LV_DT, LV_STEPS = 0.05, 200  # t in [0, 10]
LV_OBS = np.arange(10, 201, 10)  # every 0.5 time units


def _lv_problem(device, kernel: str, kernel_params: dict, n_chains: int) -> Problem:
    """Lotka–Volterra log-rate inference: RK4 in log populations, 200 steps
    of 0.05, both species observed every 10 steps (40 values), noise 0.1,
    prior N(0, 0.3²) on the four log-rates. y and the truth are frozen in
    ``lv.npz`` (the noise is drawn with a JAX key)."""
    fx = np.load(LV_FIXTURE)
    m = 2 * len(LV_OBS)
    noise = dist.DiagGaussian(mean=torch.zeros(m, device=device),
                              scale=0.1 * torch.ones(m, device=device))
    prior = dist.DiagGaussian(mean=torch.zeros(4, device=device),
                              scale=0.3 * torch.ones(4, device=device))
    return Problem(
        name=f"ode_{kernel}",
        dim=4,
        prior=prior,
        kernel=kernel,
        kernel_params=kernel_params,
        n_chains=n_chains,
        n_samples=1000,
        burn_in=500,
        data=fx["y"],
        truth=fx["theta_true"],
        notes="Lotka-Volterra log-rate inference; smooth, autograd through RK4",
        potential_fn=ode.LotkaVolterraMisfit(
            LV_Y0, LV_DT, LV_STEPS, LV_OBS, torch.tensor(fx["y"], device=device), noise),
    )


@register
def ode_mala(device) -> Problem:
    """BASELINE config 3a: MALA on the ODE forward model."""
    return _lv_problem(device, "mala",
                       {"step_size": 0.05, "adapt": True, "map_init": 300}, 1024)


@register
def ode_hmc(device) -> Problem:
    """Fixed-trajectory HMC variant of config 3."""
    return _lv_problem(device, "hmc",
                       {"step_size": 0.05, "num_integration_steps": 8,
                        "adapt": True, "map_init": 300}, 512)


@register
def ode_chees(device) -> Problem:
    """ChEES-HMC on the ODE forward model: one trajectory length for every
    chain, adapted across them (the ensemble alternative to NUTS)."""
    p = _lv_problem(device, "chees",
                    {"step_size": 0.05, "trajectory_length": 0.5, "map_init": 300}, 512)
    p.burn_in = 300
    return p


@register
def ode_nuts(device) -> Problem:
    """BASELINE config 3b: NUTS on the ODE forward model."""
    p = _lv_problem(device, "nuts",
                    {"step_size": 0.05, "max_depth": 8, "adapt": True, "map_init": 300}, 256)
    p.n_samples = 500
    p.burn_in = 200
    return p


# --- the bimodal target (parallel tempering) ----------------------------------


def _bimodal_problem(device):
    """2-D Gaussian mixture with modes at ±(sep, sep), scale sig, under a
    N(0, 3²) reference measure: (prior, Φ, sep, sig) with Φ = −log mix −
    Φ_prior, so that Φ with the prior is the mixture."""
    sep, sig = 2.5, 0.3
    prior = dist.DiagGaussian(mean=torch.zeros(2, device=device),
                              scale=3.0 * torch.ones(2, device=device))
    mode = torch.tensor([sep, sep], device=device)

    def phi(u):
        a = -0.5 * torch.sum((u - mode) ** 2, dim=-1) / sig**2
        b = -0.5 * torch.sum((u + mode) ** 2, dim=-1) / sig**2
        return -torch.logaddexp(a, b) - prior.potential(u)

    return prior, phi, sep, sig


@register
def multimodal_pt(device) -> Problem:
    """Parallel tempering on a bimodal target: 8-rung tempered-pCN ladder
    with equi-acceptance adaptation, cold chain recorded; the headline is
    the cold chain's mode balance."""
    prior, phi, sep, sig = _bimodal_problem(device)
    return Problem(
        name="multimodal_pt",
        dim=2,
        prior=prior,
        kernel="pt",
        kernel_params={"n_temps": 8, "pcn_step": 0.4, "beta_min": 0.05,
                       "adapt_ladder": True, "swap_center": 0.4},
        n_chains=256,
        n_samples=800,
        burn_in=300,
        truth=np.zeros(2),  # symmetric mixture: exact mean is 0
        notes="cold-chain mode balance ≈ 0.5/0.5; swaps transport hot-chain jumps",
        potential_fn=phi,
    )


@register
def multimodal_pt_mala(device) -> Problem:
    """PT with MALA mutations on the bimodal target (gradient proposals per
    replica, ladder swaps identical)."""
    p = multimodal_pt(device)
    p.name = "multimodal_pt_mala"
    p.kernel_params = {"n_temps": 8, "step_size": 0.25, "beta_min": 0.05,
                       "mutation": "mala", "adapt_ladder": True,
                       "swap_center": 0.4, "pcn_step": 0.4}
    return p


# --- the Darcy coefficient inversion ------------------------------------------


# the 16×16 Darcy problem's forward (``_darcy_problem``'s geometry)
DARCY16 = dict(n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)


def _darcy_potential(device, y, **forward):
    """The scan path's Φ of a Darcy config: ``misfit_potential`` of the
    single-particle forward (``models.darcy.make_darcy_forward`` with
    ``forward``'s arguments) on the data y, noise N(0, 0.002²)."""
    fwd, _ = darcy.make_darcy_forward(device=device, **forward)
    m = len(y)
    noise = dist.DiagGaussian(mean=torch.zeros(m, device=device),
                              scale=0.002 * torch.ones(m, device=device))
    return potentials.misfit_potential(fwd, torch.tensor(y, device=device), noise)


def _darcy_problem(device):
    """What the 16×16 Darcy configs share (``_darcy_problem`` of the JAX
    configs): the whitened prior, the aux constants, y, the truth and the
    cold Jacobi misfit of 48 CG iterations."""
    fx = np.load(FIXTURE)
    K = 64
    prior = dist.DiagGaussian(
        mean=torch.zeros(K, device=device), scale=torch.ones(K, device=device)
    )
    aux = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0,
                          field_scale=10.0)
    phi_batched = darcy_misfit_from_arrays(aux, fx["y"], 0.002).to(device)
    return prior, aux, fx["y"], fx["u_true"], phi_batched


@register
def darcy_pcn_4096(device) -> Problem:
    """BASELINE config 4: Darcy coefficient inversion, 64-dim KL, 4096 chains.
    Both paths run: the scan pCN with warmup_pcn on the single-particle
    forward (Jacobi, 48 CG), and with ``--fused`` the fused kernel on the
    batched misfit."""
    prior, _, y, u_true, phi_batched = _darcy_problem(device)
    return Problem(
        name="darcy_pcn_4096",
        dim=64,
        prior=prior,
        kernel="pcn",
        kernel_params={"beta": 0.08, "adapt": True},
        n_chains=4096,
        n_samples=500,
        burn_in=500,
        data=y,
        truth=u_true,
        notes="elliptic PDE inversion; whitened KL coordinates",
        potential_fn=_darcy_potential(device, y, **DARCY16),
        batched_potential_fn=phi_batched,
    )


def _darcy_composed(device, name, kernel, kp, notes) -> Problem:
    """A composed ('chains', 'model') mesh config (``darcy_composed_*`` of
    the JAX configs): the 16×16 Darcy posterior, 512 chains, 300 burn-in
    steps and 300 samples, every forward a 150-iteration Jacobi CG with the
    grid's rows sharded over 'model' (``parallel/composed.py``); the mesh's
    shape follows the world's size (``runner._run_composed``)."""
    prior, _, y, u_true, _ = _darcy_problem(device)
    _, aux = darcy.make_darcy_forward(device=device, **DARCY16)
    return Problem(
        name=name,
        dim=64,
        prior=prior,
        kernel=kernel,
        kernel_params={**kp, "cg_iters": 150, "aux": aux, "noise_scale": 0.002},
        n_chains=512,
        n_samples=300,
        burn_in=300,
        data=y,
        truth=u_true,
        notes=notes,
        potential_fn=_darcy_potential(device, y, **DARCY16),
    )


@register
def darcy_composed_pcn(device) -> Problem:
    """Composed ('chains', 'model') mesh: Darcy pCN, the chains sharded and
    each chain's forward solve row-sharded over 'model'; one rank is the
    (1, 1) mesh."""
    return _darcy_composed(device, "darcy_composed_pcn", "pcn_composed", {"beta": 0.08},
                           "grid-sharded forward solves UNDER chain sharding")


@register
def darcy_composed_mala(device) -> Problem:
    """Composed ('chains', 'model') mesh with gradient-based sampling: MALA
    whose ∇Φ comes from the distributed adjoint solve (forward CG, adjoint
    CG, face derivatives, all row-sharded over 'model')."""
    return _darcy_composed(device, "darcy_composed_mala", "mala_composed", {"step_size": 0.05},
                           "distributed adjoint gradients under chain sharding")


@register
def darcy_composed_ess(device) -> Problem:
    """Composed ('chains', 'model') mesh with tuning-free sampling:
    elliptical slice sampling, its shrink loop ending on the same trip on
    every rank."""
    return _darcy_composed(device, "darcy_composed_ess", "ess_composed", {"max_shrink": 20},
                           "rejection-free slice sampling on grid-sharded solves")


@register
def darcy_da_pcn(device) -> Problem:
    """Delayed-acceptance pCN on Darcy, scan path: a 4-step subchain on a
    loose-CG surrogate (the single-particle forward with 8 Jacobi-PCG
    iterations against the exact 48), one exact correction per outer
    step."""
    prior, _, y, u_true, phi_batched = _darcy_problem(device)
    return Problem(
        name="darcy_da_pcn",
        dim=64,
        prior=prior,
        kernel="da_pcn",
        kernel_params={"beta": 0.08, "subchain_len": 4},
        n_chains=4096,
        n_samples=250,
        burn_in=150,
        data=y,
        truth=u_true,
        notes="two-level: loose-CG surrogate subchain + exact correction",
        potential_fn=_darcy_potential(device, y, **DARCY16),
        batched_potential_fn=phi_batched,
        surrogate_potential_fn=_darcy_potential(device, y, cg_iters=8, **DARCY16),
    )


@register
def darcy_pcn_warm(device) -> Problem:
    """Warm-started fused pCN on Darcy: the CG solution rides the kernel
    state and proposal solves start from it (4 iterations, dst_trunc with
    the 64 lowest sine modes + the Jacobi remainder)."""
    prior, aux, y, u_true, phi_batched = _darcy_problem(device)
    warm, aux_dim = darcy_warm_misfit_from_arrays(
        aux, y, 0.002, cg_iters=4, precond="dst_trunc", precond_modes=64)
    return Problem(
        name="darcy_pcn_warm",
        dim=64,
        prior=prior,
        kernel="pcn",
        kernel_params={"fused": True, "warm": True, "beta": 0.08,
                       "block_chains": 256},
        n_chains=4096,
        n_samples=500,
        burn_in=500,
        data=y,
        truth=u_true,
        notes="warm dst_trunc-4 K=64",
        batched_potential_fn=phi_batched,
        batched_warm_potential=(warm.to(device), aux_dim),
    )


@register
def darcy_ess_fused(device) -> Problem:
    """Fused elliptical slice sampling on Darcy: tuning-free (no β), the
    shrink loop runs the CG misfit up to max_shrink times per step."""
    prior, _, y, u_true, phi_batched = _darcy_problem(device)
    return Problem(
        name="darcy_ess_fused",
        dim=64,
        prior=prior,
        kernel="elliptical",
        kernel_params={"fused": True, "max_shrink": 6, "block_chains": 256},
        n_chains=4096,
        n_samples=400,
        burn_in=200,
        data=y,
        truth=u_true,
        notes="rejection-free slice sampling, fixed shrink budget",
        batched_potential_fn=phi_batched,
    )


@register
def darcy_fes_fused(device) -> Problem:
    """Fused functional ensemble sampler on Darcy: affine stretch moves on
    the leading KL modes (partners within each block-ensemble) + pCN on the
    complement. The stretch dimension is chosen by the spectral-energy
    criterion ("auto": the smallest M capturing 90% of the field's KL
    eigenvalue mass; ``ops.fused_fes.choose_n_low_modes``)."""
    prior, _, y, u_true, phi_batched = _darcy_problem(device)
    # the field spectrum behind the whitened parameterization (the geometry
    # of _darcy_problem's darcy_aux call)
    _, ij = kl.sine_basis_2d(8, 16)
    lam = kl.laplacian_eigenvalues_2d(ij, alpha=2.0, scale=10.0)
    return Problem(
        name="darcy_fes_fused",
        dim=64,
        prior=prior,
        kernel="fes",
        kernel_params={"fused": True, "n_low_modes": "auto",
                       "kl_eigenvalues": lam, "energy_frac": 0.9,
                       "pcn_beta": 0.08, "block_chains": 256},
        n_chains=4096,
        n_samples=400,
        burn_in=300,
        data=y,
        truth=u_true,
        notes="block = one walker ensemble; 2 misfit solves per chain-step",
        batched_potential_fn=phi_batched,
    )


@register
def darcy_mala_fused(device) -> Problem:
    """Fused MALA on Darcy: gradient-based proposals with the adjoint CG
    solve inside the kernel (``DarcyMisfit.value_and_grad``; both solves
    cold, Jacobi, 48 iterations)."""
    prior, _, y, u_true, phi_batched = _darcy_problem(device)
    return Problem(
        name="darcy_mala_fused",
        dim=64,
        prior=prior,
        kernel="mala",
        kernel_params={"fused": True, "step_size": 0.012, "block_chains": 256},
        n_chains=4096,
        n_samples=400,
        burn_in=300,
        data=y,
        truth=u_true,
        notes="adjoint-method gradients inside the fused kernel",
        batched_potential_fn=phi_batched,
    )


@register
def darcy_mala_warm(device) -> Problem:
    """Warm fused MALA on Darcy: the forward and the adjoint CG solution
    carried in the kernel state, dense ``dst`` preconditioner, 6 + 6
    iterations."""
    prior, aux, y, u_true, phi_batched = _darcy_problem(device)
    warm, aux_dim = darcy_mala_warm_misfit_from_arrays(
        aux, y, 0.002, cg_iters=6, precond="dst")
    return Problem(
        name="darcy_mala_warm",
        dim=64,
        prior=prior,
        kernel="mala",
        kernel_params={"fused": True, "warm": True, "step_size": 0.012,
                       "block_chains": 256},
        n_chains=4096,
        n_samples=400,
        burn_in=300,
        data=y,
        truth=u_true,
        notes="explicit adjoint, warm forward+adjoint solves",
        batched_potential_fn=phi_batched,
        batched_warm_potential=(warm.to(device), aux_dim),
    )


@register
def darcy_da_fused(device) -> Problem:
    """Fused 2-level delayed-acceptance pCN on the 16×16 Darcy problem:
    48-step subchain on a calibrated 8×8-grid surrogate (3 CG iterations,
    dst_trunc over all 64 modes), one exact correction per outer step
    (12 CG iterations, dst_trunc with 128 modes)."""
    fx = np.load(FIXTURE)
    K = 64
    prior = dist.DiagGaussian(
        mean=torch.zeros(K, device=device), scale=torch.ones(K, device=device)
    )
    aux16 = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0,
                            field_scale=10.0)
    aux8 = darcy.darcy_aux(n_grid=8, n_modes_per_dim=8, alpha=2.0,
                           field_scale=10.0, obs_indices=fx["obs_coarse"])
    exact = darcy_misfit_from_arrays(aux16, fx["y"], 0.002, cg_iters=12,
                                     precond="dst_trunc", precond_modes=128)
    surrogate = darcy_misfit_from_arrays(aux8, fx["y_surr"], fx["surr_scale"],
                                         cg_iters=3, precond="dst_trunc",
                                         precond_modes=64)
    return Problem(
        name="darcy_da_fused",
        dim=K,
        prior=prior,
        kernel="da_pcn",
        kernel_params={"beta": 0.35, "subchain_len": 48, "fused": True},
        n_chains=4096,
        n_samples=400,
        burn_in=40,  # outer steps (each = 48 inner surrogate steps)
        thin=4,
        data=fx["y"],
        truth=fx["u_true"],
        notes="8x8 calibrated surrogate subchain + exact correction; "
        "exact posterior",
        batched_potential_fn=exact.to(device),
        batched_surrogate_fn=surrogate.to(device),
    )


# benchmarks/darcy_da_richardson.py's 8×8 surrogates: name -> (solver,
# iterations, ω), each calibrated with its own solver; cg3 is the one
# darcy_da_fused ships
RICHARDSON_VARIANTS = {
    "cg3": ("cg", 3, 1.0),
    "rich3_w0.9": ("richardson", 3, 0.9),
    "rich4_w0.8": ("richardson", 4, 0.8),
    "rich2_w0.9": ("richardson", 2, 0.9),
}


def richardson_fixture_key(variant: str) -> str:
    """The suffix of ``variant``'s arrays in ``darcy16_richardson.npz``."""
    return variant.replace(".", "")


def darcy_da_richardson(variant: str, device) -> Problem:
    """``benchmarks/darcy_da_richardson.py``'s fused DA run with the 8×8
    surrogate ``variant`` (``RICHARDSON_VARIANTS``): 4096 chains in blocks
    of 512, k = 48, β = 0.35; exact misfit 16², dst_trunc-128, 12 CG; the
    surrogate dst_trunc-64 solved by CG or by K17's Richardson iteration.
    The data is the NumPy oracle's (``default_rng(7)``) and each
    calibration ran the surrogate's own solver (frozen in
    ``darcy16_richardson.npz``). Burn-in 40 outer steps, then 200 recorded,
    as the benchmark's ESS run."""
    if variant not in RICHARDSON_VARIANTS:
        raise KeyError(f"unknown surrogate {variant!r}; have "
                       f"{sorted(RICHARDSON_VARIANTS)}")
    solver, iters, omega = RICHARDSON_VARIANTS[variant]
    fx, key = np.load(RICHARDSON_FIXTURE), richardson_fixture_key(variant)
    K = 64
    device = torch.device(device)
    prior = dist.DiagGaussian(
        mean=torch.zeros(K, device=device), scale=torch.ones(K, device=device)
    )
    aux16 = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0,
                            field_scale=10.0)
    aux8 = darcy.darcy_aux(n_grid=8, n_modes_per_dim=8, alpha=2.0,
                           field_scale=10.0,
                           obs_indices=np.load(FIXTURE)["obs_coarse"])
    exact = darcy_misfit_from_arrays(aux16, fx["y"], 0.002, cg_iters=12,
                                     precond="dst_trunc", precond_modes=128)
    surrogate = darcy_misfit_from_arrays(
        aux8, fx[f"y_surr_{key}"], fx[f"scale_{key}"], cg_iters=iters,
        precond="dst_trunc", precond_modes=64, solver=solver, omega=omega)
    return Problem(
        name=f"darcy_da_richardson[{variant}]",
        dim=K,
        prior=prior,
        kernel="da_pcn",
        kernel_params={"beta": 0.35, "subchain_len": 48, "fused": True,
                       "block_chains": 512},
        n_chains=4096,
        n_samples=200,
        burn_in=40,
        data=fx["y"],
        truth=fx["u_true"],
        notes=f"surrogate {variant}: {solver}, {iters} iterations, "
        f"omega {omega}",
        batched_potential_fn=exact.to(device),
        batched_surrogate_fn=surrogate.to(device),
    )


# --- the Darcy inversion on the large grids ----------------------------------


def _large_grid_warm(device, name, fixture, n, n_modes_per_dim, modes, cold):
    """What darcy32_pcn_warm and darcy64_pcn_warm share: the whitened
    prior, the frozen data, the warm dst_trunc misfit (``modes`` lowest
    sine modes + Jacobi, 4 CG from the carried solution) and the cold
    misfit of the config (``cold``: its keyword arguments; not on the fused
    path)."""
    fx = np.load(fixture)
    K = n_modes_per_dim ** 2
    prior = dist.DiagGaussian(
        mean=torch.zeros(K, device=device), scale=torch.ones(K, device=device)
    )
    aux = darcy.darcy_aux(n_grid=n, n_modes_per_dim=n_modes_per_dim,
                          alpha=2.0, field_scale=10.0)
    warm, aux_dim = darcy_warm_misfit_from_arrays(
        aux, fx["y"], 0.002, cg_iters=4, precond="dst_trunc",
        precond_modes=modes)
    return dict(
        name=name, dim=K, prior=prior, kernel="pcn", data=fx["y"],
        truth=fx["u_true"],
        batched_potential_fn=darcy_misfit_from_arrays(
            aux, fx["y"], 0.002, **cold).to(device),
        batched_warm_potential=(warm.to(device), aux_dim),
    )


@register
def darcy32_pcn_warm(device) -> Problem:
    """Fused warm pCN at 32×32 cells, 64-dim KL: dst_trunc-128 + Jacobi,
    4 CG from the carried solution; cold misfit Jacobi, 96 CG."""
    return Problem(
        **_large_grid_warm(device, "darcy32_pcn_warm", DARCY32_FIXTURE, 32, 8,
                           128, dict(cg_iters=96)),
        kernel_params={"fused": True, "warm": True, "beta": 0.08,
                       "block_chains": 128},
        n_chains=4096,
        n_samples=400,
        burn_in=300,
        notes="32x32 grid entirely in the fused kernel",
    )


@register
def darcy64_pcn_warm(device) -> Problem:
    """Fused warm pCN at 64×64 cells, 144-dim KL: dst_trunc-256 + Jacobi,
    4 CG from the carried solution; cold misfit dst_trunc-256, 30 CG."""
    return Problem(
        **_large_grid_warm(device, "darcy64_pcn_warm", DARCY64_FIXTURE, 64, 12,
                           256, dict(cg_iters=30, precond="dst_trunc",
                                     precond_modes=256)),
        kernel_params={"fused": True, "warm": True, "beta": 0.06,
                       "block_chains": 128},
        n_chains=2048,
        n_samples=300,
        burn_in=300,
        notes="64x64 grid entirely in the fused kernel (dst_trunc)",
    )


@register
def darcy64_pcn(device) -> Problem:
    """Large-grid Darcy (64² cells, 144-dim KL) on the scan path: pCN with
    warmup_pcn on the single-particle forward, dst fast-Poisson CG of 24
    iterations (the data of ``darcy64.npz``, which JAX's darcy64_pcn and
    darcy64_pcn_warm draw alike)."""
    fx = np.load(DARCY64_FIXTURE)
    K = 144
    prior = dist.DiagGaussian(
        mean=torch.zeros(K, device=device), scale=torch.ones(K, device=device)
    )
    return Problem(
        name="darcy64_pcn",
        dim=K,
        prior=prior,
        kernel="pcn",
        kernel_params={"beta": 0.06, "adapt": True},
        n_chains=512,
        n_samples=300,
        burn_in=300,
        data=fx["y"],
        truth=fx["u_true"],
        notes="64x64 grid, DST-PCG forward solve",
        potential_fn=_darcy_potential(device, fx["y"], n_grid=64, n_modes_per_dim=12,
                                      alpha=2.0, field_scale=10.0, cg_iters=24,
                                      precond="dst"),
    )


@register
def darcy64_da_fused(device) -> Problem:
    """Fused 2-level delayed-acceptance pCN at 64×64 cells, 144-dim KL: a
    48-step subchain on a calibrated 32×32 surrogate (dst_trunc-128, 3 CG,
    on the coarse observation cells), one exact correction per outer step
    (dst_trunc-256, 16 CG). The data are those of ``darcy64_pcn_warm``; the
    calibration (32 prior draws) is frozen in ``darcy64_da.npz``."""
    fx = np.load(DARCY64_DA_FIXTURE)
    K = 144
    prior = dist.DiagGaussian(
        mean=torch.zeros(K, device=device), scale=torch.ones(K, device=device)
    )
    aux64 = darcy.darcy_aux(n_grid=64, n_modes_per_dim=12, alpha=2.0,
                            field_scale=10.0)
    aux32 = darcy.darcy_aux(n_grid=32, n_modes_per_dim=12, alpha=2.0,
                            field_scale=10.0, obs_indices=fx["obs_coarse"])
    exact = darcy_misfit_from_arrays(aux64, fx["y"], 0.002, cg_iters=16,
                                     precond="dst_trunc", precond_modes=256)
    surrogate = darcy_misfit_from_arrays(aux32, fx["y_surr"], fx["surr_scale"],
                                         cg_iters=3, precond="dst_trunc",
                                         precond_modes=128)
    return Problem(
        name="darcy64_da_fused",
        dim=K,
        prior=prior,
        kernel="da_pcn",
        kernel_params={"beta": 0.4, "subchain_len": 48, "fused": True,
                       "block_chains": 128},
        n_chains=1024,
        n_samples=300,
        burn_in=30,  # outer steps (each = 48 inner surrogate steps)
        data=fx["y"],
        truth=fx["u_true"],
        notes="32c calibrated dst_trunc-3 surrogate subchain + exact "
        "dst_trunc-16 correction; exact posterior",
        batched_potential_fn=exact.to(device),
        batched_surrogate_fn=surrogate.to(device),
    )


# --- the Burgers initial-data inversion ---------------------------------------


def _sine_mean(n_cells):
    return np.sin(2 * np.pi * (np.arange(n_cells) + 0.5) / n_cells)


def _burgers_problem(device, obs_times=None):
    """What the Burgers configs share: the whitened prior of 16 KL modes,
    the fine model's aux (128 cells, t = 0.2, the conservative CFL bound)
    and the frozen arrays."""
    fx = np.load(BURGERS_FIXTURE)
    K = 16
    prior = dist.DiagGaussian(
        mean=torch.zeros(K, device=device), scale=torch.ones(K, device=device)
    )
    aux = burgers.burgers_aux(
        n_cells=128, n_modes=K, alpha=1.5, field_scale=1.0, t_final=0.2,
        mean_profile=_sine_mean(128), obs_times=obs_times,
    )
    return prior, aux, fx


def _burgers_potential(device, y, obs_times=None):
    """The scan path's Φ of a Burgers config: ``misfit_potential`` of the
    single-particle forward (128 cells, 16 modes, t = 0.2, the sine mean,
    ``obs_times``) on the data y, noise N(0, 0.02²)."""
    fwd, _ = burgers.make_burgers_forward(
        n_cells=128, n_modes=16, alpha=1.5, field_scale=1.0, t_final=0.2,
        mean_profile=_sine_mean(128), obs_times=obs_times, device=device)
    m = len(y)
    noise = dist.DiagGaussian(mean=torch.zeros(m, device=device),
                              scale=0.02 * torch.ones(m, device=device))
    return potentials.misfit_potential(fwd, torch.tensor(y, device=device), noise)


def _burgers_calibrated_surrogate(aux, fx, n_coarse):
    """The two-level-calibrated coarse Burgers misfit
    (``_burgers_calibrated_surrogate`` of the JAX configs): ``n_coarse``
    cells at ``cfl_amax`` 1.0 (about three times the fine model's time
    step), observed at the coarse cells nearest the fine observation
    points; data bias-corrected by the mean fine-coarse discrepancy over
    prior draws and per-observation noise inflated by its spread, both
    frozen in the fixture."""
    n_fine = int(aux["n_cells"])
    obs_c = np.clip(
        np.round((aux["obs_indices"] + 0.5) * n_coarse / n_fine - 0.5).astype(int),
        0, n_coarse - 1,
    )
    aux_c = burgers.burgers_aux(
        n_cells=n_coarse, n_modes=16, alpha=1.5, field_scale=1.0, t_final=0.2,
        mean_profile=_sine_mean(n_coarse), obs_indices=obs_c, cfl_amax=1.0,
    )
    return burgers_misfit_from_arrays(
        aux_c, fx[f"y_surr_{n_coarse}"], fx[f"scale_{n_coarse}"])


@register
def burgers_pcn(device) -> Problem:
    """Burgers initial-data inversion by pCN (shock-forming forward map):
    the scan path on the single-particle forward, or with ``--fused`` the
    fused kernel on the batched misfit."""
    prior, aux, fx = _burgers_problem(device)
    return Problem(
        name="burgers_pcn",
        dim=16,
        prior=prior,
        kernel="pcn",
        kernel_params={"beta": 0.15, "adapt": True},
        n_chains=2048,
        n_samples=500,
        burn_in=500,
        data=fx["y"],
        truth=fx["u_true"],
        notes="shock-forming forward map: derivative-free kernels only",
        potential_fn=_burgers_potential(device, fx["y"]),
        batched_potential_fn=burgers_misfit_from_arrays(
            aux, fx["y"], 0.02).to(device),
    )


@register
def burgers_multitime_pcn(device) -> Problem:
    """Burgers inversion observing the evolution at three times (48
    observations): the scan path, or with ``--fused`` the fused kernel."""
    prior, aux, fx = _burgers_problem(device, obs_times=[0.07, 0.14, 0.2])
    return Problem(
        name="burgers_multitime_pcn",
        dim=16,
        prior=prior,
        kernel="pcn",
        kernel_params={"beta": 0.15, "adapt": True},
        n_chains=2048,
        n_samples=500,
        burn_in=500,
        data=fx["y_multitime"],
        truth=fx["u_true"],
        notes="evolution observed at t=0.07/0.14/0.2 (48 observations)",
        potential_fn=_burgers_potential(device, fx["y_multitime"],
                                        obs_times=[0.07, 0.14, 0.2]),
        batched_potential_fn=burgers_misfit_from_arrays(
            aux, fx["y_multitime"], 0.02).to(device),
    )


@register
def burgers_da_pcn(device) -> Problem:
    """Burgers inversion by fused delayed acceptance: a 16-step subchain on
    the calibrated 64-cell surrogate at a three times coarser time step,
    one exact correction per outer step. The posterior is that of
    ``burgers_pcn``."""
    prior, aux, fx = _burgers_problem(device)
    return Problem(
        name="burgers_da_pcn",
        dim=16,
        prior=prior,
        kernel="da_pcn",
        kernel_params={"beta": 0.15, "subchain_len": 16, "fused": True},
        n_chains=2048,
        n_samples=500,
        burn_in=100,  # outer DA steps (each = 16 inner pCN steps)
        data=fx["y"],
        truth=fx["u_true"],
        notes="coarse-FV surrogate subchain + exact correction; posterior "
        "identical to burgers_pcn",
        batched_potential_fn=burgers_misfit_from_arrays(
            aux, fx["y"], 0.02).to(device),
        batched_surrogate_fn=_burgers_calibrated_surrogate(
            aux, fx, 64).to(device),
    )


@register
def burgers_da3_pcn(device) -> Problem:
    """Three-level fused delayed-acceptance pCN on the Burgers inversion:
    inner pCN subchain on the 64-cell surrogate, middle corrections against
    the 128-cell surrogate at the coarse time step, one exact fine
    correction per outer step. The posterior is that of ``burgers_pcn``."""
    prior, aux, fx = _burgers_problem(device)
    return Problem(
        name="burgers_da3_pcn",
        dim=16,
        prior=prior,
        kernel="da_pcn",
        kernel_params={"beta": 0.25, "k_inner": 8, "k_mid": 24,
                       "fused": True},
        n_chains=2048,
        n_samples=400,
        burn_in=100,  # outer steps (each = k_inner*k_mid inner pCN steps)
        data=fx["y"],
        truth=fx["u_true"],
        notes="3-level DA: 64c inner subchain, 128c middle, exact fine "
        "correction; posterior identical to burgers_pcn",
        batched_potential_fn=burgers_misfit_from_arrays(
            aux, fx["y"], 0.02).to(device),
        batched_surrogate_fn=_burgers_calibrated_surrogate(
            aux, fx, 64).to(device),
        batched_mid_fn=_burgers_calibrated_surrogate(aux, fx, 128).to(device),
    )


# --- tempered SMC, ADVI and the POD surrogates ----------------------------------


@register
def darcy_smc(device) -> Problem:
    """BASELINE config 5: adaptive tempered SMC on the Darcy inverse
    problem, the mutation pCN on the single-particle forward (Jacobi, 48
    CG)."""
    prior, _, y, u_true, _ = _darcy_problem(device)
    return Problem(
        name="darcy_smc",
        dim=64,
        prior=prior,
        kernel="smc",
        kernel_params={"ess_target": 0.5, "mutation_steps": 5, "pcn_step": 0.15,
                       "max_stages": 60},
        n_chains=4096,  # particles
        n_samples=0,
        burn_in=0,
        data=y,
        truth=u_true,
        notes="adaptive beta ladder; systematic resampling",
        potential_fn=_darcy_potential(device, y, **DARCY16),
    )


@register
def darcy_smc_warm(device) -> Problem:
    """Config 5 on the batched mutation (``smc.run_batched``): each particle
    carries its converged solve through the mutation steps and the
    resampling, so an evaluation is 6 dense-``dst`` CG iterations from it
    (``DarcyMisfitWarm``) instead of the cold 48."""
    prior, aux, y, u_true, phi_batched = _darcy_problem(device)
    warm, aux_dim = darcy_warm_misfit_from_arrays(aux, y, 0.002, cg_iters=6,
                                                  precond="dst")
    return Problem(
        name="darcy_smc_warm",
        dim=64,
        prior=prior,
        kernel="smc",
        kernel_params={"batched": True, "warm": True, "ess_target": 0.5,
                       "mutation_steps": 5, "pcn_step": 0.15, "max_stages": 60},
        n_chains=4096,
        n_samples=0,
        burn_in=0,
        data=y,
        truth=u_true,
        notes="same posterior/algorithm as darcy_smc; warm batched mutation",
        potential_fn=_darcy_potential(device, y, **DARCY16),
        batched_potential_fn=phi_batched,
        batched_warm_potential=(warm.to(device), aux_dim),
    )


@register
def lingauss_advi(device) -> Problem:
    """Full-rank ADVI on the config-2 linear-Gaussian problem: the posterior
    is Gaussian and conjugate, so the family is exact at the optimum and the
    runner reports the fitted moments' errors against the closed form."""
    p = lingauss_pcn(device)
    p.name = "lingauss_advi"
    p.kernel = "vi"
    _, lam, y, sigma = lingauss_arrays()
    # the JAX config's exact covariance: A drawn again in f64
    A = np.random.default_rng(42).standard_normal((16, 32)) / np.sqrt(32)
    _, exact_cov = linear.conjugate_posterior(A, np.zeros(32), np.asarray(lam),
                                              sigma**2 * np.ones(16), y)
    p.kernel_params = {"full_rank": True, "num_steps": 3000, "n_mc_samples": 64,
                       "learning_rate": 3e-2, "exact_cov": exact_cov}
    p.notes = "full-rank family exact for this conjugate posterior"
    return p


@register
def darcy_advi(device) -> Problem:
    """Mean-field ADVI on the Darcy inverse problem, the ELBO's gradient
    through the single-particle forward's implicit adjoint."""
    prior, _, y, u_true, _ = _darcy_problem(device)
    return Problem(
        name="darcy_advi",
        dim=64,
        prior=prior,
        kernel="vi",
        kernel_params={"full_rank": False, "num_steps": 1500, "n_mc_samples": 32,
                       "learning_rate": 5e-2},
        n_chains=0,
        n_samples=0,
        burn_in=0,
        data=y,
        truth=u_true,
        notes="mean-field ADVI; ELBO maximized through the PDE solve",
        potential_fn=_darcy_potential(device, y, **DARCY16),
    )


@register
def darcy_advi_warmstart(device) -> Problem:
    """VI → MCMC warm start: a short mean-field ADVI fit places the pCN
    chains of ``darcy_pcn_4096`` at the variational posterior instead of the
    prior (burn-in 100 instead of 500); the runner reports the fit's time and
    the start positions' mean misfit beside prior draws'. The scan path, or
    the fused kernel with ``--fused``."""
    p = darcy_pcn_4096(device)
    p.name = "darcy_advi_warmstart"
    p.burn_in = 100
    p.kernel_params = {"beta": 0.08, "adapt": True,
                       "vi_init": {"full_rank": False, "num_steps": 800,
                                   "n_mc_samples": 32, "learning_rate": 5e-2}}
    p.notes = "chains start at the ADVI variational posterior"
    return p


def _darcy_pod_problem(device, name, surrogate, kernel_params, notes, **extra):
    prior, _, y, u_true, phi_batched = _darcy_problem(device)
    return Problem(
        name=name,
        dim=64,
        prior=prior,
        kernel="da_pcn",
        kernel_params=kernel_params,
        n_chains=4096,
        n_samples=250,
        burn_in=150,
        data=y,
        truth=u_true,
        notes=notes,
        potential_fn=_darcy_potential(device, y, **DARCY16),
        batched_potential_fn=phi_batched,
        surrogate_potential_fn=surrogate,
        **extra,
    )


@register
def darcy_da_pod(device) -> Problem:
    """Delayed-acceptance pCN with a POD reduced-order surrogate: rank-20
    Galerkin projection from 64 offline prior solves; the subchain runs on
    the 20 × 20 reduced system, one full solve per ``subchain_len``
    proposals corrects exactly."""
    _, aux = darcy.make_darcy_forward(device=device, **DARCY16)
    phi_pod = darcy.make_pod_surrogate(aux, np.load(FIXTURE)["y"], 0.002,
                                       np.load(POD_FIXTURE)["draws"], rank=20)
    return _darcy_pod_problem(device, "darcy_da_pod", phi_pod,
                              {"beta": 0.08, "subchain_len": 4},
                              "reduced-order subchain + exact correction")


@register
def darcy_da_pod_online(device) -> Problem:
    """``darcy_da_pod`` with online POD enrichment: 24 prior snapshots and
    an automatic rank, then between burn-in segments full solves at the
    chain positions with the worst reduced residual and a rebuilt basis; the
    surrogate is frozen before any recorded sample (the runner's
    ``_pod_enrich_burnin``), so the DA posterior stays exact."""
    _, aux = darcy.make_darcy_forward(device=device, **DARCY16)
    phi_pod, enrich = darcy.make_pod_surrogate_online(
        aux, np.load(FIXTURE)["y"], 0.002, np.load(POD_FIXTURE)["draws_online"],
        rank="auto", enrich_batch=8)
    return _darcy_pod_problem(
        device, "darcy_da_pod_online", phi_pod,
        {"beta": 0.08, "subchain_len": 4,
         "pod_enrich": {"epochs": 3, "segment_steps": 40}},
        "online-enriched reduced-order subchain + exact correction",
        surrogate_enrich_fn=enrich)
