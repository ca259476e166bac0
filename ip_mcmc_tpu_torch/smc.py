"""Adaptive tempered-likelihood Sequential Monte Carlo (mirrors
``ip_mcmc_tpu/smc.py``; BASELINE config 5: adaptive SMC with a tempered
likelihood on the PDE inverse problem).

Particles start at prior draws and the inverse temperature β climbs from 0
to 1. Each stage picks δβ by bisection so that the incremental ESS is
``ess_target · N``, reweights by −δβ Φ, resamples systematically and moves
every particle by ``mutation_steps`` pCN steps that target exp(−β Φ) dμ₀.
The log evidence is the sum over stages of log mean exp(−δβ Φ).

The JAX package runs the whole sampler as one ``lax.while_loop``; here the
stage loop runs on the host and reads β once a stage to decide whether to
go on. The bisection, the weights, the resampling and the mutation are
tensor operations on the particles' device. ``run`` takes a potential of an
(n, d) batch, chains first, and mutates with the scan path's pCN
``transition``. ``run_batched`` takes a chain-last (d, n) potential, as
the fused configs do, and can carry each particle's warm solve (``warm_aux``)
through the mutation and the resampling. Each stage counts one
``scan_smc_stage[device]`` step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ip_mcmc_tpu_torch.kernels import pcn
from ip_mcmc_tpu_torch.kernels.base import count_step, nan_to_neg_inf, normals, uniforms


@dataclasses.dataclass
class SMCState:
    particles: torch.Tensor  # (n, d); run_batched: (d, n), chain-last
    potentials: torch.Tensor  # (n,) untempered Φ, cached
    beta: torch.Tensor  # () current inverse temperature
    log_z: torch.Tensor  # () accumulated log evidence
    stage: int
    warm_aux: Optional[torch.Tensor] = None  # run_batched: (aux_dim, n)


@dataclasses.dataclass
class SMCInfo:
    betas: torch.Tensor  # (max_stages,) β ladder, NaN-padded
    ess: torch.Tensor  # (max_stages,) post-reweight ESS
    accept_rates: torch.Tensor  # (max_stages,) last mutation step's acceptance
    n_stages: int
    mutation_counts: torch.Tensor  # (max_stages,) mutation steps a stage
    mean_potentials: torch.Tensor  # (max_stages,) E_β[Φ] after each stage
    prior_mean_potential: torch.Tensor  # E_{β=0}[Φ], the TI integrand at 0


def effective_sample_size(log_weights):
    """ESS = (Σw)² / Σw², in log space."""
    lse1 = torch.logsumexp(log_weights, dim=0)
    lse2 = torch.logsumexp(2.0 * log_weights, dim=0)
    return torch.exp(2.0 * lse1 - lse2)


def find_next_beta(beta, potentials, ess_target_frac, n_bisect=40):
    """The largest δβ in (0, 1 − β] with ESS(−δβ Φ) ≥ target · N, by
    ``n_bisect`` bisections on the device; never below 1e-6 (1 − β) +
    1e-12, so β always advances."""
    target = ess_target_frac * potentials.shape[0]

    def ess_ok(delta):
        return effective_sample_size(-delta * potentials) >= target

    hi0 = 1.0 - beta
    lo, hi = torch.zeros_like(beta), hi0
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ok = ess_ok(mid)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    delta = torch.where(ess_ok(hi0), hi0, lo)
    return torch.maximum(delta, 1e-6 * (1.0 - beta) + 1e-12)


def systematic_resample(log_weights, u0, n_out=None):
    """``n_out`` (default n) ancestor indices by systematic resampling from
    one uniform ``u0`` in [0, 1/n_out): the first index whose cumulative
    weight reaches u0 + i/n_out (``searchsorted`` on the left side, as
    ``jnp.searchsorted``), clipped to n − 1."""
    n = log_weights.shape[0]
    n_out = n if n_out is None else n_out
    cum = torch.cumsum(torch.softmax(log_weights, dim=0), dim=0)
    positions = u0 + torch.arange(n_out, dtype=cum.dtype, device=cum.device) / n_out
    return torch.clamp(torch.searchsorted(cum, positions), 0, n - 1)


def draw_u0(generator, n_out, device):
    """The resampling's uniform in [0, 1/n_out) (``uniform(minval=0,
    maxval=1/n_out)``)."""
    return uniforms(generator, (), device) * (1.0 / n_out)


def _reweight(state, n_particles, ess_target):
    """δβ, the new β, the incremental log weights, the new log Z and the
    ESS of the weights."""
    delta = find_next_beta(state.beta, state.potentials, ess_target)
    new_beta = torch.minimum(state.beta + delta, torch.ones_like(delta))
    log_w = -delta * state.potentials
    log_n = torch.log(torch.tensor(float(n_particles), dtype=log_w.dtype,
                                   device=log_w.device))
    log_z = state.log_z + torch.logsumexp(log_w, dim=0) - log_n
    return new_beta, log_w, log_z, effective_sample_size(log_w)


def _info(records, max_stages, prior_mean):
    """The NaN-padded per-stage arrays of ``records`` (one tuple a stage)."""
    dev, n = prior_mean.device, len(records)

    def column(i):
        out = torch.full((max_stages,), torch.nan, dtype=prior_mean.dtype, device=dev)
        if n:
            out[:n] = torch.stack([torch.as_tensor(r[i], dtype=prior_mean.dtype, device=dev)
                                   for r in records])
        return out

    return SMCInfo(betas=column(0), ess=column(1), accept_rates=column(2), n_stages=n,
                   mutation_counts=column(3), mean_potentials=column(4),
                   prior_mean_potential=prior_mean)


def stage(state, potential_fn, prior, u0, step_draws, *, ess_target=0.5,
          mutation_steps=5, pcn_step=0.3, waste_free=False, esjd_target=None):
    """One stage of ``run`` from given draws: ``u0`` the resampling's
    uniform, ``step_draws(i, m)`` the centred prior draws (m, d) and the
    uniforms (m,) of mutation step i. Returns (state, (β, ESS, acceptance,
    mutation steps, mean Φ))."""
    n_particles = state.particles.shape[0]
    new_beta, log_w, log_z, ess = _reweight(state, n_particles, ess_target)
    tempered = lambda u: new_beta * potential_fn(u)  # noqa: E731
    kernel = pcn.build_kernel(tempered, prior, beta=pcn_step)
    n_mut = n_particles // (mutation_steps + 1) if waste_free else n_particles

    ancestors = systematic_resample(log_w, u0, n_out=n_mut)
    particles0 = state.particles[ancestors]
    potentials0 = state.potentials[ancestors]
    ms = pcn.PCNState(position=particles0, potential=new_beta * potentials0)
    acc_rate = torch.zeros((), dtype=potentials0.dtype, device=potentials0.device)
    # waste-free: every state of the mutation chains, starts included
    positions, pots = [particles0], [ms.potential]
    n_steps, esjd = 0, 0.0
    while n_steps < mutation_steps and (esjd_target is None or esjd < esjd_target):
        prev = ms.position
        ms, minfo = kernel.transition(ms, *step_draws(n_steps, n_mut))
        acc_rate = torch.mean(minfo.accept_prob)
        if waste_free:
            positions.append(ms.position)
            pots.append(ms.potential)
        n_steps += 1
        if esjd_target is not None:  # a host read a step: the count adapts
            esjd += float(torch.mean(
                minfo.accept_prob * torch.sum(torch.square(minfo.proposal - prev), dim=-1)))
    scale = torch.clamp(new_beta, min=1e-12)
    if waste_free:
        # the next cloud: (k + 1, M, d) -> (N, d)
        particles = torch.stack(positions).reshape(n_particles, -1)
        potentials = torch.stack(pots).reshape(n_particles) / scale
    else:
        particles, potentials = ms.position, ms.potential / scale
    out = SMCState(particles=particles, potentials=potentials, beta=new_beta, log_z=log_z,
                   stage=state.stage + 1)
    return out, (new_beta, ess, acc_rate, float(n_steps), torch.mean(potentials))


def run(potential_fn, prior, generator, n_particles=1024, *, ess_target=0.5,
        mutation_steps=5, pcn_step=0.3, max_stages=50, waste_free=False,
        esjd_target=None):
    """Adaptive tempered SMC on ``potential_fn`` (the untempered data misfit
    of an (n, d) batch). ``prior`` has ``sample``, ``mean`` and
    ``scale_apply``; every draw comes from ``generator``. Returns (SMCState,
    SMCInfo).

    ``waste_free`` (Dau–Chopin 2022): resample M = N / (k + 1) ancestors
    (k = ``mutation_steps``) and keep every state of each mutation chain as
    the next cloud; needs N divisible by k + 1. ``esjd_target``: mutate
    until the pooled expected squared jump distance Σ mean(α ‖v − x‖²)
    reaches it, at most ``mutation_steps`` steps; not with ``waste_free``."""
    if waste_free and n_particles % (mutation_steps + 1):
        raise ValueError(
            f"waste-free SMC needs n_particles ({n_particles}) divisible by "
            f"mutation_steps+1 ({mutation_steps + 1})")
    if waste_free and esjd_target is not None:
        raise ValueError("esjd_target (adaptive counts) is incompatible with waste_free")
    particles = prior.sample(generator, n_particles)
    dev, d = particles.device, particles.shape[1]
    potentials = potential_fn(particles)
    zero = torch.zeros((), dtype=potentials.dtype, device=dev)
    state = SMCState(particles=particles, potentials=potentials, beta=zero, log_z=zero,
                     stage=0)
    prior_mean = torch.mean(potentials)

    def step_draws(_, m):
        return (prior.scale_apply(normals(generator, (m, d), dev)),
                uniforms(generator, (m,), dev))

    records = []
    while state.stage < max_stages and float(state.beta) < 1.0:
        count_step("scan_smc_stage", dev)
        u0 = draw_u0(generator, n_particles // (mutation_steps + 1) if waste_free
                     else n_particles, dev)
        state, rec = stage(state, potential_fn, prior, u0, step_draws,
                           ess_target=ess_target, mutation_steps=mutation_steps,
                           pcn_step=pcn_step, waste_free=waste_free,
                           esjd_target=esjd_target)
        records.append(rec)
    return state, _info(records, max_stages, prior_mean)


def mutate_batched(evaluate, U, phi, X, beta, xi, log_u, prior_mean, prior_scale,
                   pcn_step):
    """``run_batched``'s mutation of one stage: for each of the k rows of
    ``xi`` (k, d, n) and ``log_u`` (k, n), a pCN proposal
    V = m + √(1 − s²)(U − m) + s σ ξ, its (Φ, X) by ``evaluate(V, X)`` started
    from the current solutions, accepted where log u < β (Φ − Φ_V) (a NaN
    ratio rejects). Returns (U, Φ, X, the last step's acceptance)."""
    s = torch.as_tensor(pcn_step, dtype=torch.float32, device=U.device)
    contraction = torch.sqrt(1.0 - s * s)
    acc_rate = torch.zeros((), dtype=phi.dtype, device=phi.device)
    for j in range(xi.shape[0]):
        V = prior_mean + contraction * (U - prior_mean) + s * (prior_scale * xi[j])
        phi_v, X_v = evaluate(V, X)
        acc = log_u[j] < nan_to_neg_inf(beta * (phi - phi_v))
        U = torch.where(acc[None, :], V, U)
        phi = torch.where(acc, phi_v, phi)
        X = torch.where(acc[None, :], X_v, X)
        acc_rate = torch.mean(acc.to(phi.dtype))
    return U, phi, X, acc_rate


def stage_batched(state, evaluate, prior_mean, prior_scale, u0, xi, log_u, *,
                  ess_target=0.5, pcn_step=0.3):
    """One stage of ``run_batched`` from given draws (``u0``; ``xi`` (k, d,
    n) and ``log_u`` (k, n) as ``mutate_batched``'s): the warm solutions
    follow their particles to the ancestors' copies. Returns (state, (β,
    ESS, acceptance, mutation steps, mean Φ))."""
    n_particles = state.potentials.shape[0]
    new_beta, log_w, log_z, ess = _reweight(state, n_particles, ess_target)
    ancestors = systematic_resample(log_w, u0)
    U, phi, X, acc_rate = mutate_batched(
        evaluate, state.particles[:, ancestors], state.potentials[ancestors],
        state.warm_aux[:, ancestors], new_beta, xi, log_u, prior_mean, prior_scale,
        pcn_step)
    out = SMCState(particles=U, potentials=phi, beta=new_beta, log_z=log_z,
                   stage=state.stage + 1, warm_aux=X)
    return out, (new_beta, ess, acc_rate, float(xi.shape[0]), torch.mean(phi))


def run_batched(batched_potential_fn, prior_mean, prior_scale, generator,
                n_particles=4096, *, warm_potential_fn=None, aux_dim=1, ess_target=0.5,
                mutation_steps=5, pcn_step=0.3, max_stages=50, init_sweeps=8):
    """Adaptive tempered SMC on a chain-last potential (d, n) -> (n,) (the
    batched Darcy misfit: one call evaluates every particle), the prior the
    diagonal Gaussian (``prior_mean``, ``prior_scale``). Same algorithm,
    bisection, evidence and resampling as ``run``; the mutation is
    ``mutate_batched``'s pCN.

    ``warm_potential_fn``: optional ``(U, X0) -> (Φ, X)`` (the warm batched
    misfit, ``aux_dim`` rows of X a particle): each particle carries its
    solve; a proposal's solve starts from it, and resampling copies it with
    the particle. ``init_sweeps`` warm applications from X0 = 0 converge
    the first solves. Draws come from ``generator``; the particles live on
    its device."""
    dev = generator.device
    pm = torch.as_tensor(prior_mean, dtype=torch.float32).to(dev).reshape(-1, 1)
    ps = torch.as_tensor(prior_scale, dtype=torch.float32).to(dev).reshape(-1, 1)
    d = pm.shape[0]
    if warm_potential_fn is not None:
        evaluate, sweeps = warm_potential_fn, init_sweeps
    else:
        aux_dim, sweeps = 1, 1

        def evaluate(U, X0):
            return batched_potential_fn(U), X0

    particles = pm + ps * normals(generator, (d, n_particles), dev)
    warm_aux = torch.zeros((aux_dim, n_particles), dtype=torch.float32, device=dev)
    for _ in range(sweeps):
        potentials, warm_aux = evaluate(particles, warm_aux)
    zero = torch.zeros((), dtype=potentials.dtype, device=dev)
    state = SMCState(particles=particles, potentials=potentials, beta=zero, log_z=zero,
                     stage=0, warm_aux=warm_aux)
    prior_mean_phi = torch.mean(potentials)
    records = []
    while state.stage < max_stages and float(state.beta) < 1.0:
        count_step("scan_smc_stage", dev)
        u0 = draw_u0(generator, n_particles, dev)
        xi = normals(generator, (mutation_steps, d, n_particles), dev)
        log_u = torch.log(uniforms(generator, (mutation_steps, n_particles), dev))
        state, rec = stage_batched(state, evaluate, pm, ps, u0, xi, log_u,
                                   ess_target=ess_target, pcn_step=pcn_step)
        records.append(rec)
    return state, _info(records, max_stages, prior_mean_phi)


def thermodynamic_log_z(info):
    """A second evidence estimate from the same run: thermodynamic
    integration, log Z = −∫₀¹ E_β[Φ] dβ, by the trapezoid rule over the
    adaptive ladder (β = 0: the prior mean of Φ). Host-side."""
    n = int(info.n_stages)
    betas = np.concatenate([[0.0], info.betas[:n].cpu().numpy()])
    pots = np.concatenate([[float(info.prior_mean_potential)],
                           info.mean_potentials[:n].cpu().numpy()])
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(-trapezoid(pots, betas))
