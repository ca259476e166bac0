"""Chains over grid-sharded solves on a ('chains', 'model') mesh (mirrors
``ip_mcmc_tpu/parallel/composed.py``).

'chains' shards the chain batch: each chain group steps its own block of
chains. 'model' row-shards every chain's Darcy solve over the ranks of the
group (``grid_shard.solve_cg_local`` on the (c, rows, n) block of the
group's chains: one halo exchange and one ``all_reduce`` an iteration for
all of them). The ranks of a 'model' group hold the same chains and take
the same decisions from the same sums.

pCN (``sample_composed_pcn``), MALA on the distributed adjoint gradient
(``composed_misfit_and_grad``: a forward CG, an adjoint CG and the
harmonic-mean face derivative over one-row halos of a, x and λ, written
out; no autograd through a collective) and elliptical slice sampling
(``sample_composed_elliptical``). The whitened prior is N(0, I), as in the
Darcy configs.

Every draw is a function of (seed, step, global chain id) only, from the
counter-hash stream of ``ops/rng.py``, so a chain's path does not depend
on the mesh's shape. Each transition takes its draws as arguments
(``pcn_transition``, ``mala_transition``, ``ess_transition``): the CPU
tests feed them JAX's. ESS keeps JAX's loop discipline: a shrink trip ends
with one ``all_reduce`` over the whole world of the count of chains still
shrinking, so every rank leaves the loop on the same trip (at most
``max_shrink``); a rank that left alone would wait forever on the next
collective.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ip_mcmc_tpu_torch.kernels.base import count_step
from ip_mcmc_tpu_torch.ops import rng
from ip_mcmc_tpu_torch.parallel import grid_shard
from ip_mcmc_tpu_torch.parallel.mesh import CHAIN_AXIS, MODEL_AXIS, Mesh, gather_chains, make_mesh

__all__ = ["CHAIN_AXIS", "MODEL_AXIS", "composed_misfit_and_grad", "ess_transition",
           "make_composed_mesh", "mala_transition", "pcn_transition",
           "sample_composed_elliptical", "sample_composed_mala", "sample_composed_pcn"]

# counter-hash tags of a step's draws: the normals take two (Box–Muller),
# ESS's shrink trip i takes _TAG_SHRINK + i
_TAG_NORMAL, _TAG_UNIFORM, _TAG_THETA, _TAG_SHRINK = 0, 2, 3, 8


def make_composed_mesh(n_chain_groups: int, n_model_devices: int, device=None) -> Mesh:
    """The (n_chain_groups, n_model_devices) mesh; the world must hold
    their product of ranks."""
    return make_mesh(n_chain_groups, n_model_devices, device)


def _as_tensor(x, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x.cpu() if torch.is_tensor(x) else x),
                           dtype=dtype).to(device)


class _Block:
    """This rank's part of the problem: its chains' global ids, the
    group's grid rows of the KL basis (K, rows, n) and of the source, the
    observation cells in those rows, and the Darcy misfit and its adjoint
    gradient on them."""

    def __init__(self, aux, data, noise_scale, mesh: Mesh, n_chains: int, cg_iters: int,
                 log_a_mean: float):
        n = int(aux["n_grid"])
        m_model = mesh.shape[1]
        if n_chains % mesh.shape[0]:
            raise ValueError("n_chains must divide the 'chains' axis")
        if n % m_model:
            raise ValueError("n_grid must divide the 'model' axis")
        dev = mesh.device
        self.mesh, self.n, self.cg_iters, self.log_a_mean = mesh, n, int(cg_iters), log_a_mean
        self.rows = n // m_model
        r0 = mesh.model_index * self.rows
        basis = _as_tensor(aux["scaled_basis"], dev)
        self.K = basis.shape[0]
        self.basis = basis.reshape(self.K, n, n)[:, r0:r0 + self.rows].contiguous()
        self.f = _as_tensor(aux["source"], dev).reshape(n, n)[r0:r0 + self.rows].contiguous()
        obs = np.asarray(aux["obs_indices"].cpu() if torch.is_tensor(aux["obs_indices"])
                         else aux["obs_indices"])
        mine = (obs // n >= r0) & (obs // n < r0 + self.rows)
        self.m = len(obs)
        self.obs_sel = torch.as_tensor(np.nonzero(mine)[0], device=dev)
        self.obs_flat = torch.as_tensor(obs[mine] - r0 * n, device=dev)
        self.y = _as_tensor(data, dev)
        self.scale = torch.tensor(float(noise_scale), dtype=torch.float32, device=dev)
        lo, hi = mesh.chain_rows(n_chains)
        self.lo, self.c = lo, hi - lo
        self.gids = torch.arange(lo, hi, dtype=torch.int64, device=dev)

    def _field(self, u):
        """a (c, rows, n) of whitened coefficients u (c, K)."""
        log_a = (u @ self.basis.reshape(self.K, -1)).reshape(-1, self.rows, self.n)
        return torch.exp(log_a + self.log_a_mean)

    def _solve(self, a, rhs):
        return grid_shard.solve_cg_local(a, rhs, self.n, self.mesh, self.cg_iters)

    def _observe(self, sol):
        """The pressures at the m observation cells (c, m), summed over the
        'model' group from each rank's own cells."""
        pred = torch.zeros(sol.shape[0], self.m, dtype=sol.dtype, device=sol.device)
        pred[:, self.obs_sel] = sol.reshape(sol.shape[0], -1)[:, self.obs_flat]
        return grid_shard._psum(pred, self.mesh)

    def misfit(self, u):
        """Φ (c,) of a (c, K) chain block."""
        sol = self._solve(self._field(u), self.f)
        r = (self.y - self._observe(sol)) / self.scale
        return 0.5 * torch.sum(r * r, dim=1)

    def value_and_grad(self, u):
        """(Φ (c,), ∇Φ (c, K)) by the adjoint method on the sharded grid."""
        a = self._field(u)
        sol = self._solve(a, self.f)
        r = (self.y - self._observe(sol)) / self.scale
        phi = 0.5 * torch.sum(r * r, dim=1)
        # adjoint right-hand side −Oᵀ(r/σ), on this rank's cells
        rhs = torch.zeros_like(sol).reshape(sol.shape[0], -1)
        rhs[:, self.obs_flat] = -(r / self.scale)[:, self.obs_sel]
        lam = self._solve(a, rhs.reshape(sol.shape))
        g_a = _grad_wrt_a_local(a, sol, lam, self.n, self.mesh)
        g_loga = a * (-g_a)  # a = exp(log a); δΦ = −λᵀ δA x
        g_u = g_loga.reshape(g_loga.shape[0], -1) @ self.basis.reshape(self.K, -1).T
        return phi, grid_shard._psum(g_u, self.mesh)

    # --- the draws of (seed, step, global chain id) ---

    def uniforms(self, seed, t, tag):
        """(c,) uniforms in (0, 1)."""
        return rng.chain_uniforms(seed, t, tag, self.gids)

    def normals(self, seed, t):
        """(c, K) standard normals (tags 0 and 1)."""
        return rng.chain_normals(seed, t, _TAG_NORMAL, self.gids, self.K)


def _grad_wrt_a_local(a_local, x_local, lam_local, n: int, mesh: Mesh):
    """The block of ∇_a[λᵀ A(a) x] (c, rows, n): the harmonic-mean face
    derivative ∂t/∂a_i = 2h²(a_j/(a_i + a_j))², horizontal faces within the
    rows, vertical faces over one-row halos of a, x and λ (a zero halo row
    is the grid's edge: no face; the three exchanged at once), the
    Dirichlet edges 2h² x λ."""
    h2 = float(n * n)
    tb = 2.0 * h2
    first, last = grid_shard._edges(mesh)
    # the three fields' halo rows in one exchange
    up3, dn3 = grid_shard._halo_exchange_rows(torch.stack([a_local, x_local, lam_local]), mesh)
    (a_up, x_up, l_up), (a_dn, x_dn, l_dn) = up3, dn3
    g = torch.zeros_like(a_local)
    den_h = a_local[..., :, :-1] + a_local[..., :, 1:]
    s_h = (x_local[..., :, :-1] - x_local[..., :, 1:]) * (
        lam_local[..., :, :-1] - lam_local[..., :, 1:])
    g[..., :, :-1] += 2.0 * h2 * torch.square(a_local[..., :, 1:] / den_h) * s_h
    g[..., :, 1:] += 2.0 * h2 * torch.square(a_local[..., :, :-1] / den_h) * s_h

    def ext(up, loc, dn):
        return torch.cat([up[..., None, :], loc, dn[..., None, :]], dim=-2)

    a_ext, x_ext, l_ext = ext(a_up, a_local, a_dn), ext(x_up, x_local, x_dn), ext(
        l_up, lam_local, l_dn)
    face = (a_ext[..., :-1, :] > 0.0) & (a_ext[..., 1:, :] > 0.0)
    den_v = torch.where(face, a_ext[..., :-1, :] + a_ext[..., 1:, :],
                        torch.ones_like(a_ext[..., 1:, :]))
    s_v = torch.where(face, (x_ext[..., :-1, :] - x_ext[..., 1:, :])
                      * (l_ext[..., :-1, :] - l_ext[..., 1:, :]),
                      torch.zeros_like(den_v))
    up = 2.0 * h2 * torch.square(a_ext[..., 1:, :] / den_v) * s_v
    lo = 2.0 * h2 * torch.square(a_ext[..., :-1, :] / den_v) * s_v
    g = g + up[..., 1:, :] + lo[..., :-1, :]
    if first:
        g[..., 0, :] += tb * x_local[..., 0, :] * lam_local[..., 0, :]
    if last:
        g[..., -1, :] += tb * x_local[..., -1, :] * lam_local[..., -1, :]
    g[..., :, 0] += tb * x_local[..., :, 0] * lam_local[..., :, 0]
    g[..., :, -1] += tb * x_local[..., :, -1] * lam_local[..., :, -1]
    return g


def composed_misfit_and_grad(aux, data, noise_scale, mesh: Mesh, u, cg_iters=150,
                             log_a_mean=0.0):
    """(Φ (n,), ∇Φ (n, K)) of a whole (n, K) batch (the same on every
    rank): each chain group computes its rows on its sharded grids, and the
    rows are gathered."""
    blk = _Block(aux, data, noise_scale, mesh, u.shape[0], cg_iters, log_a_mean)
    phi, g = blk.value_and_grad(u[blk.lo:blk.lo + blk.c].to(mesh.device))
    return gather_chains(phi, mesh), gather_chains(g, mesh)


# --- the transitions, their draws as arguments --------------------------------


def pcn_transition(misfit, u, phi, xi, log_u, beta):
    """v = √(1 − β²) u + β ξ, accepted where log u < Φ(u) − Φ(v); returns
    (u, Φ, accepted)."""
    b = torch.tensor(beta, dtype=torch.float32, device=u.device)
    v = torch.sqrt(1.0 - b * b) * u + b * xi
    phi_v = misfit(v)
    acc = log_u < (phi - phi_v)
    return torch.where(acc[:, None], v, u), torch.where(acc, phi_v, phi), acc


def mala_transition(value_and_grad, u, phi, g, xi, log_u, step_size):
    """MALA on Φ + ½‖u‖² (the whitened prior folded into the drift and the
    ratio; a NaN ratio rejects); returns (u, Φ, ∇Φ, accepted)."""
    eps = torch.tensor(step_size, dtype=torch.float32, device=u.device)
    mean_fwd = u + 0.5 * eps * eps * (-g - u)
    v = mean_fwd + eps * xi
    phi_v, g_v = value_and_grad(v)
    mean_rev = v + 0.5 * eps * eps * (-g_v - v)
    inv2e2 = 1.0 / (2.0 * eps * eps)
    log_q_rev = -torch.sum(torch.square(u - mean_rev), dim=1) * inv2e2
    log_q_fwd = -0.5 * torch.sum(xi * xi, dim=1)
    logpi_u = -phi - 0.5 * torch.sum(u * u, dim=1)
    logpi_v = -phi_v - 0.5 * torch.sum(v * v, dim=1)
    log_ratio = logpi_v - logpi_u + log_q_rev - log_q_fwd
    log_ratio = torch.where(torch.isnan(log_ratio), torch.full_like(log_ratio, -torch.inf),
                            log_ratio)
    acc = log_u < log_ratio
    return (torch.where(acc[:, None], v, u), torch.where(acc, phi_v, phi),
            torch.where(acc[:, None], g_v, g), acc)


def ess_transition(misfit, u, phi, nu, log_w, theta0, shrink_uniforms, max_shrink):
    """Elliptical slice sampling: the bracket [θ0 − 2π, θ0] shrinks toward
    0 until −Φ(v) beats the level −Φ(u) + log w, at most ``max_shrink``
    evaluations; every chain is evaluated on every trip (masked), and the
    trip count comes from an ``all_reduce`` over the world of the chains
    still shrinking. ``shrink_uniforms(i)`` gives trip i's (c,) uniforms. A
    chain that never accepts keeps u (θ → 0). Returns (u, Φ, evaluations
    (c,))."""
    two_pi = torch.tensor(2.0 * np.pi, dtype=torch.float32)
    log_y = -phi + log_w
    u_new, phi_new, theta = u, phi, theta0
    lo, hi = theta0 - two_pi, theta0
    done = torch.zeros_like(phi, dtype=torch.bool)
    n_ev = torch.zeros_like(phi)
    remaining = torch.zeros((), dtype=torch.int64, device=u.device)
    for i in range(max_shrink):
        v = u * torch.cos(theta)[:, None] + nu * torch.sin(theta)[:, None]
        phi_v = misfit(v)
        acc = (-phi_v > log_y) & ~done
        u_new = torch.where(acc[:, None], v, u_new)
        phi_new = torch.where(acc, phi_v, phi_new)
        n_ev = n_ev + torch.where(done, 0.0, 1.0)
        done = done | acc
        lo = torch.where(done | (theta >= 0.0), lo, theta)
        hi = torch.where(done | (theta < 0.0), hi, theta)
        theta = torch.where(done, theta, lo + shrink_uniforms(i) * (hi - lo))
        remaining.copy_(torch.sum(~done))
        dist.all_reduce(remaining)
        if int(remaining) == 0:
            break
    return u_new, phi_new, n_ev


# --- the samplers ----------------------------------------------------------------


def _run(blk, name, u0, n_samples, burn_in, thin, init, step):
    """The step loop of a composed sampler: ``init(u) -> carry``,
    ``step(carry, t) -> (carry, stat (c,))`` with ``carry[0]`` the
    positions; returns (the samples of all chains (n_samples, n, K), the
    mean of ``stat`` over every step and chain)."""
    mesh = blk.mesh
    carry = init(u0[blk.lo:blk.lo + blk.c].to(mesh.device).to(torch.float32))
    total = burn_in + n_samples * thin
    stat_sum = torch.zeros((), dtype=torch.float64, device=mesh.device)
    kept = []
    for t in range(total):
        count_step(name, mesh.device)
        carry, stat = step(carry, t)
        stat_sum += torch.sum(stat.to(torch.float64))
        if t >= burn_in and (t - burn_in + 1) % thin == 0:
            kept.append(carry[0])
    samples = gather_chains(torch.stack(kept[:n_samples]), mesh, axis=1)
    dist.all_reduce(stat_sum, group=mesh.chains_group)
    return samples, (stat_sum / (total * blk.c * mesh.shape[0])).to(torch.float32)


def sample_composed_pcn(aux, data, noise_scale, *, beta, mesh: Mesh, u0, seed, n_samples,
                        burn_in=0, thin=1, cg_iters=150, log_a_mean=0.0):
    """pCN on the Darcy posterior over a ('chains', 'model') mesh. ``aux``:
    ``models.darcy.make_darcy_forward``'s (or ``darcy_aux``'s) constants;
    ``u0`` (n, K) whitened starts, the same on every rank. Returns (samples
    (n_samples, n, K), acceptance rate) on every rank."""
    blk = _Block(aux, data, noise_scale, mesh, u0.shape[0], cg_iters, log_a_mean)

    def step(carry, t):
        u, phi = carry
        xi = blk.normals(seed, t)
        log_u = torch.log(blk.uniforms(seed, t, _TAG_UNIFORM))
        u, phi, acc = pcn_transition(blk.misfit, u, phi, xi, log_u, beta)
        return (u, phi), acc

    return _run(blk, "scan_composed_pcn_step", u0, n_samples, burn_in, thin,
                lambda u: (u, blk.misfit(u)), step)


def sample_composed_mala(aux, data, noise_scale, *, step_size, mesh: Mesh, u0, seed,
                         n_samples, burn_in=0, thin=1, cg_iters=150, log_a_mean=0.0):
    """MALA on the Darcy posterior over a ('chains', 'model') mesh, ∇Φ from
    the distributed adjoint solve. Returns (samples, acceptance rate)."""
    blk = _Block(aux, data, noise_scale, mesh, u0.shape[0], cg_iters, log_a_mean)

    def step(carry, t):
        u, phi, g = carry
        xi = blk.normals(seed, t)
        log_u = torch.log(blk.uniforms(seed, t, _TAG_UNIFORM))
        u, phi, g, acc = mala_transition(blk.value_and_grad, u, phi, g, xi, log_u, step_size)
        return (u, phi, g), acc

    return _run(blk, "scan_composed_mala_step", u0, n_samples, burn_in, thin,
                lambda u: (u, *blk.value_and_grad(u)), step)


def sample_composed_elliptical(aux, data, noise_scale, *, mesh: Mesh, u0, seed, n_samples,
                               burn_in=0, thin=1, cg_iters=150, log_a_mean=0.0,
                               max_shrink=20):
    """Elliptical slice sampling on the Darcy posterior over a ('chains',
    'model') mesh. Returns (samples, mean forward evaluations a step)."""
    blk = _Block(aux, data, noise_scale, mesh, u0.shape[0], cg_iters, log_a_mean)

    def step(carry, t):
        u, phi = carry
        nu = blk.normals(seed, t)
        log_w = torch.log(blk.uniforms(seed, t, _TAG_UNIFORM))
        theta0 = blk.uniforms(seed, t, _TAG_THETA) * (2.0 * np.pi)
        u, phi, n_ev = ess_transition(
            blk.misfit, u, phi, nu, log_w, theta0,
            lambda i: blk.uniforms(seed, t, _TAG_SHRINK + i), max_shrink)
        return (u, phi), n_ev

    return _run(blk, "scan_composed_ess_step", u0, n_samples, burn_in, thin,
                lambda u: (u, blk.misfit(u)), step)
