"""The reference-name object API (mirrors ``ip_mcmc_tpu/api.py``): the
public classes of ``ochsnerd/ip_mcmc`` (``MCMCSampler``,
``StandardRWProposer``, ``pCNProposer``, ``AnalyticAccepter``,
``StandardRWAccepter``, ``pCNAccepter``, ``CountedAccepter``,
``GaussianDistribution``, ``LogNormalDistribution``,
``IndependentDistributions``, ``AnalyticPotential``,
``EvolutionPotential``), so that a script written for the reference keeps
its shape.

Nothing is dispatched object by object a chain: ``MCMCSampler.run`` steps
an (n_chains, d) batch (default one chain, the reference's) through the
scan driver (``driver.sample_chains``), the proposer and the accepter
called once a step on the whole batch. The accepters keep the cached-
potential protocol (``init_cache`` / ``log_ratio``), so a step costs one
forward evaluation. ``rng`` is a ``torch.Generator`` or an int seed in
place of JAX's key. As the port's other entry points, the distributions
and the sampler run on the card (``device="cuda"``, which raises without
one) unless ``device="cpu"`` is passed. Functions here take a batch with
the chains first.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ip_mcmc_tpu_torch import distributions as dist
from ip_mcmc_tpu_torch import driver
from ip_mcmc_tpu_torch._device import resolve_device
from ip_mcmc_tpu_torch.kernels.base import MHInfo, mh_select, normals, uniforms


def _n_of(sample_shape):
    """The draw count of a JAX ``sample_shape``: () one draw, (n,) n."""
    shape = tuple(sample_shape) if not isinstance(sample_shape, int) else (sample_shape,)
    if len(shape) > 1:
        raise ValueError(f"sample_shape {shape}: one batch dimension at most")
    return shape[0] if shape else None


def _tensor(x, device):
    """``x`` (an array, a list or a tensor) as float32 on ``device``."""
    return torch.as_tensor(np.asarray(x.cpu() if torch.is_tensor(x) else x),
                           dtype=torch.float32).to(device)


def _sample(fn, generator, sample_shape):
    n = _n_of(sample_shape)
    out = fn(generator, 1 if n is None else n)
    return out[0] if n is None else out


# ------------------------------------------------------------ distributions
class GaussianDistribution:
    """Gaussian with a dense (d, d) or a diagonal (d,) covariance."""

    def __init__(self, mean, covariance, device="cuda"):
        device = resolve_device(device)
        mean, cov = _tensor(mean, device), _tensor(covariance, device)
        if cov.dim() == 1:
            self._d = dist.DiagGaussian(mean=mean, scale=torch.sqrt(cov))
        else:
            self._d = dist.Gaussian.from_covariance(mean, cov)

    @property
    def dim(self):
        return self._d.dim

    @property
    def mean(self):
        return self._d.mean

    def sample(self, generator, sample_shape=()):
        return _sample(self._d.sample, generator, sample_shape)

    def sample_centered(self, generator, sample_shape=()):
        return _sample(self._d.sample_centered, generator, sample_shape)

    def scale_apply(self, z):
        return self._d.scale_apply(z)

    def log_density(self, x):
        return self._d.log_prob(x)

    def density(self, x):
        return torch.exp(self._d.log_prob(x))

    def potential(self, x):
        return self._d.potential(x)

    def whiten(self, x):
        return self._d.whiten(x)

    @property
    def inner(self):
        return self._d


class LogNormalDistribution:
    def __init__(self, mu, sigma, device="cuda"):
        device = resolve_device(device)
        self._d = dist.LogNormal(mu=_tensor(mu, device), sigma=_tensor(sigma, device))

    @property
    def dim(self):
        return self._d.dim

    def sample(self, generator, sample_shape=()):
        return _sample(self._d.sample, generator, sample_shape)

    def log_density(self, x):
        return self._d.log_prob(x)

    def density(self, x):
        return torch.exp(self._d.log_prob(x))

    @property
    def inner(self):
        return self._d


class IndependentDistributions:
    def __init__(self, distributions):
        self._d = dist.IndependentProduct.of(*[getattr(d, "inner", d) for d in distributions])

    @property
    def dim(self):
        return self._d.dim

    def sample(self, generator, sample_shape=()):
        return _sample(self._d.sample, generator, sample_shape)

    def log_density(self, x):
        return self._d.log_prob(x)

    def density(self, x):
        return torch.exp(self._d.log_prob(x))

    @property
    def inner(self):
        return self._d


# --------------------------------------------------------------- potentials
class AnalyticPotential:
    """Φ = −log density of a closed-form target."""

    def __init__(self, log_density_fn):
        self._f = log_density_fn

    def __call__(self, u):
        return -self._f(u)


class EvolutionPotential:
    """Φ(u) = ½‖Γ^{-1/2}(y − O(G(u)))‖²; ``evolution`` maps (..., d) to
    predictions ending in the data's shape."""

    def __init__(self, evolution, data, noise, observation=None):
        self.evolution = evolution
        self.data = _tensor(data, "cpu")
        self.noise = noise
        self.observation = observation

    def __call__(self, u):
        pred = self.evolution(u)
        if self.observation is not None:
            pred = self.observation(pred)
        if self.data.device != pred.device:
            self.data = self.data.to(pred.device)  # once: the run's device
        data = self.data
        if pred.shape[pred.dim() - data.dim():] != data.shape:
            raise ValueError(
                f"forward-model prediction shape {tuple(pred.shape)} != data shape "
                f"{tuple(data.shape)}")
        r = data - pred
        if self.noise is not None:
            r = self.noise.whiten(r + self.noise.mean)
        return 0.5 * torch.sum(torch.square(r), dim=tuple(range(-data.dim(), 0)))


# ---------------------------------------------------------------- proposers
class StandardRWProposer:
    """v = u + δ ξ (ξ ~ N(0, I), or ``covariance_sqrt`` applied to it)."""

    def __init__(self, delta, dim=None, covariance_sqrt=None):
        self.delta = delta
        self.covariance_sqrt = (None if covariance_sqrt is None else torch.as_tensor(
            np.asarray(covariance_sqrt), dtype=torch.float32))

    def propose_from(self, u, z):
        """The proposal from standard normals ``z`` (n, d)."""
        if self.covariance_sqrt is not None:
            z = z @ self.covariance_sqrt.to(z.device).T
        return u + self.delta * z

    def propose(self, generator, u):
        return self.propose_from(u, normals(generator, u.shape, u.device))


class pCNProposer:
    """v = m + √(1 − β²)(u − m) + β ξ, ξ ~ N(0, C₀)."""

    def __init__(self, beta, prior):
        if not 0.0 < float(beta) <= 1.0:
            raise ValueError(f"pCN beta must be in (0, 1], got {beta}")
        self.beta = beta
        self.prior = prior

    def propose_from(self, u, z):
        """The proposal from standard normals ``z`` (n, d) (ξ = C₀^{1/2} z)."""
        xi = self.prior.scale_apply(z)
        m = self.prior.mean
        return m + math.sqrt(1.0 - self.beta ** 2) * (u - m) + self.beta * xi

    def propose(self, generator, u):
        return self.propose_from(u, normals(generator, u.shape, u.device))


# ---------------------------------------------------------------- accepters
class AnalyticAccepter:
    """The ratio of a closed-form density: given as a density (the
    reference's) or, numerically safer, as ``log_density_fn``."""

    def __init__(self, density=None, log_density_fn=None):
        if (density is None) == (log_density_fn is None):
            raise ValueError("pass exactly one of density / log_density_fn")
        if log_density_fn is not None:
            self._logf = log_density_fn
        else:
            self._logf = lambda u: torch.log(density(u))

    def init_cache(self, u):
        return self._logf(u)

    def log_ratio(self, cache_u, u, v):
        cache_v = self._logf(v)
        return cache_v - cache_u, cache_v


class StandardRWAccepter:
    """Metropolis–Hastings on the posterior: −log π = Φ + the prior's
    potential."""

    def __init__(self, potential, prior):
        self.potential = potential
        self.prior = prior

    def _neg_log_post(self, u):
        return self.potential(u) + self.prior.potential(u)

    def init_cache(self, u):
        return self._neg_log_post(u)

    def log_ratio(self, cache_u, u, v):
        cache_v = self._neg_log_post(v)
        return cache_u - cache_v, cache_v


class pCNAccepter:
    """min(1, exp(Φ(u) − Φ(v))): the pCN proposal carries the prior."""

    def __init__(self, potential):
        self.potential = potential

    def init_cache(self, u):
        return self.potential(u)

    def log_ratio(self, cache_u, u, v):
        cache_v = self.potential(v)
        return cache_u - cache_v, cache_v


class CountedAccepter:
    """An exact accept counter around an accepter: every Metropolis–Hastings
    step of every chain (burn-in and thinned steps included), summed on the
    device and read once a run."""

    def __init__(self, accepter):
        self.accepter = accepter
        self.calls = 0
        self.accepts = 0

    def init_cache(self, u):
        return self.accepter.init_cache(u)

    def log_ratio(self, cache_u, u, v):
        return self.accepter.log_ratio(cache_u, u, v)

    def record(self, n_calls, n_accepts):
        self.calls += int(n_calls)
        self.accepts += int(n_accepts)

    @property
    def acceptance_rate(self):
        return self.accepts / max(self.calls, 1)


# ------------------------------------------------------------------ sampler
@dataclasses.dataclass
class _MHState:
    position: torch.Tensor  # (n, d)
    cache: torch.Tensor  # (n,)


class MCMCSampler:
    """``run(u0, n_samples, burn_in, sample_interval, n_chains)`` → an
    (n_samples, d) array (one chain) or (n_samples, n_chains, d).

    ``rng``: a ``torch.Generator`` (its draws moved to ``device``) or an
    int seed of one on ``device``. The run's chains live on ``device``, the
    card unless ``"cpu"`` is passed. A step draws the proposal's normals,
    then the uniforms of the accept test."""

    def __init__(self, proposer, accepter, rng, device="cuda"):
        self.proposer = proposer
        self.accepter = accepter
        self.device = resolve_device(device)
        self.generator = (rng if isinstance(rng, torch.Generator)
                          else torch.Generator(self.device).manual_seed(int(rng)))

    def transition(self, state, z, u):
        """One step of every chain from standard normals ``z`` (n, d) and
        uniforms ``u`` (n,); returns (state, info, the log acceptance
        ratio (n,))."""
        v = self.proposer.propose_from(state.position, z)
        log_ratio, cache_v = self.accepter.log_ratio(state.cache, state.position, v)
        new, accepted, accept_prob = mh_select(u, log_ratio, state,
                                               _MHState(position=v, cache=cache_v))
        return new, MHInfo(accepted=accepted, accept_prob=accept_prob, proposal=v), log_ratio

    def init(self, positions):
        return _MHState(position=positions, cache=self.accepter.init_cache(positions))

    def run(self, u0, n_samples, burn_in=0, sample_interval=1, n_chains=1):
        dev = self.device
        u0 = _tensor(u0, dev)
        batched = u0.dim() == 2
        if not batched:
            u0 = u0.expand(n_chains, -1).clone()
        n_accepts = torch.zeros((), dtype=torch.int64, device=dev)

        def kernel(generator, state):
            nonlocal n_accepts
            z = normals(generator, state.position.shape, dev)
            state, info, _ = self.transition(state, z, uniforms(generator, z.shape[:1], dev))
            n_accepts = n_accepts + torch.sum(info.accepted)
            return state, info

        _, samples, _ = driver.sample_chains(
            kernel, self.init(u0), self.generator, n_samples=n_samples, burn_in=burn_in,
            thin=sample_interval)
        if isinstance(self.accepter, CountedAccepter):
            n_steps = burn_in + n_samples * sample_interval
            self.accepter.record(n_steps * u0.shape[0], int(n_accepts))
        out = samples.cpu().numpy()
        if not batched and n_chains == 1:
            return out[:, 0, :]
        return out
