"""Two-level delayed-acceptance pCN, fused (K2–K4; mirrors
``ip_mcmc_tpu/ops/fused_mcmc.py``: ``fused_da_pcn_chain`` l.1535,
``fused_da_pcn_chain_recorded`` l.1653, the step builder
``_make_da_pcn_step_builder`` l.325 and the scaffolds ``_run_fused`` l.152 /
``_run_fused_recorded`` l.826).

Each outer step runs ``subchain_len`` pCN steps against the surrogate Φ*,
then one exact correction (Christen–Fox): accept with
log u < (Φ(u) − Φ(v)) − (Φ*(u) − Φ*(v)), a NaN ratio rejecting.

For CUDA tensors the entry points launch ``fused_da_pcn_kernel<RECORD>``
(``csrc/fused_da_pcn.cu``), which runs the whole ``n_steps`` loop in one
launch; it takes ``DarcyMisfit`` potentials only. For CPU tensors they run
the plain loop ``_run_plain`` / ``_run_plain_recorded``, which takes any
features-first callable (d, B) → (B,), so the algorithm tests can use
analytic targets. Both draw from the counter-hash stream of ``ops/rng.py``
with the JAX tags: inner step j uses 4j, 4j+1 (normals) and 4j+2 (MH
uniform); the outer correction 4k+2; the step counter restarts at 0 in
each launch, and each block of ``block_chains`` chains has the seed
uint32(seed + 7919·block).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ip_mcmc_tpu_torch.models.darcy import DarcyMisfit
from ip_mcmc_tpu_torch.ops import _build, rng


def _as_param(x, device):
    return torch.as_tensor(x, dtype=torch.float32).to(device).contiguous()


def _validate(positions, n_steps, block_chains, thin=None):
    if positions.dtype != torch.float32 or positions.dim() != 2:
        raise ValueError(
            f"positions: expected f32 (n_chains, d), got {positions.dtype} "
            f"{tuple(positions.shape)}"
        )
    n = positions.shape[0]
    if n % block_chains:
        raise ValueError(
            f"n_chains {n} must be a multiple of block_chains {block_chains}"
        )
    if thin is not None and n_steps % thin:
        raise ValueError(f"n_steps {n_steps} must be a multiple of thin {thin}")


def _contraction(beta):
    """(β, √(1 − β²)) in f32, as the JAX step builder computes them."""
    b = torch.tensor(beta, dtype=torch.float32)
    return b, torch.sqrt(1.0 - b * b)


# --- the plain version ------------------------------------------------------


def _normals(bseed, step, tag, row_idx, d):
    """(d, n) normals for every chain: rows of the (half, block_chains)
    tile of each chain's block, at each chain's lane."""
    u1 = rng.uniform_from_bits(rng.hash_bits(rng.mix_key(bseed, step, tag), row_idx))
    u2 = rng.uniform_from_bits(
        rng.hash_bits(rng.mix_key(bseed, step, tag + 1), row_idx)
    )
    return rng.normal_from_uniforms(u1, u2)[:d]


def _uniforms(bseed, step, tag, lane):
    """(n,) uniforms: element ``lane`` of each chain's (1, block) tile."""
    return rng.uniform_from_bits(rng.hash_bits(rng.mix_key(bseed, step, tag), lane))


def _da_pcn_step_plain(pot_exact, pot_surr, state, i, k, stream, params):
    """One outer DA-pCN step on features-first (d, n) state; mirrors the
    ``step`` of ``_make_da_pcn_step_builder``."""
    pos0, phi0, surr0, in_acc = state
    bseed, lane, row_idx = stream
    m, s, beta, contraction = params
    d = pos0.shape[0]
    pos, surr = pos0, surr0
    for j in range(k):
        xi = s * _normals(bseed, i, 4 * j, row_idx, d)
        prop = m + contraction * (pos - m) + beta * xi
        surr_prop = pot_surr(prop)
        log_u = torch.log(_uniforms(bseed, i, 4 * j + 2, lane))
        take = log_u < (surr - surr_prop)  # NaN ratio -> False
        in_acc = in_acc + take.to(torch.float32)
        pos = torch.where(take[None, :], prop, pos)
        surr = torch.where(take, surr_prop, surr)
    phi_end = pot_exact(pos)
    log_ratio = (phi0 - phi_end) - (surr0 - surr)
    log_ratio = torch.where(torch.isnan(log_ratio), -math.inf, log_ratio)
    accept = torch.log(_uniforms(bseed, i, 4 * k + 2, lane)) < log_ratio
    state = (
        torch.where(accept[None, :], pos, pos0),
        torch.where(accept, phi_end, phi0),
        torch.where(accept, surr, surr0),
        in_acc,
    )
    return state, accept


def _run_plain_loop(pot_exact, pot_surr, positions, prior_mean, prior_scale,
                    beta, seed, n_steps, k, block_chains, thin):
    n, d = positions.shape
    dev = positions.device
    bseed, lane = rng.block_seeds(seed, n, block_chains, dev)
    half = (d + 1) // 2
    row_idx = torch.arange(half, device=dev)[:, None] * block_chains + lane
    beta_t, contraction = _contraction(beta)
    params = (
        _as_param(prior_mean, dev)[:, None], _as_param(prior_scale, dev)[:, None],
        beta_t.to(dev), contraction.to(dev),
    )
    pos0 = positions.T.contiguous()
    state = (pos0, pot_exact(pos0), pot_surr(pos0),
             torch.zeros(n, dtype=torch.float32, device=dev))
    acc = torch.zeros(n, dtype=torch.float32, device=dev)
    records = []
    for i in range(n_steps):
        state, accept = _da_pcn_step_plain(
            pot_exact, pot_surr, state, i, k, (bseed, lane, row_idx), params
        )
        acc = acc + accept.to(torch.float32)
        if thin and (i + 1) % thin == 0:
            records.append(state[0].T)
    inner = state[3] / max(float(n_steps) * k, 1.0)
    return state[0].T.contiguous(), acc / n_steps, inner, records


def _run_plain(pot_exact, pot_surr, positions, prior_mean, prior_scale, beta,
               seed, n_steps, subchain_len, block_chains):
    """Plain twin of ``fused_da_pcn_kernel<false>``: (final (n, d),
    exact acceptance (n,), inner acceptance (n,))."""
    _validate(positions, n_steps, block_chains)
    _build.launch_counts["fused_da_pcn_plain"] += 1
    final, acc, inner, _ = _run_plain_loop(
        pot_exact, pot_surr, positions, prior_mean, prior_scale, beta, seed,
        n_steps, int(subchain_len), block_chains, None,
    )
    return final, acc, inner


def _run_plain_recorded(pot_exact, pot_surr, positions, prior_mean,
                        prior_scale, beta, seed, n_steps, thin, subchain_len,
                        block_chains):
    """Plain twin of ``fused_da_pcn_kernel<true>``: (final (n, d),
    exact acceptance (n,), samples (n_steps // thin, n, d))."""
    _validate(positions, n_steps, block_chains, thin)
    _build.launch_counts["fused_da_pcn_plain_recorded"] += 1
    final, acc, _, records = _run_plain_loop(
        pot_exact, pot_surr, positions, prior_mean, prior_scale, beta, seed,
        n_steps, int(subchain_len), block_chains, thin,
    )
    n, d = positions.shape
    samples = (torch.stack(records) if records else
               positions.new_empty((0, n, d)))
    return final, acc, samples


# --- the kernel -------------------------------------------------------------


def _launch(pot_exact, pot_surr, positions, prior_mean, prior_scale, beta,
            seed, n_steps, subchain_len, block_chains, thin=None):
    for name, pot in (("potential_fn", pot_exact), ("surrogate_fn", pot_surr)):
        if not isinstance(pot, DarcyMisfit):
            raise TypeError(
                f"{name}: the CUDA kernel takes DarcyMisfit potentials only, "
                f"got {type(pot).__name__}"
            )
    n, d = positions.shape
    positions = positions.contiguous()
    U = positions.T.contiguous()
    pot_exact.check_input(U, "positions.T (exact)")
    pot_surr.check_input(U, "positions.T (surrogate)")
    dev = positions.device
    mean, scale = _as_param(prior_mean, dev), _as_param(prior_scale, dev)
    if mean.shape != (d,) or scale.shape != (d,):
        raise ValueError(f"prior mean/scale must have shape ({d},)")
    # Φ and Φ* at the start positions come from the standalone misfit
    # kernel (the Pallas step builder's init evaluates both potentials)
    phi0, surr0 = pot_exact(U), pot_surr(U)
    out = torch.empty_like(positions)
    acc = torch.empty(n, dtype=torch.float32, device=dev)
    inner = torch.empty(n, dtype=torch.float32, device=dev)
    record = thin is not None
    samples = (torch.empty((n_steps // thin, n, d), dtype=torch.float32,
                           device=dev) if record else None)
    beta_t, contraction = _contraction(beta)
    es, ss = pot_exact.spec(), pot_surr.spec()
    status = _build.library().ipx_fused_da_pcn(
        ctypes.byref(es), ctypes.byref(ss),
        positions.data_ptr(), phi0.data_ptr(), surr0.data_ptr(),
        mean.data_ptr(), scale.data_ptr(), float(beta_t), float(contraction),
        int(seed), n, d, int(n_steps), int(subchain_len), int(block_chains),
        int(thin or 0), out.data_ptr(), acc.data_ptr(), inner.data_ptr(),
        samples.data_ptr() if record else None,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    name = f"fused_da_pcn_kernel<{'true' if record else 'false'}>"
    _build.check(status, name)
    _build.launch_counts[name] += 1
    return out, acc, (samples if record else inner)


# --- entry points -----------------------------------------------------------


def fused_da_pcn_chain(potential_fn, surrogate_fn, positions, prior_mean,
                       prior_scale, beta, seed, n_steps=100, subchain_len=4,
                       block_chains=256):
    """Delayed-acceptance pCN: (final positions (n, d), exact acceptance
    rate (n,), inner acceptance rate (n,)). Potentials take (d, B) → (B,)."""
    _validate(positions, n_steps, block_chains)
    if positions.device.type == "cuda":
        return _launch(potential_fn, surrogate_fn, positions, prior_mean,
                       prior_scale, beta, seed, n_steps, subchain_len,
                       block_chains)
    if positions.device.type == "cpu":
        return _run_plain(potential_fn, surrogate_fn, positions, prior_mean,
                          prior_scale, beta, seed, n_steps, subchain_len,
                          block_chains)
    raise ValueError(f"unsupported device {positions.device}")


def fused_da_pcn_chain_recorded(potential_fn, surrogate_fn, positions,
                                prior_mean, prior_scale, beta, seed,
                                n_steps=100, thin=1, subchain_len=4,
                                block_chains=256):
    """Delayed-acceptance pCN recording every ``thin``-th outer step:
    (final positions, exact acceptance rate, samples (n_steps // thin, n, d))."""
    _validate(positions, n_steps, block_chains, thin)
    if positions.device.type == "cuda":
        return _launch(potential_fn, surrogate_fn, positions, prior_mean,
                       prior_scale, beta, seed, n_steps, subchain_len,
                       block_chains, thin=thin)
    if positions.device.type == "cpu":
        return _run_plain_recorded(potential_fn, surrogate_fn, positions,
                                   prior_mean, prior_scale, beta, seed,
                                   n_steps, thin, subchain_len, block_chains)
    raise ValueError(f"unsupported device {positions.device}")
