"""Three-level delayed-acceptance pCN, fused (K13; mirrors
``ip_mcmc_tpu/ops/fused_mcmc.py``: ``fused_da3_pcn_chain`` l.1574,
``fused_da3_pcn_chain_recorded`` l.1614 and the step builder
``_make_da3_pcn_step_builder`` l.391).

Each outer step runs ``k_mid`` middle-level DA steps — ``k_inner`` pCN
steps against the coarse potential Φc, then a middle correction accepted
with log u < (Φm(u) − Φm(v)) − (Φc(u) − Φc(v)) — and then one fine
correction log u < (Φf(u) − Φf(v)) − (Φm(u) − Φm(v)); a NaN ratio rejects.
Each level's chain is invariant for its level's posterior (Christen–Fox),
so the level above may take its endpoint as a proposal. The main
acceptance output is the fine correction's; the third output of the plain
entry point is the middle correction's rate.

For CUDA tensors the entry points launch a kernel of
``csrc/fused_da3_pcn.cu``, the whole ``n_steps`` loop in one launch, as
``route`` says (``da3_route`` there decides): ``fused_da3_pcn_warp_kernel<RECORD>``,
one chain a warp, ``warp_geometry``'s chains a CTA, on three
``BurgersMisfit`` potentials of 64 or 128 cells with d = K = 16
(``warp_takes``), and ``fused_da3_pcn_kernel<RECORD>``, one chain a CTA, on
any other three levels of up to 128 cells with K = d up to 128; the
kernels refuse others and the wrapper raises. Three
``LinearGaussianPotential`` levels with K = d up to 256
(``_scaffold.linear_route``) run on
``fused_da3_pcn_kernel<LinearGaussianPotential, RECORD>``, one chain a CTA
(``ipx_fused_da3_pcn_linear``); another d raises ``ValueError`` before any
launch. For CPU tensors they run
the step builder below on the plain scaffold ``_scaffold.run_plain``,
which takes any three features-first callables (d, B) → (B,). Tags: inner
step (j2, j1) draws with t = 4(j2·k_inner + j1) (normals t, t+1; uniform
t+2); middle correction j2 with 4·k_inner·k_mid + 4·j2 + 2; the fine
correction with 4·k_inner·k_mid + 4·k_mid + 2.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ip_mcmc_tpu_torch.ops import _build, _burgers_warp, _scaffold


# --- the plain version ------------------------------------------------------


def _make_da3_pcn_step_builder(k_inner, k_mid):
    """Step builder on features-first (d, n) state for ``_scaffold.run_plain``;
    mirrors ``_make_da3_pcn_step_builder``. ``pots`` is (fine, middle,
    coarse); ``extra_out`` is the middle-correction acceptance rate."""
    k1, k2 = int(k_inner), int(k_mid)

    def builder(pots, beta, mean, scale):
        pot_fine, pot_mid, pot_coarse = pots
        contraction = torch.sqrt(1.0 - beta * beta)
        m, s = mean[:, None], scale[:, None]

        def init(pos):
            mid_acc = torch.zeros((1, pos.shape[1]), dtype=torch.float32,
                                  device=pos.device)
            return (pos, pot_fine(pos), pot_mid(pos), pot_coarse(pos),
                    mid_acc, 0.0)

        def step(carry, rand_n, rand_u):
            pos0, phi0, mid0, surr0, mid_acc, cnt = carry
            row = (1, pos0.shape[1])
            pos, mid, surr = pos0, mid0, surr0
            for j2 in range(k2):  # middle-level DA steps
                p1, s1 = pos, surr
                for j1 in range(k1):  # inner pCN on the coarse level
                    t = 4 * (j2 * k1 + j1)
                    xi = s * rand_n(p1.shape, t)
                    prop = m + contraction * (p1 - m) + beta * xi
                    sp = pot_coarse(prop)
                    log_u = torch.log(rand_u(row, t + 2))[0]
                    take = log_u < (s1 - sp)  # NaN ratio -> False
                    p1 = torch.where(take[None, :], prop, p1)
                    s1 = torch.where(take, sp, s1)
                mid_end = pot_mid(p1)
                lr = (mid - mid_end) - (surr - s1)  # coarse -> middle
                lr = torch.where(torch.isnan(lr), -math.inf, lr)
                log_u = torch.log(rand_u(row, 4 * k1 * k2 + 4 * j2 + 2))[0]
                take_m = log_u < lr
                mid_acc = mid_acc + take_m[None, :].to(torch.float32)
                pos = torch.where(take_m[None, :], p1, pos)
                mid = torch.where(take_m, mid_end, mid)
                surr = torch.where(take_m, s1, surr)
            phi_end = pot_fine(pos)
            log_ratio = (phi0 - phi_end) - (mid0 - mid)  # middle -> fine
            log_ratio = torch.where(torch.isnan(log_ratio), -math.inf, log_ratio)
            log_u = torch.log(rand_u(row, 4 * k1 * k2 + 4 * k2 + 2))[0]
            accept = log_u < log_ratio
            acc2 = accept[None, :]
            return (
                torch.where(acc2, pos, pos0),
                torch.where(accept, phi_end, phi0),
                torch.where(accept, mid, mid0),
                torch.where(accept, surr, surr0),
                mid_acc,
                cnt + 1.0,
            ), acc2

        return init, step

    builder.extra_out = lambda carry: carry[4][0] / max(carry[5] * k2, 1.0)
    return builder


def _run_plain(pot_fine, pot_mid, pot_coarse, positions, prior_mean,
               prior_scale, beta, seed, n_steps, k_inner, k_mid, block_chains,
               thin=None):
    """Plain twin of ``fused_da3_pcn_warp_kernel``: (final (n, d), fine
    acceptance (n,), middle acceptance (n,)), or with ``thin`` (final, fine
    acceptance, samples (n_steps // thin, n, d))."""
    _build.launch_counts[
        f"fused_da3_pcn_plain{'' if thin is None else '_recorded'}"] += 1
    final, acc, mid, samples = _scaffold.run_plain(
        _make_da3_pcn_step_builder(k_inner, k_mid),
        (pot_fine, pot_mid, pot_coarse), positions,
        [beta, prior_mean, prior_scale], seed, n_steps, block_chains, thin,
    )
    return final, acc, (mid if thin is None else samples)


# --- the kernel -------------------------------------------------------------

# ``Da3WarpDesign`` in ``csrc/fused_da3_pcn.cu``: chains (warps) a CTA at
# most. What it takes: levels that ``_burgers_warp.takes`` (64 or 128
# cells, d = K = WARP_D); a warp's slice holds four positions.
WARP_CHAINS = 16
WARP_D = _burgers_warp.WARP_D
LEVEL_FLOATS, MAX_SMEM_BYTES = _burgers_warp.LEVEL_FLOATS, _burgers_warp.MAX_SMEM_BYTES
WARP_SLICE_BYTES = _burgers_warp.slice_bytes(4)
KERNEL = "fused_da3_pcn_warp_kernel"  # the launch count's stem
CTA_KERNEL = "fused_da3_pcn_kernel"  # the one-chain-a-CTA kernel's
LINEAR_KERNEL = "fused_da3_pcn_kernel[linear]"  # its instantiation on LinearGaussianPotential
CTA_CELLS = 128  # the most cells a level, and the most coordinates (BurgersPotential's CTA)


def warp_takes(levels, d):
    """Whether the warp kernel takes the levels (fine, middle, coarse: each
    ``(cells, K)``) for chains of d coordinates, as ``da3_warp_takes`` in
    ``csrc/fused_da3_pcn.cu`` decides: each a level of the warp solve
    (``_burgers_warp.takes``)."""
    return all(_burgers_warp.takes(cells, K, d) for cells, K in levels)


def route(levels, d):
    """The kernel ``ipx_fused_da3_pcn_burgers`` sends the levels (each
    ``(cells, K)``) to, as ``da3_route`` decides: "warp" for what
    ``warp_takes``, "cta" for any other levels of up to CTA_CELLS cells with
    K = d up to CTA_CELLS, None (refused) else."""
    if warp_takes(levels, d):
        return "warp"
    if all(0 < cells <= CTA_CELLS and K == d for cells, K in levels) and 0 < d <= CTA_CELLS:
        return "cta"
    return None


def warp_geometry(n_chains, block_chains, *, cells=(128, 128, 64), d=WARP_D,
                  K=WARP_D):
    """The kernel's launch: (CTAs, chains a CTA, dynamic shared-memory
    bytes), as ``da3_warp_geometry`` in ``csrc/fused_da3_pcn.cu`` computes
    it for levels of ``cells`` (fine, middle, coarse): the three staged
    levels and a slice a warp (``_burgers_warp.geometry``). Raises
    ``ValueError`` for cells, d or K the kernel does not take and for
    shared memory the card cannot give a CTA."""
    return _burgers_warp.geometry("three-level DA kernel", n_chains, block_chains,
                                  cells=cells, d=d, K=K, chains=WARP_CHAINS, positions=4)


def _launch(pot_fine, pot_mid, pot_coarse, positions, prior_mean, prior_scale,
            beta, seed, n_steps, k_inner, k_mid, block_chains, thin=None):
    pots = {"potential_fn": pot_fine, "mid_fn": pot_mid,
            "surrogate_fn": pot_coarse}
    family = _scaffold.require_family(pots, families=("burgers", "linear"))
    if family == "linear":
        _scaffold.require_linear_route("three-level DA", positions.shape[1], *pots.values())
    args, keep = _scaffold.chain_args(positions, prior_mean, prior_scale,
                                      seed, n_steps, block_chains, thin)
    U = keep[0].T.contiguous()
    for name, pot in pots.items():
        pot.check_input(U, f"positions.T ({name})")
    # Φ of the three levels at the start positions come from the standalone
    # misfit kernel (the Pallas step builder's init evaluates all three)
    start = [pot(U) for pot in pots.values()]
    mid_rate = torch.empty(U.shape[1], dtype=torch.float32, device=U.device)
    beta_t, contraction = _scaffold.contraction(beta)
    specs = [pot.spec() for pot in pots.values()]
    lib = _build.library()
    fn = lib.ipx_fused_da3_pcn_linear if family == "linear" else lib.ipx_fused_da3_pcn_burgers
    status = fn(
        *(ctypes.byref(s) for s in specs), ctypes.byref(args),
        *(t.data_ptr() for t in start), float(beta_t), float(contraction),
        int(k_inner), int(k_mid), mid_rate.data_ptr(),
        torch.cuda.current_stream(U.device).cuda_stream,
    )
    if family == "linear":
        stem = LINEAR_KERNEL
    else:
        kernel = route([(pot.n, pot.K) for pot in pots.values()], U.shape[0])
        stem = CTA_KERNEL if kernel == "cta" else KERNEL
    name = _scaffold.kernel_name(stem, thin is not None)
    _build.check(status, name)
    _build.launch_counts[name] += 1
    _, _, _, out, acc, samples = keep
    return out, acc, (mid_rate if thin is None else samples)


# --- entry points -----------------------------------------------------------


def fused_da3_pcn_chain(potential_fn, mid_fn, surrogate_fn, positions,
                        prior_mean, prior_scale, beta, seed, n_steps=100,
                        k_inner=8, k_mid=4, block_chains=256):
    """Three-level delayed-acceptance pCN: (final positions (n, d), fine
    acceptance rate (n,), middle acceptance rate (n,)). All three
    potentials take (d, B) → (B,)."""
    _scaffold.validate(positions, n_steps, block_chains)
    run = _scaffold.on_device(positions, _launch, _run_plain)
    return run(potential_fn, mid_fn, surrogate_fn, positions, prior_mean,
               prior_scale, beta, seed, n_steps, k_inner, k_mid, block_chains)


def fused_da3_pcn_chain_recorded(potential_fn, mid_fn, surrogate_fn,
                                 positions, prior_mean, prior_scale, beta,
                                 seed, n_steps=100, thin=1, k_inner=8,
                                 k_mid=4, block_chains=256):
    """Three-level DA pCN recording every ``thin``-th outer step: (final
    positions, fine acceptance rate, samples (n_steps // thin, n, d))."""
    _scaffold.validate(positions, n_steps, block_chains, thin)
    run = _scaffold.on_device(positions, _launch, _run_plain)
    return run(potential_fn, mid_fn, surrogate_fn, positions, prior_mean,
               prior_scale, beta, seed, n_steps, k_inner, k_mid, block_chains,
               thin=thin)
