"""The No-U-Turn Sampler, scan path (mirrors ``ip_mcmc_tpu/kernels/nuts.py``):
iterative multinomial NUTS over an (n, d) batch of chains.

A transition doubles the tree up to ``max_depth`` times, each doubling in a
direction drawn per chain: 2^depth leapfrog steps from that edge, the
proposal of the new subtree sampled progressively (multinomial, one
uniform a leaf), the subtree's U-turns checked at every power-of-two span
through a checkpoint stack indexed by the popcount of the leaf index, then
the subtree merged into the tree (biased progressive sampling, one uniform
a doubling) unless it turned or diverged, and the whole tree checked for a
U-turn on its momentum sum (ρ·M⁻¹p at either edge < 0).

The JAX package ``vmap``s the two ``while_loop``s over the chains, so a
chain that has finished is frozen while the others go on. Here the chains
move together: a chain's depth and leaf index are those of the loop
(every chain still building is at the same doubling and leaf), and masks
freeze the chains that have terminated (the outer loop) or whose subtree
has turned or diverged (the inner). The loops stop when no chain is left,
read from the host once a doubling and every ``CHECK_EVERY`` leaves.

Every gradient comes from autograd through ``log_density_fn``
(``base.value_and_grad``): on the ODE configs one launch of the
Lotka–Volterra kernel a leaf."""

from __future__ import annotations

import dataclasses

import torch

from ip_mcmc_tpu_torch.kernels.base import count_step, normals, uniforms, value_and_grad

_MAX_DELTA_ENERGY = 1000.0
# leaves between two host reads of "is any chain still building its
# subtree". Timed in turns on an ode_nuts transition of 256 chains (H100
# 80GB HBM3, 700 W; scripts/measure_scan_paths.py --only-ode), no spacing
# of 1, 2, 4, 8 or 16 leaves stood out: medians 224-243 ms a transition,
# each spacing's turns spread over 45-108 ms by the host
CHECK_EVERY = 8


@dataclasses.dataclass
class NUTSState:
    position: torch.Tensor  # (n, d)
    log_density: torch.Tensor  # (n,)
    grad: torch.Tensor  # (n, d)


@dataclasses.dataclass
class NUTSInfo:
    accept_prob: torch.Tensor  # (n,) mean leaf accept prob (dual averaging's statistic)
    num_steps: torch.Tensor  # (n,) int32 leapfrog steps taken this transition
    depth: torch.Tensor  # (n,) int32 tree depth reached
    divergent: torch.Tensor  # (n,) bool
    turning: torch.Tensor  # (n,) bool


def init(position, log_density_fn):
    ld, g = value_and_grad(log_density_fn)(position)
    return NUTSState(position=position, log_density=ld, grad=g)


def _popcount(i: int) -> int:
    return bin(i).count("1")


def _trailing_ones(i: int) -> int:
    return _popcount(((i + 1) & ~i) - 1)


def _where(mask, a, b):
    """Per chain, the point ``a`` where ``mask`` (n,) holds, else ``b``:
    tuples (q, p, log π, ∇log π) of the tree's edges and proposals."""
    col = mask[:, None]
    return (torch.where(col, a[0], b[0]), torch.where(col, a[1], b[1]),
            torch.where(mask, a[2], b[2]), torch.where(col, a[3], b[3]))


def build_kernel(log_density_fn, step_size, max_depth=10, inv_mass=None,
                 divergence_threshold=_MAX_DELTA_ENERGY):
    """``inv_mass``: None (unit mass) or (d,) diagonal M⁻¹; ``step_size`` a
    float or a 0-d tensor."""
    vg = value_and_grad(log_density_fn)

    def transition(state, z, go_right, u_merge, u_sel):
        """From the standard normals ``z`` (n, d) of the momenta, each
        doubling's direction (``go_right`` (n, max_depth) bool) and merge
        uniform (``u_merge`` (n, max_depth)), and each leaf's selection
        uniform (``u_sel`` (n, 2^max_depth − 1): doubling j's leaf i in
        column 2^j − 1 + i)."""
        q0 = state.position
        n = q0.shape[0]
        im = q0.new_ones(q0.shape[1]) if inv_mass is None else inv_mass
        p0 = z / torch.sqrt(im)

        def energy(ld, p):
            return -ld + 0.5 * torch.sum(im * p * p, dim=-1)

        h0 = energy(state.log_density, p0)

        def leapfrog_one(pt, direction):
            q, p, _, g = pt
            eps = (direction * step_size)[:, None]
            p_half = p + 0.5 * eps * g
            q_new = q + eps * im * p_half
            ld_new, g_new = vg(q_new)
            p_new = p_half + 0.5 * eps * g_new
            return q_new, p_new, ld_new, g_new

        def build_subtree(edge, depth, direction, u_leaf, live):
            """2^depth leapfrog steps from ``edge`` for the chains ``live``;
            the others' results are not read. Returns (the new edge, the
            subtree's proposal, log Σ weights, Σ p, turning, divergent,
            Σ accept prob, leaves done)."""
            ckpt_p = q0.new_zeros((n, max_depth + 1, q0.shape[1]))
            ckpt_rsum = torch.zeros_like(ckpt_p)
            cur = prop = edge
            log_w_sum = torch.full_like(h0, -torch.inf)
            r_cum = torch.zeros_like(q0)
            turning = torch.zeros_like(live)
            divergent = torch.zeros_like(live)
            sum_ap = torch.zeros_like(h0)
            leaves = torch.zeros(n, dtype=torch.int32, device=q0.device)
            for i in range(1 << depth):
                if i and i % CHECK_EVERY == 0 and not bool(live.any()):
                    break
                new = leapfrog_one(cur, direction)
                delta_h = energy(new[2], new[1]) - h0
                # a NaN energy (an overflowed leapfrog) counts as a divergence
                delta_h = torch.where(torch.isnan(delta_h), torch.inf, delta_h)
                log_w = -delta_h
                div_new = delta_h > divergence_threshold
                # progressive multinomial sampling within the subtree
                log_w_sum_new = torch.logaddexp(log_w_sum, log_w)
                take = torch.log(u_leaf[:, i]) < (log_w - log_w_sum_new)
                prop = _where(live & take, new, prop)
                p = new[1]
                r_cum_new = r_cum + p
                slot = _popcount(i)
                if i % 2 == 0:  # checkpoint at the even leaves
                    ckpt_p[:, slot] = torch.where(live[:, None], p, ckpt_p[:, slot])
                    ckpt_rsum[:, slot] = torch.where(live[:, None], r_cum, ckpt_rsum[:, slot])
                # the spans completing at leaf i: slots [popcount - K, popcount)
                k = _trailing_ones(i)
                if k:
                    span_r = r_cum_new[:, None, :] - ckpt_rsum[:, slot - k:slot]
                    t_left = torch.sum(span_r * (im * ckpt_p[:, slot - k:slot]), dim=-1) < 0.0
                    t_right = torch.sum(span_r * (im * p)[:, None, :], dim=-1) < 0.0
                    turn_new = torch.any(t_left | t_right, dim=-1)
                else:
                    turn_new = torch.zeros_like(live)
                cur = _where(live, new, cur)
                log_w_sum = torch.where(live, log_w_sum_new, log_w_sum)
                r_cum = torch.where(live[:, None], r_cum_new, r_cum)
                turning = turning | (live & turn_new)
                divergent = divergent | (live & div_new)
                sum_ap = torch.where(live, sum_ap + torch.exp(torch.clamp(-delta_h, max=0.0)),
                                     sum_ap)
                leaves = leaves + live.to(torch.int32)
                live = live & ~turn_new & ~div_new
            return cur, prop, log_w_sum, r_cum, turning, divergent, sum_ap, leaves

        left = right = prop = (q0, p0, state.log_density, state.grad)
        log_w_tree = torch.zeros_like(h0)  # the initial state's log weight
        r_sum = p0
        terminated = torch.zeros(n, dtype=torch.bool, device=q0.device)
        divergent = torch.zeros_like(terminated)
        num_steps = torch.zeros(n, dtype=torch.int32, device=q0.device)
        depth = torch.zeros_like(num_steps)
        sum_ap = torch.zeros_like(h0)
        for j in range(max_depth):
            active = ~terminated  # the chains at depth j
            if j and not bool(active.any()):
                break
            right_dir = go_right[:, j]
            direction = torch.where(right_dir, 1.0, -1.0).to(q0.dtype)
            edge = _where(right_dir, right, left)
            end, prop_sub, log_w_sub, r_sum_sub, turning_sub, div_sub, ap_sub, leaves = (
                build_subtree(edge, j, direction, u_sel[:, (1 << j) - 1:(2 << j) - 1], active))
            left = _where(active & ~right_dir, end, left)
            right = _where(active & right_dir, end, right)
            ok = ~turning_sub & ~div_sub
            # biased progressive merge: the subtree's proposal w.p. min(1, W_sub / W_tree)
            take = (torch.log(u_merge[:, j]) < (log_w_sub - log_w_tree)) & ok
            prop = _where(active & take, prop_sub, prop)
            log_w_tree = torch.where(active & ok, torch.logaddexp(log_w_tree, log_w_sub),
                                     log_w_tree)
            r_sum = torch.where(active[:, None], r_sum + r_sum_sub, r_sum)
            turning_tree = ((torch.sum(r_sum * (im * left[1]), dim=-1) < 0.0)
                            | (torch.sum(r_sum * (im * right[1]), dim=-1) < 0.0))
            terminated = torch.where(active, turning_sub | div_sub | turning_tree, terminated)
            num_steps = num_steps + torch.where(active, leaves, 0)
            divergent = divergent | (active & div_sub)
            sum_ap = torch.where(active, sum_ap + ap_sub, sum_ap)
            depth = depth + active.to(torch.int32)

        q, _, ld, g = prop
        accept_prob = torch.where(num_steps > 0, sum_ap / torch.clamp(num_steps, min=1),
                                  torch.zeros_like(sum_ap))
        info = NUTSInfo(accept_prob=accept_prob, num_steps=num_steps, depth=depth,
                        divergent=divergent, turning=terminated & ~divergent)
        return NUTSState(position=q, log_density=ld, grad=g), info

    def kernel(generator, state):
        """One transition, its draws from ``generator``; counts one
        ``scan_nuts_step``."""
        pos = state.position
        n, dev = pos.shape[0], pos.device
        count_step("scan_nuts_step", dev)
        z = normals(generator, pos.shape, dev)
        go_right = uniforms(generator, (n, max_depth), dev) < 0.5
        u_merge = uniforms(generator, (n, max_depth), dev)
        u_sel = uniforms(generator, (n, (1 << max_depth) - 1), dev)
        return transition(state, z, go_right, u_merge, u_sel)

    kernel.transition = transition
    return kernel
