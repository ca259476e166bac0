"""The launch scaffold of the fused samplers (K2, K3; mirrors
``ip_mcmc_tpu/ops/fused_mcmc.py`` ``_run_fused`` l.152 and
``_run_fused_recorded`` l.826), plain PyTorch, and what the samplers'
wrappers share.

``run_plain`` is one loop for every sampler. It takes a step builder as the
JAX scaffold does: ``step_builder(pot, *params) -> (init, step)`` with
``init(pos) -> carry`` (``carry[0]`` is the (d, n) position) and
``step(carry, rand_n, rand_u) -> (carry, accepted (1, n))``. ``rand_n(shape,
tag)`` draws normals with the keys ``tag`` and ``tag + 1``, ``rand_u(shape,
tag)`` uniforms with the key ``tag``, both from the counter-hash stream of
``ops/rng.py``; ``shape`` is (rows, n), and column c holds what the JAX
kernel draws for chain c: element ``lane`` of its block's (rows,
block_chains) tile under the block's seed uint32(seed + 7919·block). A
draw of shape (rows, 1) is one number per block (the JAX kernel's
``rand_u((1, 1), tag)``): it comes back as (rows, n), every chain holding
its block's number. All chains step together, so there is no loop over
blocks, and a ragged last block is taken: chain c's draws depend on its
block and lane only. The step counter restarts at 0 in each launch. A
builder's ``extra_out(carry)`` gives a third per-chain output.

The CUDA side of the same scaffold is ``csrc/fused_scaffold.cuh``.
"""

from __future__ import annotations

import torch

from ip_mcmc_tpu_torch.ops import _build, rng


def as_param(x, device):
    return torch.as_tensor(x, dtype=torch.float32).to(device).contiguous()


def contraction(beta):
    """(β, √(1 − β²)) in f32, as the JAX step builders compute them."""
    b = torch.as_tensor(beta, dtype=torch.float32)
    return b, torch.sqrt(1.0 - b * b)


def validate(positions, n_steps, block_chains, thin=None, whole_blocks=True):
    """What every entry point checks. ``whole_blocks`` False lets a ragged
    last block through: the plain scaffold takes one, as the twin of a
    kernel launched on a ragged width (the entry points refuse it)."""
    if positions.dtype != torch.float32 or positions.dim() != 2:
        raise ValueError(
            f"positions: expected f32 (n_chains, d), got {positions.dtype} "
            f"{tuple(positions.shape)}"
        )
    n = positions.shape[0]
    if whole_blocks and n % block_chains:
        raise ValueError(
            f"n_chains {n} must be a multiple of block_chains {block_chains}"
        )
    if thin is not None and n_steps % thin:
        raise ValueError(f"n_steps {n_steps} must be a multiple of thin {thin}")


def on_device(positions, kernel, plain):
    """``kernel`` for CUDA positions, ``plain`` for CPU positions: the
    plain version runs only because the tensor lies on the CPU."""
    kind = positions.device.type
    if kind == "cuda":
        return kernel
    if kind == "cpu":
        return plain
    raise ValueError(f"unsupported device {positions.device}")


# --- the plain scaffold -------------------------------------------------------


def run_plain(step_builder, potential_fn, positions, params, seed, n_steps,
              block_chains, thin=None):
    """(final (n, d), acceptance mean (n,), extra (n,) or None, samples
    (n_steps // thin, n, d) or None when ``thin`` is None)."""
    validate(positions, n_steps, block_chains, thin, whole_blocks=False)
    n, d = positions.shape
    dev = positions.device
    bseed, lane = rng.block_seeds(seed, n, block_chains, dev)

    def tile_index(shape):
        rows, cols = shape
        if cols == 1:  # per block: elements 0..rows of a (rows, 1) tile
            return torch.arange(rows, device=dev)[:, None].expand(rows, n)
        if cols != n:
            raise ValueError(f"draw of {cols} columns for {n} chains")
        return torch.arange(rows, device=dev)[:, None] * block_chains + lane

    step_init, step = step_builder(
        potential_fn, *(as_param(p, dev) for p in params)
    )
    carry = step_init(positions.T.contiguous())
    acc = torch.zeros((1, n), dtype=torch.float32, device=dev)
    records = []
    for i in range(n_steps):

        def rand_u(shape, tag, i=i):
            return rng.uniform_from_bits(
                rng.hash_bits(rng.mix_key(bseed, i, tag), tile_index(shape))
            )

        def rand_n(shape, tag, i=i):
            half = ((shape[0] + 1) // 2, shape[1])
            z = rng.normal_from_uniforms(rand_u(half, tag), rand_u(half, tag + 1))
            return z[: shape[0]]

        carry, accepted = step(carry, rand_n, rand_u)
        acc = acc + accepted.to(torch.float32)
        if thin and (i + 1) % thin == 0:
            records.append(carry[0].T)
    extra_out = getattr(step_builder, "extra_out", None)
    extra = None if extra_out is None else extra_out(carry)
    samples = None
    if thin is not None:
        samples = (torch.stack(records) if records
                   else positions.new_empty((0, n, d)))
    return carry[0].T.contiguous(), acc[0] / n_steps, extra, samples


# --- what the kernels' wrappers share -----------------------------------------


def require_family(pots: dict, families=("darcy",), warm=False,
                   richardson=()) -> str:
    """The family of a launch's potentials, ``"darcy"``, ``"burgers"`` or
    ``"linear"``.

    A CUDA kernel cannot inline a Python callable: it is compiled per
    family of misfit module, and every potential of one launch is of one
    family. ``pots`` maps argument names to potentials; ``families`` are
    those the kernel is instantiated for. Cold samplers (``warm`` False)
    take a ``DarcyMisfit``, a ``BurgersMisfit`` or a
    ``LinearGaussianPotential``, warm pCN (True) a ``DarcyMisfitWarm``, warm
    MALA (``"mala"``) a ``DarcyMisfitMalaWarm``. The Darcy kernels solve by
    CG; ``richardson`` names the arguments that may instead be solved by
    K17's Richardson iteration (the delayed-acceptance surrogate). Raises
    ``TypeError`` for anything else and for a mixed launch."""
    # imported here: the models import ops._build
    from ip_mcmc_tpu_torch.models import burgers, darcy, linear

    carried = (darcy.DarcyMisfitWarm, darcy.DarcyMisfitMalaWarm)
    if warm:
        classes = {"darcy": carried[1] if warm == "mala" else carried[0]}
    else:
        classes = {"burgers": burgers.BurgersMisfit, "darcy": darcy.DarcyMisfit,
                   "linear": linear.LinearGaussianPotential}
    # named in this order, the Darcy misfit last: a refusal names every
    # family the kernel takes
    classes = {f: classes[f] for f in ("linear", "burgers", "darcy") if f in families}
    wanted = " or ".join(c.__name__ for c in classes.values())
    found = {}
    for name, pot in pots.items():
        family = next((f for f, c in classes.items() if isinstance(pot, c)), None)
        if family is None or (not warm and isinstance(pot, carried)):
            raise TypeError(
                f"{name}: the CUDA kernel takes {wanted} potentials only, "
                f"got {type(pot).__name__}"
            )
        found[name] = family
        solver = getattr(pot, "solver", "cg")
        if solver != "cg" and name not in richardson:
            raise TypeError(
                f"{name}: this CUDA kernel solves a Darcy misfit by CG, got "
                f"solver={solver!r} (Richardson runs in the standalone misfit "
                "kernel and as a delayed-acceptance surrogate)"
            )
    if len(set(found.values())) != 1:
        raise TypeError(
            f"the potentials of one launch must be of one family, got {found}"
        )
    return family


def linear_route(d, *pots):
    """The kernel that cold pCN, DA-pCN, three-level DA, ESS, FES and cold
    MALA send linear-Gaussian levels ``pots`` to for chains of d
    coordinates, as ``linear_cta_takes`` in ``csrc/gaussian_potential.cuh``
    decides (each sampler's ``ipx_*_linear_route``): "cta", one chain a
    CTA, when every level has K = d, a thread a coordinate up to
    ``LinearGaussianPotential.MAX_DIM``; None (refused) else."""
    from ip_mcmc_tpu_torch.models.linear import LinearGaussianPotential

    ok = 0 < d <= LinearGaussianPotential.MAX_DIM and all(p.K == d and p.m >= 0 for p in pots)
    return "cta" if ok else None


def require_linear_route(sampler, d, *pots):
    """Raises ``ValueError`` before any launch where ``linear_route``
    refuses."""
    from ip_mcmc_tpu_torch.models.linear import LinearGaussianPotential

    if linear_route(d, *pots) is None:
        raise ValueError(
            f"the {sampler} kernel takes linear-Gaussian levels with K = d up to "
            f"{LinearGaussianPotential.MAX_DIM}; got K = {[p.K for p in pots]}, d = {d}")


def chain_args(positions, prior_mean, prior_scale, seed, n_steps,
               block_chains, thin=None, in_place=False):
    """Allocate a launch's outputs and fill the C view ``ChainArgs``.
    Returns (args, keep): ``keep`` is (positions, mean, scale, out, acc,
    samples or None), the tensors ``args`` points into. ``in_place``: for a
    kernel that updates ``positions`` itself and counts its acceptances
    elsewhere; ``out`` and ``acc`` are then None (null in ``args``)."""
    n, d = positions.shape
    dev = positions.device
    positions = positions.contiguous()
    mean, scale = as_param(prior_mean, dev), as_param(prior_scale, dev)
    if mean.shape != (d,) or scale.shape != (d,):
        raise ValueError(f"prior mean/scale must have shape ({d},)")
    out = acc = samples = None
    if not in_place:
        out = torch.empty_like(positions)
        acc = torch.empty(n, dtype=torch.float32, device=dev)
    if thin is not None:
        samples = torch.empty((n_steps // thin, n, d), dtype=torch.float32,
                              device=dev)
    args = _build.ChainArgs(
        pos_in=positions.data_ptr(), mean=mean.data_ptr(),
        scale=scale.data_ptr(),
        out=None if out is None else out.data_ptr(),
        acc=None if acc is None else acc.data_ptr(),
        samples=None if samples is None else samples.data_ptr(),
        seed=int(seed), n=n, d=d, n_steps=int(n_steps),
        block_chains=int(block_chains), thin=int(thin or 0),
    )
    return args, (positions, mean, scale, out, acc, samples)


def kernel_name(stem: str, recorded: bool) -> str:
    return f"{stem}<{'true' if recorded else 'false'}>"


# --- the samplers' takes-rules -------------------------------------------------

# The kernel that a sampler's dispatch sends a spec to, by the code its C
# rule returns (``kRoute*`` in ``csrc/fused_scaffold.cuh``; each wrapper's
# ``route`` mirrors its ``ipx_*_route``): the Hopper design a chain a warp
# or G chains a thread-block cluster, one chain a CTA for the rest of the
# domain, and outside it none (the kernel refuses it: not supported).
ROUTES = {0: None, 1: "warp", 2: "cluster", 3: "cta"}
# The Darcy CTA layouts (``Layout16`` / ``Layout32`` / ``Layout64`` in
# ``csrc/darcy_misfit.cuh``): the most cells each takes, its threads.
LAYOUTS = ((256, 256), (1024, 1024), (4096, 512))


def _layout(cells):
    return next((i for i, (most, _) in enumerate(LAYOUTS) if cells <= most), len(LAYOUTS) - 1)


def layout_threads(cells):
    """The threads of the layout that ``with_darcy_layout`` picks for a grid
    of ``cells`` cells (``darcy_layout_threads``)."""
    return LAYOUTS[_layout(cells)][1]


def layout_side(cells):
    """The grid side of that layout's class: 16, 32 or 64."""
    return 16 << _layout(cells)


def cta_spec(*, n, K, precond, modes, solver, d, max_cells, max_d, want="cg"):
    """Whether a one-chain-a-CTA sampler takes a Darcy misfit of these
    fields for chains of d coordinates, as ``darcy_cta_spec`` in
    ``csrc/darcy_misfit.cuh`` decides: an n×n grid of up to ``max_cells``
    cells, K = d up to ``max_d``, a preconditioner the solve knows (Jacobi or
    dense dst with no modes, dst_trunc with some), solved by ``want``."""
    ok = modes > 0 if precond == "dst_trunc" else precond in ("jacobi", "dst") and modes == 0
    return 0 < n * n <= max_cells and K == d and 0 < d <= max_d and ok and solver == want
