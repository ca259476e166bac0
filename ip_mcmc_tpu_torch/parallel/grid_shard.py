"""The Darcy solve with its grid row-sharded over the 'model' axis (mirrors
``ip_mcmc_tpu/parallel/grid_shard.py``).

Each rank of a 'model' group holds a block of rows of the (n, n) field.
The 5-point stencil reaches one row past a block, so a matvec first swaps
one halo row with each neighbour (``batch_isend_irecv``; a block on the
grid's edge gets zeros, as JAX's ``ppermute`` gives), and CG's dot
products are ``all_reduce`` sums over the group. Arrays may carry leading
chain dimensions (c, rows, n): one halo exchange and one ``all_reduce`` of
a (c,) vector serve the whole chain block, as JAX's ``vmap`` batches its
collectives. The field's halo rows (and so its transmissibilities) are
exchanged once a solve; JAX's ``sharded_apply_operator`` exchanges them
every matvec, with the same values.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ip_mcmc_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, make_mesh

__all__ = ["MODEL_AXIS", "make_model_mesh", "sharded_apply_operator", "sharded_solve_cg",
           "solve_cg_local"]


def _halo_exchange_rows(x_local, mesh: Mesh):
    """(row_above, row_below) of a (..., rows, n) block: the previous rank's
    last row (zeros on the first rank of the group) and the next rank's
    first row (zeros on the last)."""
    ranks, j = mesh.model_ranks(), mesh.model_index
    above = torch.zeros_like(x_local[..., 0, :])
    below = torch.zeros_like(x_local[..., 0, :])
    ops = []
    if j > 0:
        ops += [dist.P2POp(dist.isend, x_local[..., 0, :].contiguous(), ranks[j - 1],
                           mesh.model_group),
                dist.P2POp(dist.irecv, above, ranks[j - 1], mesh.model_group)]
    if j + 1 < len(ranks):
        ops += [dist.P2POp(dist.isend, x_local[..., -1, :].contiguous(), ranks[j + 1],
                           mesh.model_group),
                dist.P2POp(dist.irecv, below, ranks[j + 1], mesh.model_group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return above, below


def _psum(x, mesh: Mesh):
    """``x`` summed over the 'model' group (in place; returned)."""
    dist.all_reduce(x, group=mesh.model_group)
    return x


def _transmissibilities(a_local, n: int, mesh: Mesh):
    """t_h (..., rows, n − 1) within rows and t_v (..., rows + 1, n) on the
    faces of the halo-extended block (face k between extended rows k and
    k + 1; 0 where a halo row is a zero, i.e. past the grid's edge)."""
    h2 = float(n * n)
    a_above, a_below = _halo_exchange_rows(a_local, mesh)
    t_h = 2.0 * a_local[..., :, :-1] * a_local[..., :, 1:] / (
        a_local[..., :, :-1] + a_local[..., :, 1:]) * h2
    a_ext = torch.cat([a_above[..., None, :], a_local, a_below[..., None, :]], dim=-2)
    denom = a_ext[..., :-1, :] + a_ext[..., 1:, :]
    safe = torch.where(denom > 0.0, denom, torch.ones_like(denom))
    t_v = torch.where(denom > 0.0, 2.0 * a_ext[..., :-1, :] * a_ext[..., 1:, :] / safe,
                      torch.zeros_like(denom)) * h2
    return t_h, t_v


def _edges(mesh: Mesh):
    j = mesh.model_index
    return j == 0, j == mesh.shape[1] - 1


def _apply(a_local, t_h, t_v, p_local, n: int, mesh: Mesh):
    """A(a) p on the block, given the field's transmissibilities (JAX's
    ``sharded_apply_operator`` arithmetic in its order of additions)."""
    tb = 2.0 * float(n * n)
    first, last = _edges(mesh)
    p_above, p_below = _halo_exchange_rows(p_local, mesh)
    flux_h = t_h * (p_local[..., :, :-1] - p_local[..., :, 1:])
    out = torch.zeros_like(p_local)
    out[..., :, :-1] += flux_h
    out[..., :, 1:] += -flux_h
    p_ext = torch.cat([p_above[..., None, :], p_local, p_below[..., None, :]], dim=-2)
    flux_v = t_v * (p_ext[..., :-1, :] - p_ext[..., 1:, :])
    out = out + flux_v[..., 1:, :] - flux_v[..., :-1, :]
    if first:
        out[..., 0, :] += tb * a_local[..., 0, :] * p_local[..., 0, :]
    if last:
        out[..., -1, :] += tb * a_local[..., -1, :] * p_local[..., -1, :]
    out[..., :, 0] += tb * a_local[..., :, 0] * p_local[..., :, 0]
    out[..., :, -1] += tb * a_local[..., :, -1] * p_local[..., :, -1]
    return out


def sharded_apply_operator(a_local, p_local, n: int, mesh: Mesh):
    """The block of A(a) p (``models.darcy.apply_operator``) for (...,
    rows, n) blocks of a and p."""
    t_h, t_v = _transmissibilities(a_local, n, mesh)
    return _apply(a_local, t_h, t_v, p_local, n, mesh)


def solve_cg_local(a_local, f_local, n: int, mesh: Mesh, n_iters: int = 150):
    """A rank's part of the distributed Jacobi-PCG solve of A(a) x = f:
    ``a_local`` (..., rows, n), ``f_local`` broadcastable to it; returns the
    block of x. Every rank of the 'model' group calls it together (its
    halo swaps and sums are collectives); α = 0 where pAp ≤ 0 and β = 0
    where rz ≤ 0, as JAX's loop."""
    h2 = float(n * n)
    tb = 2.0 * h2
    first, last = _edges(mesh)
    t_h, t_v = _transmissibilities(a_local, n, mesh)
    d = torch.zeros_like(a_local)
    d[..., :, :-1] += t_h
    d[..., :, 1:] += t_h
    d = d + t_v[..., 1:, :] + t_v[..., :-1, :]
    if first:
        d[..., 0, :] += tb * a_local[..., 0, :]
    if last:
        d[..., -1, :] += tb * a_local[..., -1, :]
    d[..., :, 0] += tb * a_local[..., :, 0]
    d[..., :, -1] += tb * a_local[..., :, -1]
    inv_diag = 1.0 / d

    def dot(u, v):
        return _psum(torch.sum(u * v, dim=(-2, -1)), mesh)[..., None, None]

    x = torch.zeros_like(a_local)
    r = f_local.expand_as(a_local)
    z = inv_diag * r
    p = z
    rz = dot(r, z)
    zero = torch.zeros_like(rz)
    for _ in range(n_iters):
        Ap = _apply(a_local, t_h, t_v, p, n, mesh)
        pAp = dot(p, Ap)
        alpha = torch.where(pAp > 0.0, rz / torch.where(pAp > 0.0, pAp, 1.0), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = dot(r, z)
        beta = torch.where(rz > 0.0, rz_new / torch.where(rz > 0.0, rz, 1.0), zero)
        p = z + beta * p
        rz = rz_new
    return x


def sharded_solve_cg(a, f, n: int, mesh: Mesh, n_iters: int = 150):
    """Distributed Jacobi-PCG solve of A(a) x = f over the 'model' axis:
    ``a`` (..., n, n) and ``f`` (n²,) whole on every rank of the group;
    returns the whole solution (..., n²) (the blocks ``all_gather``-ed)."""
    m = mesh.shape[1]
    if n % m:
        raise ValueError(f"n_grid {n} must divide over the {m}-device 'model' axis")
    rows = n // m
    r0 = mesh.model_index * rows
    a = a.to(mesh.device)
    x = solve_cg_local(a[..., r0:r0 + rows, :].contiguous(),
                       f.to(mesh.device).reshape(n, n)[r0:r0 + rows], n, mesh, n_iters)
    parts = [torch.empty_like(x) for _ in range(m)]
    dist.all_gather(parts, x.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=-2).reshape(*a.shape[:-2], n * n)


def make_model_mesh(n_devices=None, device=None) -> Mesh:
    """The 1-D 'model' mesh (1, world): every rank holds rows of one grid.
    ``n_devices`` other than the world's size raises."""
    if n_devices is not None and not dist.is_initialized() and int(n_devices) != 1:
        raise ValueError(f"a model mesh of {n_devices} devices needs a world of "
                         f"{n_devices} processes")
    mesh = make_mesh(1, dist.get_world_size() if dist.is_initialized() else 1, device)
    if n_devices is not None and int(n_devices) != mesh.size:
        raise ValueError(f"a model mesh of {n_devices} devices in a world of {mesh.size}")
    return mesh
