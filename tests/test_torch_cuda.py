"""The CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU (and nvcc: the kernels build at first use); they
skip elsewhere. On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

chip_smoke.py runs the same comparisons at the main path's full width.
"""

import pytest
import torch

from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.ops import _build
from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

pytestmark = pytest.mark.cuda


@pytest.fixture
def problem():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return configs.build("darcy_da_fused", "cuda")


def test_misfit_kernel_matches_plain(problem):
    g = torch.Generator().manual_seed(0)
    U = problem.prior.sample(g, 512).T.contiguous()
    for pot in (problem.batched_potential_fn, problem.batched_surrogate_fn):
        name = f"darcy_misfit_kernel[n={pot.n}]"
        before = _build.launch_counts[name]
        got = pot(U)
        assert _build.launch_counts[name] == before + 1
        ref = pot._forward_plain(U)
        rel = ((got - ref).abs() / ref.abs()).cpu()
        # bf16 rounding flips: see tests/test_torch_darcy.py
        assert float(rel.median()) <= 2e-6
        assert float((rel <= 1e-5).double().mean()) >= 0.80
        assert float(rel.max()) <= 5e-3


@pytest.mark.parametrize("record", [False, True])
def test_fused_kernel_matches_plain(problem, record):
    g = torch.Generator().manual_seed(1)
    pos = problem.init_positions(g, 512).cuda()
    args = (problem.batched_potential_fn, problem.batched_surrogate_fn, pos,
            problem.prior.mean, problem.prior.scale, 0.35, 3)
    kw = dict(n_steps=4, subchain_len=6, block_chains=128)
    if record:
        got = da.fused_da_pcn_chain_recorded(*args, thin=2, **kw)
        ref = da._run_plain_recorded(*args, thin=2, **kw)
        assert got[2].shape == ref[2].shape == (2, 512, 64)
    else:
        got = da.fused_da_pcn_chain(*args, **kw)
        ref = da._run_plain(*args, **kw)
    dev = (got[0] - ref[0]).abs().max(dim=1).values
    assert float((dev <= 1e-4).double().mean()) >= 0.99
    assert abs(float(got[1].mean()) - float(ref[1].mean())) <= 1e-2


def test_kernel_refuses_plain_callables(problem):
    pos = torch.zeros(64, 64, device="cuda")
    with pytest.raises(TypeError, match="DarcyMisfit"):
        da.fused_da_pcn_chain(lambda U: U.sum(0), problem.batched_surrogate_fn,
                              pos, problem.prior.mean, problem.prior.scale,
                              0.35, 0, n_steps=1, block_chains=64)
