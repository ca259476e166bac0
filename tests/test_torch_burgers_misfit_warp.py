"""K12, the standalone Burgers misfit, a draw a warp
(``burgers_misfit_warp_kernel`` in ``csrc/fused_da3_pcn.cu``, on the Burgers
samplers' solve ``burgers_phi_warp``): which levels the card sends to it and
which to the one-draw-a-CTA ``burgers_misfit_kernel`` (the Python mirror
``_burgers_warp.misfit_takes`` of the C rule ``burgers_warp_takes(s, s.K)``),
the launch-count names, the launch geometry's mirror (the card tests and
chip_smoke.py hold it against ``ipx_burgers_misfit_warp_geometry``), the
mirror's constants against the C design line, and the plain version, which
counts a plain launch. The order in which the warp solve adds Φ over the old
CTA's threads is mirrored in NumPy by ``tests/test_torch_burgers_warp.py``;
the plain version is held against JAX by ``tests/test_torch_burgers.py``."""

import re

import numpy as np
import pytest
import torch

from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.configs import burgers_misfit_from_arrays
from ip_mcmc_tpu_torch.models import burgers
from ip_mcmc_tpu_torch.ops import _build, _burgers_warp

torch.set_num_threads(1)

WARP, CTA = "burgers_misfit_warp_kernel", "burgers_misfit_kernel"
# (config, level) -> (cells, the Godunov steps of each segment)
SHIPPED = {
    ("burgers_da3_pcn", "fine"): (128, "154"),
    ("burgers_da3_pcn", "mid"): (128, "52"),
    ("burgers_da3_pcn", "coarse"): (64, "26"),
    ("burgers_da_pcn", "fine"): (128, "154"),
    ("burgers_da_pcn", "coarse"): (64, "26"),
    ("burgers_pcn", "fine"): (128, "154"),
    ("burgers_multitime_pcn", "fine"): (128, "54+54+46"),
}


def _level(config, level):
    p = configs.build(config, "cpu")
    return {"fine": p.batched_potential_fn, "mid": p.batched_mid_fn,
            "coarse": p.batched_surrogate_fn}[level]


def _hand_made(n_cells, n_modes=16, m=16):
    """A Burgers misfit of no config: t = 0.2, m observed cells, zero data."""
    obs = np.linspace(0, n_cells - 1, m).round().astype(int)
    aux = burgers.burgers_aux(n_cells=n_cells, n_modes=n_modes, alpha=1.5, field_scale=1.0,
                              t_final=0.2, obs_indices=obs)
    return burgers_misfit_from_arrays(aux, np.zeros(m, np.float32), 0.02)


def _padded(pot):
    """A copy of ``pot`` by hand with a 17th KL mode of zeros."""
    basis = np.vstack([pot.basis.numpy(), np.zeros((1, pot.n), np.float32)])
    return burgers.BurgersMisfit(basis, pot.mean.numpy(), pot.obs.numpy(), pot.data.numpy(),
                                 pot.noise.numpy(), pot.n, pot.dt_over_h / pot.n, pot.segments)


# --- what the rule takes and leaves ------------------------------------------------


@pytest.mark.parametrize("config, level", sorted(SHIPPED))
def test_rule_takes_every_shipped_level(config, level):
    """Each level of the four Burgers configs (64 or 128 cells, K = 16):
    the rule takes it and the label names the kernel a draw a warp."""
    pot = _level(config, level)
    cells, steps = SHIPPED[config, level]
    assert (pot.n, pot.K) == (cells, 16)
    assert _burgers_warp.misfit_takes(pot.n, pot.K)
    assert pot.kernel_label == f"{WARP}[n={cells},steps={steps}]"


@pytest.mark.parametrize("cells, n_modes", [(96, 16), (32, 16), (256, 16), (128, 8), (64, 8)])
def test_rule_leaves_other_levels(cells, n_modes):
    """Other cell counts and K != 16 stay on the one-draw-a-CTA kernel: the
    mirror refuses them and the label names that kernel."""
    pot = _hand_made(cells, n_modes)
    assert not _burgers_warp.misfit_takes(pot.n, pot.K)
    with pytest.raises(ValueError, match="Burgers warp misfit kernel takes"):
        _burgers_warp.misfit_geometry(64, pot.n, pot.K)
    assert pot.kernel_label.startswith(f"{CTA}[n={cells},")


def test_rule_leaves_a_hand_made_level_of_17_modes():
    """The fine level with a 17th mode of zeros, built by hand (the card
    holds the new kernel bit for bit against the old one on it): K = 17,
    so the old kernel takes it, under the old name."""
    pot = _padded(_level("burgers_pcn", "fine"))
    assert (pot.n, pot.K) == (128, 17)
    assert not _burgers_warp.misfit_takes(pot.n, pot.K)
    assert pot.kernel_label == f"{CTA}[n=128,steps=154]"


# --- the geometry --------------------------------------------------------------------

# 4 bytes × (the level's basis and mean, 17 rows of its cells, + 16 warps ×
# (16 coefficients + the gather buffer of its cells))
SMEM = {128: 4 * (17 * 128 + 16 * (16 + 128)), 64: 4 * (17 * 64 + 16 * (16 + 64))}


@pytest.mark.parametrize("cells", [128, 64])
@pytest.mark.parametrize("B, ctas", [(2048, 128), (2047, 128), (13, 1), (1, 1), (0, 0)])
def test_geometry(cells, B, ctas):
    """16 draws a CTA: the configs' 2048 draws on 128 CTAs, a ragged 2047
    (15 live warps in the last CTA), 13 (3 spare warps), 1, none; 17,920
    bytes at 128 cells, 9,472 at 64."""
    assert SMEM == {128: 17_920, 64: 9_472}
    assert _burgers_warp.misfit_geometry(B, cells) == (16, ctas, SMEM[cells])
    assert SMEM[cells] <= _burgers_warp.MAX_SMEM_BYTES


def test_geometry_refuses_a_negative_width():
    with pytest.raises(ValueError, match="B -1"):
        _burgers_warp.misfit_geometry(-1, 128)


def test_mirror_constants_follow_the_design_line():
    """MISFIT_WARP_DRAWS is the C design line's kWarps, and the kernel the
    labels name is the source's."""
    src = (_build.CSRC / "fused_da3_pcn.cu").read_text()
    m = re.search(r"struct MisfitBurgersWarpDesign \{ static constexpr int kWarps = (\d+), "
                  r"kSmWarps = \d+; \};", src)
    assert m is not None and int(m.group(1)) == _burgers_warp.MISFIT_WARP_DRAWS
    assert f"{_burgers_warp.MISFIT_WARP_KERNEL}(const __grid_constant__" in src


# --- the plain version on the CPU ----------------------------------------------------


@pytest.mark.parametrize("config, level", [("burgers_da3_pcn", "coarse"),
                                           ("burgers_multitime_pcn", "fine")])
def test_plain_version_runs_on_the_cpu_and_counts_itself(config, level):
    """On CPU tensors a level the rule takes runs its plain version: finite
    Φ of the batch's width, one plain launch counted under the plain name,
    none under the kernel's."""
    pot = _level(config, level)
    U = torch.randn(16, 5, generator=torch.Generator().manual_seed(0))
    before = dict(_build.launch_counts)
    phi = pot(U)
    assert phi.shape == (5,) and bool(torch.isfinite(phi).all())
    plain = pot.kernel_label.replace(WARP, "burgers_misfit_plain")
    assert _build.launch_counts[plain] == before.get(plain, 0) + 1
    assert _build.launch_counts[pot.kernel_label] == before.get(pot.kernel_label, 0)


def test_a_zero_mode_leaves_the_plain_phi_as_it_is():
    """The padded level on U with a row of zeros gives the level's Φ (the
    check the card makes bit for bit, here within f32 rounding of the KL
    product's order)."""
    pot = _level("burgers_da_pcn", "fine")
    U = torch.randn(16, 7, generator=torch.Generator().manual_seed(1))
    U17 = torch.cat([U, torch.zeros(1, 7)])
    torch.testing.assert_close(_padded(pot)(U17), pot(U), rtol=1e-5, atol=0.0)
