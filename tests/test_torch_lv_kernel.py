"""The Lotka–Volterra misfit of the ODE configs (``models/ode.py``
``LotkaVolterraMisfit``) and its kernel's side on the CPU
(``ops/lv_rk4.py``; the kernel, ``csrc/lv_rk4.cu``
``lv_misfit_grad_kernel``, runs only on the card: ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold it against the plain version there).

On the CPU: the misfit routes a CPU tensor to the plain version
(``misfit_potential`` of the RK4 forward, bit for bit what the configs
computed before the kernel, and counted as ``lv_misfit_plain``) and refuses
to launch the kernel for it; the spec the kernel takes (the observations
sorted by step, the step sizes rounded as the plain version rounds them) and
what it refuses; the ctypes mirror of ``IpxLvSpec``; and the kernel's
algorithm, the discrete adjoint of RK4 as ``adjoint_reference`` spells it
out, against autograd through the plain version. Tolerances: in float64
both sides are the same function, so Φ within 1e-12 and ∇Φ within 1e-10 of
each chain's largest entry (measured 3.6e-15 / 3.1e-15); in f32 the adjoint's
own roundings against autograd's, Φ within 1e-6 relative and ∇Φ within
2e-5 of each chain's largest entry (measured 3.7e-7 and 1.2e-6)."""

import pathlib
import re

import numpy as np
import pytest
import torch

from ip_mcmc_tpu_torch import configs, potentials
from ip_mcmc_tpu_torch import distributions as dist
from ip_mcmc_tpu_torch.models import ode
from ip_mcmc_tpu_torch.ops import _build, lv_rk4

torch.set_num_threads(1)

ODE = ("ode_mala", "ode_hmc", "ode_nuts", "ode_chees")


def _thetas(batch=8, seed=0, dtype=np.float32):
    th = (0.3 * np.random.default_rng(seed).standard_normal((batch, 4))).astype(dtype)
    th[batch // 2:] *= 2.0
    return torch.tensor(th)


def _rel(got, want):
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())


@pytest.fixture(scope="module")
def misfit():
    return configs.build("ode_mala", "cpu").potential_fn


@pytest.mark.parametrize("name", ODE)
def test_configs_route_through_the_misfit(name):
    """Every ODE config's potential is the misfit, on the configs' forward
    (200 steps of 0.05, both species every 10 steps, σ 0.1)."""
    pot = configs.build(name, "cpu").potential_fn
    assert isinstance(pot, ode.LotkaVolterraMisfit)
    spec = pot.spec
    assert (spec.n_steps, spec.dt, spec.obs_step.tolist()) == (200, 0.05, list(range(10, 201, 10)))
    assert spec.species.tolist() == [0, 1] and torch.all(spec.noise == 0.1)


def test_cpu_runs_the_plain_version_bit_for_bit(misfit):
    """On a CPU tensor: potentials.misfit_potential of the forward, as the
    configs computed it before the kernel, the gradient by autograd; counted
    as a plain launch."""
    fx = np.load(configs.LV_FIXTURE)
    fwd = ode.make_lotka_volterra_forward(configs.LV_Y0, configs.LV_DT, configs.LV_STEPS,
                                          configs.LV_OBS)
    ref = potentials.misfit_potential(fwd, torch.tensor(fx["y"]), dist.DiagGaussian(
        mean=torch.zeros(40), scale=0.1 * torch.ones(40)))
    th = _thetas().requires_grad_(True)
    before = _build.launch_counts[ode.PLAIN]
    got = misfit(th)
    assert _build.launch_counts[ode.PLAIN] == before + 1
    assert torch.equal(got, ref(th))
    (g,) = torch.autograd.grad(got.sum(), th)
    (g_ref,) = torch.autograd.grad(ref(th).sum(), th)
    assert torch.equal(g, g_ref)
    v, g2 = misfit.plain_value_and_grad(th)
    assert torch.equal(v, got.detach()) and torch.equal(g2, g)


def test_the_kernel_entry_refuses_cpu_tensors(misfit):
    with pytest.raises(ValueError, match="runs on the card"):
        lv_rk4.misfit_and_grad(_thetas(), misfit.spec)
    with pytest.raises(ValueError, match="runs on the card"):
        lv_rk4.LvMisfitFunction.apply(_thetas(), misfit.spec)


def test_spec_sorts_the_observations_and_rounds_as_the_plain_version():
    """Observations given out of order (and a species alone) are sorted by
    step with their data rows; 0.5 dt, dt and dt / 6 are the plain
    version's f32 alphas, z0 its f32 log."""
    spec = lv_rk4.LvSpec.build([1.0, 0.5], 0.05, 40, [30, 10, 40, 10], [1],
                               [3.0, 1.0, 4.0, 2.0], [0.3, 0.1, 0.4, 0.2], "cpu")
    assert spec.obs_step.tolist() == [10, 10, 30, 40]
    assert spec.data[:, 0].tolist() == pytest.approx([1.0, 2.0, 3.0, 4.0])
    assert spec.noise[:, 0].tolist() == pytest.approx([0.1, 0.2, 0.3, 0.4])
    c = spec.c_struct
    assert (c.half_dt, c.dt, c.dt6) == (np.float32(0.025), np.float32(0.05),
                                        np.float32(0.05 / 6.0))
    assert (c.n_steps, c.T, c.S) == (40, 4, 1)
    assert list(c.z0) == torch.log(torch.tensor([1.0, 0.5])).tolist()


@pytest.mark.parametrize("bad, match", [
    (dict(n_steps=0), "n_steps >= 1"),
    (dict(dt=0.0), "dt > 0"),
    (dict(obs=[10, 41]), r"lie in \[0, 40\]"),
    (dict(obs=[-1]), r"lie in \[0, 40\]"),
    (dict(species=[0, 2]), "species must be 0 or 1"),
])
def test_spec_refuses_what_the_kernel_does_not_take(bad, match):
    kw = dict(n_steps=40, dt=0.05, obs=[10, 20], species=[0, 1])
    kw.update(bad)
    m = len(kw["obs"]) * len(kw["species"])
    with pytest.raises(ValueError, match=match):
        lv_rk4.LvSpec.build([1.0, 0.5], kw["dt"], kw["n_steps"], kw["obs"], kw["species"],
                            np.ones(m), np.ones(m), "cpu")


def test_ctypes_spec_mirrors_the_c_struct():
    """_build.LvSpec's fields, in order, are IpxLvSpec's."""
    src = (pathlib.Path(_build.CSRC) / "lv_rk4.cu").read_text()
    body = re.search(r"struct IpxLvSpec \{(.*?)\};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            names += [re.sub(r"\[.*\]", "", n.strip().lstrip("*")).split()[-1].lstrip("*")
                      for n in decl.split(",")]
    assert names == [f[0] for f in _build.LvSpec._fields_]


def _misfit_on(obs, species=(0, 1), n_steps=40):
    """A misfit of the configs' kind on ``obs`` (any order, repeats) with
    data from the truth's forward plus noise."""
    rng = np.random.default_rng(4)
    fwd = ode.make_lotka_volterra_forward([1.0, 0.5], 0.05, n_steps, obs, species)
    y = fwd(torch.tensor([[0.1, -0.2, 0.05, 0.3]])).numpy()[0]
    y = y + 0.05 * rng.standard_normal(y.shape).astype(np.float32)
    m = len(y)
    noise = dist.DiagGaussian(mean=torch.zeros(m),
                              scale=torch.tensor(rng.uniform(0.05, 0.2, m).astype(np.float32)))
    return ode.LotkaVolterraMisfit([1.0, 0.5], 0.05, n_steps, obs, torch.tensor(y), noise,
                                   species)


@pytest.mark.parametrize("which", ["configs", "unsorted", "one species"])
def test_adjoint_reference_is_the_gradient(misfit, which):
    """The kernel's algorithm against autograd through the plain version:
    float64 (the same function) and f32."""
    pot = {"configs": misfit, "unsorted": _misfit_on([30, 0, 40, 10, 30]),
           "one species": _misfit_on([40, 20, 5], species=(1,))}[which]
    for dtype, phi_tol, grad_tol in ((np.float64, 1e-12, 1e-10), (np.float32, 1e-6, 2e-5)):
        th = _thetas(dtype=dtype)
        want_v, want_g = pot.plain_value_and_grad(th)
        got_v, got_g = lv_rk4.adjoint_reference(th, pot.spec)
        assert float(((got_v - want_v).abs() / want_v.abs()).max()) <= phi_tol
        assert _rel(got_g, want_g) <= grad_tol
