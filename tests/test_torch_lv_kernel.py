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
2e-5 of each chain's largest entry (measured 3.7e-7 and 1.2e-6). The
warp-parallel adjoint's association (``adjoint_scan_reference``) is held to
autograd in float64 with the same bounds (measured 7e-16 / 2e-15).

The rule that sends a spec to ``lv_misfit_grad_kernel`` (its stage
exponentials in shared memory) and its Python mirror are checked here against
the C source's constants; on the card (marked ``cuda``, skipped here) the C
rule and the Python rule agree, a spec the rule leaves runs on
``lv_misfit_grad_states_kernel``, and on the configs' spec no chain's Φ or
∇Φ differs between the two kernels."""

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
        lv_rk4.misfit_and_grad_states(_thetas(), misfit.spec)
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


@pytest.mark.parametrize("which", ["configs", "unsorted", "one species", "fewer steps than lanes"])
def test_adjoint_scan_reference_is_the_gradient(misfit, which):
    """The warp-parallel adjoint's association (lanes' affine maps composed
    by a Hillis–Steele scan, a butterfly sum) against autograd in float64."""
    pot = {"configs": misfit, "unsorted": _misfit_on([30, 0, 40, 10, 30]),
           "one species": _misfit_on([40, 20, 5], species=(1,)),
           "fewer steps than lanes": _misfit_on([0, 5, 20, 13], n_steps=20)}[which]
    th = _thetas(dtype=np.float64)
    want_v, want_g = pot.plain_value_and_grad(th)
    got_v, got_g = lv_rk4.adjoint_scan_reference(th, pot.spec)
    assert float(((got_v - want_v).abs() / want_v.abs()).max()) <= 1e-12
    assert _rel(got_g, want_g) <= 1e-10


def _c_constant(name):
    src = (pathlib.Path(_build.CSRC) / "lv_rk4.cu").read_text()
    return int(re.search(rf"\b{name}\b\s*=\s*(\d+)", src).group(1))


def test_stages_rule_mirrors_the_c_source(misfit):
    """stages_takes / stages_geometry use lv_rk4.cu's constants: two chains
    a CTA, 8 f32 a step and the T · S injections each, a CTA's 232,448
    bytes; with the configs' 40 observed values up to 3,627 steps."""
    import dataclasses

    assert (lv_rk4.STAGES_CHAINS, lv_rk4.STAGE_VALUES, lv_rk4.MAX_SMEM) == (
        _c_constant("kChains"), _c_constant("kLvStageValues"), _c_constant("kLvMaxSmem"))
    steps = lambda k: dataclasses.replace(misfit.spec, n_steps=k)  # noqa: E731
    assert lv_rk4.stages_takes(misfit.spec) and lv_rk4.stages_takes(steps(3627))
    assert not lv_rk4.stages_takes(steps(3628))
    assert lv_rk4.stages_geometry(1024, misfit.spec) == (2, 512, 13120)
    assert lv_rk4.stages_geometry(77, misfit.spec) == (2, 39, 13120)
    with pytest.raises(ValueError, match="3628 steps need 232512"):
        lv_rk4.stages_geometry(256, steps(3628))


@pytest.mark.parametrize("n_steps, kernel, scratch", [
    (200, lv_rk4.KERNEL, False), (3628, lv_rk4.STATES_KERNEL, True)])
def test_wrapper_allocates_the_states_only_for_the_states_kernel(monkeypatch, misfit, n_steps,
                                                                 kernel, scratch):
    """misfit_and_grad passes no scratch (null) for a spec the stages kernel
    takes and counts that kernel; for a spec the rule leaves it allocates
    the (n_steps + 1) · 2n states and counts the states kernel. The forced
    entry always passes the scratch."""
    import dataclasses
    import types

    seen = []

    class Lib:
        def ipx_lv_misfit_grad(self, *a):
            seen.append(("rule", a[3]))
            return 0

        def ipx_lv_misfit_grad_states(self, *a):
            seen.append(("states", a[3]))
            return 0

    spec = dataclasses.replace(misfit.spec, n_steps=n_steps)
    th = _thetas()
    monkeypatch.setattr(lv_rk4, "_check", lambda theta, spec: (theta, Lib()))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    before = dict(_build.launch_counts)
    lv_rk4.misfit_and_grad(th, spec)
    assert _build.launch_counts[kernel] == before.get(kernel, 0) + 1
    assert seen[0][0] == "rule" and (seen[0][1] is not None) == scratch
    lv_rk4.misfit_and_grad_states(th, spec)
    assert seen[1][0] == "states" and seen[1][1] is not None


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def card_misfit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return configs.build("ode_mala", "cuda")


@pytest.mark.cuda
def test_c_and_python_stages_rules_agree(card_misfit):
    """ipx_lv_stages_geometry (the C rule) against stages_geometry /
    stages_takes, for step counts around the limit and ragged widths."""
    import ctypes

    lib = _build.library()
    for n_steps in (1, 200, 3000, 3631, 3632, 8000):
        spec = lv_rk4.LvSpec.build([1.0, 0.5], 0.01, n_steps, [n_steps], [0, 1], [1.0, 1.0],
                                   [0.1, 0.1], "cuda")
        for n in (1, 77, 256, 1024):
            out = (ctypes.c_int * 3)()
            status = lib.ipx_lv_stages_geometry(ctypes.byref(spec.c_struct), n, out)
            if lv_rk4.stages_takes(spec):
                assert status == 0 and tuple(out) == lv_rk4.stages_geometry(n, spec)
            else:
                assert status == 801  # cudaErrorNotSupported


@pytest.mark.cuda
def test_a_spec_the_rule_leaves_runs_on_the_states_kernel(card_misfit):
    """4,000 steps of 0.0025 (the configs' span) exceed a CTA's shared
    memory: misfit_and_grad launches lv_misfit_grad_states_kernel, the same
    bits as the forced entry, within the plain version's tolerances."""
    ones = torch.ones(20, device="cuda")
    pot = ode.LotkaVolterraMisfit(configs.LV_Y0, 0.0025, 4000, [400 * k for k in range(1, 11)],
                                  ones, dist.DiagGaussian(mean=0 * ones, scale=0.1 * ones))
    assert not lv_rk4.stages_takes(pot.spec)
    th = card_misfit.prior.sample(torch.Generator().manual_seed(64), 256)
    before = dict(_build.launch_counts)
    phi, grad = lv_rk4.misfit_and_grad(th, pot.spec)
    assert _build.launch_counts[lv_rk4.STATES_KERNEL] == before.get(lv_rk4.STATES_KERNEL, 0) + 1
    assert _build.launch_counts[lv_rk4.KERNEL] == before.get(lv_rk4.KERNEL, 0)
    ref = lv_rk4.misfit_and_grad_states(th, pot.spec)
    assert torch.equal(phi, ref[0]) and torch.equal(grad, ref[1])
    want_v, want_g = pot.plain_value_and_grad(th)
    assert float(((phi - want_v).abs() / want_v.abs()).max()) <= 1e-4
    assert _rel(grad, want_g) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 512, 1024])
def test_stages_kernel_against_the_states_kernel(card_misfit, n):
    """On the configs' spec (prior draws, half doubled) the stages kernel
    gives the states kernel's Φ and ∇Φ bit for bit: 0 of n chains differ;
    and it allocates no states scratch (the peak memory of a call stays
    below the scratch's size)."""
    pot = card_misfit.potential_fn
    th = card_misfit.prior.sample(torch.Generator().manual_seed(75 + n), n)
    th[n // 2:] *= 2.0
    ref = lv_rk4.misfit_and_grad_states(th, pot.spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    phi, grad = lv_rk4.misfit_and_grad(th, pot.spec)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < (pot.spec.n_steps + 1) * 2 * n * 4
    differ = int(((phi != ref[0]) | (grad != ref[1]).any(dim=1)).sum())
    print(f"{n} chains: {differ} of {n} differ from lv_misfit_grad_states_kernel")
    assert differ == 0
