"""Checkpoint / resume of the port (``ip_mcmc_tpu_torch/checkpoint.py``),
the cases of ``tests/test_checkpoint.py`` on the port's scan RWM kernel:
the round trip, a resume that reproduces the uninterrupted run bit for bit
(the chunks' generators are seeded from (seed, global offset)), a resume
from an empty directory, the in-scan checkpoints and their resume, and no
in-scan file giving the template back; then what the JAX package's Orbax
manager does beside it: only the newest three steps stay, and a restore
fills the template's structure on its device and in its dtype. All exact:
the same seeds give the same draws."""

import numpy as np
import pytest
import torch

from ip_mcmc_tpu_torch import checkpoint, driver
from ip_mcmc_tpu_torch.kernels import rwm, pcn

torch.set_num_threads(1)


def logpi(x):
    return -0.5 * torch.sum(x * x, dim=-1)


def _setup(n_chains=8):
    kernel = rwm.build_kernel(logpi, step_size=0.5)
    positions = torch.tensor(np.random.default_rng(0).standard_normal((n_chains, 2)),
                             dtype=torch.float32)
    return kernel, driver.init_chains(rwm.init, positions, logpi)


def test_save_restore_roundtrip(tmp_path):
    _, state = _setup()
    checkpoint.save(str(tmp_path / "ck"), 3, state)
    assert checkpoint.latest_step(str(tmp_path / "ck")) == 3
    template = rwm.RWMState(position=torch.zeros_like(state.position),
                            log_density=torch.zeros_like(state.log_density))
    step, restored = checkpoint.restore(str(tmp_path / "ck"), template)
    assert step == 3
    assert torch.equal(restored.position, state.position)
    assert torch.equal(restored.log_density, state.log_density)


def test_resume_reproduces_uninterrupted_run(tmp_path):
    """A chunked run that stops after chunk 1 and resumes from disk gives
    the uninterrupted run's samples bit for bit."""
    kernel, state = _setup()
    full = checkpoint.CheckpointingDriver(str(tmp_path / "full"), kernel, 42, chunk_size=10)
    _, samples_full = full.run(state, n_samples=30)
    part_driver = checkpoint.CheckpointingDriver(str(tmp_path / "int"), kernel, 42,
                                                 chunk_size=10)
    _, part = part_driver.run(state, n_samples=20)  # chunks 0, 1
    resumed = checkpoint.CheckpointingDriver(str(tmp_path / "int"), kernel, 42, chunk_size=10)
    _, rest = resumed.resume(state, n_samples=30)  # chunk 2
    assert samples_full.shape == (30, 8, 2)
    assert torch.equal(samples_full[:20], part)
    assert torch.equal(samples_full[20:], rest)


def test_resume_from_empty_runs_everything(tmp_path):
    kernel, state = _setup()
    d = checkpoint.CheckpointingDriver(str(tmp_path / "e"), kernel, 1, chunk_size=5)
    _, samples = d.resume(state, n_samples=12)
    assert samples.shape[0] == 12
    assert checkpoint.latest_step(str(tmp_path / "e")) == 2


class TestInScanCheckpointing:
    def test_resume_reproduces_uninterrupted_run(self, tmp_path):
        """In-scan checkpoints every 10 samples, a stop at 20 and a resume
        from the newest file: the uninterrupted run bit for bit (each
        step's generator seeded from its global index)."""
        kernel, state0 = _setup(32)
        d = str(tmp_path / "inscan")
        _, s_full, _ = checkpoint.sample_chains_inscan(
            kernel, state0, 1, n_samples=40, every=10, directory=str(tmp_path / "full"))
        _, s_a, _ = checkpoint.sample_chains_inscan(kernel, state0, 1, n_samples=20, every=10,
                                                    directory=d)
        start, state_r = checkpoint.latest_inscan(d, state0)
        assert start == 20
        _, s_b, info = checkpoint.sample_chains_inscan(kernel, state_r, 1, n_samples=20,
                                                       every=10, directory=d,
                                                       start_sample=start)
        assert torch.equal(s_full, torch.cat([s_a, s_b]))
        assert info.accepted.shape == (20,)
        with np.load(str(tmp_path / "inscan" / "inscan_00000019.npz")) as z:
            assert sorted(z.files) == ["leaf0", "leaf1", "step"] and int(z["step"]) == 19

    def test_no_checkpoint_returns_template(self, tmp_path):
        start, st = checkpoint.latest_inscan(str(tmp_path), {"a": torch.ones(3)})
        assert start == 0 and float(st["a"][0]) == 1.0

    def test_thinned_pcn_resume(self, tmp_path):
        """With thin 3 on the scan pCN kernel: the same, every 5 samples."""
        from ip_mcmc_tpu_torch.distributions import DiagGaussian

        prior = DiagGaussian(mean=torch.zeros(2), scale=torch.ones(2))
        y = torch.tensor([1.0, -0.5])
        phi = lambda u: 0.5 * torch.sum((y - u) ** 2, dim=-1)  # noqa: E731
        kernel = pcn.build_kernel(phi, prior, beta=0.4)
        state0 = driver.init_chains(pcn.init, prior.sample(torch.Generator().manual_seed(0), 16),
                                    phi)
        _, full, _ = checkpoint.sample_chains_inscan(
            kernel, state0, 7, n_samples=15, thin=3, every=5, directory=str(tmp_path / "f"))
        d = str(tmp_path / "i")
        _, a, _ = checkpoint.sample_chains_inscan(kernel, state0, 7, n_samples=10, thin=3,
                                                  every=5, directory=d)
        start, st = checkpoint.latest_inscan(d, state0)
        _, b, _ = checkpoint.sample_chains_inscan(kernel, st, 7, n_samples=5, thin=3, every=5,
                                                  directory=d, start_sample=start)
        assert start == 10 and torch.equal(full, torch.cat([a, b]))


def test_keeps_the_newest_three_steps(tmp_path):
    _, state = _setup()
    for step in range(6):
        checkpoint.save(str(tmp_path), step, state)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3", "4", "5"]
    assert checkpoint.latest_step(str(tmp_path)) == 5
    step, _ = checkpoint.restore(str(tmp_path), state, step=4)
    assert step == 4


def test_restore_follows_the_template_device_dtype_and_structure(tmp_path):
    """Saved f32 on the CPU, restored into f64 templates (a dataclass, and
    an extra dict of a tensor, a list and a number): values equal, each
    leaf in its template's dtype and on its device, the dict in the
    template's key order."""
    _, state = _setup()
    extra = {"step_size": torch.tensor(0.5), "b": [torch.arange(3), 2.5], "a": 7}
    checkpoint.save(str(tmp_path), 0, state, extra=extra)
    template = rwm.RWMState(position=torch.zeros(8, 2, dtype=torch.float64),
                            log_density=torch.zeros(8, dtype=torch.float64))
    extra_t = {"step_size": torch.tensor(0.0, dtype=torch.float64),
               "b": [torch.zeros(3, dtype=torch.int32), 0.0], "a": 0}
    step, got, got_extra = checkpoint.restore(str(tmp_path), template, extra_template=extra_t)
    assert step == 0 and got.position.dtype == torch.float64
    assert got.position.device == template.position.device
    assert torch.equal(got.position, state.position.double())
    assert list(got_extra) == ["step_size", "b", "a"]
    assert got_extra["b"][0].dtype == torch.int32 and got_extra["b"][1] == 2.5
    assert got_extra["a"] == 7 and float(got_extra["step_size"]) == 0.5
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), rwm.RWMState(position=torch.zeros(4, 2),
                                                       log_density=torch.zeros(4)))


def test_step_generators_differ_by_offset_and_seed():
    """(seed, offset) → generator: the same pair the same draws, another
    offset or seed other draws."""
    draw = lambda s, o: torch.rand(4, generator=checkpoint.step_generator(s, o, "cpu"))  # noqa: E731
    assert torch.equal(draw(3, 10), draw(3, 10))
    assert not torch.equal(draw(3, 10), draw(3, 11))
    assert not torch.equal(draw(3, 10), draw(4, 10))
    assert 0 <= checkpoint.step_seed(2**70, -5) < 2**63
