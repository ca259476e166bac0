"""The port's example scripts (ip_mcmc_tpu_torch/examples) at tiny sizes
with ``--device cpu``, and the tutorial notebook's code cells executed in
order, on the CPU.

The scripts' outputs are Monte Carlo estimates from a few chains and
steps: the checks are their shapes and finiteness, the rates in (0, 1],
and the multimodal script's plain pCN stuck in the mode it starts in
(occupancy 0, as the JAX script prints); no tolerance on a statistic. The
notebook states its sizes in its first cell and runs in seconds.
"""

import json

import numpy as np
import pytest
import torch

from ip_mcmc_tpu_torch.examples import (burgers_inversion, darcy_inversion, gaussian_sanity,
                                        multimodal_inversion)
from torch_world import ROOT

torch.set_num_threads(1)

NOTEBOOK = ROOT / "ip_mcmc_tpu_torch" / "examples" / "tutorial.ipynb"


def test_gaussian_sanity():
    out = gaussian_sanity.main(["--device", "cpu", "--n-chains", "16", "--n-samples", "50"])
    assert 0.0 < out["accept_rate"] <= 1.0
    assert out["cov"].shape == (2, 2) and np.isfinite(out["mean"]).all()


@pytest.mark.parametrize("mode", [[], ["--fused"], ["--smc"]])
def test_darcy_inversion(mode):
    out = darcy_inversion.main(["--device", "cpu", "--n-chains", "16", "--n-samples", "10",
                                "--burn-in", "5", *mode])
    assert np.isfinite(out["field_error"]) and out["field_std"] > 0.0
    if mode == ["--smc"]:
        assert out["n_stages"] >= 1 and np.isfinite(out["log_z"])
    else:
        assert 0.0 < out["accept_rate"] <= 1.0


def test_burgers_inversion():
    out = burgers_inversion.main(["--device", "cpu", "--n-chains", "8", "--n-samples", "10",
                                  "--burn-in", "5"])
    assert 0.0 < out["accept_rate"] <= 1.0 and np.isfinite(out["rel_error"])


def test_multimodal_inversion():
    out = multimodal_inversion.main(["--device", "cpu", "--n-chains", "16"])
    assert out["pcn"] == 0.0  # every chain starts, and stays, in the left mode
    assert 0.0 <= out["pt"] <= 1.0 and 0.0 <= out["smc"] <= 1.0 and out["smc_stages"] >= 1


def test_tutorial_notebook_runs_in_order():
    nb = json.loads(NOTEBOOK.read_text())
    cells = [c for c in nb["cells"] if c["cell_type"] == "code"]
    assert len(cells) >= 8
    ns = {}
    for i, cell in enumerate(cells):
        exec(compile("".join(cell["source"]), f"tutorial cell {i}", "exec"), ns)
    assert ns["s_comp"].shape == (2, 8, 16)
    assert 0.0 <= ns["counted"].acceptance_rate <= 1.0
    assert ns["met"]["kernel"] == "da_pcn(fused)"
