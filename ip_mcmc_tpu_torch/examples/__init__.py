"""Narrative experiments on the port (mirrors the JAX package's
``examples/``): ``gaussian_sanity``, ``darcy_inversion``,
``burgers_inversion``, ``multimodal_inversion`` and ``tutorial.ipynb``.
Each script runs on the card by default (``--device cpu`` for the plain
versions): ``python -m ip_mcmc_tpu_torch.examples.darcy_inversion``."""
