"""Scan-path MCMC kernels of the port (mirrors ``ip_mcmc_tpu/kernels``:
``base``, ``rwm``, ``pcn``, ``da_pcn``, ``elliptical``, ``ensemble``,
``mala``, ``hmc``, ``nuts``, ``chees_hmc``, ``tempering``). A kernel is
``kernel(generator, state) -> (state, info)`` over an (n, d) batch of
chains (the ensemble's, the ladder's and ChEES's ``batch_step`` over their
whole batch); ``kernel.transition(state, *draws)`` is the same step from
given draws."""
