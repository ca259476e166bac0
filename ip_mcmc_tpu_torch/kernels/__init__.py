"""Scan-path MCMC kernels of the port (mirrors ``ip_mcmc_tpu/kernels``:
``base``, ``rwm``, ``pcn``, ``da_pcn``, ``elliptical``, ``ensemble``,
``mala``, ``hmc``, ``tempering``). A kernel is ``kernel(generator, state)
-> (state, info)`` over an (n, d) batch of chains (the ensemble's and the
ladder's over their whole batch); ``kernel.transition(state, *draws)`` is
the same step from given draws."""
