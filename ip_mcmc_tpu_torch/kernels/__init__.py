"""Scan-path MCMC kernels of the port (mirrors ``ip_mcmc_tpu/kernels``:
``base``, ``rwm``, ``pcn``). A kernel is ``kernel(generator, state) ->
(state, info)`` over an (n, d) batch of chains; ``kernel.transition(state,
xi, u)`` is the same step from given draws."""
