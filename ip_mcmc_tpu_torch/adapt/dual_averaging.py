"""Nesterov dual averaging for step-size adaptation (mirrors
``ip_mcmc_tpu/adapt/dual_averaging.py``; Hoffman & Gelman 2014 §3.2.1, Stan
defaults). The state is a handful of 0-d f32 tensors on the chains' device
and the acceptance it consumes is the cross-chain pooled mean, so a warm-up
step never waits for the host."""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class DAState:
    log_x: torch.Tensor  # current log step size
    log_x_avg: torch.Tensor  # averaged iterate (used after warm-up)
    h_avg: torch.Tensor  # running average of (target − accept)
    t: torch.Tensor  # iteration counter
    mu: torch.Tensor  # shrinkage point log(10 x0)


def init(initial_value, device="cpu"):
    log_x0 = torch.log(torch.as_tensor(initial_value, dtype=torch.float32,
                                       device=device))
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return DAState(log_x=log_x0, log_x_avg=log_x0, h_avg=zero, t=zero,
                   mu=math.log(10.0) + log_x0)


def update(state, accept_prob, target=0.8, gamma=0.05, t0=10.0, kappa=0.75):
    t = state.t + 1.0
    eta_h = 1.0 / (t + t0)
    h_avg = (1.0 - eta_h) * state.h_avg + eta_h * (target - accept_prob)
    log_x = state.mu - torch.sqrt(t) / gamma * h_avg
    eta_x = t ** (-kappa)
    log_x_avg = eta_x * log_x + (1.0 - eta_x) * state.log_x_avg
    return DAState(log_x=log_x, log_x_avg=log_x_avg, h_avg=h_avg, t=t,
                   mu=state.mu)


def current(state):
    return torch.exp(state.log_x)


def final(state):
    return torch.exp(state.log_x_avg)
