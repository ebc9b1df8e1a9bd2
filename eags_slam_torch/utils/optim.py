"""Masked Adam with per-leaf learning rates and slot reset (port of
eags_slam_tpu.utils.optim).

Parameter trees are plain dicts of tensors. Dead map rows receive zero
gradients; `reset_slots` zeroes the moments of newly seeded rows. The
amsgrad variant (`vmax`) drives the camera-pose optimizer."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]


@dataclass
class AdamState:
    step: int
    mu: Tree
    nu: Tree
    vmax: Tree

    def clone(self) -> "AdamState":
        return AdamState(self.step, {k: v.clone() for k, v in self.mu.items()},
                         {k: v.clone() for k, v in self.nu.items()},
                         {k: v.clone() for k, v in self.vmax.items()})


def adam_init(params: Tree) -> AdamState:
    z = {k: torch.zeros_like(v) for k, v in params.items()}
    return AdamState(0, z, {k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()})


@torch.no_grad()
def adam_update(state: AdamState, params: Tree, grads: Tree, lr_tree,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                amsgrad: bool = False):
    """One Adam step; `lr_tree` is a dict of scalars or one scalar.
    Returns (new_params, new_state); inputs are not modified."""
    step = state.step + 1
    t = float(step)
    bc1 = 1.0 - math.pow(b1, t)
    bc2 = 1.0 - math.pow(b2, t)
    mu = {k: b1 * state.mu[k] + (1 - b1) * g for k, g in grads.items()}
    nu = {k: b2 * state.nu[k] + (1 - b2) * g * g for k, g in grads.items()}
    if amsgrad:
        vmax = {k: torch.maximum(state.vmax[k], nu[k]) for k in nu}
        denom = vmax
    else:
        vmax = state.vmax
        denom = nu
    if not isinstance(lr_tree, dict):
        lr_tree = {k: lr_tree for k in params}
    new = {
        k: params[k] - lr_tree[k] * (mu[k] / bc1)
        / (torch.sqrt(denom[k] / bc2) + eps)
        for k in params
    }
    return new, AdamState(step, mu, nu, vmax)


@torch.no_grad()
def reset_slots(state: AdamState, idx: torch.Tensor,
                valid: torch.Tensor) -> AdamState:
    """Zero first-axis rows `idx` (where valid) of every moment tree."""
    rows = idx[valid]

    def zero_rows(tree):
        out = {}
        for k, x in tree.items():
            x = x.clone()
            x[rows] = 0.0
            out[k] = x
        return out

    return AdamState(state.step, zero_rows(state.mu), zero_rows(state.nu),
                     zero_rows(state.vmax))


def exp_lr_schedule(step: int, lr_init: float, lr_final: float,
                    max_steps: int, delay_mult: float = 0.01,
                    delay_steps: int = 0) -> float:
    """3DGS log-linear interpolation schedule."""
    t = min(max(step / max_steps, 0.0), 1.0)
    log_lerp = math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
    if delay_steps > 0:
        delay_rate = delay_mult + (1 - delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / delay_steps, 0.0), 1.0))
    else:
        delay_rate = 1.0
    return delay_rate * log_lerp


@dataclass
class PlateauState:
    """ReduceLROnPlateau state (torch.optim.lr_scheduler semantics)."""

    lr_scale: float = 1.0
    best: float = math.inf
    bad_count: int = 0


def plateau_init() -> PlateauState:
    return PlateauState()


def plateau_update(state: PlateauState, loss: float, patience: int = 5,
                   factor: float = 0.5, min_scale: float = 1e-3
                   ) -> PlateauState:
    improved = loss < state.best
    bad = 0 if improved else state.bad_count + 1
    trigger = bad > patience
    scale = max(state.lr_scale * factor, min_scale) if trigger \
        else state.lr_scale
    return PlateauState(scale, min(state.best, loss), 0 if trigger else bad)
