"""Capacity + alive-mask Gaussian map state (port of
eags_slam_tpu.core.gaussians).

A submap is a capacity-padded set of parameter tensors with an alive mask:
seeding writes rows into dead slots (dead-first allocation), pruning clears
alive bits, Adam moments are zeroed at newly seeded rows. The state lives at
the smallest power-of-two bucket that fits (`bucket_for` / `expand_state`).

`state_from_numpy` / `state_to_numpy` move a state to and from the numpy
dict layout of `eags_slam_tpu.slam.submap.pack_state` (plus the alive mask
and the Adam moments), so one map can be handed to both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils import optim
from .sh import rgb_to_sh

OPT_KEYS = ("xyz", "log_scales", "quats", "opacity_logits")
PARAM_KEYS = ("xyz", "f_dc", "f_rest", "log_scales", "quats",
              "opacity_logits")


@dataclass
class GaussianParams:
    xyz: torch.Tensor             # (N, 3)
    f_dc: torch.Tensor            # (N, 3) SH degree-0 coefficients
    f_rest: torch.Tensor          # (N, 15, 3) SH degree 1..3 (zero in SLAM)
    log_scales: torch.Tensor      # (N, 3)
    quats: torch.Tensor           # (N, 4) wxyz
    opacity_logits: torch.Tensor  # (N, 1)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def replace(self, **kw) -> "GaussianParams":
        return replace(self, **kw)

    def map(self, fn) -> "GaussianParams":
        return GaussianParams(**{k: fn(v) for k, v in self.as_dict().items()})


@dataclass
class GaussianState:
    params: GaussianParams
    alive: torch.Tensor           # (N,) bool
    adam: optim.AdamState         # moments over OPT_KEYS

    @property
    def capacity(self) -> int:
        return int(self.alive.shape[0])


def empty_params(capacity: int, device="cpu") -> GaussianParams:
    f32 = dict(dtype=torch.float32, device=device)
    return GaussianParams(
        xyz=torch.zeros((capacity, 3), **f32),
        f_dc=torch.zeros((capacity, 3), **f32),
        f_rest=torch.zeros((capacity, 15, 3), **f32),
        log_scales=torch.full((capacity, 3), -10.0, **f32),
        quats=torch.cat([torch.ones((capacity, 1), **f32),
                         torch.zeros((capacity, 3), **f32)], dim=-1),
        opacity_logits=torch.full((capacity, 1), -10.0, **f32),
    )


def opt_subset(params: GaussianParams) -> Dict[str, torch.Tensor]:
    return {k: getattr(params, k) for k in OPT_KEYS}


def empty_state(capacity: int, device="cpu") -> GaussianState:
    params = empty_params(capacity, device)
    return GaussianState(params, torch.zeros(capacity, dtype=torch.bool,
                                             device=device),
                         optim.adam_init(opt_subset(params)))


def num_alive(state: GaussianState) -> int:
    return int(state.alive.sum())


@torch.no_grad()
def insert(state: GaussianState, rows: GaussianParams, valid: torch.Tensor
           ) -> Tuple[GaussianState, int]:
    """Write `rows` into dead slots (dead first, index order); valid rows
    beyond the free capacity are dropped. Returns (state, n_inserted)."""
    capacity = state.capacity
    slot_order = torch.argsort(state.alive.to(torch.int32), stable=True)
    num_dead = capacity - int(state.alive.sum())
    k = torch.cumsum(valid.to(torch.int64), 0) - 1
    ok = valid & (k < num_dead)
    dest = slot_order[torch.clamp(k, 0, capacity - 1)][ok]

    new = {}
    for name, slot_arr in state.params.as_dict().items():
        arr = slot_arr.clone()
        arr[dest] = getattr(rows, name)[ok].to(arr.dtype)
        new[name] = arr
    alive = state.alive.clone()
    alive[dest] = True
    adam = optim.reset_slots(state.adam, dest, torch.ones_like(dest,
                                                              dtype=torch.bool))
    return GaussianState(GaussianParams(**new), alive, adam), int(ok.sum())


def prune(state: GaussianState, kill: torch.Tensor) -> GaussianState:
    return GaussianState(state.params, state.alive & ~kill, state.adam)


def point_rows(xyz: torch.Tensor, rgb: torch.Tensor, dist2: torch.Tensor,
               opacity: torch.Tensor) -> GaussianParams:
    """Point gaussians: identity rotation, isotropic sqrt(knn dist2) scale."""
    m = xyz.shape[0]
    logit = torch.log(opacity / (1.0 - opacity))
    ones = torch.ones((m, 1), dtype=xyz.dtype, device=xyz.device)
    return GaussianParams(
        xyz=xyz,
        f_dc=rgb_to_sh(rgb),
        f_rest=torch.zeros((m, 15, 3), dtype=xyz.dtype, device=xyz.device),
        log_scales=(0.5 * torch.log(torch.clamp(dist2, min=1e-7)))[:, None]
        .repeat(1, 3),
        quats=torch.cat([ones, torch.zeros((m, 3), dtype=xyz.dtype,
                                           device=xyz.device)], -1),
        opacity_logits=logit[:, None] if logit.ndim == 1 else logit,
    )


def _quat_from_x_axis(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Quaternion rotating the x-axis onto unit vectors v (..., 3)."""
    x = v.new_tensor([1.0, 0.0, 0.0])
    cross = torch.stack([torch.zeros_like(v[..., 0]), -v[..., 2], v[..., 1]],
                        dim=-1)
    dot = torch.clamp(v[..., 0], -1.0, 1.0)
    angle = torch.arccos(dot)
    norm = torch.linalg.norm(cross, dim=-1, keepdim=True)
    axis = torch.where(norm > eps, cross / torch.clamp(norm, min=eps), x)
    half = angle / 2.0
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)


@torch.no_grad()
def edge_pair_seeds(sample_ids, sample_valid, edge, depth, points, colors,
                    height: int, width: int, depth_thres: float = 0.025):
    """Edge-gaussian candidates from sampled edge pixels (3x3 patches,
    depth-consistency filter, 2..3-edge patch gate, sorted-deduped pairs).
    Same outputs as the JAX function."""
    dev = sample_ids.device
    sample_ids = sample_ids.long()
    edge_f = edge.reshape(-1)
    depth_f = depth.reshape(-1)
    rows = sample_ids // width
    cols = sample_ids % width
    is_edge_sample = sample_valid & edge_f[sample_ids]

    dr = torch.tensor([-1, -1, -1, 0, 0, 1, 1, 1], device=dev)
    dc = torch.tensor([-1, 0, 1, -1, 1, -1, 0, 1], device=dev)
    nr = rows[:, None] + dr[None, :]
    nc = cols[:, None] + dc[None, :]
    inb = (nr >= 0) & (nr < height) & (nc >= 0) & (nc < width)
    nid = nr.clamp(0, height - 1) * width + nc.clamp(0, width - 1)
    d_mid = depth_f[sample_ids][:, None]
    nbr_edge = (inb & edge_f[nid] & (torch.abs(depth_f[nid] - d_mid)
                                     < depth_thres)
                & is_edge_sample[:, None])
    cnt = nbr_edge.sum(1) + is_edge_sample.long()
    good = (cnt > 1) & (cnt < 4)
    pair_ok = nbr_edge & good[:, None]

    center = sample_ids[:, None].expand_as(nid)
    lo = torch.minimum(center, nid).reshape(-1)
    hi = torch.maximum(center, nid).reshape(-1)
    ok = pair_ok.reshape(-1)
    imax = 2**31 - 1
    sort_lo = torch.where(ok, lo, torch.full_like(lo, imax))
    sort_hi = torch.where(ok, hi, torch.full_like(hi, imax))
    order = torch.sort(sort_lo * (2**31) + sort_hi, stable=True).indices
    s_lo, s_hi, s_ok = sort_lo[order], sort_hi[order], ok[order]
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                     (s_lo[1:] == s_lo[:-1]) & (s_hi[1:] == s_hi[:-1])])
    pair_valid = s_ok & ~dup
    safe_lo = s_lo.clamp(0, height * width - 1)
    safe_hi = s_hi.clamp(0, height * width - 1)

    p1 = points[safe_lo]
    p2 = points[safe_hi]
    vec = p2 - p1
    dist = torch.linalg.norm(vec, dim=-1)
    unit = vec / torch.clamp(dist, min=1e-8)[:, None]
    xyz = 0.5 * (p1 + p2)
    rgb = 0.5 * (colors[safe_lo] + colors[safe_hi])
    d_safe = torch.clamp(dist, min=1e-6)
    log_scales = torch.log(torch.stack([1.25 * d_safe, 0.5 * d_safe,
                                        0.5 * d_safe], dim=-1))
    quats = _quat_from_x_axis(unit)

    member_px = torch.zeros(height * width + 1, dtype=torch.bool, device=dev)
    sink = height * width
    member_px[torch.where(pair_valid, safe_lo, sink)] = True
    member_px[torch.where(pair_valid, safe_hi, sink)] = True
    member = member_px[:sink][sample_ids] & sample_valid
    return (s_lo.to(torch.int32), s_hi.to(torch.int32), pair_valid, xyz, rgb,
            log_scales, quats, member)


def edge_rows(xyz, rgb, log_scales, quats) -> GaussianParams:
    """Edge-gaussian rows (opacity 0.5)."""
    m = xyz.shape[0]
    return GaussianParams(
        xyz=xyz, f_dc=rgb_to_sh(rgb),
        f_rest=torch.zeros((m, 15, 3), dtype=xyz.dtype, device=xyz.device),
        log_scales=log_scales, quats=quats,
        opacity_logits=torch.zeros((m, 1), dtype=xyz.dtype,
                                   device=xyz.device),
    )


def concat_rows(a: GaussianParams, b: GaussianParams) -> GaussianParams:
    return GaussianParams(**{k: torch.cat([getattr(a, k), getattr(b, k)], 0)
                             for k in PARAM_KEYS})


_BUCKETS = (1 << 13, 1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19)


def bucket_for(n: int, cap: int) -> int:
    """Smallest bucket >= n, clamped to the configured capacity."""
    bucket = next((b for b in _BUCKETS if b >= max(n, 1)), cap)
    return min(bucket, cap)


@torch.no_grad()
def expand_state(state: GaussianState, new_capacity: int) -> GaussianState:
    """Grow the state to a larger capacity (new rows empty and dead)."""
    old = state.capacity
    if new_capacity <= old:
        return state
    dev = state.alive.device
    pad = empty_params(new_capacity - old, dev)
    params = GaussianParams(**{k: torch.cat([getattr(state.params, k),
                                             getattr(pad, k)], 0)
                               for k in PARAM_KEYS})
    alive = torch.cat([state.alive, torch.zeros(new_capacity - old,
                                                dtype=torch.bool,
                                                device=dev)])

    def cat0(tree):
        return {k: torch.cat([v, torch.zeros((new_capacity - old,)
                                             + v.shape[1:], dtype=v.dtype,
                                             device=dev)], 0)
                for k, v in tree.items()}

    a = state.adam
    adam = optim.AdamState(a.step, cat0(a.mu), cat0(a.nu), cat0(a.vmax))
    return GaussianState(params, alive, adam)


def state_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> GaussianState:
    """Port state from a numpy dict: the parameter keys of
    `eags_slam_tpu.slam.submap.pack_state` (an all-zero `f_rest` may be the
    (0, 15, 3) marker), optionally `alive` (default: all alive),
    `adam_step` and `adam_{mu,nu,vmax}_{xyz,log_scales,quats,opacity_logits}`
    (default: zero moments)."""
    n = d["xyz"].shape[0]
    t = {}
    for k in PARAM_KEYS:
        a = np.asarray(d[k], np.float32)
        if k == "f_rest" and a.shape[0] == 0:
            a = np.zeros((n, 15, 3), np.float32)
        t[k] = torch.as_tensor(a.copy(), device=device)
    params = GaussianParams(**t)
    alive = torch.as_tensor(np.asarray(d.get("alive", np.ones(n, bool)),
                                       bool).copy(), device=device)
    adam = optim.adam_init(opt_subset(params))
    adam.step = int(d.get("adam_step", 0))
    for slot in ("mu", "nu", "vmax"):
        for k in OPT_KEYS:
            key = f"adam_{slot}_{k}"
            if key in d:
                getattr(adam, slot)[k] = torch.as_tensor(
                    np.asarray(d[key], np.float32).copy(), device=device)
    return GaussianState(params, alive, adam)


def state_to_numpy(state: GaussianState) -> Dict[str, np.ndarray]:
    """Inverse of `state_from_numpy`: every row (dead ones too), the alive
    mask and the Adam moments, as host numpy."""
    out = {k: getattr(state.params, k).detach().cpu().numpy()
           for k in PARAM_KEYS}
    out["alive"] = state.alive.cpu().numpy()
    out["adam_step"] = np.asarray(state.adam.step, np.int32)
    for slot in ("mu", "nu", "vmax"):
        for k in OPT_KEYS:
            out[f"adam_{slot}_{k}"] = getattr(state.adam, slot)[k] \
                .detach().cpu().numpy()
    return out
