"""Toy-scene run of every multi-device step (the counterpart of the JAX
package's `__graft_entry__.dryrun_multichip`):

    python -m eags_slam_torch.parallel.dryrun 1          # one card
    python -m eags_slam_torch.parallel.dryrun 4 --device cpu   # 4 gloo ranks

Over n ranks -- gloo processes on the CPU, or NCCL processes one a card --
it takes one data-parallel map step, runs the pipeline's `optimize_submap`
with the mesh, one spatially-parallel map step, the spatially-parallel
tracking refinement and, when n >= 4 and even, one step on the 2D (data x
space) mesh, each on tiny shapes, and asserts every loss finite.
"""
from __future__ import annotations

import argparse
import os
import pickle
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _steps(n: int, device: torch.device) -> dict:
    """Every step on the toy scene; returns {stage: loss}."""
    from ..core import gaussians as G
    from ..core.camera import Camera
    from ..ops.rasterizer import RasterConfig
    from ..slam.mapper import (MapperConfig, empty_keyframes, optimize_submap,
                               push_keyframe)
    from ..slam.tracker import TrackerConfig
    from . import mesh as P

    h = w = 32
    cam = Camera(fx=35.0, fy=35.0, cx=(w - 1) / 2, cy=(h - 1) / 2, width=w,
                 height=h)
    rcfg = RasterConfig(tile=16, dup_side=4)
    mcfg = MapperConfig(max_keyframes=n)
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=device)
    xyz = np.stack([rng.uniform(-1, 1, 128), rng.uniform(-1, 1, 128),
                    rng.uniform(1, 3, 128)], axis=-1).astype(np.float32)
    rows = G.point_rows(torch.as_tensor(xyz, **f32),
                        torch.full((128, 3), 0.5, **f32),
                        torch.full((128,), 0.01, **f32),
                        torch.full((128,), 0.5, **f32))
    state, _ = G.insert(G.empty_state(256, device), rows,
                        torch.ones(128, dtype=torch.bool, device=device))
    colors = torch.as_tensor(
        rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32), **f32)
    depths = torch.full((n, h, w), 2.0, **f32)
    w2cs = torch.eye(4, **f32).repeat(n, 1, 1)
    losses = {}

    mesh = P.make_mesh(n, device=device)
    step, init_adam = P.dp_map_step(mesh, cam, rcfg, mcfg)
    _, _, losses["dp"] = step(state, init_adam(state), colors, depths, w2cs)

    # The pipeline's path: optimize_submap with the mesh (what
    # GaussianSLAM.map_frame runs above one rank).
    kfs = empty_keyframes(4, cam, device)
    push_keyframe(kfs, 0, colors[0], depths[0], torch.eye(4, **f32),
                  torch.zeros(2, **f32))
    gen = torch.Generator(device=device).manual_seed(1)
    _, aux = optimize_submap(state, kfs, 1, 4, cam, rcfg,
                             MapperConfig(max_keyframes=4), generator=gen,
                             mesh=mesh)
    losses["optimize_submap"] = torch.tensor(float(aux["losses"][-1, 0]))

    rcfg_sp = RasterConfig(tile=16, dup_side=4, seg_cap=64, bands=3,
                           group=1)
    sp_step, sp_init, _ = P.sp_map_step(mesh, cam, rcfg_sp, mcfg)
    _, _, losses["sp"], _ = sp_step(state, sp_init(state), colors[0],
                                    depths[0], torch.eye(4, **f32))

    # A scene the tracking loss sees (alpha above its threshold, positive
    # depth): a 16 x 16 pixel grid backprojected to the depth plane z = 2,
    # near-opaque gaussians of a few pixels.
    gy, gx = np.meshgrid(np.linspace(2, h - 3, 16), np.linspace(2, w - 3, 16),
                         indexing="ij")
    plane = np.stack([(gx.ravel() - cam.cx) / cam.fx * 2.0,
                      (gy.ravel() - cam.cy) / cam.fy * 2.0,
                      np.full(gx.size, 2.0)], axis=-1).astype(np.float32)
    m = plane.shape[0]
    rows_t = G.point_rows(
        torch.as_tensor(plane, **f32),
        torch.as_tensor(rng.uniform(0.2, 0.8, (m, 3)).astype(np.float32),
                        **f32),
        torch.full((m,), 0.04, **f32), torch.full((m,), 0.99, **f32))
    state_t, _ = G.insert(G.empty_state(256, device), rows_t,
                          torch.ones(m, dtype=torch.bool, device=device))
    refine, _ = P.sp_track_refine(mesh, cam, rcfg_sp,
                                  TrackerConfig(iterations=3,
                                                enable_exposure=True))
    rel, _, stats = refine(state_t.params, state_t.alive, torch.eye(4, **f32),
                           torch.eye(4, **f32), colors[0], depths[0],
                           torch.zeros(2, **f32), 3)
    assert bool(torch.isfinite(rel).all())
    losses["sp_track"] = torch.tensor(float(stats[0]))

    if n >= 4 and n % 2 == 0:
        mesh2 = P.make_mesh2d(2, n // 2, device=device)
        d_step, d_init, _ = P.dpsp_map_step(mesh2, cam, rcfg_sp, mcfg)
        _, _, losses["dpsp"], _ = d_step(state, d_init(state), colors[:2],
                                         depths[:2], w2cs[:2])
    out = {k: float(v) for k, v in losses.items()}
    for k, v in out.items():
        assert np.isfinite(v), (k, v)
    return out


def _rank(rank: int, n: int, store: str, out: str, device_type: str):
    device = torch.device("cpu")
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.FileStore(store, n), rank=rank,
                            world_size=n)
    try:
        losses = _steps(n, device)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(losses, f)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Every multi-device step over `n_devices` ranks (module docstring):
    one NCCL process a card, or gloo processes with `device` "cpu". Prints
    and returns rank 0's {stage: loss}."""
    if device == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"{n_devices} ranks need {n_devices} cards; "
                           f"{torch.cuda.device_count()} visible")
    tmp = tempfile.mkdtemp(prefix="eags_dryrun_")
    try:
        out = os.path.join(tmp, "losses.pkl")
        mp.spawn(_rank, args=(n_devices, os.path.join(tmp, "store"), out,
                              device), nprocs=n_devices, join=True)
        with open(out, "rb") as f:
            losses = pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for stage, loss in losses.items():
        print(f"dryrun_multichip({n_devices}): {stage} OK, loss={loss:.4f}")
    return losses


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    a = p.parse_args()
    dryrun_multichip(a.n_devices, a.device)
