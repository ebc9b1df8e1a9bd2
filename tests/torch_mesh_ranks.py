"""Rank bodies of the port's multi-rank CPU tests (gloo): every case takes
numpy inputs, runs on each spawned rank through eags_slam_torch.parallel
and returns numpy outputs. No JAX here, so a spawned rank imports only the
port. `run(world, tmp, cases)` spawns the ranks (torch.multiprocessing,
rendezvous on a FileStore under `tmp`) and returns every rank's results.
"""
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from eags_slam_torch.core import gaussians as G
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.ops.rasterizer import RasterConfig
from eags_slam_torch.parallel import mesh as P
from eags_slam_torch.slam import mapper as M
from eags_slam_torch.slam import tracker as T

RCFG = RasterConfig(tile=16, dup_side=4, seg_cap=128, bands=3, group=2)


def _np(t):
    return t.detach().cpu().numpy()


def _grads_np(grads):
    return {k: _np(v) for k, v in grads.items()}


def sp_map(state, cam, color, depth, w2c):
    """sp_map_step on the mesh of every rank."""
    st = G.state_from_numpy(state)
    step, init_adam, _ = P.sp_map_step(P.make_mesh(), Camera(*cam), RCFG,
                                       M.MapperConfig(max_keyframes=4))
    _, _, loss, grads = step(st, init_adam(st), torch.as_tensor(color),
                             torch.as_tensor(depth), torch.as_tensor(w2c))
    return {"loss": float(loss), "grads": _grads_np(grads)}


def dpsp_map(state, cam, colors, depths, w2cs, n_data, n_space):
    st = G.state_from_numpy(state)
    mesh = P.make_mesh2d(n_data, n_space)
    step, init_adam, _ = P.dpsp_map_step(mesh, Camera(*cam), RCFG,
                                         M.MapperConfig(max_keyframes=4))
    _, _, loss, grads = step(st, init_adam(st), torch.as_tensor(colors),
                             torch.as_tensor(depths), torch.as_tensor(w2cs))
    return {"loss": float(loss), "grads": _grads_np(grads),
            "coord": mesh.coord}


def dp_map(state, cam, colors, depths, w2cs):
    """dp_map_step; the averaged gradient read back from Adam's first
    moment after its first step (mu = (1 - b1) g)."""
    st = G.state_from_numpy(state)
    mesh = P.make_mesh()
    step, init_adam = P.dp_map_step(mesh, Camera(*cam), RCFG,
                                    M.MapperConfig(max_keyframes=4))
    _, adam, loss = step(st, init_adam(st), torch.as_tensor(colors),
                         torch.as_tensor(depths), torch.as_tensor(w2cs))
    return {"loss": float(loss),
            "grads": {k: _np(v) / (1 - 0.9) for k, v in adam.mu.items()}}


def map_branch(state, cam, kf, n_kf, iters, kidxs, mcfg):
    """optimize_submap with the mesh of every rank and the draws
    `kidxs[it]` (n_dev indices an iteration)."""
    st = G.state_from_numpy(state)
    cam = Camera(*cam)
    kfs = M.empty_keyframes(4, cam)
    for i in range(n_kf):
        M.push_keyframe(kfs, i, torch.as_tensor(kf["color"][i]),
                        torch.as_tensor(kf["depth"][i]),
                        torch.as_tensor(kf["w2c"][i]),
                        torch.as_tensor(kf["exposure"][i]))
    calls = []

    def kf_sampler(p_kf, it, n=None):
        calls.append((it, n))
        return list(kidxs[it])

    P.reset_collective_counts()
    new, aux = M.optimize_submap(st, kfs, n_kf, iters, cam, RCFG,
                                 M.MapperConfig(**mcfg),
                                 kf_sampler=kf_sampler, mesh=P.make_mesh())
    return {"losses": aux["losses"], "iterations": aux["iterations"],
            "state": G.state_to_numpy(new), "calls": calls,
            "collectives": P.collective_counts()}


def sp_track(params, cam, gt_color, gt_depth, init_rel, iters, tcfg):
    st = G.state_from_numpy(params)
    refine, aux = P.sp_track_refine(P.make_mesh(), Camera(*cam), RCFG,
                                    T.TrackerConfig(**tcfg))
    P.reset_collective_counts()
    rel, expo, stats = refine(st.params, st.alive, torch.as_tensor(init_rel),
                              torch.eye(4), torch.as_tensor(gt_color),
                              torch.as_tensor(gt_depth), torch.zeros(2),
                              iters)
    return {"rel": _np(rel), "exposure": _np(expo), "stats": stats,
            "aux": {k: aux[k] for k in ("n_tiles", "s_pad")},
            "collectives": P.collective_counts()}


def meshes():
    """The mesh set-up arithmetic at this world size: make_mesh, a mesh of
    all but the last rank, lc_submesh."""
    world = dist.get_world_size()
    full = P.make_mesh()
    part = P.make_mesh(max(world - 1, 1))
    lc = P.lc_submesh(full, 2)
    return {"full": (full.ranks, full.coord), "part": (part.ranks,
                                                       part.member),
            "lc": (lc.ranks, lc.axis_names, lc.member)}


def slam(config, out_paths):
    """GaussianSLAM.run with the config on every rank, rank r writing (or
    not) under out_paths[r]."""
    import copy

    from eags_slam_torch.slam.gaussian_slam import GaussianSLAM

    cfg = copy.deepcopy(config)
    cfg["data"]["output_path"] = out_paths[dist.get_rank()]
    g = GaussianSLAM(cfg)
    try:
        wired = (g.mesh.size, g.tracker._sp_refine is not None, g.is_main)
        report = g.run()
    finally:
        g.cleanup()
    return {"c2ws": g.estimated_c2ws,
            "gt": np.stack([g.dataset.poses[i]
                            for i in range(len(g.dataset))]),
            "frames": report["frames"], "mesh": report["mesh"],
            "wired": wired, "state": G.state_to_numpy(g.state)}


CASES = {"slam": slam, "sp_map": sp_map, "dpsp_map": dpsp_map,
         "dp_map": dp_map, "map_branch": map_branch, "sp_track": sp_track,
         "meshes": meshes}


def _rank(rank, world, store, out, cases):
    # At most four threads over the ranks: the suite runs in several
    # processes at once.
    torch.set_num_threads(max(1, 4 // world))
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        res = {name: CASES[fn](**kw) for name, (fn, kw) in cases.items()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def run(world: int, tmp, cases: dict):
    """Spawn `world` gloo ranks that each run `cases` ({name: (case,
    kwargs)}); returns the list of the ranks' {name: result}."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, "store")
    mp.spawn(_rank, args=(world, store, tmp, cases), nprocs=world,
             join=True)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out

