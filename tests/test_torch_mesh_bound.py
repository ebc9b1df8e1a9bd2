"""`python -m eags_slam_torch.mesh_bound` against the functions of the JAX
package's scripts/mesh_bound.py, on the --small scene (240x136).

Parity: the port's fused frames, poses and GT surface go through the
port's `bound_line` and through the JAX script's sequence of calls (grid
bounds, make_grid, integrate, surface_nets, clean_mesh, sample_surface,
mesh_metrics), the depth bounds at a 4 cm voxel and the trajectory bounds
(at least 12 m a side) at 8 cm. The kNN of the metrics is the CPU's cost,
so the GT surface has 5,000 points a frame (the script's 20,000) and 5,000
mesh samples are scored (its 200,000). Grid dims exact; the fused TSDFs
differ only at voxels that float32 rounding decides
(tests/test_torch_tsdf.py), so the faces within 2% and F1 within 0.005.
The command line itself runs once at 6 frames and a 10 cm voxel at the
same reduced counts: one JSON line a (voxel, bounds), the script's keys.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest

from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.evaluation import mesh as jm
from eags_slam_tpu.ops import tsdf as jt
from eags_slam_torch import mesh_bound as mb
from eags_slam_torch.synthetic_hard import SyntheticHard

VOXEL = {"depths": 0.04, "trajectory": 0.08}
SAMPLES = 5000
PER_FRAME = 5000
KEYS = {"mode", "voxel", "bounds", "dims", "n_vertices", "n_faces",
        "accuracy", "completion", "precision", "recall", "f1", "wall_s"}


@pytest.fixture(scope="module")
def frames():
    ds = SyntheticHard(mb.scene_config(True, 7), device="cpu")
    ids = list(range(0, len(ds), 3))
    fr = [ds.frame(i) for i in ids]
    poses = [np.asarray(ds.poses[i], np.float64) for i in ids]
    cam = ds.camera
    ds.close()
    colors = [c for c, _ in fr]
    depths = [d for _, d in fr]
    surface = mb.gt_surface([d.numpy() for d in depths], poses, cam,
                            PER_FRAME)
    return colors, depths, poses, surface, cam


def _jax_line(colors, depths, poses, surface, cam, kind):
    """The body of scripts/mesh_bound.py's loop, on the same inputs."""
    voxel = VOXEL[kind]
    jcam = JCamera(*cam)
    depths_h = [d.numpy() for d in depths]
    if kind == "trajectory":
        origin, dims = jt.grid_bounds_from_trajectory(
            np.stack(poses), 6.0, voxel, max_dim=384)
    else:
        origin, dims = jt.grid_bounds_from_depths(
            depths_h[::3], poses[::3], jcam, voxel, max_dim=512)
    grid = jt.make_grid(origin, dims, voxel, 4 * voxel)
    for color, depth, c2w in zip(colors, depths_h, poses):
        grid = jt.integrate(grid, jnp.asarray(color.numpy()),
                            jnp.asarray(depth),
                            jnp.asarray(np.linalg.inv(c2w), jnp.float32),
                            jcam)
    verts, faces = jm.surface_nets(np.asarray(grid.sdf),
                                   np.asarray(grid.weight),
                                   np.asarray(grid.origin), grid.voxel)
    verts, faces = jm.clean_mesh(verts, faces)
    line = {"dims": list(dims), "n_faces": int(len(faces))}
    line.update(jm.mesh_metrics(jm.sample_surface(verts, faces, SAMPLES),
                                surface, tau=0.01))
    return line


@pytest.mark.parametrize("kind", mb.BOUNDS)
def test_bound_line_matches_jax_script(frames, kind):
    colors, depths, poses, surface, cam = frames
    got = mb.bound_line(colors, depths, poses, surface, cam, VOXEL[kind],
                        kind, "cpu", n_samples=SAMPLES)
    want = _jax_line(colors, depths, poses, surface, cam, kind)
    assert got["dims"] == [int(d) for d in want["dims"]]
    assert got["n_faces"] > 0
    assert abs(got["n_faces"] - want["n_faces"]) <= 0.02 * want["n_faces"]
    assert abs(got["f1"] - want["f1"]) < 0.005, (got, want)
    assert 0.0 < got["f1"] <= 1.0


def test_cli_small(capsys, monkeypatch):
    monkeypatch.setattr(mb, "GT_PER_FRAME", PER_FRAME)
    monkeypatch.setattr(mb, "SAMPLES", SAMPLES)
    lines = mb.main(["--small", "--frames", "6", "--kf_every", "3",
                     "--voxels", "0.1"])
    out = [json.loads(r) for r in capsys.readouterr().out.splitlines()
           if r.startswith("{")]
    assert out == lines and [r["bounds"] for r in out] == list(mb.BOUNDS)
    for r in out:
        assert set(r) == KEYS and r["voxel"] == 0.1 and r["n_faces"] > 0
        assert r["mode"] == "gt_depth_gt_pose" and np.isfinite(r["f1"])
