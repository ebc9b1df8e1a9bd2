"""`evaluation.pose_spread`: the frame-by-frame spread between two runs'
trajectories and VO trajectories (host numpy, no JAX)."""
import json
import os

import numpy as np
import pytest

from eags_slam_torch.evaluation import pose_spread as ps


def _rot_z(deg):
    a = np.radians(deg)
    return np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                     [0.0, 0.0, 1.0]])


def _run(path, c2ws, vo_rows=None, log=()):
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "estimated_c2w.npz"), c2ws=c2ws,
             exposures=np.zeros((len(c2ws), 2)))
    if vo_rows is not None:
        np.savetxt(os.path.join(path, "vo_traj_tum.txt"), vo_rows,
                   header="timestamp tx ty tz qx qy qz qw")
    with open(os.path.join(path, "log.jsonl"), "w") as f:
        for rec in log:
            f.write(json.dumps(rec) + "\n")


def _traj(n, seed=0):
    rng = np.random.default_rng(seed)
    c2ws = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        c2ws[i, :3, :3] = _rot_z(rng.uniform(-30, 30))
        c2ws[i, :3, 3] = rng.normal(size=3)
    return c2ws


@pytest.mark.parametrize("parted_at", [None, 0, 3])
def test_spread_names_the_first_frame_that_parts(tmp_path, parted_at):
    """Equal runs give no differing frame; a run moved by 1 mm and turned
    by 0.1 deg from frame `parted_at` on is named at that frame with those
    spreads, while equal VO trajectories stay equal."""
    a = _traj(6)
    b = a.copy()
    if parted_at is not None:
        b[parted_at:, :3, 3] += np.array([1e-3, 0.0, 0.0])
        b[parted_at:, :3, :3] = b[parted_at:, :3, :3] @ _rot_z(0.1)
    vo = np.column_stack([np.arange(6) / 30.0, a[:, :3, 3],
                          np.tile([0.0, 0.0, 0.0, 1.0], (6, 1))])
    _run(tmp_path / "a", a, vo)
    _run(tmp_path / "b", b, vo)
    out = ps.pose_spread(str(tmp_path / "a"), str(tmp_path / "b"))
    assert out["poses"]["frames"] == 6
    assert out["poses"]["first_differing_frame"] == parted_at
    if parted_at is None:
        assert out["poses"]["max_trans_m"] == out["poses"]["max_rot_deg"] == 0
    else:
        assert out["poses"]["max_trans_m"] == pytest.approx(1e-3, rel=1e-6)
        assert out["poses"]["max_rot_deg"] == pytest.approx(0.1, rel=1e-4)
        assert out["poses"]["trans_m"][parted_at - 1 if parted_at else 0] \
            == (0.0 if parted_at else pytest.approx(1e-3))
    assert out["vo"]["first_differing_frame"] is None
    json.dumps(out)


def test_spread_names_the_first_log_record_that_differs(tmp_path):
    """Mapping and tracking records are compared frame by frame without
    their timings: equal mapping, tracking parted at frame 3's loss."""
    def log(loss3, t):
        return [{"t": t, "kind": "mapping", "frame": 0, "final_loss": 0.5,
                 "map_ms": t, "n_alive": 100},
                {"t": t, "kind": "tracking", "frame": 2, "color_loss": 0.1,
                 "vo_ms": t},
                {"t": t, "kind": "tracking", "frame": 3,
                 "color_loss": loss3, "iters": 20.0}]
    c2ws = _traj(4)
    _run(tmp_path / "a", c2ws, log=log(0.2, 1.0))
    _run(tmp_path / "b", c2ws, log=log(0.2 + 1e-7, 2.0))
    out = ps.pose_spread(str(tmp_path / "a"), str(tmp_path / "b"))
    assert out["mapping"] == {"frames": 1, "first_difference": None}
    assert out["tracking"] == {"frames": 2, "first_difference": {
        "frame": 3, "fields": ["color_loss"]}}


def test_spread_without_vo_and_with_unequal_runs(tmp_path):
    """Runs without a VO trajectory or log records report poses only;
    trajectories of different lengths are refused."""
    _run(tmp_path / "a", _traj(4))
    _run(tmp_path / "b", _traj(4, seed=1))
    _run(tmp_path / "c", _traj(5))
    out = ps.pose_spread(str(tmp_path / "a"), str(tmp_path / "b"))
    assert set(out) == {"poses"} and out["poses"]["first_differing_frame"] == 0
    with pytest.raises(ValueError):
        ps.pose_spread(str(tmp_path / "a"), str(tmp_path / "c"))
