"""The port's visualisation helpers against the JAX package's: the depth
colouriser exactly (the same numpy arithmetic), the TUM trajectory reader
exactly (each package's own pose parser on the same file), and the two
figures written as PNG files (skipped without matplotlib); a plot that
cannot be drawn is swallowed, as in the JAX package.
"""
import numpy as np
import pytest

from eags_slam_tpu.utils import vis as jv
from eags_slam_torch.utils import vis as tv


@pytest.mark.parametrize("bounds", [(None, None), (0.5, 3.0)])
def test_colorize_depth_matches_jax(bounds):
    rng = np.random.default_rng(0)
    d = rng.uniform(0.2, 4.0, (24, 32)).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = 0.0
    out = tv.colorize_depth(d, *bounds)
    assert out.dtype == np.uint8 and out.shape == (24, 32, 3)
    np.testing.assert_array_equal(out, jv.colorize_depth(d, *bounds))
    assert not out[d == 0].any()
    np.testing.assert_array_equal(tv.colorize_depth(np.zeros((4, 4))),
                                  jv.colorize_depth(np.zeros((4, 4))))


def test_read_tum_trajectory_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    rows = ["# timestamp tx ty tz qx qy qz qw", ""]
    for i in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3)
        rows.append(f"{i / 30:.6f} " + " ".join(f"{v:.6f}" for v in
                                               (*t, *q)))
    path = tmp_path / "traj.txt"
    path.write_text("\n".join(rows) + "\n")
    got = tv.read_tum_trajectory(str(path))
    assert got.shape == (5, 4, 4)
    np.testing.assert_array_equal(got, jv.read_tum_trajectory(str(path)))
    empty = tmp_path / "empty.txt"
    empty.write_text("# nothing\n")
    assert tv.read_tum_trajectory(str(empty)).shape == (0, 4, 4)


def test_plots_written(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(2)
    c2w = np.tile(np.eye(4), (6, 1, 1))
    c2w[:, :3, 3] = np.cumsum(rng.normal(0, 0.05, (6, 3)), 0)
    tv.save_trajectory_plot(str(tmp_path / "traj.png"), c2w, c2w * 1.01)
    pts = rng.normal(size=(50, 3))
    T = np.eye(4)
    T[:3, 3] = [0.1, 0, 0]
    tv.save_registration_vis(str(tmp_path / "reg.png"), pts, pts + 0.1, T)
    for name in ("traj.png", "reg.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # A failure is swallowed (a path in a missing directory).
    tv.save_trajectory_plot(str(tmp_path / "no" / "dir.png"), c2w)
    assert not (tmp_path / "no").exists()
