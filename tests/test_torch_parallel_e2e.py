"""The port's SLAM loop over a 2-rank gloo mesh on the CPU: the JAX
package's `test_e2e_sp_tracking` protocol (tests/test_parallel.py:395-428:
configs/synthetic/base.yaml at 64x96, 8 frames, 15 tracking iterations,
`tracking.sp_track` on, `use_mesh` true), with the mapping data-parallel
over both ranks and the tracking refinement tile-split over them. Every
frame's position error stays under the JAX test's 4 cm, both ranks end on
the same poses and the same map bit for bit, and only rank 0 writes."""
import os
import pathlib

import numpy as np
import pytest

import torch_mesh_ranks as R
from eags_slam_torch.config import load_config

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e")
    config = load_config(str(REPO / "configs/synthetic/base.yaml"))
    config["device"] = "cpu"
    config["use_mesh"] = True
    config["data"]["n_frames"] = 8
    config["cam"].update({"H": 64, "W": 96, "fx": 80.0, "fy": 80.0,
                          "cx": 47.5, "cy": 31.5})
    config["mapping"].update({
        "new_submap_every": 6, "iterations": 40,
        "new_submap_iterations": 80, "max_gaussians": 8192,
        "new_submap_points_num": 2000,
        "new_submap_gradient_points_num": 500,
        "new_frame_sample_size": 500,
    })
    config["tracking"].update({"iterations": 15, "sp_track": True})
    outs = [str(tmp / "rank0"), str(tmp / "rank1")]
    res = R.run(2, tmp / "spawn", {"slam": ("slam", dict(
        config=config, out_paths=outs))})
    return [r["slam"] for r in res], outs


def test_e2e_sp_tracking_two_ranks(ranks):
    res, _ = ranks
    r0 = res[0]
    assert r0["frames"] == 8
    assert r0["wired"] == (2, True, True) and res[1]["wired"] == (2, True,
                                                                   False)
    err = np.linalg.norm(r0["c2ws"][:, :3, 3] - r0["gt"][:, :3, 3], axis=-1)
    assert err.max() < 0.04, err
    # Tracking ran tile-split: per refinement iteration one all-gather.
    assert r0["mesh"]["collectives"]["all_gather"] > 0
    assert r0["mesh"]["replicated"] is True     # the run's own check


def test_ranks_agree_bit_for_bit(ranks):
    res, _ = ranks
    np.testing.assert_array_equal(res[0]["c2ws"], res[1]["c2ws"])
    for k, v in res[0]["state"].items():
        np.testing.assert_array_equal(v, res[1]["state"][k], err_msg=k)
    assert res[0]["mesh"] == res[1]["mesh"]


def test_only_rank_zero_writes(ranks):
    _, outs = ranks
    assert not os.path.exists(outs[1])
    files = set(os.listdir(outs[0]))
    assert {"config.yaml", "log.jsonl", "estimated_c2w.npz",
            "submaps"} <= files
    assert len(os.listdir(os.path.join(outs[0], "submaps"))) == 2
