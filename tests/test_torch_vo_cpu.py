"""`vo.device: cpu`: the edge VO on the host CPU, pipelined one frame ahead
on its worker thread, against the inline VO (the default device, stepped
in the loop's thread), in decoupled and in coupled mode.

Tiny synthetic_hard runs (96x64, 5 frames, the odometer, _CHEAP
iterations) on the CPU. The pipelined step sees the inline step's inputs
(the same host frame) and pose chain (submitted only once that chain is
final: after frame f's step when decoupled, after its set_pose when
coupled, and after set_pose at frames 0 and 1), so every SLAM pose, every
VO pose and every seeding edge map equal the inline run's bit for bit.
"""
import json
import threading

import numpy as np
import pytest
import torch

from eags_slam_torch.slam.gaussian_slam import GaussianSLAM
from test_torch_guards import _CHEAP, _tiny

N = 5


def _run(tmp_path, device, decoupled):
    cfg = _tiny(tmp_path / f"{device}_{decoupled}", frames=N, **_CHEAP)
    cfg["data"].update({"dataset_name": "synthetic_hard", "n_frames": N})
    cfg["tracking"]["odometry_type"] = "odometer"
    cfg["vo"] = {"device": device, "decoupled": decoupled}
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    gslam = GaussianSLAM(cfg)
    steps, edges = [], {}
    step = gslam.odometer.step

    def recording(rgb, depth, ts):
        steps.append((threading.current_thread().name, rgb.device.type))
        return step(rgb, depth, ts)

    gslam.odometer.step = recording
    vo_edges = gslam._vo_edges

    def edges_of(fid):
        e = vo_edges(fid)
        edges[fid] = None if e is None else e.clone()
        return e

    gslam._vo_edges = edges_of
    try:
        report = gslam.run()
        vo_poses = np.stack([gslam.odometer.get_pose(i) for i in range(N)])
        pyr_dev = gslam.odometer.keyframes[-1].pyramid.levels[0].pts.device
    finally:
        gslam.cleanup()
        torch.set_num_threads(threads)
    with open(cfg["data"]["output_path"] + "/log.jsonl") as f:
        track = [json.loads(r) for r in f if '"tracking"' in r]
    return dict(c2w=gslam.estimated_c2ws.copy(), vo=vo_poses, steps=steps,
                edges=edges, report=report, pyr_dev=pyr_dev,
                track=[r for r in track if r["kind"] == "tracking"],
                pool=gslam._vo_pool)


@pytest.mark.parametrize("decoupled", [True, False],
                         ids=["decoupled", "coupled"])
def test_cpu_pipelined_vo_equals_inline(tmp_path, decoupled):
    inline = _run(tmp_path, "default", decoupled)
    piped = _run(tmp_path, "cpu", decoupled)
    # Bit for bit: SLAM poses, the VO's pose graph, the seeding edges.
    np.testing.assert_array_equal(piped["c2w"], inline["c2w"])
    np.testing.assert_array_equal(piped["vo"], inline["vo"])
    assert sorted(piped["edges"]) == sorted(inline["edges"])
    for fid, e in inline["edges"].items():
        assert e is not None and torch.equal(piped["edges"][fid], e)
    # The odometer candidate was scored (frames 3 and 4).
    assert piped["report"]["tracker"]["init_pose_cnt"] \
        == inline["report"]["tracker"]["init_pose_cnt"]
    # Inline: every step in the loop's thread, nothing pipelined.
    assert inline["pool"] is None
    assert inline["report"]["vo"]["pipelined"] == 0
    assert {name for name, _ in inline["steps"]} \
        == {threading.current_thread().name}
    # Pipelined: frame 0 in the loop's thread, frames 1..N-1 on the
    # worker, all on CPU tensors.
    vo = piped["report"]["vo"]
    assert vo["device"] == "cpu" and vo["pipelined"] == N - 1
    assert piped["steps"][0][0] == threading.current_thread().name
    assert all(name.startswith("eags-vo") for name, _ in piped["steps"][1:])
    assert {dev for _, dev in piped["steps"]} == {"cpu"}
    assert piped["pyr_dev"].type == "cpu"
    assert len(piped["track"]) == N - 2
    for rec in piped["track"] + inline["track"]:
        assert rec["vo_wait_ms"] >= 0.0 and rec["vo_ms"] > 0.0
