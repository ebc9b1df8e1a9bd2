"""The JAX orchestrator's run-level environment overrides
(eags_slam_tpu/slam/gaussian_slam.py:127-206): EAGS_INIT_HALFRES,
EAGS_INIT_WARM and EAGS_MAP_STALE in the MapperConfig, EAGS_STALE_BEST and
EAGS_POSE_KERNEL in the TrackerConfig, EAGS_SP_TRACK in the tracker. With
each set in turn, over a config that says otherwise, the port builds the
same configs as the JAX GaussianSLAM (built as its __init__ builds them, on
a dataset stub that holds only the camera: no frame is rendered, nothing
runs); env over config, `int` then `bool` for the flags, so "0" turns an
option off."""
import pathlib

import pytest

from eags_slam_tpu.config import load_config as j_load_config
from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.slam import gaussian_slam as JGS
from eags_slam_torch.config import load_config
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.slam import gaussian_slam as TGS

REPO = pathlib.Path(__file__).resolve().parents[1]
ENV = ("EAGS_INIT_HALFRES", "EAGS_INIT_WARM", "EAGS_MAP_STALE",
       "EAGS_STALE_BEST", "EAGS_POSE_KERNEL", "EAGS_SP_TRACK",
       "EAGS_RCFG", "EAGS_RMW_WINDOW")


class _CameraOnly:
    """A frame source with the config's camera and no frames."""

    def __init__(self, config):
        c = config["cam"]
        self.camera = JCamera(c["fx"], c["fy"], c["cx"], c["cy"], c["W"],
                              c["H"])
        self.full_camera = self.camera

    def __len__(self):
        return 0

    def start_prefetch(self):
        pass

    def close(self):
        pass


# (variable, value, config section, key, config value the variable
# overrides)
CASES = [
    (None, None, "mapping", "init_warm_start", True),
    ("EAGS_INIT_HALFRES", "0.25", "mapping", "init_halfres_frac", 0.5),
    ("EAGS_INIT_WARM", "0", "mapping", "init_warm_start", True),
    ("EAGS_INIT_WARM", "1", "mapping", "init_warm_start", False),
    ("EAGS_MAP_STALE", "7", "mapping", "stale_best_cnt", 20),
    ("EAGS_STALE_BEST", "5", "tracking", "stale_best_cnt", 15),
    ("EAGS_POSE_KERNEL", "0", "tracking", "pose_grad_kernel", True),
    ("EAGS_POSE_KERNEL", "1", "tracking", "pose_grad_kernel", False),
    ("EAGS_SP_TRACK", "1", "tracking", "sp_track", False),
    ("EAGS_SP_TRACK", "0", "tracking", "sp_track", True),
]


@pytest.mark.parametrize("var,value,section,key,cfg_value", CASES,
                         ids=lambda v: str(v))
def test_env_override_matches_jax(var, value, section, key, cfg_value,
                                  monkeypatch, tmp_path):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    if var is not None:
        monkeypatch.setenv(var, value)
    configs = []
    for load in (j_load_config, load_config):
        cfg = load(str(REPO / "configs/synthetic/tiny.yaml"))
        cfg[section][key] = cfg_value
        # A mesh in both, so that the JAX tracker's sp_track shows.
        cfg["force_mesh"] = True
        cfg["data"]["output_path"] = str(tmp_path / "jax")
        configs.append(cfg)
    monkeypatch.setattr(JGS, "get_dataset", lambda name: _CameraOnly)
    jslam = JGS.GaussianSLAM(configs[0])
    try:
        cfg = configs[1]
        c = cfg["cam"]
        cam = Camera(c["fx"], c["fy"], c["cx"], c["cy"], c["W"], c["H"])
        mcfg, tcfg = TGS.mapper_config(cfg, cam), TGS.tracker_config(cfg)
        assert mcfg._asdict() == {f: getattr(jslam.mcfg, f)
                                  for f in mcfg._fields}
        assert tcfg._asdict() == {f: getattr(jslam.tcfg, f)
                                  for f in tcfg._fields}
        assert TGS.sp_track_enabled(cfg) is \
            (jslam.tracker._sp_refine is not None)
    finally:
        jslam.cleanup()
    if var is not None:
        # The variable won over the config.
        got = (TGS.sp_track_enabled(cfg) if key == "sp_track"
               else getattr(mcfg if section == "mapping" else tcfg, key))
        want = float(value) if key == "init_halfres_frac" else (
            int(value) if key.endswith("cnt") else bool(int(value)))
        assert got == want and got != cfg_value
