"""The port's synthetic_hard scene (torch ray caster, exposure drift, numpy
sensor noise) against the JAX package's on the CPU.

Tolerances: uint8 colour within 1 level (the casts of float32 colours that
differ in the last bit can round to neighbouring levels); depth within
float16 rounding (1 ulp at the depth's magnitude), after the identical
noise draws.
"""
import numpy as np
import pytest
import torch

from eags_slam_tpu.config import load_config as j_load_config
from eags_slam_tpu.synthetic_hard import SyntheticHard as JSyntheticHard
from eags_slam_tpu.synthetic_hard import _raycast_fn
from eags_slam_torch.config import load_config
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.datasets import get_dataset
from eags_slam_torch.synthetic_hard import SyntheticHard, raycast


def _cfg(load):
    cfg = load("configs/synthetic/tiny.yaml")
    cfg["data"].update({"dataset_name": "synthetic_hard", "n_frames": 12,
                        "orbit_speed": 1.5 / 72, "depth_noise": 0.002,
                        "depth_dropout": 0.003, "exposure_amp": 0.08})
    cfg["seed"] = 3
    cfg["frame_limit"] = 4
    return cfg


def _f16_ulp(x):
    return np.spacing(np.abs(x).astype(np.float16)).astype(np.float32)


@pytest.mark.parametrize("frame", [0, 7])
def test_raycast_matches_jax(frame):
    """The noiseless ray cast at two poses of the bench orbit, 80x120 with
    off-centre intrinsics."""
    import jax.numpy as jnp

    from eags_slam_tpu.core.camera import Camera as JCamera
    from eags_slam_torch.datasets import orbit_poses

    cam = (95.0, 90.0, 61.5, 38.0, 120, 80)
    c2w = orbit_poses(frame + 1, 1.5 / 72)[frame].astype(np.float32)
    jc, jd = _raycast_fn(JCamera(*cam))(jnp.asarray(c2w))
    tc, td = raycast(torch.as_tensor(c2w), Camera(*cam))
    j8 = np.clip(np.asarray(jc) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    t8 = torch.clamp(tc * 255.0 + 0.5, 0, 255).to(torch.uint8).numpy()
    assert np.abs(j8.astype(int) - t8).max() <= 1
    jd = np.asarray(jd)
    assert jd.max() < 10.0                      # every ray hits the room
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5)


def test_dataset_frames_match_jax():
    jds = JSyntheticHard(_cfg(j_load_config))
    cfg = _cfg(load_config)
    tds = get_dataset("synthetic_hard")(cfg, device="cpu")
    assert isinstance(tds, SyntheticHard) and len(tds) == len(jds) == 4
    for i in range(len(tds)):
        np.testing.assert_allclose(tds.poses[i], jds.poses[i], atol=1e-12)
        assert tds.timestamps[i] == jds.timestamps[i]
        rgb8, d16 = tds._frames[i]
        j8, jd = (np.asarray(a) for a in jds._dev_cache[i])
        assert rgb8.dtype == torch.uint8 and d16.dtype == torch.float16
        assert np.abs(rgb8.numpy().astype(int) - j8.astype(int)).max() <= 1
        jd = jd.astype(np.float32)
        td = d16.numpy().astype(np.float32)
        np.testing.assert_array_equal(td == 0, jd == 0)   # the same dropout
        assert np.all(np.abs(td - jd) <= _f16_ulp(jd))
        color, depth = tds.frame(i)
        assert color.dtype == depth.dtype == torch.float32
        c8, d32 = tds.frame_u8(i)
        assert torch.equal(c8, rgb8) and torch.equal(d32, depth)
