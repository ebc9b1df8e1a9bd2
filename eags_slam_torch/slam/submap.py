"""Submap serialisation unit (port of eags_slam_tpu.slam.submap).

Gaussians are stored in the submap's anchor-keyframe frame, keyframe poses
as `Tmc` relative to the anchor, submaps chained by `T_prev_m`; re-anchoring
runs in host numpy float64. The npz keys are the JAX package's, so either
package reads the other's files.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


def _rotmat_to_quat_np(R: np.ndarray) -> np.ndarray:
    """f64 matrix -> wxyz quaternion (single)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _quat_mul_np(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product, q1 single (4,), q2 batch (N, 4)."""
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2[:, 0], q2[:, 1], q2[:, 2], q2[:, 3]
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


@dataclass
class Submap:
    submap_id: int
    kf_id: int                      # global frame id of the anchor keyframe
    T_prev_m: np.ndarray            # (4,4) f64: anchor in previous anchor's frame
    Tmc: np.ndarray                 # (K,4,4) f64: keyframe poses in anchor frame
    kf_frame_ids: List[int]
    gaussians: Dict[str, np.ndarray] = field(default_factory=dict)
    # anchor-frame packed arrays: xyz, f_dc, f_rest, log_scales, quats,
    # opacity_logits
    # Per-keyframe global descriptors computed at map time (loop closure
    # reads them instead of re-describing every keyframe). None when
    # unavailable.
    descs: "np.ndarray | None" = None

    @staticmethod
    def from_world_arrays(
        submap_id: int, kf_id: int, Twm: np.ndarray, T_prev_m: np.ndarray,
        Tmc: np.ndarray, kf_frame_ids: List[int], world_gauss: Dict[str, np.ndarray],
        descs: "np.ndarray | None" = None,
    ) -> "Submap":
        """Convert world-frame packed gaussians into the anchor frame (f64
        rotation of means + quaternions, reference submap.py:72-107)."""
        T_mw = np.linalg.inv(np.asarray(Twm, np.float64))
        R, t = T_mw[:3, :3], T_mw[:3, 3]
        q_mw = _rotmat_to_quat_np(R)
        g = dict(world_gauss)
        g["xyz"] = (world_gauss["xyz"].astype(np.float64) @ R.T + t).astype(
            np.float32
        )
        g["quats"] = _quat_mul_np(
            q_mw, world_gauss["quats"].astype(np.float64)
        ).astype(np.float32)
        return Submap(submap_id, kf_id, np.asarray(T_prev_m, np.float64),
                      np.asarray(Tmc, np.float64), list(kf_frame_ids), g,
                      descs)

    def restore_world(self, Twm: np.ndarray) -> Dict[str, np.ndarray]:
        """Anchor-frame gaussians -> world frame given the (possibly
        loop-corrected) anchor pose (reference restore_gauss :39-70)."""
        T = np.asarray(Twm, np.float64)
        R, t = T[:3, :3], T[:3, 3]
        q_wm = _rotmat_to_quat_np(R)
        out = dict(self.gaussians)
        out["xyz"] = (self.gaussians["xyz"].astype(np.float64) @ R.T + t).astype(
            np.float32
        )
        out["quats"] = _quat_mul_np(
            q_wm, self.gaussians["quats"].astype(np.float64)
        ).astype(np.float32)
        return out

    def path(self, out_dir: str) -> str:
        return os.path.join(out_dir, "submaps", f"{self.submap_id:06d}.npz")

    def save(self, out_dir: str) -> str:
        p = self.path(out_dir)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        extra = {}
        if self.descs is not None:
            extra["descs"] = np.asarray(self.descs, np.float32)
        gauss = dict(self.gaussians)
        # All-zero f_rest is written as the (0, ...) marker (inverse of the
        # load-side densify).
        fr = gauss.get("f_rest")
        if fr is not None and fr.size and not np.any(fr):
            gauss["f_rest"] = np.zeros((0,) + fr.shape[1:], fr.dtype)
        # Uncompressed: the write sits on the SLAM loop's critical path.
        np.savez(
            p,
            submap_id=self.submap_id,
            kf_id=self.kf_id,
            T_prev_m=self.T_prev_m,
            Tmc=self.Tmc,
            kf_frame_ids=np.asarray(self.kf_frame_ids, np.int64),
            **extra,
            **{f"g_{k}": v for k, v in gauss.items()},
        )
        return p

    @staticmethod
    def load(path: str) -> "Submap":
        z = np.load(path)
        gauss = {k[2:]: z[k] for k in z.files if k.startswith("g_")}
        # All-zero f_rest is stored as a (0, ...) marker (see pack_state);
        # rebuild the dense zeros so consumers keep a uniform schema.
        fr = gauss.get("f_rest")
        if fr is not None and fr.shape[0] == 0 and "xyz" in gauss:
            gauss["f_rest"] = np.zeros(
                (gauss["xyz"].shape[0],) + fr.shape[1:], fr.dtype
            )
        return Submap(
            submap_id=int(z["submap_id"]),
            kf_id=int(z["kf_id"]),
            T_prev_m=z["T_prev_m"],
            Tmc=z["Tmc"],
            kf_frame_ids=list(z["kf_frame_ids"]),
            gaussians=gauss,
            descs=z["descs"] if "descs" in z.files else None,
        )


def pack_state(state) -> Dict[str, np.ndarray]:
    """Alive rows of a GaussianState -> host numpy dict (world frame). An
    all-zero `f_rest` travels as the (0, 15, 3) marker."""
    alive = state.alive.detach().cpu().numpy()
    p = state.params

    def host(x):
        return x.detach().cpu().numpy()[alive]

    if bool((p.f_rest != 0).any()):
        f_rest = host(p.f_rest)
    else:
        f_rest = np.zeros((0,) + tuple(p.f_rest.shape[1:]), np.float32)
    return {
        "xyz": host(p.xyz),
        "f_dc": host(p.f_dc),
        "f_rest": f_rest,
        "log_scales": host(p.log_scales),
        "quats": host(p.quats),
        "opacity_logits": host(p.opacity_logits),
    }
