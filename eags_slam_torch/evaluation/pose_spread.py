"""Frame-by-frame spread between two SLAM runs of the same configuration and
seeds: how far their estimated poses (`estimated_c2w.npz`) part, and where
a difference first enters: their VO trajectories (`vo_traj_tum.txt`, when
both runs wrote one) and the per-frame mapping and tracking records of
`log.jsonl` (losses, counts; timings left out).

    python -m eags_slam_torch.evaluation.pose_spread RUN_A RUN_B

Prints one JSON object: per frame the translation difference (m) and the
rotation angle between the two poses (deg); the first frame whose poses
differ at all, and the largest differences; for the VO the same; for the
mapping and tracking records the first frame with a field that differs,
and those fields. Host-side numpy only.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np


def _rot_deg(ra: np.ndarray, rb: np.ndarray) -> np.ndarray:
    """Angle of ra^T rb per frame, in degrees: (N, 3, 3) x2 -> (N,). Taken
    as atan2(|axis part|, cos part), which keeps its precision near zero
    (an arccos of the trace loses half the digits there)."""
    r = np.einsum("nji,njk->nik", ra, rb)
    s = np.stack([r[:, 2, 1] - r[:, 1, 2], r[:, 0, 2] - r[:, 2, 0],
                  r[:, 1, 0] - r[:, 0, 1]], -1)
    tr = r[:, 0, 0] + r[:, 1, 1] + r[:, 2, 2]
    return np.degrees(np.arctan2(0.5 * np.linalg.norm(s, axis=-1),
                                 0.5 * (tr - 1.0)))


def _spread(ta: np.ndarray, tb: np.ndarray, ra: np.ndarray,
            rb: np.ndarray) -> Dict:
    dt = np.linalg.norm(ta - tb, axis=1)
    dr = _rot_deg(ra, rb)
    parted = np.nonzero((dt > 0) | (dr > 0))[0]
    return {"frames": int(dt.shape[0]),
            "first_differing_frame": int(parted[0]) if parted.size else None,
            "max_trans_m": float(dt.max()) if dt.size else 0.0,
            "max_rot_deg": float(dr.max()) if dr.size else 0.0,
            "trans_m": dt.tolist(), "rot_deg": dr.tolist()}


def _quat_xyzw_to_rot(q: np.ndarray) -> np.ndarray:
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = (q[:, i] for i in range(4))
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], 1)


def _tum(path: str) -> Optional[np.ndarray]:
    return np.loadtxt(path, ndmin=2) if os.path.exists(path) else None


def _log_records(run: str, kind: str) -> Dict[int, Dict]:
    """The `kind` records of a run's log.jsonl by frame, without their
    timings (`t`, `*_ms`)."""
    path = os.path.join(run, "log.jsonl")
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("kind") == kind:
                    out[rec["frame"]] = {
                        k: v for k, v in rec.items()
                        if k not in ("t", "kind", "frame")
                        and not k.endswith("_ms")}
    return out


def _first_record_difference(a: Dict[int, Dict], b: Dict[int, Dict]) -> Dict:
    frames = sorted(set(a) & set(b))
    first = None
    for fr in frames:
        fields = sorted(k for k in set(a[fr]) | set(b[fr])
                        if a[fr].get(k) != b[fr].get(k))
        if fields:
            first = {"frame": fr, "fields": fields}
            break
    return {"frames": len(frames), "first_difference": first}


def pose_spread(run_a: str, run_b: str) -> Dict:
    """The spread between runs `run_a` and `run_b` (output directories)."""
    ca = np.load(os.path.join(run_a, "estimated_c2w.npz"))["c2ws"]
    cb = np.load(os.path.join(run_b, "estimated_c2w.npz"))["c2ws"]
    if ca.shape != cb.shape:
        raise ValueError(f"trajectories differ in shape: {ca.shape} "
                         f"against {cb.shape}")
    out = {"poses": _spread(ca[:, :3, 3], cb[:, :3, 3], ca[:, :3, :3],
                            cb[:, :3, :3])}
    va = _tum(os.path.join(run_a, "vo_traj_tum.txt"))
    vb = _tum(os.path.join(run_b, "vo_traj_tum.txt"))
    if va is not None and vb is not None and va.shape == vb.shape:
        out["vo"] = _spread(va[:, 1:4], vb[:, 1:4],
                            _quat_xyzw_to_rot(va[:, 4:8]),
                            _quat_xyzw_to_rot(vb[:, 4:8]))
    for kind in ("mapping", "tracking"):
        ra, rb = _log_records(run_a, kind), _log_records(run_b, kind)
        if ra and rb:
            out[kind] = _first_record_difference(ra, rb)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_a")
    p.add_argument("run_b")
    args = p.parse_args()
    print(json.dumps(pose_spread(args.run_a, args.run_b)), flush=True)


if __name__ == "__main__":
    main()
