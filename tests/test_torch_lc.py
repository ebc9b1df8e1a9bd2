"""The port's LoopClosure against the JAX package's, on submap files the
test writes: detection (twin of test_lc_round3.py's recall / precision
scenario), the drained corrections (twins of test_lc_drain.py) and the
rewritten T_prev_m, a whole gs_reg pass over three submaps with a revisit
(the JAX closer on the sorted backend in Pallas interpret mode), the
worker thread against the inline pass, an exception in the worker, the
closer's launches counted apart from the main path's, and the NetVLAD gate
(twin of test_netvlad.py). Tolerances are stated in each test."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eags_slam_tpu.lc.netvlad as j_netvlad
from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.core.se3 import se3_exp as j_se3_exp
from eags_slam_tpu.core.sh import rgb_to_sh as j_rgb_to_sh
from eags_slam_tpu.core.sh import sh_to_rgb as j_sh_to_rgb
from eags_slam_tpu.lc.loop_closure import LoopClosure as JLoopClosure
from eags_slam_tpu.lc.loop_closure import _SubmapInfo as JInfo
from eags_slam_tpu.ops.rasterizer import RasterConfig as JRaster
from eags_slam_tpu.ops.rasterizer import render as j_render
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.lc import netvlad as t_netvlad
from eags_slam_torch.lc.descriptor import GlobalDesc
from eags_slam_torch.lc.loop_closure import LC_TAG, LoopClosure, _SubmapInfo
from eags_slam_torch.ops import composite_sorted as cs
from eags_slam_torch.slam.submap import Submap

CAM = Camera(fx=70.0, fy=70.0, cx=31.5, cy=23.5, width=64, height=48)
JCAM = JCamera(*CAM)


def _translation(t):
    T = np.eye(4)
    T[:3, 3] = t
    return T


class _Frames:
    """dataset[fid] -> (fid, color (H, W, 3), depth (H, W), pose)."""

    def __init__(self, frames, poses=None):
        self.frames = frames
        self.poses = poses if poses is not None else {}

    def __getitem__(self, fid):
        color, depth = self.frames[fid]
        return fid, color, depth, self.poses.get(fid, np.eye(4))

    def device_frame(self, fid):
        """The JAX closer asks for a device-resident frame first."""
        return None


def _closers(tmp_path, lc_cfg, dataset=None):
    """Both packages' closers; their registrations render through the
    sorted backend at tile 16 with 256-lane band segments in place of the
    closers' 1024: a band of these 300-gaussian maps holds far fewer than
    256, so the renders are the same, and the JAX side's interpret-mode
    kernels run fewer lanes."""
    config = {"lc": dict({"enabled": True, "parallel": False,
                          "min_interval": 2}, **lc_cfg),
              "mapping": {"max_gaussians": 4096, "tile_capacity": 128}}
    jlc = JLoopClosure(config, str(tmp_path / "jax"), JCAM, dataset=dataset)
    jlc.rcfg = jlc.rcfg._replace(backend="sorted", seg_cap=256)
    tlc = LoopClosure(config, str(tmp_path / "port"), CAM, dataset=dataset)
    tlc.rcfg = tlc.rcfg._replace(seg_cap=256)
    return jlc, tlc


def _gaussians(pts):
    n = pts.shape[0]
    return {"xyz": pts.astype(np.float32),
            "f_dc": np.zeros((n, 3), np.float32),
            "f_rest": np.zeros((n, 15, 3), np.float32),
            "log_scales": np.full((n, 3), -3.0, np.float32),
            "quats": np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
            "opacity_logits": np.zeros((n, 1), np.float32)}


def _write_submap(out_dirs, sid, kf_id, frame_ids, g, T_prev_m=None,
                  Tmc=None):
    sm = Submap(sid, kf_id, np.eye(4) if T_prev_m is None else T_prev_m,
                np.stack([np.eye(4)] * len(frame_ids)) if Tmc is None
                else Tmc, list(frame_ids), g)
    for d in out_dirs:
        sm.save(str(d))


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------


def _room_image(room_seed, view, rng_global):
    """tests/test_lc_round3.py's room appearance with per-view variation."""
    rng = np.random.default_rng(room_seed)
    h, w = 48, 64
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    fu, fv = rng.uniform(0.15, 0.6, 2)
    base = rng.uniform(0.2, 0.8, 3)
    orient = rng.uniform(0, np.pi)
    uu = np.cos(orient) * u + np.sin(orient) * v
    shift = 9.0 * view
    img = np.stack([
        0.5 + 0.5 * np.sin(fu * (u + shift) + 2 * np.pi * base[0]),
        0.5 + 0.5 * np.sin(fv * v + 0.7 * fu * (uu + shift)),
        ((np.floor((u + shift) / (3 + 9 * base[2])) + np.floor(v / 5)) % 2),
    ], axis=-1).astype(np.float32)
    img += rng_global.normal(scale=0.02, size=img.shape).astype(np.float32)
    return np.clip(img, 0, 1)


def test_detect_closures_recall_precision(tmp_path, rng):
    """Four different rooms, then a revisit of room 0: each package loads
    the submap files (no saved descriptors: each describes the dataset's
    frames itself) and detects room 0 only. Descriptors agree to 1e-4,
    self-similarity thresholds to 1e-4, matches exactly."""
    frames, ids = {}, []
    for s in range(5):
        room = 1000 + (0 if s == 4 else s)
        off = 0.04 if s == 4 else 0.0
        fids = list(range(4 * s, 4 * s + 4))
        for k, fid in enumerate(fids):
            frames[fid] = (_room_image(room, k + off, rng),
                           np.ones((48, 64), np.float32))
        ids.append(fids)
    ds = _Frames(frames)
    jlc, tlc = _closers(tmp_path, {"min_similarity": 0.7,
                                   "self_sim_topk": 3}, ds)
    pts = rng.uniform(-1, 1, (200, 3))
    for s, fids in enumerate(ids):
        _write_submap([tmp_path / "jax", tmp_path / "port"], s, fids[0], fids,
                      _gaussians(pts))
        jlc._load_submap_info(s, fids[-1] + 1)
        tlc._load_submap_info(s, fids[-1] + 1)
    for ji, ti in zip(jlc.infos, tlc.infos):
        np.testing.assert_allclose(ti.descriptors, ji.descriptors, atol=1e-4)
        np.testing.assert_allclose(ti.self_sim_thre, ji.self_sim_thre,
                                   atol=1e-4)
        assert ti.start_frame == ji.start_frame
    matches = tlc._detect_closures(4)
    assert matches == jlc._detect_closures(4) == [0]


# ---------------------------------------------------------------------------
# drained corrections and the rewritten submap files
# ---------------------------------------------------------------------------


def _fake_infos(cls, ranges):
    out = []
    for start, end in ranges:
        sm = types.SimpleNamespace(T_prev_m=np.eye(4), save=lambda path: None)
        out.append(cls(submap=sm, descriptors=np.zeros((0, 8)),
                       self_sim_thre=np.zeros((0,)), start_frame=start,
                       end_frame=end))
    return out


def test_drain_applies_deltas_to_live_array(tmp_path):
    """Twin of test_lc_drain.py::test_drain_applies_deltas_to_live_array,
    the port's drained ranges equal to JAX's (atol 1e-12)."""
    jlc, tlc = _closers(tmp_path, {})
    jlc.infos = _fake_infos(JInfo, [(0, 5), (5, 10)])
    tlc.infos = _fake_infos(_SubmapInfo, [(0, 5), (5, 10)])
    anchors = np.stack([np.eye(4), _translation([1.0, 0, 0])])
    corrected = np.stack([np.eye(4), _translation([1.5, 0, 0])])
    jlc._apply_corrections(anchors, corrected, np.tile(np.eye(4), (10, 1, 1)))
    tlc._apply_corrections(anchors, corrected, np.tile(np.eye(4), (10, 1, 1)))
    corrs, jcorrs = tlc.drain_corrections(), jlc.drain_corrections()
    assert len(corrs) == len(jcorrs) == 2
    for (s, e, c), (js, je, jc) in zip(corrs, jcorrs):
        assert (s, e) == (js, je)
        np.testing.assert_allclose(c, jc, atol=1e-12)
    assert corrs[-1][1] is None
    assert tlc.drain_corrections() is None
    live = np.tile(np.eye(4), (14, 1, 1))
    for f in range(14):
        live[f][:3, 3] = [0.1 * f, 0.0, 0.0]
    expect = live.copy()
    for start, end, corr in corrs:
        e = len(live) if end is None else end
        live[start:e] = corr @ live[start:e]
    np.testing.assert_allclose(live[:5], expect[:5], atol=1e-12)
    np.testing.assert_allclose(live[5:], _translation([0.5, 0, 0])
                               @ expect[5:], atol=1e-12)


def test_pending_accumulates_across_passes(tmp_path):
    """Twin of test_lc_drain.py::test_pending_accumulates_across_passes."""
    _, tlc = _closers(tmp_path, {})
    tlc.infos = _fake_infos(_SubmapInfo, [(0, 5)])
    anchors = np.eye(4)[None]
    corrected = _translation([0.2, 0, 0])[None]
    twc = np.tile(np.eye(4), (5, 1, 1))
    tlc._apply_corrections(anchors, corrected, twc.copy())
    tlc._apply_corrections(anchors, corrected, twc.copy())
    assert len(tlc.drain_corrections()) == 2


def test_apply_corrections_rewrites_submap_files(tmp_path, rng):
    """T_prev_m of every submap becomes inv(corrected[s-1]) @ corrected[s],
    in memory and in the file, as the JAX closer writes it (atol 1e-12);
    the pose array's ranges move by each submap's correction."""
    jlc, tlc = _closers(tmp_path, {})
    ds = _Frames({f: (np.zeros((48, 64, 3), np.float32),
                      np.zeros((48, 64), np.float32)) for f in range(9)})
    jlc.dataset = tlc.dataset = ds
    anchors = np.stack([np.eye(4), _translation([0.4, 0, 0]),
                        _translation([0.8, 0.1, 0])])
    pts = rng.uniform(-1, 1, (50, 3))
    for s in range(3):
        T_prev = anchors[0] if s == 0 else \
            np.linalg.inv(anchors[s - 1]) @ anchors[s]
        _write_submap([tmp_path / "jax", tmp_path / "port"], s, 3 * s,
                      [3 * s], _gaussians(pts), T_prev_m=T_prev)
        jlc._load_submap_info(s, 3 * s + 3)
        tlc._load_submap_info(s, 3 * s + 3)
    np.testing.assert_allclose(tlc._anchor_world_poses(), anchors,
                               atol=1e-12)
    corrected = np.stack([np.eye(4), _translation([0.41, 0.01, 0]),
                          _translation([0.75, 0.12, 0.02])])
    twc = np.tile(np.eye(4), (9, 1, 1))
    jlc._apply_corrections(anchors, corrected, twc.copy())
    tlc._apply_corrections(anchors, corrected, twc.copy())
    for s in range(3):
        want = corrected[0] if s == 0 else \
            np.linalg.inv(corrected[s - 1]) @ corrected[s]
        t_file = Submap.load(str(tmp_path / "port" / "submaps"
                                 / f"{s:06d}.npz"))
        j_file = Submap.load(str(tmp_path / "jax" / "submaps"
                                 / f"{s:06d}.npz"))
        np.testing.assert_allclose(t_file.T_prev_m, want, atol=1e-12)
        np.testing.assert_allclose(t_file.T_prev_m, j_file.T_prev_m,
                                   atol=1e-12)
    np.testing.assert_allclose(tlc._twc, jlc._twc, atol=1e-12)
    tlc.save_twc()
    jlc.save_twc()
    np.testing.assert_allclose(
        np.load(tmp_path / "port" / "estimated_c2w.npz")["c2ws"],
        np.load(tmp_path / "jax" / "estimated_c2w.npz")["c2ws"], atol=1e-12)


def test_pgo_analysis_matches_jax(tmp_path, rng):
    """Twin of test_lc.py::test_pgo_analysis_artifacts (verbose runs): the
    same pgo/<n>/pgo_analysis.json as the JAX closer's, to 1e-9."""
    import json

    n = 4
    step = np.asarray(j_se3_exp(jnp.asarray([0.4, 0.0, 0.0, 0.0, 0.15,
                                             0.0])))
    poses = [np.eye(4)]
    for _ in range(1, n):
        poses.append(poses[-1] @ step)
    ds = _Frames({}, {i * 10: p for i, p in enumerate(poses)})
    config = {"lc": {"enabled": True}, "mapping": {"max_gaussians": 64},
              "verbose": True}
    jlc = JLoopClosure(config, str(tmp_path / "jax"), JCAM, dataset=ds)
    tlc = LoopClosure(config, str(tmp_path / "port"), CAM, dataset=ds)
    for lc, cls in ((jlc, JInfo), (tlc, _SubmapInfo)):
        for i in range(n):
            sm = Submap(i, i * 10, np.eye(4), np.eye(4)[None], [i * 10], {})
            lc.infos.append(cls(sm, np.zeros((1, 8)), np.zeros(1), i * 10,
                                i * 10 + 10))
    anchors = np.stack([p @ np.asarray(j_se3_exp(jnp.asarray(
        rng.normal(size=6) * 0.01, jnp.float32))) for p in poses])
    corrected = np.stack(poses)
    edges_ij = [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]
    edges_T = [np.linalg.inv(anchors[i]) @ anchors[j]
               for i, j in edges_ij[:-1]]
    edges_T.append(np.linalg.inv(poses[0]) @ poses[-1])
    is_loop = [False] * (n - 1) + [True]
    jlc._pgo_count = tlc._pgo_count = 1
    jlc._analyse_pgo(anchors, corrected, edges_ij, edges_T, is_loop,
                     np.tile(np.eye(4), (40, 1, 1)))
    tlc._analyse_pgo(anchors, corrected, edges_ij, edges_T, is_loop)
    reps = []
    for side in ("jax", "port"):
        with open(tmp_path / side / "pgo" / "1" / "pgo_analysis.json") as f:
            reps.append(json.load(f))
    j, t = reps
    assert [(e["i"], e["j"], e["type"]) for e in t["edges"]] == \
        [(e["i"], e["j"], e["type"]) for e in j["edges"]]
    for et, ej in zip(t["edges"], j["edges"]):
        for k in ("rot_err_deg", "trans_err_cm"):
            assert abs(et[k] - ej[k]) < 1e-9
    for k in ("anchor_ate_before_m", "anchor_ate_after_m"):
        assert abs(t[k] - j[k]) < 1e-9
    assert t["anchor_ate_after_m"] < 1e-6


# ---------------------------------------------------------------------------
# a whole gs_reg pass
# ---------------------------------------------------------------------------

# Three submaps of one scene: anchors at the origin, 4 cm to the side, and
# back at the origin (the revisit) but with a drifted estimate.
DRIFT = [0.03, -0.02, 0.015, 0.008, -0.01, 0.008]
LC_CFG = {"pose_opt_iters": 40, "localize_restarts": 2, "localize_level": 0,
          "top_views": 1, "overlap_thre": 0.1}


def _revisit_scene(rng, n=300):
    xyz = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                    rng.uniform(1.5, 3.0, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    g = {"xyz": xyz,
         "f_dc": np.asarray(j_rgb_to_sh(jnp.asarray(
             rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)))),
         "f_rest": np.zeros((n, 15, 3), np.float32),
         "log_scales": np.log(rng.uniform(0.06, 0.15, (n, 3))).astype(
             np.float32),
         "quats": q,
         "opacity_logits": rng.uniform(1.5, 4.0, (n, 1)).astype(np.float32)}
    true = [np.eye(4), _translation([0.04, 0.0, 0.0]), np.eye(4)]
    drift = np.asarray(j_se3_exp(jnp.asarray(DRIFT)), np.float64)
    est = [true[0], true[1], true[2] @ drift]
    rcfg = JRaster(tile=16, dup_side=4, backend="sorted", seg_cap=256)
    frames = {}
    for s, P in enumerate(true):
        out = j_render(jnp.asarray(g["xyz"]), jnp.asarray(g["quats"]),
                       jnp.asarray(g["log_scales"]),
                       jnp.asarray(g["opacity_logits"]),
                       j_sh_to_rgb(jnp.asarray(g["f_dc"])),
                       jnp.asarray(np.linalg.inv(P), dtype=jnp.float32),
                       JCAM, rcfg)
        depth = np.asarray(jnp.where(
            out.alpha > 0.5, out.depth / jnp.maximum(out.alpha, 1e-6), 0.0))
        frames[3 * s] = (np.asarray(jnp.clip(out.color, 0, 1)), depth)
    return g, true, est, frames


def _write_revisit(out_dir, g, true, est):
    for s in range(3):
        Ti = np.linalg.inv(true[s])
        local = dict(g)
        local["xyz"] = (g["xyz"] @ Ti[:3, :3].T + Ti[:3, 3]).astype(
            np.float32)
        T_prev = est[0] if s == 0 else np.linalg.inv(est[s - 1]) @ est[s]
        _write_submap([out_dir], s, 3 * s, [3 * s], local, T_prev_m=T_prev)


def _twc(est):
    return np.stack([est[f // 3] for f in range(9)])


def _drive(closer, est, parallel):
    """Submit the three submaps as the SLAM loop does; returns the drained
    corrections."""
    closer.parallel = parallel
    for s in range(3):
        closer.submit(s, 3 * s + 2, _twc(est))
    closer.finalize()
    return closer.drain_corrections()


@pytest.fixture(scope="module")
def revisit(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("revisit")
    rng = np.random.default_rng(0)
    g, true, est, frames = _revisit_scene(rng)
    ds = _Frames(frames, {3 * s: P for s, P in enumerate(true)})
    out = {"true": true, "est": est, "tmp": tmp}
    jlc, tlc = _closers(tmp, LC_CFG, ds)
    for d in ("jax", "port"):
        _write_revisit(tmp / d, g, true, est)
    out["j_corrs"] = _drive(jlc, est, parallel=True)
    cs.reset_counts()
    out["t_corrs"] = _drive(tlc, est, parallel=True)
    out["counts"] = (cs.counts(), cs.counts(LC_TAG))
    out["jlc"], out["tlc"] = jlc, tlc
    # The same pass inline, on fresh files.
    _, inline = _closers(tmp / "inline", LC_CFG, ds)
    _write_revisit(tmp / "inline" / "port", g, true, est)
    out["inline_corrs"] = _drive(inline, est, parallel=False)
    out["inline"] = inline
    return out


def test_revisit_closes_like_jax(revisit):
    """One closure in each package; the corrections agree to 1e-3 (gs_reg's
    own parity tolerance) and move the revisit's frames toward the truth
    (part of the way: the PGO weighs the loop edge against the drifted
    odometry edge by their information)."""
    jlc, tlc = revisit["jlc"], revisit["tlc"]
    assert tlc.n_closures == jlc.n_closures == 1
    assert [lat["n_matches"] for lat in tlc.latencies] == [0, 0, 1]
    rep = tlc.report()
    assert rep["n_submits"] == 3 and rep["register_ms_mean"] > 0
    assert "pgo_solve_ms" in tlc.latencies[-1]
    corrs, jcorrs = revisit["t_corrs"], revisit["j_corrs"]
    assert [c[:2] for c in corrs] == [c[:2] for c in jcorrs]
    for (_, _, c), (_, _, jc) in zip(corrs, jcorrs):
        np.testing.assert_allclose(c, jc, atol=1e-3)
    twc = _twc(revisit["est"])
    for start, end, corr in corrs:
        e = len(twc) if end is None else end
        twc[start:e] = corr @ twc[start:e]
    err_before = np.linalg.norm(revisit["est"][2][:3, 3])
    err_after = np.linalg.norm(twc[6][:3, 3] - revisit["true"][2][:3, 3])
    assert err_after < 0.95 * err_before, (err_before, err_after)


def test_revisit_rewrites_submap_files(revisit):
    tmp = revisit["tmp"]
    for s in range(3):
        t = Submap.load(str(tmp / "port" / "submaps" / f"{s:06d}.npz"))
        j = Submap.load(str(tmp / "jax" / "submaps" / f"{s:06d}.npz"))
        np.testing.assert_allclose(t.T_prev_m, j.T_prev_m, atol=1e-3)
    moved = Submap.load(str(tmp / "port" / "submaps" / "000002.npz"))
    est = revisit["est"]
    assert not np.allclose(moved.T_prev_m, np.linalg.inv(est[1]) @ est[2],
                           atol=1e-4)


def test_parallel_equals_inline(revisit):
    """The worker-thread pass and the inline pass give the same corrections
    (atol 1e-6: the same CPU ops in another thread)."""
    corrs, inline = revisit["t_corrs"], revisit["inline_corrs"]
    assert [c[:2] for c in corrs] == [c[:2] for c in inline]
    for (_, _, c), (_, _, ci) in zip(corrs, inline):
        np.testing.assert_allclose(c, ci, atol=1e-6)
    assert revisit["inline"].n_closures == 1


def test_closer_launches_count_apart(revisit):
    """The closer's renders count under its tag, none under the main
    path's (on the CPU: the twins' calls, by thread)."""
    main, lc = revisit["counts"]
    assert lc["fwd_twin_calls"] > 0 and lc["bwd_twin_calls"] > 0
    assert main["fwd_twin_calls"] == main["bwd_twin_calls"] == 0


def test_worker_exception_reaches_check_futures(tmp_path):
    """An exception raised on the worker thread is re-raised by
    check_futures (and finalize), never swallowed."""
    _, tlc = _closers(tmp_path, {"parallel": True})

    def boom(*args):
        raise ValueError("closer failed")

    tlc._run_inner = boom
    fut = tlc.submit(0, 3, np.tile(np.eye(4), (4, 1, 1)))
    fut.exception(timeout=60)
    with pytest.raises(ValueError, match="closer failed"):
        tlc.check_futures()
    tlc.submit(1, 5, np.tile(np.eye(4), (6, 1, 1)))
    with pytest.raises(ValueError, match="closer failed"):
        tlc.finalize()


def test_closer_refuses_cuda_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    config = {"lc": {"enabled": True}, "mapping": {}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LoopClosure(config, str(tmp_path), CAM, device="cuda")


# ---------------------------------------------------------------------------
# the NetVLAD gate
# ---------------------------------------------------------------------------


def _random_weights(tmp_path, k=8, d=512, out_dim=64):
    """tests/test_netvlad.py's fixture weights."""
    rng = np.random.default_rng(0)
    z = {}
    cin = 3
    for i, (cout, _) in enumerate(t_netvlad._VGG):
        z[f"conv{i + 1}_w"] = rng.normal(0, 0.05, (cout, cin, 3, 3)).astype(
            np.float32)
        z[f"conv{i + 1}_b"] = np.zeros(cout, np.float32)
        cin = cout
    z["assign_w"] = rng.normal(0, 0.1, (k, d, 1, 1)).astype(np.float32)
    z["assign_b"] = np.zeros(k, np.float32)
    z["centroids"] = rng.normal(0, 0.1, (k, d)).astype(np.float32)
    z["pca_w"] = rng.normal(0, 0.01, (out_dim, k * d)).astype(np.float32)
    z["pca_b"] = np.zeros(out_dim, np.float32)
    p = tmp_path / "netvlad.npz"
    np.savez(p, **z)
    return str(p)


@pytest.fixture
def reset_gate():
    t_netvlad._NET = None
    j_netvlad._NET = None
    yield
    t_netvlad._NET = None
    t_netvlad._ON_DEVICE.clear()
    j_netvlad._NET = None


def test_netvlad_gate_closed_falls_back_to_hog(reset_gate, rng):
    assert t_netvlad.load("/nonexistent/netvlad.npz") is None
    desc = GlobalDesc()
    assert desc.dim == 1024
    d = desc(rng.uniform(0, 1, (48, 64, 3)).astype(np.float32))
    assert d.shape == (1024,)
    assert abs(float(torch.linalg.norm(d)) - 1.0) < 1e-4


def test_netvlad_gate_open_matches_jax(reset_gate, rng, tmp_path):
    """With the fixture weights both packages run VGG16 + NetVLAD; the
    port's descriptor is a deterministic unit vector within 1e-4 of JAX's,
    and distinct inputs give distinct codes."""
    path = _random_weights(tmp_path)
    assert t_netvlad.load(path) is not None
    assert j_netvlad.load(path) is not None
    assert GlobalDesc().dim == 4096
    img = rng.uniform(0, 1, (64, 96, 3)).astype(np.float32)
    d1 = t_netvlad.describe(img).numpy()
    d2 = t_netvlad.describe(torch.as_tensor(img)).numpy()
    assert d1.shape == (64,)
    assert abs(np.linalg.norm(d1) - 1.0) < 1e-4
    np.testing.assert_allclose(d1, d2, atol=1e-6)
    np.testing.assert_allclose(d1, np.asarray(j_netvlad.describe(img)),
                               atol=1e-4)
    other = np.linspace(0, 1, 96, dtype=np.float32)[None, :, None] \
        * np.ones((64, 1, 3), np.float32)
    assert not np.allclose(d1, t_netvlad.describe(other).numpy(), atol=1e-4)
