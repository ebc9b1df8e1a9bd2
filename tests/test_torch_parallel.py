"""The port's multi-device steps (eags_slam_torch.parallel.mesh) over gloo
ranks on the CPU, against the JAX package's shard_map steps on its forced
8-device CPU mesh (a sub-mesh of the same size, the sorted backend in
interpret mode) and against the port's own single-rank full-grid
computation, at the JAX tests' shapes (tests/test_parallel.py: 64x64, tile
16, ~160 gaussians).

The ranks are spawned once per world size (`tests/torch_mesh_ranks.py`):
W = 2 runs dp_map_step, sp_map_step, the mapper's mesh branch and
sp_track_refine on an unpadded (24 tiles) and a padded grid (15 tiles, one
weight-0 pad tile on rank 1); W = 4 runs sp_map_step
and dpsp_map_step at (2, 2). Tolerances are the JAX tests': loss within
1e-4, each gradient leaf rtol 2e-3 / atol 1e-6 (:113,121,222-227), the
tracked rel and exposure atol 1e-4, stats[:2] rtol 1e-3 / atol 1e-6
(:304-311,388-392); the mapper's mesh branch as the mapper parity tests
(tests/test_torch_mapper.py): losses rtol 1e-4, parameters atol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from test_torch_mapper import CAM as MAPPER_CAM
from test_torch_mapper import _frame as mapper_frame
from test_torch_mapper import _jax_state as _mapper_jax_state
from test_torch_mapper import _rows as mapper_rows
from eags_slam_tpu.core import gaussians as JG
from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.core.se3 import se3_exp
from eags_slam_tpu.core.sh import sh_to_rgb as j_sh_to_rgb
from eags_slam_tpu.ops.rasterizer import RasterConfig as JRaster
from eags_slam_tpu.ops.rasterizer import render as j_render
from eags_slam_tpu.parallel import mesh as JP
from eags_slam_tpu.slam import mapper as JM
from eags_slam_tpu.slam import tracker as JT
from eags_slam_torch.core import gaussians as G
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.core.sh import sh_to_rgb
from eags_slam_torch.ops.losses import isotropic_loss, ssim_batched
from eags_slam_torch.ops.rasterizer import gt_tiles, render_tiles
from eags_slam_torch.slam import tracker as T

JRCFG = JRaster(tile=16, dup_side=4, chunk=16, backend="sorted", seg_cap=128,
                bands=3, group=2)
OPT = ("xyz", "log_scales", "quats", "opacity_logits")
MAP_CAM = (70.0, 70.0, 31.5, 31.5, 64, 64)
TRACK_TCFG = dict(enable_exposure=True, frozen_binning=True,
                  tile_subset_frac=0.0, early_stop_cnt=50)


def _jax_state(seed, n, xlim=1.0, ylim=0.8, opacity=0.8):
    """The JAX tests' toy map; returns (rng, JAX state)."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-xlim, xlim, n), rng.uniform(-ylim, ylim, n),
                    rng.uniform(1.2, 3.0, n)], -1).astype(np.float32)
    rows = JG.point_rows(
        jnp.asarray(xyz),
        jnp.asarray(rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)),
        jnp.full((n,), 0.05), jnp.full((n,), opacity))
    st, _ = JG.insert(JG.empty_state(256), rows, jnp.ones(n, bool))
    return rng, st


def _to_np(st):
    p = st.params
    out = {k: np.asarray(getattr(p, k)) for k in G.PARAM_KEYS}
    out["alive"] = np.asarray(st.alive)
    return out


def _track_scene(seed, n, h, w, xlim, ylim, init_rel, iters):
    _, st = _jax_state(seed, n, xlim, ylim, 0.85)
    cam = (80.0, 80.0, (w - 1) / 2, (h - 1) / 2, w, h)
    p = st.params
    out = j_render(p.xyz, p.quats, p.log_scales, p.opacity_logits,
                   j_sh_to_rgb(p.f_dc), jnp.eye(4), JCamera(*cam), JRCFG,
                   alive=st.alive)
    return dict(params=_to_np(st), cam=cam,
                gt_color=np.asarray(out.color), gt_depth=np.asarray(out.depth),
                init_rel=init_rel, iters=iters,
                tcfg=dict(TRACK_TCFG, iterations=iters)), st


def _kidx_draws(key, iters, n_kf, n_dev):
    """The JAX mesh branch's keyframe draws: per iteration key, k_sel, _ =
    split(key, 3), n_dev categorical draws (all 0 while it < 5)."""
    p_kf = JM._keyframe_distribution(n_kf, 4, 0.4)
    out = []
    for it in range(iters):
        key, k_sel, _ = jax.random.split(key, 3)
        d = np.asarray(jax.random.categorical(
            k_sel, jnp.log(p_kf + 1e-12), shape=(n_dev,)))
        out.append([0] * n_dev if it < 5 else [int(v) for v in d])
    return out


@pytest.fixture(scope="module")
def inputs():
    rng, sp_st = _jax_state(3, 160)
    sp = dict(state=_to_np(sp_st), cam=MAP_CAM,
              color=rng.uniform(0, 1, (64, 64, 3)).astype(np.float32),
              depth=rng.uniform(1.0, 3.0, (64, 64)).astype(np.float32),
              w2c=np.eye(4, dtype=np.float32))
    rng, v_st = _jax_state(5, 150)
    w2c1 = np.asarray(se3_exp(jnp.asarray([0.03, 0.0, -0.02, 0.01, 0.0,
                                           0.0])), np.float32)
    views = dict(state=_to_np(v_st), cam=MAP_CAM,
                 colors=rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32),
                 depths=rng.uniform(1.0, 3.0, (2, 64, 64)).astype(np.float32),
                 w2cs=np.stack([np.eye(4, dtype=np.float32), w2c1]))
    # The mapper's mesh branch on the mapper parity tests' frame and a map
    # backprojected from it (on the random toy scene many rows' gradients
    # sit in Adam's eps zone, |g| ~ 1e-8, where float reordering alone
    # moves a step by up to the learning rate: tests/test_parallel.py:122).
    color, depth = mapper_frame()
    m_st = _mapper_jax_state(mapper_rows(color, depth, 600, seed=1), 1024)
    w2c2 = np.asarray(se3_exp(jnp.asarray([-0.02, 0.01, 0.0, 0.0, 0.015,
                                           0.0])), np.float32)
    kf = dict(color=np.stack([color] * 3), depth=np.stack([depth] * 3),
              w2c=np.stack([np.eye(4, dtype=np.float32), w2c1, w2c2]),
              exposure=np.array([[0.0, 0.0], [0.05, -0.02], [-0.04, 0.01]],
                                np.float32))
    key = np.array([0, 7], np.uint32)
    branch = dict(state=_to_np(m_st), cam=tuple(MAPPER_CAM), kf=kf, n_kf=3,
                  iters=9, kidxs=_kidx_draws(jnp.asarray(key), 9, 3, 2),
                  mcfg=dict(max_keyframes=4))
    t1, t1_st = _track_scene(11, 200, 64, 96, 1.0, 0.7, np.array(
        [[1, 0, 0, 0.01], [0, 1, 0, -0.008], [0, 0, 1, 0.012],
         [0, 0, 0, 1]], np.float32), 15)
    rel2 = np.eye(4, dtype=np.float32)
    rel2[1, 3] = 0.012
    # 5 x 3 = 15 tiles: at W = 2 the grid pads to 16 (the JAX test's
    # 20-tile grid pads only on its 8-device mesh).
    t2, t2_st = _track_scene(23, 180, 48, 80, 0.8, 0.6, rel2, 12)
    return dict(sp=sp, views=views, branch=branch, key=key, t1=t1, t2=t2,
                jax_states=dict(sp=sp_st, views=v_st, branch=m_st,
                                t1=t1_st, t2=t2_st))


def _port_cases(inp, names):
    return {n: c for n, c in {
        "sp_map": ("sp_map", inp["sp"]),
        "dp_map": ("dp_map", inp["views"]),
        "dpsp_map": ("dpsp_map", dict(inp["views"], n_data=2, n_space=2)),
        "map_branch": ("map_branch", inp["branch"]),
        "track_full": ("sp_track", inp["t1"]),
        "track_padded": ("sp_track", inp["t2"]),
        "meshes": ("meshes", {}),
    }.items() if n in names}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs in several processes at once,
    and more threads than cores slow all of them down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def w2(inputs, tmp_path_factory):
    return R.run(2, tmp_path_factory.mktemp("w2"), _port_cases(inputs, (
        "sp_map", "dp_map", "map_branch", "track_full", "track_padded",
        "meshes")))


@pytest.fixture(scope="module")
def w4(inputs, tmp_path_factory):
    return R.run(4, tmp_path_factory.mktemp("w4"), _port_cases(inputs, (
        "sp_map", "dpsp_map", "meshes")))


def _assert_grads(got, want, what):
    for k in OPT:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=2e-3,
                                   atol=1e-6, err_msg=f"{what}: {k}")


def _jax_grads(tree):
    return {k: np.asarray(getattr(tree, k)) for k in OPT}


def _port_view_loss(leaves, st, color, depth, w2c, cam):
    """The per-tile map loss of one view over every tile, on one rank (the
    JAX test's single-device reference, in the port)."""
    ts = 16
    tiles_x, tiles_y = -(-cam.width // ts), -(-cam.height // ts)
    ids = torch.arange(tiles_x * tiles_y, dtype=torch.int32)
    out = render_tiles(leaves["xyz"], leaves["quats"], leaves["log_scales"],
                       leaves["opacity_logits"], sh_to_rgb(st.params.f_dc),
                       torch.as_tensor(w2c), ids, cam, R.RCFG,
                       alive=st.alive)
    gt_c = gt_tiles(torch.as_tensor(color), ids, ts, tiles_x, tiles_y)
    gt_d = gt_tiles(torch.as_tensor(depth), ids, ts, tiles_x, tiles_y)
    m = ((gt_d > 0) & ~torch.isnan(out.depth)).to(torch.float32)
    color_l1 = (torch.abs(out.color - gt_c) * m[..., None]).sum() \
        / torch.clamp(m.sum() * 3.0, min=1.0)
    depth_l1 = (torch.abs(out.depth - gt_d) * m).sum() \
        / torch.clamp(m.sum(), min=1.0)
    ssim_mean = ssim_batched(torch.clamp(out.color, 0.0, 1.0), gt_c).mean()
    return 0.8 * color_l1 + 0.2 * (1 - ssim_mean) + depth_l1


def _port_reference(state_np, views):
    """(loss, alive-masked grads) of the mean of the views' full-grid tile
    losses plus the regulariser, on one rank."""
    st = G.state_from_numpy(state_np)
    leaves = {k: getattr(st.params, k).clone().requires_grad_(True)
              for k in OPT}
    cam = Camera(*MAP_CAM)
    loss = sum(_port_view_loss(leaves, st, *v, cam) for v in views) \
        / len(views) + isotropic_loss(leaves["log_scales"], st.alive)
    gs = torch.autograd.grad(loss, [leaves[k] for k in OPT])
    m = st.alive.to(torch.float32)
    return float(loss.detach()), {
        k: (g * m.reshape((-1,) + (1,) * (g.dim() - 1))).numpy()
        for k, g in zip(OPT, gs)}


@pytest.mark.parametrize("world", [2, 4])
def test_sp_map_step_matches_jax_and_one_rank(world, inputs, w2, w4):
    """sp_map_step at W = 2 and 4: every rank's loss and gradient equal
    JAX's sharded step on a W-device mesh and the port's own one-rank
    full-grid gradient (a 1/D error would miss the latter by D)."""
    sp = inputs["sp"]
    ranks = w2 if world == 2 else w4
    step, init_adam, _ = JP.sp_map_step(JP.make_mesh(world),
                                        JCamera(*MAP_CAM), JRCFG,
                                        JM.MapperConfig(max_keyframes=4))
    jst = inputs["jax_states"]["sp"]
    _, _, j_loss, j_grads = step(jst, init_adam(jst),
                                 jnp.asarray(sp["color"]),
                                 jnp.asarray(sp["depth"]), jnp.eye(4))
    ref_loss, ref_grads = _port_reference(
        sp["state"], [(sp["color"], sp["depth"], sp["w2c"])])
    for r, res in enumerate(ranks):
        got = res["sp_map"]
        assert abs(got["loss"] - float(j_loss)) < 1e-4, (r, got["loss"])
        assert abs(got["loss"] - ref_loss) < 1e-4
        _assert_grads(got["grads"], _jax_grads(j_grads), f"rank {r} / JAX")
        _assert_grads(got["grads"], ref_grads, f"rank {r} / one rank")
    assert np.abs(ref_grads["xyz"]).max() > 1e-3


def test_dpsp_map_step_matches_jax_and_one_rank(inputs, w4):
    """dpsp_map_step on a (2, 2) mesh: two views, each one's tile grid split
    over two ranks; against JAX's (2, 2) mesh and the port's one-rank mean
    of the two views' full-grid losses."""
    v = inputs["views"]
    step, init_adam, _ = JP.dpsp_map_step(JP.make_mesh2d(2, 2),
                                          JCamera(*MAP_CAM), JRCFG,
                                          JM.MapperConfig(max_keyframes=4))
    jst = inputs["jax_states"]["views"]
    _, _, j_loss, j_grads = step(jst, init_adam(jst),
                                 jnp.asarray(v["colors"]),
                                 jnp.asarray(v["depths"]),
                                 jnp.asarray(v["w2cs"]))
    ref_loss, ref_grads = _port_reference(
        v["state"], [(v["colors"][i], v["depths"][i], v["w2cs"][i])
                     for i in range(2)])
    coords = []
    for r, res in enumerate(w4):
        got = res["dpsp_map"]
        coords.append((got["coord"]["data"], got["coord"]["space"]))
        assert abs(got["loss"] - float(j_loss)) < 1e-4
        assert abs(got["loss"] - ref_loss) < 1e-4
        _assert_grads(got["grads"], _jax_grads(j_grads), f"rank {r} / JAX")
        _assert_grads(got["grads"], ref_grads, f"rank {r} / one rank")
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_dp_map_step_matches_jax(inputs, w2):
    """dp_map_step at W = 2 on two keyframes: the loss and the averaged
    gradient (read from Adam's first moment after the first step, in both
    packages) against JAX's."""
    v = inputs["views"]
    step, init_adam = JP.dp_map_step(JP.make_mesh(2), JCamera(*MAP_CAM),
                                     JRCFG, JM.MapperConfig(max_keyframes=4))
    jst = inputs["jax_states"]["views"]
    _, j_adam, j_loss = step(jst, init_adam(jst), jnp.asarray(v["colors"]),
                             jnp.asarray(v["depths"]), jnp.asarray(v["w2cs"]))
    j_grads = {k: np.asarray(getattr(j_adam.mu, k)) / (1 - 0.9) for k in OPT}
    for r, res in enumerate(w2):
        got = res["dp_map"]
        assert abs(got["loss"] - float(j_loss)) < 1e-4
        _assert_grads(got["grads"], j_grads, f"rank {r}")


def test_mapper_mesh_branch_matches_jax(inputs, w2):
    """optimize_submap with a 2-rank mesh (the mapper's mesh branch: the
    plain loop, two keyframes an iteration, one a rank) and JAX's with a
    2-device mesh, on the same draws: the loss log and the final map; the
    sampler is asked for two indices every iteration."""
    b = inputs["branch"]
    jst = inputs["jax_states"]["branch"]
    kfs = JM.empty_keyframes(4, JCamera(*b["cam"]))
    for i in range(b["n_kf"]):
        kfs = JM.push_keyframe(kfs, i, *(jnp.asarray(b["kf"][k][i]) for k in
                                         ("color", "depth", "w2c",
                                          "exposure")))
    j_state, j_aux = JM.optimize_submap(
        jst, kfs, jnp.asarray(b["n_kf"], jnp.int32),
        jnp.asarray(inputs["key"]), b["iters"], JCamera(*b["cam"]), JRCFG,
        JM.MapperConfig(**b["mcfg"]), mesh=JP.make_mesh(2))
    assert any(k != [0, 0] for k in b["kidxs"])
    for res in w2:
        got = res["map_branch"]
        assert got["calls"] == [(it, 2) for it in range(got["iterations"])]
        assert got["collectives"]["all_reduce"] == got["iterations"]
        np.testing.assert_allclose(got["losses"],
                                   np.asarray(j_aux["losses"]), rtol=1e-4)
        np.testing.assert_array_equal(got["state"]["alive"],
                                      np.asarray(j_state.alive))
        for k in OPT:
            np.testing.assert_allclose(
                got["state"][k], np.asarray(getattr(j_state.params, k)),
                atol=1e-4, err_msg=k)


def test_ranks_stay_bit_identical(w2):
    """After the mapper's mesh-branch iterations both ranks hold the same
    parameters, alive mask and Adam state, bit for bit."""
    a, b = (res["map_branch"]["state"] for res in w2)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", ["track_full", "track_padded"])
def test_sp_track_refine_matches_jax_and_one_rank(case, inputs, w2):
    """sp_track_refine at W = 2 on the 24-tile grid (12 tiles a rank) and
    on a 15-tile grid padded to 16: the pose, exposure and best losses
    against JAX's 2-device sp_track_refine and the port's one-rank
    refinement over the real tiles (the tracker's subset path)."""
    t = inputs["t1" if case == "track_full" else "t2"]
    n_real, s_pad = (24, 24) if case == "track_full" else (15, 16)
    jst = inputs["jax_states"]["t1" if case == "track_full" else "t2"]
    jtcfg = JT.TrackerConfig(**t["tcfg"])
    refine, aux = JP.sp_track_refine(JP.make_mesh(2), JCamera(*t["cam"]),
                                     JRCFG, jtcfg)
    assert aux["n_tiles"] == n_real and aux["s_pad"] == s_pad
    j_rel, j_exp, j_stats = refine(
        jst.params, jst.alive, jnp.asarray(t["init_rel"]), jnp.eye(4),
        jnp.asarray(t["gt_color"]), jnp.asarray(t["gt_depth"]), jnp.zeros(2),
        jnp.asarray(t["iters"], jnp.int32))

    st = G.state_from_numpy(t["params"])
    cam = Camera(*t["cam"])
    tiles_x, tiles_y = -(-cam.width // 16), -(-cam.height // 16)
    ids = torch.arange(n_real, dtype=torch.int32)
    gc, gd = torch.tensor(t["gt_color"]), torch.tensor(t["gt_depth"])
    tcfg = T.TrackerConfig(**t["tcfg"])
    loss_fn = T._make_loss_fn(
        st.params, st.alive, sh_to_rgb(st.params.f_dc),
        torch.as_tensor(t["init_rel"]), torch.eye(4), gc, gd, cam, R.RCFG,
        tcfg, subset=(ids, gt_tiles(gc, ids, 16, tiles_x, tiles_y),
                      gt_tiles(gd, ids, 16, tiles_x, tiles_y),
                      T._in_image_mask(ids, 16, tiles_x, cam)))
    r_rel, r_exp, r_stats, _ = T._refine(loss_fn,
                                         torch.as_tensor(t["init_rel"]),
                                         t["iters"], torch.zeros(2), tcfg)
    for res in w2:
        got = res[case]
        assert got["aux"] == {"n_tiles": n_real, "s_pad": s_pad}
        for want_rel, want_exp, want_stats in (
                (np.asarray(j_rel), np.asarray(j_exp), np.asarray(j_stats)),
                (r_rel.numpy(), r_exp.numpy(), r_stats)):
            np.testing.assert_allclose(got["rel"], want_rel, rtol=0,
                                       atol=1e-4)
            np.testing.assert_allclose(got["exposure"], want_exp, rtol=0,
                                       atol=1e-4)
            np.testing.assert_allclose(got["stats"][:2], want_stats[:2],
                                       rtol=1e-3, atol=1e-6)
        # One all-gather (the median) and two all-reduces (the sums, the
        # pose gradient) an iteration.
        n_it = int(got["stats"][3])
        assert got["collectives"] == {"all_reduce": 2 * n_it,
                                      "all_gather": n_it, "broadcast": 0}
    a, b = (res[case] for res in w2)
    np.testing.assert_array_equal(a["rel"], b["rel"])
    np.testing.assert_array_equal(a["stats"], b["stats"])
    if case == "track_full":    # the refinement improved the pose
        err0 = float(np.linalg.norm(t["init_rel"][:3, 3]))
        assert float(np.linalg.norm(a["rel"][:3, 3])) < err0


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_layout(world, w2, w4):
    """make_mesh, a mesh of all but the last rank (the orchestrator's
    n_dev - 1 map ranks above two) and lc_submesh keep JAX's arithmetic."""
    ranks = w2 if world == 2 else w4
    for r, res in enumerate(ranks):
        m = res["meshes"]
        assert m["full"] == (list(range(world)), {"data": r})
        n_part = max(world - 1, 1)
        assert m["part"] == (list(range(n_part)), r < n_part)
        n_lc = min(2, max(world - 1, 1))
        lc_ranks = list(range(world))[-n_lc:]
        assert m["lc"] == (lc_ranks, ("lc",), r in lc_ranks)


def test_dryrun_multichip_4():
    """dryrun_multichip(4) over four gloo ranks: every step, the 2D mesh's
    included, ends with a finite loss (the JAX dry run's stages)."""
    from eags_slam_torch.parallel.dryrun import dryrun_multichip

    losses = dryrun_multichip(4, device="cpu")
    assert set(losses) == {"dp", "optimize_submap", "sp", "sp_track",
                           "dpsp"}
    assert all(np.isfinite(v) for v in losses.values())
