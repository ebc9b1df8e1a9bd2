"""The port's entry-binned (`pallas`) backend against the JAX package's,
which runs its v1 Pallas kernels in interpret mode on the CPU: the binning
and slot layout (exactly), the K5 / K6 plain twins against
`rasterizer_pallas.composite_entries`, `render(backend="pallas")` and the
frozen-binning tracking render and its pose gradient (also against
finite differences, as tests/test_frozen_binning.py holds the JAX one). (The CUDA
kernels against the twins: tests/test_torch_kernels_cuda.py, on the card.)

Shapes of tests/test_rasterizer_pallas.py and tests/test_frozen_binning.py:
48x32, tile 16, dup_side 4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.core.se3 import se3_exp as j_se3_exp
from eags_slam_tpu.ops import rasterizer as jr
from eags_slam_tpu.ops.rasterizer_pallas import \
    composite_entries as j_composite
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.core.se3 import se3_exp
from eags_slam_torch.ops import composite_entries as ce
from eags_slam_torch.ops import rasterizer as tr

CAM = (60.0, 60.0, 23.5, 15.5, 48, 32)
JCAM, TCAM = JCamera(*CAM), Camera(*CAM)
JCFG = jr.RasterConfig(tile=16, dup_side=4, chunk=16, backend="pallas",
                       max_per_tile=256, group=2)
TCFG = tr.RasterConfig(tile=16, dup_side=4, backend="pallas",
                       max_per_tile=256, group=2)
TILES_X, NUM_TILES = 3, 6


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _scene(seed, n=48, scale=(0.02, 0.08), opacity=(-1.0, 3.0)):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(1.0, 3.0, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return (means, q, np.log(rng.uniform(*scale, (n, 3))).astype(np.float32),
            rng.uniform(*opacity, (n, 1)).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _jproj(args, w2c=np.eye(4, dtype=np.float32), cfg=JCFG):
    return jr.project_gaussians(*(jnp.asarray(a) for a in args[:4]),
                                jnp.asarray(w2c), JCAM, cfg)


def _tproj(jproj):
    """The JAX projection as the port's _Projected (so both binnings see
    the same floats)."""
    return tr._Projected(*(torch.as_tensor(np.array(getattr(jproj, f)))
                           for f in jproj._fields))


@pytest.mark.parametrize("case", ["default", "margin", "budget",
                                  "per_tile_cap"])
def test_binning_and_slots_match_jax_exactly(case):
    """Sorted entries, slot gaussians, segment starts and counts equal the
    JAX ones. "budget": entry_cap_factor 1 cuts the sorted entries (the
    last tiles lose entries); "per_tile_cap": max_per_tile 16 clips the
    tiles; "margin": freeze_binning's tile / 2 margin."""
    n = {"budget": 160, "per_tile_cap": 96}.get(case, 48)
    jcfg, tcfg = JCFG, TCFG
    if case == "budget":
        jcfg = jcfg._replace(entry_cap_factor=1)
        tcfg = tcfg._replace(entry_cap_factor=1)
    if case == "per_tile_cap":
        jcfg = jcfg._replace(max_per_tile=16)
        tcfg = tcfg._replace(max_per_tile=16)
    margin = 8.0 if case == "margin" else 0.0
    jp = _jproj(_scene(3, n), cfg=jcfg)
    tp = _tproj(jp)
    js_tile, js_gauss, _, jstart, jcount = jax.jit(
        jr._bin_entries, static_argnums=(1, 2, 3))(jp, JCAM, jcfg, margin)
    ts_tile, ts_gauss, tstart, tcount = tr._bin_entries(tp, TCAM, tcfg,
                                                        margin)
    np.testing.assert_array_equal(N(ts_tile), N(js_tile))
    np.testing.assert_array_equal(N(ts_gauss), N(js_gauss))
    np.testing.assert_array_equal(N(tstart), N(jstart))
    np.testing.assert_array_equal(N(tcount), N(jcount))
    jslot, jps, jc = jax.jit(jr._build_slots, static_argnums=(1, 2, 3))(
        jp, JCAM, jcfg, margin)
    tslot, tps, tc = tr._build_slots(tp, TCAM, tcfg, margin)
    np.testing.assert_array_equal(N(tslot), N(jslot))
    np.testing.assert_array_equal(N(tps), N(jps))
    np.testing.assert_array_equal(N(tc), N(jc))
    raw = int(N(jcount).sum())
    kept = int(N(jc).sum())
    if case in ("budget", "per_tile_cap"):
        assert kept < raw, (kept, raw)        # the cut happened
        if case == "budget":
            assert N(jc)[-1] < N(jcount)[-1]  # the last tile lost entries
    else:
        assert kept == raw > 0


def _entries(seed, n, scale=(0.02, 0.08), opacity=(-1.0, 3.0), cfg=JCFG):
    """The JAX layout: entries (16, Epad), pstart, count."""
    args = _scene(seed, n, scale, opacity)
    jp = _jproj(args, cfg=cfg)
    slot, pstart, count = jr._build_slots(jp, JCAM, cfg)
    zeros = [jnp.zeros_like(jp.depth)] * 6
    attrs = jnp.stack([jp.mean2d[:, 0], jp.mean2d[:, 1], jp.conic[:, 0],
                       jp.conic[:, 1], jp.conic[:, 2], jp.opacity]
                      + [jnp.asarray(args[4][:, i]) for i in range(3)]
                      + [jp.depth] + zeros, 0)
    attrs = jnp.concatenate([attrs, jnp.zeros((16, 1))], 1)
    return np.asarray(attrs[:, slot]), np.asarray(pstart), np.asarray(count)


@pytest.mark.parametrize("case", ["sparse", "dense_early_stop"])
def test_twins_match_composite_entries(case):
    """K5's twin against the JAX forward (channels 0-6, 1e-5 absolute: the
    same per-pair float32 operations, sums in another order) and K6's twin
    against its VJP (1e-4 of each row's largest |grad|), with exact zeros in
    the columns the forward did not composite. "dense_early_stop": 1200
    large opaque gaussians (max_per_tile 2048), several chunks a tile, and
    some tiles stop at log T <= -11.5 before their last chunk."""
    if case == "sparse":
        ent, ps, cnt = _entries(0, 48)
    else:
        ent, ps, cnt = _entries(1, 1200, scale=(0.05, 0.12),
                                opacity=(3.0, 6.0),
                                cfg=JCFG._replace(max_per_tile=2048))
    rng = np.random.default_rng(5)

    def jf(e):
        return j_composite(e, jnp.asarray(ps), jnp.asarray(cnt), NUM_TILES,
                           128, 16, TILES_X, 2)

    j_out, vjp = jax.vjp(jf, jnp.asarray(ent))
    dout = np.zeros(j_out.shape, np.float32)   # (T_pad, 16, PX)
    dout[:NUM_TILES, :5] = rng.normal(size=(NUM_TILES, 5, 256))
    (j_g,) = vjp(jnp.asarray(dout))
    j_g = np.asarray(j_g)
    j_out = np.asarray(j_out)[:NUM_TILES]
    dout = dout[:NUM_TILES]

    te = torch.as_tensor(ent)
    tps, tcnt = torch.as_tensor(ps), torch.as_tensor(cnt)
    ce.reset_counts()
    t_out = ce.composite_entries_fwd_plain(te, tps, tcnt, 16, TILES_X)
    t_g = ce.composite_entries_bwd_plain(te, tps, tcnt, t_out,
                                         torch.as_tensor(dout[:, :8]), 16,
                                         TILES_X)
    assert ce.counts()["entries_fwd_twin_calls"] == 1
    np.testing.assert_allclose(N(t_out)[:, :7], j_out[:, :7], atol=1e-5)
    np.testing.assert_array_equal(N(t_out)[:, 7, 0], cnt)
    eff = j_out[:, 6, 0].astype(int)
    n_chunks = -(-cnt // 128)
    if case == "dense_early_stop":
        assert (n_chunks > 1).all() and (eff < n_chunks).any(), (eff,
                                                                  n_chunks)
    for r in range(10):
        scale = max(np.abs(j_g[r]).max(), 1e-9)
        np.testing.assert_allclose(N(t_g)[r], j_g[r], atol=1e-4 * scale,
                                   err_msg=str(r))
    assert np.abs(j_g[:10]).max() > 0
    visited = np.zeros(ent.shape[1], bool)
    for t in range(NUM_TILES):
        visited[ps[t]: ps[t] + eff[t] * 128] = True
    assert (N(t_g)[:, ~visited] == 0).all()
    assert (N(t_g)[10:] == 0).all()


def _render_both(args, w2c, target):
    def jloss(*xs):
        o = jr.render(*xs, JCAM, JCFG)
        return (jnp.mean(jnp.abs(o.color - target)) + 0.1 * jnp.mean(o.depth)
                + 0.05 * jnp.mean(o.alpha)), o

    jargs = [jnp.asarray(x) for x in args] + [jnp.asarray(w2c)]
    (_, jo), jg = jax.value_and_grad(jloss, argnums=tuple(range(6)),
                                     has_aux=True)(*jargs)
    targs = [torch.as_tensor(x).requires_grad_(True) for x in args] + \
        [torch.as_tensor(w2c).requires_grad_(True)]
    ce.reset_counts()
    o = tr.render(*targs, TCAM, TCFG)
    loss = (torch.mean(torch.abs(o.color - torch.as_tensor(target)))
            + 0.1 * torch.mean(o.depth) + 0.05 * torch.mean(o.alpha))
    tg = torch.autograd.grad(loss, targs)
    return jo, o, jg, tg


def test_render_pallas_matches_jax():
    """render(backend="pallas"): image (colour / alpha 1e-4, depth 5e-4, as
    the sorted backend's parity test) and the grads w.r.t. means, quats,
    scales, opacity, colours and the pose (1e-3 of each input's largest
    |grad|: float32 sums in another order through projection, gather and
    replay)."""
    args = _scene(2, 32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.02, -0.01, 0.05]
    target = np.random.default_rng(2).uniform(0, 1, (32, 48, 3)).astype(
        np.float32)
    jo, to, jg, tg = _render_both(args, w2c, target)
    np.testing.assert_allclose(N(to.color), N(jo.color), atol=1e-4)
    np.testing.assert_allclose(N(to.alpha), N(jo.alpha), atol=1e-4)
    np.testing.assert_allclose(N(to.depth), N(jo.depth), atol=5e-4)
    np.testing.assert_array_equal(N(to.radii), N(jo.radii))
    assert float(N(to.alpha).max()) > 0.5
    c = ce.counts()
    assert c["entries_fwd_twin_calls"] == c["entries_bwd_twin_calls"] == 1
    names = ["means", "quats", "log_scales", "opacity", "colors", "w2c"]
    for name, a, b in zip(names, tg, jg):
        b = N(b)
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(N(a), b, atol=1e-3 * scale, err_msg=name)
        assert np.abs(b).max() > 0, name


def _frozen_both(seed, n=48):
    args = _scene(seed, n)
    fb_j = jr.freeze_binning(*(jnp.asarray(a) for a in args), jnp.eye(4),
                             JCAM, JCFG)
    fb_t = tr.freeze_binning(*(torch.as_tensor(a) for a in args),
                             torch.eye(4), TCAM, TCFG)
    return args, fb_j, fb_t


@pytest.mark.parametrize("shift", [False, True], ids=["init", "shifted"])
def test_frozen_binning_render_matches_jax(shift):
    """freeze_binning's layout equals the JAX one (slot starts and counts
    exactly, the 3D rows to float32 rounding), and render_frozen matches at
    the init pose and at a ~2 px shifted pose (colour / alpha 1e-4, depth
    5e-4)."""
    _, fb_j, fb_t = _frozen_both(0)
    np.testing.assert_array_equal(N(fb_t.pstart), N(fb_j.pstart))
    np.testing.assert_array_equal(N(fb_t.count), N(fb_j.count))
    np.testing.assert_allclose(N(fb_t.e3d), N(fb_j.e3d), rtol=1e-5,
                               atol=1e-6)
    tau = np.array([0.03, 0.0, 0.0, 0.0, 0.0, 0.0] if shift else [0.0] * 6,
                   np.float32)
    jo = jr.render_frozen(fb_j, j_se3_exp(jnp.asarray(tau)), JCAM, JCFG)
    to = tr.render_frozen(fb_t, se3_exp(torch.as_tensor(tau)), TCAM, TCFG)
    np.testing.assert_allclose(N(to.color), N(jo.color), atol=1e-4)
    np.testing.assert_allclose(N(to.alpha), N(jo.alpha), atol=1e-4)
    np.testing.assert_allclose(N(to.depth), N(jo.depth), atol=5e-4)
    assert float(N(to.alpha).max()) > 0.5


def test_frozen_binning_pose_grads():
    """The pose gradient of the frozen-binning render (K6's twin, then
    autograd through _reproject_rows and se3_exp) at a small nonzero
    tangent: against jax.grad of the same loss on the JAX binning (1e-3 of
    max |g|, as the other gradient parity tests), and against central
    finite differences with the tolerance of tests/test_frozen_binning.py's
    own check (5% of |fd| + 1e-5)."""
    _, fb_j, fb = _frozen_both(1, n=32)
    tau0_np = np.array([0.004, -0.003, 0.002, 0.01, -0.008, 0.006],
                       np.float32)
    target = tr.render_frozen(fb, torch.eye(4), TCAM, TCFG).color
    tau0 = torch.as_tensor(tau0_np)

    def loss(tau):
        o = tr.render_frozen(fb, se3_exp(tau0 + tau), TCAM, TCFG)
        return torch.mean((o.color - target) ** 2)

    def jloss(tau):
        o = jr.render_frozen(fb_j, j_se3_exp(jnp.asarray(tau0_np) + tau),
                             JCAM, JCFG)
        return jnp.mean((o.color - jnp.asarray(N(target))) ** 2)

    tau = torch.zeros(6, requires_grad=True)
    (g,) = torch.autograd.grad(loss(tau), tau)
    g = g.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    jg = np.asarray(jax.grad(jloss)(jnp.zeros(6)))
    np.testing.assert_allclose(g, jg, atol=1e-3 * np.abs(jg).max())
    eps = 1e-3
    with torch.no_grad():
        for i in range(6):
            e = torch.zeros(6)
            e[i] = eps
            fd = (float(loss(e)) - float(loss(-e))) / (2 * eps)
            assert abs(g[i] - fd) < 0.05 * max(abs(fd), 1e-3) + 1e-5, \
                (i, g[i], fd)
