"""The merged map of the port (`evaluation/merged_map.py`) against the JAX
package on the same numpy inputs made from a seed: `merge_submaps` exactly
(the voxel hash, the first row of each voxel, the capped draw), the numpy
map with a non-zero `f_rest` carried into the port's state, and
`refine_global_map` at 48 x 32 with 64 gaussians (seg_cap 256, one frame a
batch, chunks of 3 iterations, 6 iterations), the JAX side on its sorted
backend (Pallas in interpret mode).

Tolerance of the refined parameters: 2e-5 absolute (measured: 2.4e-6 on
the opacity logits, 1e-6 or less elsewhere): six Adam steps of size at most
the learning rate (0.05 for the opacity), from gradients whose float32 sums
run in another order. With one
frame a batch, the per-iteration frame draw (JAX's key stream, the port's
torch.Generator) always picks that frame, so both runs see the same
frames in the same order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.core.camera import Camera as JCamera
from eags_slam_tpu.evaluation import merged_map as JMM
from eags_slam_tpu.ops.rasterizer import RasterConfig as JRaster
from eags_slam_torch.core import gaussians as G
from eags_slam_torch.core.camera import Camera
from eags_slam_torch.evaluation import merged_map as TMM
from eags_slam_torch.ops.rasterizer import RasterConfig

CAM = Camera(fx=40.0, fy=40.0, cx=23.5, cy=15.5, width=48, height=32)
JRCFG = JRaster(tile=16, dup_side=4, chunk=16, backend="sorted", seg_cap=256,
                bands=3)
RCFG = RasterConfig(tile=16, dup_side=4, seg_cap=256, bands=3)
N = 64
N_LOW = 6          # rows whose opacity a prune would remove


def _map(seed=0, n=N):
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(-0.6, 0.6, n),
                    rng.uniform(1.8, 2.4, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    op = rng.uniform(-0.5, 2.0, (n, 1)).astype(np.float32)
    op[:N_LOW] = -8.0                    # sigmoid < 0.005
    return {"xyz": xyz,
            "f_dc": rng.normal(0, 0.6, (n, 3)).astype(np.float32),
            "f_rest": rng.normal(0, 0.05, (n, 15, 3)).astype(np.float32),
            "log_scales": np.log(rng.uniform(0.05, 0.12, (n, 3))).astype(
                np.float32),
            "quats": q, "opacity_logits": op}


def _frames(n_frames=3):
    u, v = np.meshgrid(np.arange(CAM.width), np.arange(CAM.height))
    out = {}
    for k in range(n_frames):
        color = np.stack([0.5 + 0.4 * np.sin(u / 5.0 + k),
                          0.5 + 0.4 * np.cos(v / 7.0 - k),
                          0.3 + 0.3 * ((u // 8 + v // 8 + k) % 2)],
                         -1).astype(np.float32)
        depth = (2.1 + 0.1 * np.sin(u / 9.0) * np.cos(v / 6.0)).astype(
            np.float32)
        depth[k::11, ::13] = 0.0
        c2w = np.eye(4)
        c2w[:3, 3] = [0.03 * k, -0.02 * k, 0.0]
        out[k] = (color, depth, c2w, np.array([0.02 * k, -0.01], np.float32))
    return out


def test_merge_submaps_matches_jax():
    dicts = []
    for k in range(3):
        m = _map(seed=10 + k, n=400)
        m["xyz"] = np.round(m["xyz"] / 0.004) * 0.004   # shared voxels
        m["f_rest"][:] = 0.0
        dicts.append(m)
    for max_points in (5_000_000, 300):
        j = JMM.merge_submaps(dicts, max_points=max_points)
        t = TMM.merge_submaps(dicts, max_points=max_points)
        assert set(t) == set(j)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert 300 == t["xyz"].shape[0] < sum(d["xyz"].shape[0] for d in dicts)


def test_state_carries_a_merged_map():
    """A merged map with non-zero SH rests carries into the port's state
    bit for bit; an all-zero rest may travel as the (0, 15, 3) marker."""
    m = _map()
    st = G.state_from_numpy(m)
    for k in G.PARAM_KEYS:
        np.testing.assert_array_equal(getattr(st.params, k).numpy(), m[k])
    assert st.params.f_rest.abs().max() > 0 and bool(st.alive.all())
    m0 = dict(m, f_rest=np.zeros((0, 15, 3), np.float32))
    assert G.state_from_numpy(m0).params.f_rest.shape == (N, 15, 3)


@pytest.fixture(scope="module")
def refined():
    m = _map()
    frames = _frames()
    ids = [0, 1, 2]
    kw = dict(iterations=6, batch_frames=1, chunk_iters=3, seed=3)
    j_params, j_alive = JMM.refine_global_map(
        m, lambda f: frames[f], ids, JCamera(*CAM), JRCFG, **kw)
    t_params, t_alive = TMM.refine_global_map(
        m, lambda f: frames[f], ids, CAM, RCFG, prune_every=3, device="cpu",
        **kw)
    return m, frames, (j_params, j_alive), (t_params, t_alive)


def test_refine_global_map_matches_jax(refined):
    m, _, (jp, ja), (tp, ta) = refined
    assert ja.shape[0] >= N and not ja[N:].any()   # JAX pads; the port not
    assert ta.shape == (N,) and ta.dtype == torch.bool
    moved = 0.0
    for k in G.PARAM_KEYS:
        t = getattr(tp, k).numpy()
        j = np.asarray(getattr(jp, k))[:N]
        assert t.shape == m[k].shape
        np.testing.assert_allclose(t, j, atol=2e-5, rtol=0, err_msg=k)
        moved = max(moved, float(np.abs(t - m[k]).max()))
    assert moved > 1e-3                  # the refine did move the map


def test_prune_never_fires_with_chunk_equal_prune_every(refined):
    """The JAX package's prune test reads the chunk-local index, so with
    chunk_iters == prune_every it never fires: the refine above (chunks
    of 3, prune_every 3) keeps the low-opacity rows alive, as the JAX
    refine (prune_every 500) does. A chunk longer than prune_every does
    prune them (here at the 4th iteration of a 6-iteration chunk)."""
    m, frames, (_, ja), (_, ta) = refined
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja)[:N])
    assert bool(ta.all())
    _, alive = TMM.refine_global_map(
        m, lambda f: frames[f], [0, 1, 2], CAM, RCFG, iterations=6,
        batch_frames=1, chunk_iters=6, seed=3, prune_every=3, device="cpu")
    assert not alive[:N_LOW].any() and bool(alive[N_LOW:].all())
