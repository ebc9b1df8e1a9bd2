"""Loop closure's kNN in the port against the JAX package:
`nearest_neighbor` (chunked brute-force 1-NN with masked reference rows)
and `overlap_ratio` (the larger directional fraction within a distance),
on the same float32 numpy inputs from a seed. Tolerances: squared
distances rtol 1e-5 plus atol 2e-6, the float32 rounding of the expansion
|q|^2 - 2 q.r + |r|^2 that both packages compute (its terms are ~1 here,
a few ulps of which is ~1e-6, while the nearest d2 is ~1e-3); indices
equal wherever the nearest and the runner-up differ by more than 1e-5;
overlap ratios equal to 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.ops import knn as JK
from eags_slam_torch.ops import knn as TK


def _clouds(rng, nq, nr, spread=1.0):
    q = rng.uniform(-spread, spread, (nq, 3)).astype(np.float32)
    r = rng.uniform(-spread, spread, (nr, 3)).astype(np.float32)
    return q, r


@pytest.mark.parametrize("nq,nr,chunk", [(300, 500, 64), (1000, 1500, 1024),
                                         (7, 2000, 1024)])
def test_nearest_neighbor(rng, nq, nr, chunk):
    q, r = _clouds(rng, nq, nr)
    rmask = rng.uniform(size=nr) > 0.3
    qmask = rng.uniform(size=nq) > 0.2
    d2_j, i_j = JK.nearest_neighbor(jnp.asarray(q), jnp.asarray(qmask),
                                    jnp.asarray(r), jnp.asarray(rmask),
                                    chunk=chunk)
    d2_t, i_t = TK.nearest_neighbor(torch.as_tensor(q),
                                    torch.as_tensor(qmask),
                                    torch.as_tensor(r),
                                    torch.as_tensor(rmask), chunk=chunk)
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=1e-5,
                               atol=2e-6)
    assert i_t.dtype == torch.int32
    assert rmask[i_t.numpy()].all()            # masked rows never match
    # Exact distances: the runner-up gap decides where indices must agree.
    d = ((q[:, None, :].astype(np.float64) - r[None]) ** 2).sum(-1)
    d[:, ~rmask] = np.inf
    two = np.sort(d, axis=1)[:, :2]
    clear = two[:, 1] - two[:, 0] > 1e-5
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(i_t.numpy()[clear], np.asarray(i_j)[clear])


@pytest.mark.parametrize("dist", [0.02, 0.05, 0.2])
def test_overlap_ratio(rng, dist):
    a, b = _clouds(rng, 800, 600)
    b[:300] = a[:300] + rng.normal(scale=0.01, size=(300, 3)).astype(
        np.float32)
    ma = rng.uniform(size=800) > 0.1
    mb = rng.uniform(size=600) > 0.1
    j = float(JK.overlap_ratio(jnp.asarray(a), jnp.asarray(ma),
                               jnp.asarray(b), jnp.asarray(mb), dist))
    t = float(TK.overlap_ratio(torch.as_tensor(a), torch.as_tensor(ma),
                               torch.as_tensor(b), torch.as_tensor(mb),
                               dist))
    assert 0.0 < j < 1.0
    assert abs(t - j) <= 1e-6, (t, j)
