"""Loop closure's SE(3) functions in the port against the JAX package:
quat_rotate, so3_log, se3_log, const_speed_extrapolate, special_procrustes
and rotation_average, on the same float32 numpy inputs from a seed,
including rotation angles near 0 and at 3.0 rad. Tolerance: rtol 1e-5,
atol 1e-5 (float32 on both sides)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.core import se3 as JS
from eags_slam_torch.core import se3 as TS

TOL = dict(rtol=1e-5, atol=1e-5)


def _rotations(rng, angles):
    """(len(angles), 3, 3) float32 rotations about random axes."""
    axis = rng.normal(size=(len(angles), 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    w = (axis * np.asarray(angles)[:, None]).astype(np.float32)
    return np.asarray(JS.so3_exp(jnp.asarray(w))), w


def _poses(rng, angles):
    R, _ = _rotations(rng, angles)
    T = np.tile(np.eye(4, dtype=np.float32), (len(angles), 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(size=(len(angles), 3)).astype(np.float32)
    return T


ANGLES = [0.0, 1e-5, 1e-3, 0.05, 0.7, 2.0, 3.0]


def test_quat_rotate(rng):
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TS.quat_rotate(torch.as_tensor(q), torch.as_tensor(v)).numpy(),
        np.asarray(JS.quat_rotate(jnp.asarray(q), jnp.asarray(v))), **TOL)


@pytest.mark.parametrize("angle", ANGLES)
def test_so3_log(rng, angle):
    R, _ = _rotations(rng, [angle] * 8)
    np.testing.assert_allclose(TS.so3_log(torch.as_tensor(R)).numpy(),
                               np.asarray(JS.so3_log(jnp.asarray(R))), **TOL)


@pytest.mark.parametrize("angle", ANGLES)
def test_se3_log(rng, angle):
    T = _poses(rng, [angle] * 8)
    np.testing.assert_allclose(TS.se3_log(torch.as_tensor(T)).numpy(),
                               np.asarray(JS.se3_log(jnp.asarray(T))), **TOL)


def test_se3_log_gradient_finite_at_identity():
    """The clip keeps the jacobian finite at a zero residual, as in JAX."""
    tau = torch.zeros(6, requires_grad=True)
    TS.se3_log(TS.se3_exp(tau)).sum().backward()
    assert torch.isfinite(tau.grad).all()


def test_const_speed_extrapolate(rng):
    a, b = _poses(rng, [0.3] * 5), _poses(rng, [0.2] * 5)
    np.testing.assert_allclose(
        TS.const_speed_extrapolate(torch.as_tensor(a),
                                   torch.as_tensor(b)).numpy(),
        np.asarray(JS.const_speed_extrapolate(jnp.asarray(a),
                                              jnp.asarray(b))), **TOL)


def test_special_procrustes(rng):
    """Noisy rotations, and matrices with a negative determinant (the sign
    goes on D[2, 2])."""
    R, _ = _rotations(rng, [0.4] * 6)
    M = (R + 0.1 * rng.normal(size=R.shape)).astype(np.float32)
    M[3:] = -M[3:]
    out = TS.special_procrustes(torch.as_tensor(M)).numpy()
    np.testing.assert_allclose(
        out, np.asarray(JS.special_procrustes(jnp.asarray(M))), **TOL)
    np.testing.assert_allclose(np.linalg.det(out), 1.0, atol=1e-5)


def test_rotation_average(rng):
    R, _ = _rotations(rng, [0.1, 0.15, 0.12, 3.0])
    w = np.array([0.5, 0.3, 0.15, 0.05], np.float32)
    np.testing.assert_allclose(
        TS.rotation_average(torch.as_tensor(R), torch.as_tensor(w)).numpy(),
        np.asarray(JS.rotation_average(jnp.asarray(R), jnp.asarray(w))),
        **TOL)
