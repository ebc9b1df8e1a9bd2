"""Spherical harmonics of the port (`core/sh.py`) against the JAX package:
`eval_sh` and `sh_colors` at degrees 0-3, values and gradients (autograd
against `jax.grad` of the same scalar), on the same numpy inputs made from
a seed. Tolerance: 1e-6 absolute (float32 sums of at most 16 terms of
order 1, in the same order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eags_slam_tpu.core import sh as JS
from eags_slam_torch.core import sh as TS

TOL = 1e-6


def _inputs(seed=0, n=64):
    rng = np.random.default_rng(seed)
    f_dc = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    f_rest = rng.normal(0, 0.2, (n, 15, 3)).astype(np.float32)
    xyz = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    center = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
    weights = rng.normal(size=(n, 3)).astype(np.float32)
    return f_dc, f_rest, xyz, center, weights


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(50, 16, 3)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    j = np.asarray(JS.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)))
    t = TS.eval_sh(deg, torch.as_tensor(sh), torch.as_tensor(d)).numpy()
    np.testing.assert_allclose(t, j, atol=TOL, rtol=0)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_colors_values_and_grads_match_jax(deg):
    f_dc, f_rest, xyz, center, w = _inputs(seed=10 + deg)

    def jloss(f_dc, f_rest, xyz):
        return jnp.sum(JS.sh_colors(deg, f_dc, f_rest, xyz,
                                    jnp.asarray(center)) * w)

    jv = np.asarray(JS.sh_colors(deg, jnp.asarray(f_dc), jnp.asarray(f_rest),
                                 jnp.asarray(xyz), jnp.asarray(center)))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(f_dc), jnp.asarray(f_rest), jnp.asarray(xyz))

    t = [torch.as_tensor(a).requires_grad_(True) for a in (f_dc, f_rest,
                                                            xyz)]
    tv = TS.sh_colors(deg, t[0], t[1], t[2], torch.as_tensor(center))
    np.testing.assert_allclose(tv.detach().numpy(), jv, atol=TOL, rtol=0)
    assert (jv >= 0).all() and (jv == 0).any() == (tv == 0).any().item()
    tg = torch.autograd.grad((tv * torch.as_tensor(w)).sum(), t,
                             allow_unused=True)
    for name, a, b in zip(("f_dc", "f_rest", "xyz"), tg, jg):
        a = np.zeros_like(np.asarray(b)) if a is None else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=0,
                                   err_msg=name)
