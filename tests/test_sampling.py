"""Statistical tests for the analytic samplers vs the reference's
rejection-sampled distributions (tracing.rs:70-89, materials.rs:171-178)."""

import jax
import jax.numpy as jnp
import numpy as np

from cs397raytracingsp22.utils import sampling


def test_ball_vec_uniform_in_ball():
    key = jax.random.key(0)
    v = np.asarray(sampling.ball_vec(key, (200_000,)))
    r = np.linalg.norm(v, axis=-1)
    assert r.max() <= 1.0 + 1e-5
    # Uniform in ball: E[r] = 3/4, E[r^2] = 3/5.
    np.testing.assert_allclose(r.mean(), 0.75, atol=5e-3)
    np.testing.assert_allclose((r**2).mean(), 0.6, atol=5e-3)
    # Direction uniform on sphere: componentwise mean 0.
    np.testing.assert_allclose(v.mean(axis=0), 0.0, atol=5e-3)
    # P(r < 0.5) = 0.125 for volume-uniform sampling.
    np.testing.assert_allclose((r < 0.5).mean(), 0.125, atol=5e-3)


def test_disk_vec_uniform_in_disk():
    key = jax.random.key(1)
    v = np.asarray(sampling.disk_vec(key, (200_000,)))
    assert np.all(v[:, 2] == 0.0)
    r = np.linalg.norm(v[:, :2], axis=-1)
    assert r.max() <= 1.0 + 1e-5
    # Uniform in disk: E[r] = 2/3, P(r<0.5) = 0.25.
    np.testing.assert_allclose(r.mean(), 2.0 / 3.0, atol=5e-3)
    np.testing.assert_allclose((r < 0.5).mean(), 0.25, atol=5e-3)


def test_hemisphere_vec_on_normal_side():
    key = jax.random.key(2)
    n = jnp.array([0.3, 0.6, -0.5])
    n = n / jnp.linalg.norm(n)
    ball = sampling.ball_vec(key, (100_000,))
    h = np.asarray(sampling.hemisphere_vec(ball, n))
    d = h @ np.asarray(n)
    assert (d >= 0.0).all()
    # Length distribution unchanged by the fold: E[r] = 3/4.
    np.testing.assert_allclose(np.linalg.norm(h, axis=-1).mean(), 0.75, atol=5e-3)
    # Direction uniform on hemisphere about n: E[cos theta] = 1/2 where
    # cos theta is of the *normalized* direction.
    cos = d / np.linalg.norm(h, axis=-1)
    np.testing.assert_allclose(cos.mean(), 0.5, atol=5e-3)


def test_hemisphere_vec_zero_normal_passthrough():
    # Masked-out lanes carry zero normals; must not produce NaN.
    key = jax.random.key(3)
    ball = sampling.ball_vec(key, (128,))
    h = sampling.hemisphere_vec(ball, jnp.zeros(3))
    np.testing.assert_allclose(np.asarray(h), np.asarray(ball))


def test_from_uniform_variants_match():
    key = jax.random.key(4)
    u3 = jax.random.uniform(key, (50_000, 3))
    v = np.asarray(sampling.ball_vec_from_uniform(u3))
    r = np.linalg.norm(v, axis=-1)
    np.testing.assert_allclose(r.mean(), 0.75, atol=6e-3)
    u2 = jax.random.uniform(key, (50_000, 2))
    d = np.asarray(sampling.disk_vec_from_uniform(u2))
    np.testing.assert_allclose(
        np.linalg.norm(d[:, :2], axis=-1).mean(), 2.0 / 3.0, atol=6e-3
    )
