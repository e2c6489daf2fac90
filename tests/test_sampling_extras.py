"""Tests for the reference's alternate (unused) samplers, kept for API
parity (materials.rs:181-199)."""

import jax
import jax.numpy as jnp
import numpy as np

from cs397raytracingsp22.utils import sampling


def test_alpha_sample_distribution():
    key = jax.random.key(0)
    u = jax.random.uniform(key, (100_000, 2))
    n = jnp.tile(jnp.asarray([0.0, 0.0, 1.0]), (100_000, 1))
    d, pdf = sampling.alpha_sample(u, n, alpha=1.0)
    d = np.asarray(d)
    # directions on the +n hemisphere, unit length
    assert (d[:, 2] >= -1e-6).all()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    # alpha=1 → cos_theta = sqrt(U): E[cos] = 2/3
    np.testing.assert_allclose(d[:, 2].mean(), 2.0 / 3.0, atol=5e-3)
    np.testing.assert_allclose(
        np.asarray(pdf), 2.0 * d[:, 2] / (2 * np.pi), rtol=1e-4
    )


def test_alpha_sample_rotated_normal():
    key = jax.random.key(1)
    u = jax.random.uniform(key, (50_000, 2))
    n = jnp.tile(jnp.asarray([1.0, 0.0, 0.0]), (50_000, 1))
    d, _ = sampling.alpha_sample(u, n)
    d = np.asarray(d)
    assert (d[:, 0] >= -1e-5).all()  # hemisphere about +x
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)


def test_rtow_sample_shape():
    key = jax.random.key(2)
    ball = sampling.ball_vec(key, (64,))
    p = jnp.zeros((64, 3))
    n = jnp.tile(jnp.asarray([0.0, 1.0, 0.0]), (64, 1))
    out, pdf = sampling.rtow_sample(ball, p, n)
    assert out.shape == (64, 3)
    assert pdf == 1.0 / (2 * np.pi)
