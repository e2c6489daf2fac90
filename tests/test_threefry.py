"""Threefry-2x32 implementation vs jax.random's internal reference."""

import jax
import jax.numpy as jnp
import numpy as np

from cs397raytracingsp22.utils import threefry as tf


def test_matches_jax_threefry():
    from jax._src.prng import threefry_2x32

    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, size=2, dtype=np.uint32)
    counters = rng.integers(0, 2**32, size=(2, 64), dtype=np.uint32)
    ref = np.asarray(
        threefry_2x32(jnp.asarray(keys), jnp.asarray(counters.reshape(-1)))
    ).reshape(2, 64)
    x0, x1 = tf.threefry2x32(keys[0], keys[1], counters[0], counters[1])
    np.testing.assert_array_equal(np.asarray(x0), ref[0])
    np.testing.assert_array_equal(np.asarray(x1), ref[1])


def test_uniform_range_and_distribution():
    u = np.asarray(tf.counter_uniforms(1234, jnp.arange(50_000), 3, 4))
    assert u.shape == (50_000, 4)
    assert (u >= 0).all() and (u < 1).all()
    np.testing.assert_allclose(u.mean(), 0.5, atol=5e-3)
    np.testing.assert_allclose(u.var(), 1.0 / 12.0, atol=5e-3)
    # columns decorrelated
    c = np.corrcoef(u.T)
    off = c[~np.eye(4, dtype=bool)]
    assert np.abs(off).max() < 0.02


def test_sites_and_uids_independent():
    a = np.asarray(tf.counter_uniforms(7, jnp.arange(1000), 0, 2))
    b = np.asarray(tf.counter_uniforms(7, jnp.arange(1000), 1, 2))
    assert not np.allclose(a, b)
    c = np.asarray(tf.counter_uniforms(8, jnp.arange(1000), 0, 2))
    assert not np.allclose(a, c)
    # determinism
    a2 = np.asarray(tf.counter_uniforms(7, jnp.arange(1000), 0, 2))
    np.testing.assert_array_equal(a, a2)
