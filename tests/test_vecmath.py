"""Unit tests for vector math vs the reference formulas (tracing.rs:54-97)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cs397raytracingsp22.utils import vecmath as vm


def test_reflect_matches_formula():
    v = jnp.array([1.0, -1.0, 0.0])
    n = jnp.array([0.0, 1.0, 0.0])
    np.testing.assert_allclose(vm.reflect(v, n), [1.0, 1.0, 0.0], atol=1e-6)


def test_reflect_preserves_magnitude():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(32, 3)).astype(np.float32)
    n = rng.normal(size=(32, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    r = np.asarray(vm.reflect(jnp.asarray(v), jnp.asarray(n)))
    np.testing.assert_allclose(
        np.linalg.norm(r, axis=-1), np.linalg.norm(v, axis=-1), rtol=1e-5
    )


def test_fresnel_schlick_normal_incidence():
    # Head-on: fresnel = r0 = ((ir-1)/(ir+1))^2.
    v = jnp.array([0.0, 0.0, -1.0])
    n = jnp.array([0.0, 0.0, 1.0])
    ir = 1.5
    r0 = ((ir - 1.0) / (ir + 1.0)) ** 2
    np.testing.assert_allclose(vm.fresnel(v, n, ir), r0, rtol=1e-6)


def test_fresnel_grazing_goes_to_one():
    v = jnp.array([1.0, 0.0, 0.0])
    n = jnp.array([0.0, 0.0, 1.0])
    np.testing.assert_allclose(vm.fresnel(v, n, 1.5), 1.0, rtol=1e-6)


def test_refract_snell():
    # 45-degree incidence air->glass: check Snell's law on the output.
    theta_i = np.deg2rad(45.0)
    v = jnp.array([np.sin(theta_i), -np.cos(theta_i), 0.0], dtype=jnp.float32)
    n = jnp.array([0.0, 1.0, 0.0])
    eta = 1.0 / 1.5
    out = np.asarray(vm.refract(v, n, eta))
    sin_t = np.linalg.norm(np.cross(out / np.linalg.norm(out), np.asarray(n)))
    np.testing.assert_allclose(sin_t, eta * np.sin(theta_i), rtol=1e-5)


def test_refract_straight_through():
    v = jnp.array([0.0, -1.0, 0.0])
    n = jnp.array([0.0, 1.0, 0.0])
    out = np.asarray(vm.refract(v, n, 1.0 / 1.5))
    np.testing.assert_allclose(out, [0.0, -1.0, 0.0], atol=1e-6)


def test_clampvec_lerpvec():
    v = jnp.array([-1.0, 0.5, 2.0])
    np.testing.assert_allclose(vm.clampvec(v, 0.0, 1.0), [0.0, 0.5, 1.0])
    a = jnp.array([0.0, 0.0, 0.0])
    b = jnp.array([1.0, 2.0, 3.0])
    np.testing.assert_allclose(vm.lerpvec(a, b, 0.5), [0.5, 1.0, 1.5])


def test_signum_matches_rust():
    x = jnp.array([-2.0, -0.0, 0.0, 3.0])
    np.testing.assert_allclose(vm.signum(x), [-1.0, 1.0, 1.0, 1.0])


@pytest.mark.parametrize("shape", [(7, 3), (4, 5, 3)])
def test_batched_shapes(shape):
    rng = np.random.default_rng(1)
    v = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    n = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    assert vm.reflect(v, n).shape == shape
    assert vm.fresnel(v, n, 1.5).shape == shape[:-1]
    assert vm.refract(v, n, 0.8).shape == shape
