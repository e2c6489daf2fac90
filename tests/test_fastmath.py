"""Polynomial transcendental replacements (utils/sampling.py): accuracy
vs float64 references and domain edges."""

import numpy as np
import jax.numpy as jnp

from cs397raytracingsp22.utils import sampling


def _ulp_diff(a32: np.ndarray, b32: np.ndarray) -> np.ndarray:
    return np.abs(
        a32.view(np.int32).astype(np.int64)
        - b32.view(np.int32).astype(np.int64)
    )


def test_sincos_2pi_accuracy():
    rng = np.random.default_rng(0)
    u = np.concatenate(
        [rng.uniform(0, 1, 200_000), [0.0, 0.25, 0.5, 0.75, 0.999999]]
    ).astype(np.float32)
    c, s = sampling.sincos_2pi(jnp.asarray(u))
    c64 = np.cos(2 * np.pi * u.astype(np.float64))
    s64 = np.sin(2 * np.pi * u.astype(np.float64))
    # max ABS error ~1.02e-7 ≈ 1.7 ulp at magnitude 1 (near the zeros
    # of sin/cos a fixed absolute error spans many tiny-magnitude ulps,
    # so ulp is the wrong metric there)
    assert np.abs(np.asarray(c) - c64).max() <= 2e-7
    assert np.abs(np.asarray(s) - s64).max() <= 2e-7
    # exact quadrant points: cos(0)=1, cos(π)=-1, sin(π/2)=1
    out_c, out_s = sampling.sincos_2pi(jnp.asarray([0.0, 0.5, 0.25], jnp.float32))
    np.testing.assert_array_equal(np.asarray(out_c)[:2], [1.0, -1.0])
    assert float(out_s[2]) == 1.0


def test_cbrt_fast_accuracy():
    rng = np.random.default_rng(1)
    # smallest input a uniform draw can clamp to is FLT_MIN (denormals
    # are flushed by XLA — sampling.cbrt_fast docstring)
    u = np.concatenate(
        [rng.uniform(0, 1, 200_000), [1.1754944e-38, 1e-30, 1e-10, 0.5, 1.0]]
    ).astype(np.float32)
    out = np.asarray(sampling.cbrt_fast(jnp.asarray(u))).astype(np.float64)
    ref = np.cbrt(u.astype(np.float64))
    rel = np.abs(out - ref) / ref
    assert rel.max() <= 1e-6  # ~7 ulp; the f32 pow path was up to 41
    # u = 0 flushes through the FLT_MIN clamp, no NaN/inf anywhere
    z = np.asarray(sampling.cbrt_fast(jnp.asarray([0.0], jnp.float32)))
    assert np.isfinite(z).all() and z[0] < 1e-12


def test_ball_vec_uniform_radius_distribution():
    """r = cbrt(u) gives the uniform-ball radius law: E[r] = 3/4 and
    P(r ≤ t) = t³ — quantile check at 1% tolerance on 100k draws."""
    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.uniform(0, 1, (100_000, 3)).astype(np.float32))
    b = np.asarray(sampling.ball_vec_from_uniform(u))
    r = np.linalg.norm(b, axis=1)
    assert abs(r.mean() - 0.75) < 0.01
    for q in (0.3, 0.6, 0.9):
        assert abs((r <= q).mean() - q**3) < 0.01
    assert r.max() <= 1.0 + 1e-5
