"""Tonemap tests vs the reference epilogue (tracing.rs:241-256)."""

import jax.numpy as jnp
import numpy as np

from cs397raytracingsp22.ops import tonemap


def reference_bleed(c):
    """Direct scalar transliteration of tracing.rs:243-251 for testing."""
    final = c.copy()
    tmp = c.copy()
    for i in range(3):
        d = tmp[i] - 1.0
        if d > 0.0:
            final[(i + 1) % 3] += d
            final[(i + 2) % 3] += d
    return final


def test_channel_bleed_matches_scalar_reference():
    rng = np.random.default_rng(0)
    colors = rng.uniform(0.0, 3.0, size=(256, 3)).astype(np.float32)
    ours = np.asarray(tonemap.channel_bleed(jnp.asarray(colors)))
    for i, c in enumerate(colors):
        np.testing.assert_allclose(ours[i], reference_bleed(c), rtol=1e-6)


def test_bleed_noop_below_one():
    c = jnp.array([[0.2, 0.5, 0.99]])
    np.testing.assert_allclose(np.asarray(tonemap.channel_bleed(c)), np.asarray(c))


def test_tonemap_quantization():
    # gamma=2: out = floor(sqrt(clamp(c))*255.9999)
    c = jnp.array([[0.25, 1.0, 4.0]])
    out = np.asarray(tonemap.tonemap(c, gamma=2.0))
    # 4.0 bleeds +3 into others → [3.25, 4.0, 4.0] → clamp 1 → 255
    np.testing.assert_array_equal(out[0], [255, 255, 255])
    c2 = jnp.array([[0.25, 0.0, 1.0]])
    out2 = np.asarray(tonemap.tonemap(c2, gamma=2.0))
    np.testing.assert_array_equal(out2[0], [127, 0, 255])


def test_tonemap_dtype_and_shape():
    img = jnp.zeros((4, 5, 3))
    out = tonemap.tonemap(img, gamma=2.2)
    assert out.shape == (4, 5, 3) and out.dtype == jnp.uint8
