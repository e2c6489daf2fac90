"""Statistical golden-value tests for the path-trace estimator
(SURVEY.md §4 "furnace-style"), plus determinism/chunking invariance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cs397raytracingsp22 import (
    Camera,
    Lambertian,
    Metal,
    Scene,
    Sphere,
)
from cs397raytracingsp22.render import integrator
from cs397raytracingsp22.render.driver import render_chunk, render_to_image


def trace(scene_objects, o, d, n_rays=2048, depth=10, seed=0, max_dist=10000.0):
    # NOTE max_dist is generous because scatter directions are
    # unnormalized (reference behavior): t is measured in units of |d|,
    # so a radius-100 surround needs t up to ~400.
    scene = Scene(camera=Camera(), objects=scene_objects).compile()
    o = jnp.tile(jnp.asarray(o, jnp.float32), (n_rays, 1))
    d = jnp.tile(jnp.asarray(d, jnp.float32), (n_rays, 1))
    rad, _ = integrator.path_trace(
        scene, o, d, jnp.arange(n_rays), seed, depth, max_dist
    )
    return np.asarray(rad)


def test_direct_emission():
    # Ray pointed at an emissive sphere: radiance = emission + bounce term.
    # With albedo 0 the bounce term vanishes → exactly the emission.
    objs = [
        Sphere(
            center=(0, 0, -5),
            radius=1.0,
            material=Lambertian(albedo=(0, 0, 0), emission=(2.0, 3.0, 4.0)),
        )
    ]
    rad = trace(objs, [0, 0, 0], [0, 0, -1], n_rays=8)
    np.testing.assert_allclose(rad, np.tile([2.0, 3.0, 4.0], (8, 1)), rtol=1e-6)


def test_miss_is_black():
    objs = [Sphere(center=(0, 0, -5), radius=1.0, material=Lambertian())]
    rad = trace(objs, [0, 0, 0], [0, 1, 0], n_rays=4)
    np.testing.assert_allclose(rad, 0.0)


def test_lambertian_factor_convention():
    """One diffuse bounce into an emissive surround.

    The reference Lambertian convention (brdf=albedo/π, pdf=1/2π,
    dot = |unnormalized_dir · n| — materials.rs:41-42 + tracing.rs:313)
    gives a per-bounce factor 2·albedo·E[r·cosθ] with r the half-ball
    radius: E[r·cosθ] = E[r]·E[cosθ] = (3/4)·(1/2) = 3/8, so one bounce
    under uniform emission L returns L·(2·a·3/8) = 0.75·a·L.
    """
    a = 0.6
    L = 2.0
    objs = [
        # small diffuse target sphere
        Sphere(center=(0, 0, -5), radius=1.0, material=Lambertian(albedo=(a, a, a))),
        # huge emissive surround (emission only visible from inside)
        Sphere(
            center=(0, 0, 0),
            radius=100.0,
            material=Lambertian(albedo=(0, 0, 0), emission=(L, L, L)),
        ),
    ]
    rad = trace(objs, [0, 0, 0], [0, 0, -1], n_rays=16384, depth=3)
    expected = 0.75 * a * L
    np.testing.assert_allclose(rad.mean(axis=0), expected, rtol=0.03)


def test_mirror_metal_bounce():
    # Perfect mirror (roughness 0) pointed at the emissive surround at a
    # 45° wall: factor = attenuation·|refl·n| exactly, no randomness in
    # direction.
    objs = [
        Sphere(center=(0, 0, -5), radius=1.0, material=Metal(albedo=(0.8, 0.8, 0.8))),
        Sphere(
            center=(0, 0, 0),
            radius=100.0,
            material=Lambertian(albedo=(0, 0, 0), emission=(1.0, 1.0, 1.0)),
        ),
    ]
    # head-on hit: reflect straight back, dot=1 → 0.8·1.0
    rad = trace(objs, [0, 0, 0], [0, 0, -1], n_rays=8, depth=3)
    np.testing.assert_allclose(rad.mean(axis=0), 0.8, rtol=1e-5)


def test_depth_cutoff():
    # Mirror box: two facing mirrors with nothing emissive — depth cap
    # must terminate with zero contribution (background), not hang.
    objs = [
        Sphere(center=(0, 0, -10), radius=1.0, material=Metal(albedo=(1, 1, 1))),
        Sphere(center=(0, 0, 12), radius=1.0, material=Metal(albedo=(1, 1, 1))),
    ]
    rad = trace(objs, [0, 0, 0], [0, 0, -1], n_rays=4, depth=5)
    np.testing.assert_allclose(rad, 0.0)


@pytest.mark.slow
def test_chunking_invariance():
    """Bit-identical output for different pixel/spp chunkings — the
    content-keyed RNG guarantee that also underpins device sharding."""
    from scenes import cornell

    scene = cornell.build(width=16, height=16, spp=4, path_depth=3)
    img_a, _ = render_to_image(scene, seed=7, verbose=False)
    img_b, _ = render_to_image(
        scene, seed=7, pixel_chunk=37, spp_chunk=1, verbose=False
    )
    np.testing.assert_array_equal(img_a, img_b)


def test_render_chunk_deterministic():
    from scenes import cornell

    from cs397raytracingsp22.utils import threefry

    scene = cornell.build(width=8, height=8, spp=2, path_depth=2)
    data = scene.compile()
    key = threefry.key_words(3)
    ids = jnp.arange(64, dtype=jnp.int32)
    r1, s1 = render_chunk(data, scene.camera, ids, key, jnp.int32(0), 2, 1)
    r2, s2 = render_chunk(data, scene.camera, ids, key, jnp.int32(0), 2, 1)
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
