"""Phong debug integrator tests (tracing.rs:277-297 semantics)."""

import jax
import jax.numpy as jnp
import numpy as np

from cs397raytracingsp22 import Camera, Lambertian, Plane, Scene, Sphere
from cs397raytracingsp22.render import integrator


def phong(objects, o, d, light=(0, 10, 0), ambient=(0.1, 0.1, 0.1), eye=(0, 0, 0)):
    scene = Scene(
        camera=Camera(), objects=objects, point_light_pos=light, ambient=ambient
    ).compile()
    o = jnp.asarray(o, jnp.float32).reshape(-1, 3)
    d = jnp.asarray(d, jnp.float32).reshape(-1, 3)
    uids = jnp.arange(o.shape[0])
    return np.asarray(
        jax.jit(integrator.phong_trace)(
            scene, o, d, uids, jnp.asarray([0, 0], jnp.uint32),
            jnp.asarray(eye, jnp.float32), 100.0
        )
    )


def test_miss_is_background():
    out = phong([Sphere(center=(0, 0, -5), radius=1.0, material=Lambertian())],
                [[0, 0, 0]], [[0, 1, 0]])
    np.testing.assert_allclose(out[0], 0.0)


def test_lit_floor_unoccluded():
    # Flat floor, light straight above the hitpoint: diffuse weight 1,
    # albedo term = albedo/pi (scatter attenuation), no shadow.
    a = 0.6
    out = phong(
        [Plane(point=(0, 0, 0), normal=(0, 1, 0), material=Lambertian(albedo=(a, a, a)))],
        [[0, 1, -1]],
        [[0, -1, 0]],
        light=(0, 10, -1),
        ambient=(0.1, 0.1, 0.1),
        eye=(0, 1, -1),
    )
    # to_light=(0,1,0), n=(0,1,0): diffuse_w=1. reflected=(0,1,0);
    # to_camera=(0,1,0) → spec=(1)^40=1 → + 0.4.
    expected = 0.1 + a / np.pi + 0.4
    np.testing.assert_allclose(out[0], expected, rtol=1e-5)


def test_hard_shadow_occlusion():
    # Sphere between the floor point and the light → weight 0.3.
    a = 0.6
    objs = [
        Plane(point=(0, 0, 0), normal=(0, 1, 0), material=Lambertian(albedo=(a, a, a))),
        Sphere(center=(0, 5, -1), radius=1.0, material=Lambertian()),
    ]
    out_shadow = phong(objs, [[0, 1, -1]], [[0, -1, 0]], light=(0, 10, -1), eye=(0, 1, -1))
    out_clear = phong(objs[:1], [[0, 1, -1]], [[0, -1, 0]], light=(0, 10, -1), eye=(0, 1, -1))
    np.testing.assert_allclose(out_shadow[0], 0.3 * out_clear[0], rtol=1e-5)


def test_phong_through_driver():
    from cs397raytracingsp22.models.camera import ShadingMode
    from cs397raytracingsp22.render.driver import render_to_image

    scene = Scene(
        camera=Camera(
            eyepoint=(0.0, 1.0, 3.0),
            screen_width=8,
            screen_height=8,
            aa_sample_count=4,
            shading_mode=ShadingMode.PHONG,
        ),
        objects=[
            Sphere(center=(0, 1, 0), radius=1.0, material=Lambertian(albedo=(0.8, 0.2, 0.2))),
            Plane(point=(0, 0, 0), normal=(0, 1, 0), material=Lambertian()),
        ],
        point_light_pos=(2.0, 5.0, 3.0),
        ambient=(0.1, 0.1, 0.1),
    )
    img, stats = render_to_image(scene, verbose=False)
    assert img.shape == (8, 8, 3)
    assert img.mean() > 5  # lit scene isn't black
