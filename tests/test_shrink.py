"""Shrinking-wavefront staged executor (driver.render_chunk_staged +
integrator.path_trace_shrink): bit-identical to the reference executors
on textured scenes, with the staged executor asked for
(render_to_image(staged=StagedOptions())), at widths small enough that
several shrink steps fire."""

import numpy as np
import jax.numpy as jnp
import pytest

from cs397raytracingsp22 import Camera, Lambertian, Plane, Scene, Sphere
from cs397raytracingsp22.render import integrator
from cs397raytracingsp22.render.driver import StagedOptions, render_to_image
from tests.test_mesh import make_mesh


def textured_scene(width=16, height=16, spp=4):
    # checkerboard albedo texture -> texture-synthesized material
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[::2, ::2] = (255, 40, 40)
    tex[1::2, 1::2] = (40, 255, 40)
    quad = make_mesh(
        [[-2, 0, -3], [2, 0, -3], [2, 3, -3], [-2, 3, -3]],
        [[0, 1, 2], [0, 2, 3]],
        texcoords=[[0, 0], [1, 0], [1, 1], [0, 1]],
        material=None,
        textures=(tex, None, None, None, None),
    )
    return Scene(
        camera=Camera(
            eyepoint=(0, 1, 3), view_dir=(0, 0, -1), up=(0, 1, 0),
            screen_width=width, screen_height=height,
            aa_sample_count=spp, path_depth=6,
        ),
        objects=[
            quad,
            Plane(point=(0, -1, 0), normal=(0, 1, 0),
                  material=Lambertian(albedo=(0.5, 0.5, 0.5))),
            Sphere(center=(0, 6, 1), radius=2.0,
                   material=Lambertian(albedo=(0, 0, 0), emission=(6, 6, 6))),
        ],
    )


def test_path_trace_shrink_matches_path_trace():
    scene = textured_scene()
    data = scene.compile()
    rng = np.random.default_rng(0)
    n = 1024
    o = jnp.asarray(rng.uniform(-2, 3, (n, 3)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    uids = jnp.arange(n, dtype=jnp.int32)

    rad_ref, segs_ref = integrator.path_trace(
        data, o, d, uids, 7, 6, max_trace_dist=100.0
    )
    rad_s, segs_s = integrator.path_trace_shrink(
        data, o, d, uids, 7, 6, max_trace_dist=100.0, min_width=64
    )
    np.testing.assert_array_equal(np.asarray(rad_ref), np.asarray(rad_s))
    assert float(segs_ref) == float(segs_s)


def test_driver_shrink_bit_identical():
    scene = textured_scene()
    img_ref, _ = render_to_image(scene, seed=3, verbose=False)
    img_s, stats = render_to_image(
        scene, seed=3, verbose=False, staged=StagedOptions()
    )
    np.testing.assert_array_equal(img_ref, img_s)
