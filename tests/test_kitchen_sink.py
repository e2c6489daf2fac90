"""Kitchen-sink integration gate: every feature class in ONE scene
through the FULL driver stack, comparing the staged executor (shrink
executor + static width schedule + sorted wavefront) against the
one-program path_trace — bit-identical images.

This is the config-4/5-shaped scene:
a big (> DENSE_MESH_MAX_TRIS) textured + normal-mapped mesh, a dense
texture-synthesized mesh, a general-boundary ConvexVolume, a dielectric
sphere, an emissive light, and an infinite plane.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from cs397raytracingsp22 import (
    Camera, ConvexVolume, Dielectric, Isotropic, Lambertian, Plane, Scene,
    Sphere, Triangle,
)
from cs397raytracingsp22.models import transform as tf
from cs397raytracingsp22.render.driver import StagedOptions, render_to_image
from tests.test_mesh import make_mesh


def _grid_mesh_arrays(g, bump=0.0):
    xs = np.linspace(-1.0, 1.0, g + 1, dtype=np.float32)
    px, pz = np.meshgrid(xs, xs, indexing="ij")
    py = bump * np.sin(2.5 * px) * np.cos(2.5 * pz)
    positions = np.stack([px, py, pz], axis=-1).reshape(-1, 3)
    uv = np.stack(
        [(px + 1.0) / 2.0, (pz + 1.0) / 2.0], axis=-1
    ).reshape(-1, 2)
    vid = np.arange((g + 1) * (g + 1), dtype=np.int32).reshape(g + 1, g + 1)
    a, b = vid[:-1, :-1].ravel(), vid[1:, :-1].ravel()
    c, d4 = vid[1:, 1:].ravel(), vid[:-1, 1:].ravel()
    faces = np.concatenate(
        [np.stack([a, b, c], axis=-1), np.stack([a, c, d4], axis=-1)]
    )
    return positions, uv, faces


def kitchen_sink_scene(width=12, height=12, spp=2):
    from cs397raytracingsp22.ops.bvh import DENSE_MESH_MAX_TRIS

    # big textured + normal-mapped mesh (> DENSE_MESH_MAX_TRIS → BVH
    # traversal)
    g_big = int(np.sqrt(DENSE_MESH_MAX_TRIS / 2)) + 1  # 2·g² triangles
    pos, uv, faces = _grid_mesh_arrays(g_big, bump=0.3)
    assert len(faces) > DENSE_MESH_MAX_TRIS
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[::2] = (200, 120, 60)
    tex[1::2] = (60, 120, 200)
    nrm_map = np.full((4, 4, 3), 128, np.uint8)
    nrm_map[:2, :2] = (160, 140, 235)
    big = make_mesh(
        pos, faces, texcoords=uv, material=None,
        textures=(tex, None, None, tex, nrm_map),
        transform=tf.translate(0.0, 0.0, -2.0) @ tf.scale(2.0),
    )

    # dense texture-synthesized mesh
    pos2, uv2, faces2 = _grid_mesh_arrays(12, bump=0.15)
    dense = make_mesh(
        pos2, faces2, texcoords=uv2, material=None,
        textures=(tex, None, None, None, None),
        transform=tf.translate(-1.2, 1.2, -1.0) @ tf.rotate_x(80.0),
    )

    gvol = ConvexVolume(
        boundary=Sphere(center=(1.3, 0.8, -1.2), radius=0.7,
                        material=Lambertian()),
        phase_function=Isotropic(albedo=(0.9, 0.7, 0.7)),
        density=0.8,
    )
    # a second volume with a TRIANGLE boundary exercises the general
    # (non-sphere) entry/exit scan
    gvol_tri = ConvexVolume(
        boundary=Triangle(a=(-2.2, 0.2, -1.0), b=(-1.4, 0.2, -1.0),
                          c=(-1.8, 1.0, -1.0), material=Lambertian()),
        phase_function=Isotropic(albedo=(0.6, 0.9, 0.6)),
        density=1.5,
    )

    return Scene(
        camera=Camera(
            eyepoint=(0.0, 1.2, 2.6), view_dir=(0.0, -0.25, -1.0),
            up=(0, 1, 0), screen_width=width, screen_height=height,
            aa_sample_count=spp, path_depth=5,
        ),
        objects=[
            big, dense, gvol, gvol_tri,
            Sphere(center=(0.0, 0.55, -0.6), radius=0.35,
                   material=Dielectric(idx_of_refraction=1.5)),
            Plane(point=(0, -0.8, 0), normal=(0, 1, 0),
                  material=Lambertian(albedo=(0.6, 0.6, 0.6))),
            Sphere(center=(0, 5.5, 0), radius=2.0,
                   material=Lambertian(albedo=(0, 0, 0),
                                       emission=(8.0, 8.0, 8.0))),
        ],
    )


@pytest.mark.slow
def test_full_stack_staged_vs_path_trace_bit_identical():
    scene = kitchen_sink_scene()
    data = scene.compile()
    # the scene must actually exercise all three mesh paths
    assert len(data.dense_mesh_ids) == 1 and len(data.meshes) == 2
    assert data.n_gvols >= 1 and data.n_volumes >= 1

    img_one, _ = render_to_image(scene, seed=11, verbose=False,
                                 scene_data=data)

    img_staged, _ = render_to_image(scene, seed=11, verbose=False,
                                    scene_data=data, staged=StagedOptions())
    np.testing.assert_array_equal(img_one, img_staged)
