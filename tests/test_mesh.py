"""StaticMesh pipeline tests: transforms, smooth normals, texture-driven
materials, normal maps, BVH-in-scene (SURVEY.md §4)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cs397raytracingsp22 import Camera, Lambertian, Scene, Triangle
from cs397raytracingsp22.models import materials as mat
from cs397raytracingsp22.models import transform as tf
from cs397raytracingsp22.models.geometry import StaticMesh
from cs397raytracingsp22.ops.intersect import intersect_scene
from cs397raytracingsp22.utils.obj_loader import ObjMesh


def make_mesh(
    positions,
    indices,
    normals=None,
    texcoords=None,
    material=Lambertian(albedo=(0.5, 0.5, 0.5)),
    textures=(None,) * 5,
    transform=None,
):
    positions = np.asarray(positions, np.float32)
    if normals is None:
        normals = np.zeros_like(positions)
        normals[:, 2] = 1.0
    if texcoords is None:
        texcoords = np.zeros((len(positions), 2), np.float32)
    m = ObjMesh(
        positions=positions,
        normals=np.asarray(normals, np.float32),
        texcoords=np.asarray(texcoords, np.float32),
        indices=np.asarray(indices, np.int32),
        has_normals=True,
        has_texcoords=True,
    )
    return StaticMesh(
        m,
        list(textures),
        material,
        np.eye(4, dtype=np.float32) if transform is None else transform,
    )


def shoot(scene_objects, o, d, t_min=0.001, t_max=100.0):
    data = Scene(camera=Camera(), objects=scene_objects).compile()
    o = jnp.asarray(o, jnp.float32).reshape(-1, 3)
    d = jnp.asarray(d, jnp.float32).reshape(-1, 3)
    u = jnp.full((o.shape[0], data.vol_center.shape[0]), 0.5)
    return intersect_scene(data, o, d, t_min, t_max, u)


TRI_POS = [[0, 0, -3], [2, 0, -3], [0, 2, -3]]
TRI_IDX = [[0, 1, 2]]


def test_mesh_triangle_matches_standalone():
    mesh = make_mesh(TRI_POS, TRI_IDX)
    tri = Triangle(a=TRI_POS[0], b=TRI_POS[1], c=TRI_POS[2], material=Lambertian())
    o = [[0.5, 0.5, 0.0], [1.5, 1.5, 0.0]]
    d = [[0, 0, -1]] * 2
    hm = shoot([mesh], o, d)
    ht = shoot([tri], o, d)
    np.testing.assert_array_equal(np.asarray(hm.valid), np.asarray(ht.valid))
    m = np.asarray(hm.valid)
    np.testing.assert_allclose(np.asarray(hm.t)[m], np.asarray(ht.t)[m], rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(hm.point)[m], np.asarray(ht.point)[m], rtol=1e-5
    )


def test_transform_parameter_invariance():
    """The ray parameter t is invariant under the object transform (the
    direction is transformed WITHOUT renormalization, geometry.rs:304), so
    a scaled mesh reports the same t as its world-space equivalent."""
    scale = 0.1
    # object-space triangle 10x larger, scaled down to the same world tri
    big = (np.asarray(TRI_POS, np.float32) / scale).tolist()
    mesh = make_mesh(big, TRI_IDX, transform=tf.scale(scale))
    ref = make_mesh(TRI_POS, TRI_IDX)
    o = [[0.5, 0.5, 0.0]]
    d = [[0, 0, -1]]
    hm = shoot([mesh], o, d)
    hr = shoot([ref], o, d)
    assert bool(hm.valid[0]) and bool(hr.valid[0])
    np.testing.assert_allclose(float(hm.t[0]), float(hr.t[0]), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(hm.point[0]), np.asarray(hr.point[0]), atol=1e-5
    )


def test_translated_rotated_mesh():
    mesh = make_mesh(
        [[-1, -1, 0], [1, -1, 0], [0, 1, 0]],
        TRI_IDX,
        transform=tf.translate(0, 0, -5) @ tf.rotate_y(45.0),
    )
    hit = shoot([mesh], [[0, 0, 0]], [[0, 0, -1]])
    assert bool(hit.valid[0])
    np.testing.assert_allclose(np.asarray(hit.point[0]), [0, 0, -5], atol=1e-5)
    # world normal = rotated +z (flipped toward ray): (sin45, 0, cos45)
    np.testing.assert_allclose(
        np.asarray(hit.normal[0]), [np.sin(np.pi / 4), 0, np.cos(np.pi / 4)], atol=1e-5
    )


def test_smooth_normal_interpolation():
    # vertex normals tilted differently; at barycenter the interpolated
    # normal is their (normalized) mean.
    normals = np.asarray([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)
    mesh = make_mesh(TRI_POS, TRI_IDX, normals=normals)
    # aim at the barycenter (2/3, 2/3, -3)
    hit = shoot([mesh], [[2 / 3, 2 / 3, 0.0]], [[0, 0, -1]])
    assert bool(hit.valid[0])
    expected = normals.mean(axis=0)
    expected /= np.linalg.norm(expected)
    np.testing.assert_allclose(np.asarray(hit.normal[0]), expected, atol=1e-4)


def test_texture_synthesized_material():
    albedo_img = np.zeros((2, 2, 3), np.uint8)
    albedo_img[...] = [64, 128, 255]
    mesh = make_mesh(
        TRI_POS,
        TRI_IDX,
        texcoords=[[0.5, 0.5]] * 3,
        material=None,
        textures=(albedo_img, None, None, None, None),
    )
    hit = shoot([mesh], [[0.5, 0.5, 0.0]], [[0, 0, -1]])
    assert bool(hit.valid[0])
    assert int(hit.mtype[0]) == mat.PARAMETERIZED
    np.testing.assert_allclose(
        np.asarray(hit.albedo[0]), [64 / 255, 128 / 255, 1.0], atol=1e-6
    )
    np.testing.assert_allclose(np.asarray(hit.emission[0]), 0.0)
    # defaults without maps: metallic 0, roughness 1 (geometry.rs:260-263)
    np.testing.assert_allclose(float(hit.metallic[0]), 0.0)
    np.testing.assert_allclose(float(hit.roughness[0]), 1.0)


def test_flat_normal_map_identity():
    # A (128,128,255) normal map encodes (0,0,1) in tangent space → the
    # shading normal equals the interpolated normal (up to quantization).
    flat_nm = np.full((2, 2, 3), 128, np.uint8)
    flat_nm[..., 2] = 255
    albedo_img = np.full((2, 2, 3), 200, np.uint8)
    uvs = [[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]
    with_nm = make_mesh(
        TRI_POS, TRI_IDX, texcoords=uvs, material=None,
        textures=(albedo_img, None, None, None, flat_nm),
    )
    without_nm = make_mesh(
        TRI_POS, TRI_IDX, texcoords=uvs, material=None,
        textures=(albedo_img, None, None, None, None),
    )
    h1 = shoot([with_nm], [[0.5, 0.5, 0.0]], [[0, 0, -1]])
    h0 = shoot([without_nm], [[0.5, 0.5, 0.0]], [[0, 0, -1]])
    assert bool(h1.valid[0]) and bool(h0.valid[0])
    np.testing.assert_allclose(
        np.asarray(h1.normal[0]), np.asarray(h0.normal[0]), atol=0.01
    )


def test_mesh_without_material_or_uvs_rejected():
    m = ObjMesh(
        positions=np.asarray(TRI_POS, np.float32),
        normals=np.zeros((3, 3), np.float32),
        texcoords=np.zeros((3, 2), np.float32),
        indices=np.asarray(TRI_IDX, np.int32),
        has_normals=True,
        has_texcoords=False,
    )
    with pytest.raises(ValueError):
        StaticMesh(m, [None] * 5, None, np.eye(4, dtype=np.float32))


@pytest.mark.slow
def test_teapot_bvh_in_scene():
    """Teapot OBJ through the full scene path: BVH traversal (240 tris >
    brute-force threshold), smooth normals, world transform."""
    import os

    if not os.path.exists("/root/reference/obj/teapot.obj"):
        pytest.skip("asset absent")
    mesh = StaticMesh.load_from_file(
        "/root/reference/obj/teapot.obj",
        material=Lambertian(albedo=(0.7, 0.4, 0.2)),
        transform=tf.translate(0.0, 0.0, -3.0) @ tf.rotate_x(-90.0),
    )
    # grid of rays toward the teapot
    xs, ys = np.meshgrid(np.linspace(-1, 1, 8), np.linspace(-0.5, 1.0, 8))
    o = np.stack([xs.ravel(), ys.ravel(), np.full(64, 2.0)], axis=-1)
    d = np.tile([[0.0, 0.0, -1.0]], (64, 1))
    hit = shoot([mesh], o, d)
    v = np.asarray(hit.valid)
    assert v.sum() > 5  # plenty of rays hit the pot
    # normals are unit where hit
    nn = np.linalg.norm(np.asarray(hit.normal)[v], axis=-1)
    np.testing.assert_allclose(nn, 1.0, atol=1e-4)
    # hit distances sane: teapot sits around z=-3, rays from z=2
    t = np.asarray(hit.t)[v]
    assert (t > 3.0).all() and (t < 7.0).all()
