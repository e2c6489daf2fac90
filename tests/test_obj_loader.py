"""OBJ loader tests vs tobj semantics and known asset counts
(SURVEY.md §2.4/§4)."""

import os
import textwrap

import numpy as np
import pytest

from cs397raytracingsp22.utils import obj_loader

ASSET_DIR = "/root/reference/obj"


def write_obj(tmp_path, text):
    p = tmp_path / "m.obj"
    p.write_text(textwrap.dedent(text))
    return str(p)


def test_triangle_fan_quads(tmp_path):
    path = write_obj(
        tmp_path,
        """
        v 0 0 0
        v 1 0 0
        v 1 1 0
        v 0 1 0
        f 1 2 3 4
        """,
    )
    m = obj_loader.load_obj(path)
    assert m.num_triangles == 2
    np.testing.assert_array_equal(m.indices, [[0, 1, 2], [0, 2, 3]])


def test_single_index_unification(tmp_path):
    # Two faces sharing position 1 but with different normals must split
    # into distinct unified vertices (tobj single_index semantics).
    path = write_obj(
        tmp_path,
        """
        v 0 0 0
        v 1 0 0
        v 0 1 0
        vn 0 0 1
        vn 0 1 0
        f 1//1 2//1 3//1
        f 1//2 2//2 3//2
        """,
    )
    m = obj_loader.load_obj(path)
    assert m.num_triangles == 2
    assert m.num_vertices == 6  # no sharing across normal change
    np.testing.assert_allclose(m.normals[0], [0, 0, 1])
    np.testing.assert_allclose(m.normals[3], [0, 1, 0])


def test_negative_indices(tmp_path):
    path = write_obj(
        tmp_path,
        """
        v 0 0 0
        v 1 0 0
        v 0 1 0
        f -3 -2 -1
        """,
    )
    m = obj_loader.load_obj(path)
    assert m.num_triangles == 1
    np.testing.assert_allclose(m.positions[m.indices[0]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]])


@pytest.mark.skipif(not os.path.isdir(ASSET_DIR), reason="reference assets absent")
@pytest.mark.parametrize(
    "name,expected_tris",
    [
        ("cube.obj", 12),
        ("teapot.obj", 240),
        # sphere.obj: 16384 faces (quads + 256 pole triangles) → 32512
        ("sphere.obj", 32512),
    ],
)
def test_reference_assets_counts(name, expected_tris):
    m = obj_loader.load_obj(os.path.join(ASSET_DIR, name))
    assert m.num_triangles == expected_tris
    assert m.has_normals and m.has_texcoords
    # normals should be (approximately) unit where present
    norms = np.linalg.norm(m.normals, axis=-1)
    assert (norms > 0.5).mean() > 0.99


@pytest.mark.skipif(not os.path.isdir(ASSET_DIR), reason="reference assets absent")
def test_drone_mixed_faces():
    m = obj_loader.load_obj(os.path.join(ASSET_DIR, "drone.obj"))
    # 900 mixed faces triangulate to >= 900 triangles
    assert m.num_triangles >= 900
    assert m.has_texcoords


def test_uv_sphere_tessellation():
    """The generated 128×128 UV sphere: 32,512 non-degenerate triangles,
    unit radius, outward winding, normals equal to positions, texcoords
    in [0, 1]."""
    from cs397raytracingsp22.utils.obj_loader import uv_sphere

    m = uv_sphere(128, 128)
    assert m.num_triangles == 32512 and m.num_vertices == 129 * 129
    np.testing.assert_allclose(np.linalg.norm(m.positions, axis=1), 1.0, atol=1e-6)
    p = m.positions[m.indices]
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    assert (np.linalg.norm(n, axis=1) > 0).all()
    assert (np.sum(n * p.mean(axis=1), axis=1) > 0).all()
    np.testing.assert_array_equal(m.normals, m.positions)
    assert m.texcoords.min() >= 0.0 and m.texcoords.max() <= 1.0
