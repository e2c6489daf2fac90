"""Native (C++) runtime vs pure-Python specification."""

import os

import numpy as np
import pytest

from cs397raytracingsp22.ops import bvh as bvhlib
from cs397raytracingsp22.utils import native, obj_loader

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)

ASSET_DIR = "/root/reference/obj"


@pytest.mark.parametrize("name", ["cube.obj", "teapot.obj", "drone.obj"])
def test_native_obj_matches_python(name):
    path = os.path.join(ASSET_DIR, name)
    if not os.path.exists(path):
        pytest.skip("asset absent")
    py = obj_loader.load_obj(path, use_native=False)
    nat = obj_loader.load_obj(path, use_native=True)
    assert nat.num_triangles == py.num_triangles
    assert nat.num_vertices == py.num_vertices
    np.testing.assert_allclose(nat.positions, py.positions, rtol=1e-6)
    np.testing.assert_allclose(nat.normals, py.normals, rtol=1e-6)
    np.testing.assert_allclose(nat.texcoords, py.texcoords, rtol=1e-6)
    np.testing.assert_array_equal(nat.indices, py.indices)
    assert nat.has_normals == py.has_normals
    assert nat.has_texcoords == py.has_texcoords


def test_native_bvh_valid_and_equivalent():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    centers = rng.uniform(-5, 5, size=(403, 1, 3))
    tris = (centers + rng.uniform(-0.5, 0.5, size=(403, 3, 3))).astype(np.float32)

    nat = bvhlib.build_bvh(tris, leaf_size=4, use_native=True)
    py = bvhlib.build_bvh(tris, leaf_size=4, use_native=False)

    # structural invariants
    for b in (nat, py):
        nn = b.skip.shape[0]
        assert sorted(b.tri_order.tolist()) == list(range(403))
        assert (b.skip > np.arange(nn)).all() and (b.skip <= nn).all()
        leaves = b.leaf_start >= 0
        assert b.leaf_count[leaves].sum() == 403

    # identical traversal results on random rays
    o = rng.uniform(-8, 8, size=(128, 3)).astype(np.float32)
    targets = tris[rng.integers(0, 403, 128)].mean(axis=1)
    d = (targets - o).astype(np.float32)

    def trav(b):
        return bvhlib.traverse(
            jnp.asarray(o), jnp.asarray(d), 0.001, 100.0,
            jnp.asarray(b.bounds_min), jnp.asarray(b.bounds_max),
            jnp.asarray(b.skip), jnp.asarray(b.leaf_start),
            jnp.asarray(b.leaf_count), jnp.asarray(tris[b.tri_order]), 4,
        )

    hn, tn, in_, _, _ = trav(nat)
    hp, tp, ip, _, _ = trav(py)
    np.testing.assert_array_equal(np.asarray(hn), np.asarray(hp))
    m = np.asarray(hn)
    assert m.sum() > 50
    np.testing.assert_allclose(np.asarray(tn)[m], np.asarray(tp)[m], rtol=1e-5)
    # original tri ids must agree
    np.testing.assert_array_equal(
        nat.tri_order[np.asarray(in_)[m]], py.tri_order[np.asarray(ip)[m]]
    )


def test_malformed_obj_agrees_and_never_crashes(tmp_path):
    """Hostile/unusual OBJ input: tab-delimited 'v\\t' lines (valid OBJ;
    used to leave the native vertex pool empty and SEGFAULT on the
    unchecked face-index read), corners with a missing position index
    (used to wrap to pos_arr[-1] in the Python loader — a phantom
    triangle), out-of-range and zero indices, and an 18 KB face line
    (used to split mid-token under the fixed 8 KB fgets buffer). Both
    loaders must survive and agree exactly."""
    n_big = 2000  # 2000 corners ≈ 18 KB line, past the old 8 KB buffer
    lines = ["v\t0 0 0", "v\t1 0 0", "v\t0 1 0", "v\t9 9 9", "vt 0.5 0.5"]
    lines += [f"v {i} {i} 1" for i in range(n_big)]
    big_face = "f " + " ".join(str(5 + i) for i in range(n_big))
    lines += [
        "f 1 2 3",        # fine
        "f 1 2 /1/1",     # missing v index → corner dropped, face degenerate
        "f 1 2 99999",    # out-of-range → corner dropped
        "f 0 1 2",        # 0 is invalid (1-based) → maps past-the-end, dropped
        "f -1 -2 -3",     # negative relative indices → valid
        big_face,          # long-line robustness
    ]
    path = tmp_path / "hostile.obj"
    path.write_text("\n".join(lines) + "\n")

    py = obj_loader.load_obj(str(path), use_native=False)
    nat = obj_loader.load_obj(str(path), use_native=True)
    assert py.num_triangles == nat.num_triangles
    np.testing.assert_allclose(nat.positions, py.positions, rtol=1e-6)
    np.testing.assert_array_equal(nat.indices, py.indices)
    # 1 (f 1 2 3) + 1 (f -1 -2 -3) + (n_big - 2) fan triangles
    assert py.num_triangles == 2 + (n_big - 2)
