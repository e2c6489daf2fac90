"""BVH build + traversal vs brute force (SURVEY.md §4 unit tier)."""

import jax.numpy as jnp
import numpy as np

from cs397raytracingsp22.ops import bvh as bvhlib


def random_tris(n, rng, spread=5.0):
    centers = rng.uniform(-spread, spread, size=(n, 1, 3))
    corners = rng.uniform(-0.5, 0.5, size=(n, 3, 3))
    return (centers + corners).astype(np.float32)


def test_build_invariants():
    rng = np.random.default_rng(0)
    tris = random_tris(100, rng)
    bvh = bvhlib.build_bvh(tris, leaf_size=4)
    nn = bvh.skip.shape[0]
    # tri_order is a permutation
    assert sorted(bvh.tri_order.tolist()) == list(range(100))
    # skip targets are forward and within [1, nn]
    assert (bvh.skip > np.arange(nn)).all() and (bvh.skip <= nn).all()
    # leaves cover all triangles exactly once
    leaves = bvh.leaf_start >= 0
    counts = bvh.leaf_count[leaves]
    assert counts.sum() == 100 and (counts <= 4).all() and (counts >= 1).all()
    # parent boxes contain leaf boxes (root contains everything)
    assert (bvh.bounds_min[0] <= tris.reshape(-1, 3).min(0) + 1e-6).all()
    assert (bvh.bounds_max[0] >= tris.reshape(-1, 3).max(0) - 1e-6).all()


def test_traverse_matches_bruteforce():
    rng = np.random.default_rng(1)
    tris = random_tris(257, rng)  # odd count → uneven leaves
    bvh = bvhlib.build_bvh(tris, leaf_size=4)
    reordered = tris[bvh.tri_order]

    n_rays = 256
    o = rng.uniform(-8, 8, size=(n_rays, 3)).astype(np.float32)
    # aim at random triangle centroids (with jitter) so most rays hit
    targets = tris[rng.integers(0, len(tris), n_rays)].mean(axis=1)
    d = (targets - o + rng.normal(scale=0.05, size=(n_rays, 3))).astype(np.float32)

    hit_b, t_b, idx_b, u_b, v_b = bvhlib.intersect_tris_bruteforce(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(reordered), 0.001, 100.0
    )
    hit_t, t_t, idx_t, u_t, v_t = bvhlib.traverse(
        jnp.asarray(o),
        jnp.asarray(d),
        0.001,
        100.0,
        jnp.asarray(bvh.bounds_min),
        jnp.asarray(bvh.bounds_max),
        jnp.asarray(bvh.skip),
        jnp.asarray(bvh.leaf_start),
        jnp.asarray(bvh.leaf_count),
        jnp.asarray(reordered),
        4,
    )
    np.testing.assert_array_equal(np.asarray(hit_b), np.asarray(hit_t))
    m = np.asarray(hit_b)
    assert m.sum() > 20, "test scene should produce plenty of hits"
    np.testing.assert_allclose(
        np.asarray(t_b)[m], np.asarray(t_t)[m], rtol=1e-5
    )
    # the same triangle should win (barring exact ties)
    same = np.asarray(idx_b)[m] == np.asarray(idx_t)[m]
    assert same.mean() > 0.99
    np.testing.assert_allclose(np.asarray(u_b)[m], np.asarray(u_t)[m], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(v_b)[m], np.asarray(v_t)[m], rtol=1e-4, atol=1e-5)


def test_scan_matches_bruteforce():
    rng = np.random.default_rng(5)
    tris = random_tris(300, rng)  # not a multiple of the chunk size
    o = rng.uniform(-8, 8, size=(128, 3)).astype(np.float32)
    targets = tris[rng.integers(0, len(tris), 128)].mean(axis=1)
    d = (targets - o).astype(np.float32)
    hb, tb, ib, ub, vb = bvhlib.intersect_tris_bruteforce(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris), 0.001, 100.0
    )
    hs, ts, is_, us, vs = bvhlib.intersect_tris_scan(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris), 0.001, 100.0, chunk=64
    )
    np.testing.assert_array_equal(np.asarray(hb), np.asarray(hs))
    m = np.asarray(hb)
    assert m.sum() > 50
    np.testing.assert_allclose(np.asarray(tb)[m], np.asarray(ts)[m], rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(ib)[m], np.asarray(is_)[m])


def test_traverse_respects_t_range():
    rng = np.random.default_rng(2)
    tris = random_tris(33, rng, spread=2.0)
    bvh = bvhlib.build_bvh(tris, leaf_size=2)
    reordered = tris[bvh.tri_order]
    o = np.zeros((16, 3), np.float32)
    o[:, 2] = 10.0
    d = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (16, 1))
    hit, t, _, _, _ = bvhlib.traverse(
        jnp.asarray(o), jnp.asarray(d), 0.001, 5.0,
        jnp.asarray(bvh.bounds_min), jnp.asarray(bvh.bounds_max),
        jnp.asarray(bvh.skip), jnp.asarray(bvh.leaf_start),
        jnp.asarray(bvh.leaf_count), jnp.asarray(reordered), 2,
    )
    m = np.asarray(hit)
    assert (np.asarray(t)[m] <= 5.0).all()


def test_single_triangle_mesh():
    tris = np.asarray([[[0, 0, -3], [2, 0, -3], [0, 2, -3]]], np.float32)
    bvh = bvhlib.build_bvh(tris, leaf_size=4)
    o = jnp.asarray([[0.5, 0.5, 0.0], [5.0, 5.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 2)
    hit, t, _, u, v = bvhlib.traverse(
        o, d, 0.001, 100.0,
        jnp.asarray(bvh.bounds_min), jnp.asarray(bvh.bounds_max),
        jnp.asarray(bvh.skip), jnp.asarray(bvh.leaf_start),
        jnp.asarray(bvh.leaf_count), jnp.asarray(tris[bvh.tri_order]), 4,
    )
    assert np.asarray(hit).tolist() == [True, False]
    np.testing.assert_allclose(float(t[0]), 3.0, rtol=1e-5)
