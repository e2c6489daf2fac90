"""The Triton dense triangle scan (ops/pallas/tri_scan.py) in interpret
mode against its specification, ops/bvh.intersect_tris_scan: same hit
set and winners, t to float rounding, the earliest-index tie-break,
ragged ray and triangle counts, per-ray bounds, and the platform
dispatch in ops/intersect.dense_scan. The compiled kernel runs on the
card only (the `gpu` marker; chip_smoke.py phase c)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cs397raytracingsp22.ops import bvh
from cs397raytracingsp22.ops.pallas import tri_scan as ts


def _soup(nt, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-2, 2, (nt, 3)).astype(np.float32)
    e1 = rng.uniform(-0.5, 0.5, (nt, 3)).astype(np.float32)
    e2 = rng.uniform(-0.5, 0.5, (nt, 3)).astype(np.float32)
    verts = np.stack([a, a + e1, a + e2], axis=1)
    # the scene compiler's table: edges from the f32 corners
    table = np.concatenate([verts[:, 0], verts[:, 1] - verts[:, 0],
                            verts[:, 2] - verts[:, 0]], axis=1)
    return verts, table


def _rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d)


def _assert_parity(ref, got):
    hit_r, t_r, id_r, u_r, v_r = (np.asarray(x) for x in ref)
    hit_g, t_g, id_g, u_g, v_g = (np.asarray(x) for x in got)
    np.testing.assert_array_equal(hit_r, hit_g)
    np.testing.assert_array_equal(np.where(hit_r, id_r, -1), id_g)
    np.testing.assert_allclose(t_g, t_r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(u_g[hit_r], u_r[hit_r], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v_g[hit_r], v_r[hit_r], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_rays", [64, 203])
@pytest.mark.parametrize("n_tris", [12, 240, 6144])
def test_matches_jnp_scan(n_tris, n_rays):
    verts, table = _soup(n_tris)
    o, d = _rays(n_rays)
    ref = bvh.intersect_tris_scan(o, d, jnp.asarray(verts), 1e-3, 100.0)
    got = ts.tri_scan(o, d, jnp.asarray(table), 1e-3, 100.0, interpret=True)
    _assert_parity(ref, got)
    assert 0 < int(np.sum(np.asarray(ref[0]))) < n_rays


@pytest.mark.parametrize("block_rays,block_tris", [(16, 16), (128, 64)])
def test_block_shapes_agree(block_rays, block_tris, monkeypatch):
    monkeypatch.setattr(ts, "BLOCK_RAYS", block_rays)
    monkeypatch.setattr(ts, "BLOCK_TRIS", block_tris)
    verts, table = _soup(300, seed=3)
    o, d = _rays(150, seed=4)
    ref = bvh.intersect_tris_scan(o, d, jnp.asarray(verts), 1e-3, 100.0)
    got = ts.tri_scan(o, d, jnp.asarray(table), 1e-3, 100.0, interpret=True)
    _assert_parity(ref, got)


def test_per_ray_bounds():
    """Per-ray t_min and t_max (the integrator's dead-ray window is
    [t_min, 0]): a ray whose window excludes its nearest hit takes the
    next one or misses, and t = t_max on a miss."""
    verts, table = _soup(240, seed=5)
    o, d = _rays(257, seed=6)
    rng = np.random.default_rng(7)
    t_min = jnp.asarray(rng.choice([1e-3, 0.7, 2.0], 257).astype(np.float32))
    t_max = jnp.asarray(rng.choice([0.0, 1.5, 100.0], 257).astype(np.float32))
    ref = bvh.intersect_tris_scan(o, d, jnp.asarray(verts), t_min, t_max)
    got = ts.tri_scan(o, d, jnp.asarray(table), t_min, t_max, interpret=True)
    _assert_parity(ref, got)
    miss = ~np.asarray(got[0])
    np.testing.assert_array_equal(np.asarray(got[1])[miss], np.asarray(t_max)[miss])
    assert not np.asarray(got[0])[np.asarray(t_max) == 0.0].any()


def test_earliest_index_wins_ties():
    """Exact duplicates of one triangle, within a tile and across tiles:
    every ray that hits them reports the lowest index, like argmin."""
    verts, table = _soup(200, seed=8)
    target = np.array([[-0.5, -0.5, 3.0], [0.5, -0.5, 3.0], [0.0, 0.5, 3.0]],
                      np.float32)
    for i in (37, 40, 75, 160):  # lanes 5 and 8 of tile 1, tiles 2 and 5
        verts[i] = target
        table[i] = np.concatenate([target[0], target[1] - target[0],
                                   target[2] - target[0]])
    n = 70
    rng = np.random.default_rng(9)
    o = np.concatenate([rng.uniform(-0.1, 0.1, (n, 2)),
                        np.full((n, 1), 5.0)], axis=1).astype(np.float32)
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    o, d = jnp.asarray(o), jnp.asarray(d)
    ref = bvh.intersect_tris_scan(o, d, jnp.asarray(verts), 1e-3, 4.0)
    got = ts.tri_scan(o, d, jnp.asarray(table), 1e-3, 4.0, interpret=True)
    _assert_parity(ref, got)
    ids = np.asarray(got[2])
    assert (ids == 37).sum() == n  # every ray hits the duplicates first


def test_planar_table_pads_with_inert_rows():
    _, table = _soup(70)
    planes = ts.planar_table(jnp.asarray(table), 32)
    assert planes.shape == (9, 96)
    np.testing.assert_array_equal(np.asarray(planes[:, :70]), table.T)
    assert not np.asarray(planes[:, 70:]).any()


def test_dense_scan_dispatch_is_jnp_off_the_card():
    """On the CPU, intersect.dense_scan lowers the jnp scan: bit-identical
    to ops/bvh.intersect_tris_scan under jit."""
    from cs397raytracingsp22 import Lambertian, Scene
    from cs397raytracingsp22.models.camera import Camera
    from cs397raytracingsp22.ops import intersect
    from tests.test_mesh import make_mesh

    verts, _ = _soup(40, seed=10)
    mesh = make_mesh(verts.reshape(-1, 3), np.arange(120).reshape(40, 3),
                     material=Lambertian(albedo=(0.5, 0.5, 0.5)))
    block = Scene(camera=Camera(), objects=[mesh]).compile().meshes[0]
    o, d = _rays(90, seed=11)
    got = jax.jit(lambda o, d: intersect.dense_scan(block, o, d, 1e-3, 100.0))(o, d)
    ref = jax.jit(lambda o, d: bvh.intersect_tris_scan(
        o, d, block.tri_verts, 1e-3, 100.0))(o, d)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("jnp_cap,kernel_cap,expect", [
    (64, 128, "scan"),       # under both caps: the jnp scan
    (16, 128, "traverse"),   # only the kernel's cap admits it: the BVH
    (8, 16, "traverse"),     # over both caps: the BVH
])
def test_mesh_nearest_cap_follows_the_scan_that_runs(
        jnp_cap, kernel_cap, expect, monkeypatch):
    """Off the card the dense path stops at bvh.JNP_SCAN_MAX_TRIS, not at
    the Triton kernel's DENSE_MESH_MAX_TRIS: a 40-triangle mesh between
    the two caps traverses its BVH on the CPU."""
    from cs397raytracingsp22 import Lambertian, Scene
    from cs397raytracingsp22.models.camera import Camera
    from cs397raytracingsp22.ops import intersect
    from tests.test_mesh import make_mesh

    monkeypatch.setattr(bvh, "JNP_SCAN_MAX_TRIS", jnp_cap)
    monkeypatch.setattr(bvh, "DENSE_MESH_MAX_TRIS", kernel_cap)
    verts, _ = _soup(40, seed=14)
    mesh = make_mesh(verts.reshape(-1, 3), np.arange(120).reshape(40, 3),
                     material=Lambertian(albedo=(0.5, 0.5, 0.5)))
    m = Scene(camera=Camera(), objects=[mesh]).compile().meshes[0]
    # rays aimed at triangle centroids, so some of them hit
    rng = np.random.default_rng(15)
    o = rng.uniform(-3, 3, (90, 3)).astype(np.float32)
    aim = verts[rng.integers(0, 40, 90)].mean(axis=1)
    o, d = jnp.asarray(o), jnp.asarray(aim - o)
    got = jax.jit(lambda o, d: intersect.mesh_nearest(m, o, d, 1e-3, 100.0))(o, d)
    if expect == "scan":
        ref = jax.jit(lambda o, d: bvh.intersect_tris_scan(
            o, d, m.tri_verts, 1e-3, 100.0))(o, d)
    else:
        ref = jax.jit(lambda o, d: bvh.traverse(
            o, d, 1e-3, 100.0, m.bounds_min, m.bounds_max, m.skip,
            m.leaf_start, m.leaf_count, m.tri_verts, m.leaf_size))(o, d)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(got[0]).any()


@pytest.mark.gpu
def test_compiled_kernel_on_card(gpu_device):
    """The Triton-compiled kernel against the jnp scan, both on the card."""
    verts, table = _soup(6144, seed=12)
    o, d = _rays(5000, seed=13)
    ref = jax.jit(bvh.intersect_tris_scan)(o, d, jnp.asarray(verts), 1e-3, 100.0)
    got = ts.tri_scan(o, d, jnp.asarray(table), 1e-3, 100.0)
    hit_r, hit_g = np.asarray(ref[0]), np.asarray(got[0])
    assert np.mean(hit_r == hit_g) >= 1 - 1e-3
    both = hit_r & hit_g
    np.testing.assert_allclose(np.asarray(got[1])[both], np.asarray(ref[1])[both],
                               rtol=1e-5)
