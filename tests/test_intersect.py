"""Closed-form intersection tests per primitive (SURVEY.md §4 unit tier).

Covers the reference semantics at geometry.rs: sphere (395-411), plane
(474-487), triangle MT (431-449), AABB slab incl. strict inequality
(52-68), ConvexVolume free flight (502-525), and the scene-level nearest
reduction (tracing.rs:326-350)."""

import jax
import jax.numpy as jnp
import numpy as np

from cs397raytracingsp22 import (
    Camera,
    ConvexVolume,
    Isotropic,
    Lambertian,
    Metal,
    Plane,
    Scene,
    Sphere,
    Triangle,
)
from cs397raytracingsp22.models import materials as mat
from cs397raytracingsp22.ops import bvh as bvhlib
from cs397raytracingsp22.ops.intersect import intersect_scene


def make_scene(objects):
    return Scene(camera=Camera(), objects=objects).compile()


def shoot(scene_data, origins, dirs, t_min=0.001, t_max=100.0, u_vol=None):
    o = jnp.asarray(origins, jnp.float32).reshape(-1, 3)
    d = jnp.asarray(dirs, jnp.float32).reshape(-1, 3)
    if u_vol is None:
        u_vol = jnp.full((o.shape[0], scene_data.vol_center.shape[0]), 0.5)
    return intersect_scene(scene_data, o, d, t_min, t_max, u_vol)


def test_sphere_hit_miss_inside():
    s = make_scene([Sphere(center=(0, 0, -5), radius=1.0, material=Lambertian())])
    hit = shoot(
        s,
        [[0, 0, 0], [0, 3, 0], [0, 0, -5]],
        [[0, 0, -1], [0, 0, -1], [0, 0, -1]],
    )
    v = np.asarray(hit.valid)
    assert v.tolist() == [True, False, True]
    np.testing.assert_allclose(np.asarray(hit.t)[0], 4.0, rtol=1e-5)
    # inside the sphere: first root is behind (t1=-1 < t_min) → t2=+1
    np.testing.assert_allclose(np.asarray(hit.t)[2], 1.0, rtol=1e-5)
    # normal flipped toward ray for the inside hit (backface)
    np.testing.assert_allclose(np.asarray(hit.normal)[2], [0, 0, 1], atol=1e-5)
    assert not bool(hit.frontface[2])
    np.testing.assert_allclose(np.asarray(hit.normal)[0], [0, 0, 1], atol=1e-5)
    assert bool(hit.frontface[0])


def test_sphere_tangent_ray():
    s = make_scene([Sphere(center=(0, 0, -5), radius=1.0, material=Lambertian())])
    hit = shoot(s, [[1.0, 0, 0]], [[0, 0, -1]])
    # grazing: disc == 0 (within float error) — either outcome is
    # acceptable; just require no NaN poisoning
    assert np.isfinite(np.asarray(hit.t)).all() or not bool(hit.valid[0])


def test_sphere_unnormalized_direction_t_scales():
    s = make_scene([Sphere(center=(0, 0, -5), radius=1.0, material=Lambertian())])
    hit = shoot(s, [[0, 0, 0]], [[0, 0, -2]])
    np.testing.assert_allclose(np.asarray(hit.t)[0], 2.0, rtol=1e-5)


def test_plane_sign_flip_and_backside():
    s = make_scene(
        [Plane(point=(0, 0, 0), normal=(0, 1, 0), material=Lambertian())]
    )
    hit = shoot(
        s,
        [[0, 2, 0], [0, -2, 0], [0, 2, 0]],
        [[0, -1, 0], [0, 1, 0], [0, 1, 0]],
    )
    v = np.asarray(hit.valid)
    assert v.tolist() == [True, True, False]  # below-plane ray also hits (flip)
    np.testing.assert_allclose(np.asarray(hit.normal)[0], [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(hit.normal)[1], [0, -1, 0], atol=1e-6)


def test_triangle_edge_and_interior():
    tri = Triangle(a=(0, 0, -3), b=(2, 0, -3), c=(0, 2, -3), material=Lambertian())
    s = make_scene([tri])
    hit = shoot(
        s,
        [[0.5, 0.5, 0], [1.5, 1.5, 0], [-0.1, 0.5, 0]],
        [[0, 0, -1]] * 3,
    )
    assert np.asarray(hit.valid).tolist() == [True, False, False]
    np.testing.assert_allclose(np.asarray(hit.t)[0], 3.0, rtol=1e-5)
    # flat geometric normal (flipped toward ray)
    np.testing.assert_allclose(np.asarray(hit.normal)[0], [0, 0, 1], atol=1e-5)


def test_nearest_hit_wins_across_classes():
    s = make_scene(
        [
            Sphere(center=(0, 0, -5), radius=1.0, material=Metal()),
            Plane(point=(0, 0, -8), normal=(0, 0, 1), material=Lambertian()),
        ]
    )
    hit = shoot(s, [[0, 0, 0], [3, 0, 0]], [[0, 0, -1]] * 2)
    assert np.asarray(hit.valid).tolist() == [True, True]
    # ray 0 hits sphere (t=4) before plane (t=8); ray 1 misses sphere
    assert int(hit.mtype[0]) == mat.METAL
    assert int(hit.mtype[1]) == mat.LAMBERTIAN
    np.testing.assert_allclose(np.asarray(hit.t), [4.0, 8.0], rtol=1e-5)


def test_t_range_limits():
    s = make_scene([Sphere(center=(0, 0, -5), radius=1.0, material=Lambertian())])
    hit_far = shoot(s, [[0, 0, 0]], [[0, 0, -1]], t_max=3.0)
    assert not bool(hit_far.valid[0])
    hit_near = shoot(s, [[0, 0, -3.5]], [[0, 0, -1]], t_min=1.0)
    # t1 = 0.5 < t_min → t2 = 2.5 (the reference picks t2, geometry.rs:408)
    assert bool(hit_near.valid[0])
    np.testing.assert_allclose(np.asarray(hit_near.t)[0], 2.5, rtol=1e-5)


def test_emissive_material_resolved():
    s = make_scene(
        [
            Sphere(
                center=(0, 0, -5),
                radius=1.0,
                material=Lambertian(albedo=(0.3, 0.3, 0.3), emission=(0, 1, 1)),
            )
        ]
    )
    hit = shoot(s, [[0, 0, 0]], [[0, 0, -1]])
    np.testing.assert_allclose(np.asarray(hit.emission)[0], [0, 1, 1])
    np.testing.assert_allclose(np.asarray(hit.albedo)[0], [0.3, 0.3, 0.3])


def test_volume_free_flight():
    vol = ConvexVolume(
        boundary=Sphere(center=(0, 0, -5), radius=1.0, material=Lambertian()),
        phase_function=Isotropic(albedo=(1, 1, 1)),
        density=0.5,
    )
    s = make_scene([vol])
    o = [[0, 0, 0]] * 3
    d = [[0, 0, -1]] * 3
    # dist_before_scatter = -ln(U)/0.5; span in volume = 2.
    # U=0.9 → 0.21 < 2 scatter at t=4.21; U=0.5 → 1.39 scatter;
    # U=0.2 → 3.2 > 2 pass through.
    u = jnp.asarray([[0.9], [0.5], [0.2]])
    hit = shoot(s, o, d, u_vol=u)
    v = np.asarray(hit.valid)
    assert v.tolist() == [True, True, False]
    np.testing.assert_allclose(
        np.asarray(hit.t)[0], 4.0 - 2.0 * np.log(0.9), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(hit.t)[1], 4.0 - 2.0 * np.log(0.5), rtol=1e-5
    )
    # volume hits carry zero normals (geometry.rs:520)
    np.testing.assert_allclose(np.asarray(hit.normal)[0], [0, 0, 0])
    assert int(hit.mtype[0]) == mat.ISOTROPIC


def test_volume_ray_starting_inside():
    vol = ConvexVolume(
        boundary=Sphere(center=(0, 0, 0), radius=2.0, material=Lambertian()),
        phase_function=Isotropic(albedo=(1, 1, 1)),
        density=10.0,
    )
    s = make_scene([vol])
    # origin at center: entry root t1 = -2 (behind), exit t2 = +2;
    # t_start = max(-2, t_min) = t_min; very dense → always scatters.
    hit = shoot(s, [[0, 0, 0]], [[0, 0, -1]], u_vol=jnp.asarray([[0.5]]))
    assert bool(hit.valid[0])
    np.testing.assert_allclose(
        np.asarray(hit.t)[0], 0.001 + 0.1 * np.log(2.0), rtol=1e-3
    )


def test_slab_test_strict_inequality():
    # Degenerate flat box (zero extent in z) must MISS by the reference's
    # strict `tmax <= tmin` (geometry.rs:65) even for a ray crossing it.
    o = jnp.asarray([[0.0, 0.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    hit = bvhlib.slab_test(
        o, d, jnp.asarray([-1.0, -1.0, 0.0]), jnp.asarray([1.0, 1.0, 0.0]), 0.001, 100.0
    )
    assert not bool(hit[0])
    # Non-degenerate box hit
    hit2 = bvhlib.slab_test(
        o, d, jnp.asarray([-1.0, -1.0, -1.0]), jnp.asarray([1.0, 1.0, 1.0]), 0.001, 100.0
    )
    assert bool(hit2[0])


def test_slab_axis_parallel_ray_on_face():
    # Ray with d.x == 0 exactly on the box's x-min face: Rust's NaN-ignoring
    # max/min accept it (the x axis just doesn't constrain).
    o = jnp.asarray([[-1.0, 0.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    hit = bvhlib.slab_test(
        o, d, jnp.asarray([-1.0, -1.0, -1.0]), jnp.asarray([1.0, 1.0, 1.0]), 0.001, 100.0
    )
    assert bool(hit[0])
    running = bvhlib._slab_test_running(
        o, d, jnp.asarray([-1.0, -1.0, -1.0]), jnp.asarray([1.0, 1.0, 1.0]), 0.001, 100.0
    )
    assert bool(running[0])


def test_tri_scan_pallas_middle_tier_parity():
    """The Triton dense scan (interpret mode, asked for by the caller)
    vs the jnp scan on a 2,500-triangle table, a count that is not a
    multiple of the triangle tile."""
    from cs397raytracingsp22.ops.pallas.tri_scan import tri_scan

    rng = np.random.default_rng(0)
    n_tris = 2500
    a = rng.uniform(-2, 2, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-0.4, 0.4, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-0.4, 0.4, (n_tris, 3)).astype(np.float32)
    tri_verts = np.stack([a, a + e1, a + e2], axis=1)
    tri_table = np.concatenate([a, e1, e2], axis=1)

    n = 256
    o = jnp.asarray(rng.uniform(-3, 3, (n, 3)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))

    hit_j, t_j, id_j, u_j, v_j = bvhlib.intersect_tris_scan(
        o, d, jnp.asarray(tri_verts), 1e-3, 100.0
    )
    hit_p, t_p, id_p, u_p, v_p = tri_scan(
        o, d, jnp.asarray(tri_table), 1e-3, 100.0, interpret=True
    )
    hit = np.asarray(hit_j)
    np.testing.assert_array_equal(hit, np.asarray(hit_p))
    np.testing.assert_array_equal(np.asarray(id_j), np.asarray(id_p))
    np.testing.assert_allclose(
        np.asarray(t_j)[hit], np.asarray(t_p)[hit], rtol=1e-5, atol=1e-6
    )
    assert int(hit.sum()) > 50  # rays actually hit
