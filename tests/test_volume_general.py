"""General-boundary ConvexVolume (geometry.rs:495-530 with a non-sphere
`boundary: Arc<dyn Intersectable>`): parity against a literal numpy port
of the reference algorithm, analytic transmittance, and end-to-end render
coverage."""

import numpy as np
import jax.numpy as jnp
import pytest

from cs397raytracingsp22 import (
    Camera, ConvexVolume, Isotropic, Lambertian, Plane, Scene, Sphere,
)
from cs397raytracingsp22.models.geometry import StaticMesh, Triangle
from cs397raytracingsp22.ops import intersect as isect
from cs397raytracingsp22.render.driver import render_to_image

MT_EPS = 1e-4

# The 12-triangle cube spanning [-1, 1]^3 (the reference's obj/cube.obj).
CUBE_OBJ = """\
v -1 -1 -1
v 1 -1 -1
v 1 1 -1
v -1 1 -1
v -1 -1 1
v 1 -1 1
v 1 1 1
v -1 1 1
f 1 3 2
f 1 4 3
f 5 6 7
f 5 7 8
f 1 2 6
f 1 6 5
f 4 7 3
f 4 8 7
f 1 5 8
f 1 8 4
f 2 3 7
f 2 7 6
"""


@pytest.fixture
def cube(tmp_path):
    path = tmp_path / "cube.obj"
    path.write_text(CUBE_OBJ)
    return str(path)


def _cube_volume(cube, density=2.0, scale=1.0, center=(0.0, 0.0, 0.0)):
    from cs397raytracingsp22.models import transform as tf

    mesh = StaticMesh.load_from_file(
        cube,
        material=Lambertian(albedo=(1, 1, 1)),
        transform=tf.translate(*center) @ tf.scale(scale),
    )
    return ConvexVolume(
        boundary=mesh,
        phase_function=Isotropic(albedo=(0.9, 0.9, 0.9)),
        density=density,
    )


def _ref_volume_intersect(tris, density, o, d, t_min, t_max, u):
    """Literal numpy port of ConvexVolume::intersect_ray
    (geometry.rs:502-525) over a triangle-soup boundary: entry = nearest
    boundary hit over (-inf, inf), exit = nearest over (entry+1e-4, inf),
    then free-flight sampling with the SAME uniform."""

    def nearest(lo):
        best = np.inf
        for row in tris:
            a, e1, e2 = row[0:3], row[3:6], row[6:9]
            q = np.cross(d, e2)
            det = np.dot(e1, q)
            if abs(det) < MT_EPS:
                continue
            f = 1.0 / det
            s = o - a
            uu = f * np.dot(s, q)
            r = np.cross(s, e1)
            vv = f * np.dot(d, r)
            t = f * np.dot(e2, r)
            if uu >= 0 and vv >= 0 and uu + vv <= 1 and lo <= t < best:
                best = t
        return best

    t_entr = nearest(-np.inf)
    if not np.isfinite(t_entr):
        return None
    t_exit = nearest(t_entr + 1e-4)
    if not np.isfinite(t_exit):
        return None
    if t_exit < t_min or t_entr > t_max:
        return None
    t_start = max(t_entr, t_min)
    t_end = min(t_exit, t_max)
    dist = (-1.0 / density) * np.log(max(u, 1e-38))
    if dist < t_end - t_start:
        return t_start + dist
    return None


def test_matches_reference_algorithm(cube):
    vol = _cube_volume(cube, density=1.7)
    scene = Scene(
        camera=Camera(eyepoint=(0, 0, 4), view_dir=(0, 0, -1), up=(0, 1, 0)),
        objects=[vol],
    )
    data = scene.compile()
    assert data.n_gvols == 1
    tris = np.asarray(data.gvol_tri[0])
    assert tris.shape == (12, 9)

    rng = np.random.default_rng(7)
    n = 256
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    u = rng.uniform(1e-3, 1.0, n).astype(np.float32)
    t_min, t_max = 0.001, 50.0

    t_j, v_j = isect.intersect_general_volume(
        jnp.asarray(tris), jnp.float32(1.7), jnp.asarray(o), jnp.asarray(d),
        t_min, t_max, jnp.asarray(u),
    )
    t_j = np.asarray(t_j)
    v_j = np.asarray(v_j)

    for i in range(n):
        ref = _ref_volume_intersect(tris, 1.7, o[i], d[i], t_min, t_max, u[i])
        assert v_j[i] == (ref is not None), i
        if ref is not None:
            np.testing.assert_allclose(t_j[i], ref, rtol=2e-4, atol=2e-5)


def test_transmittance_through_cube(cube):
    """Axis-aligned rays through a unit-side-2 cube: chord length 2, so
    the scatter probability is 1 - exp(-rho * 2) with uniform draws."""
    rho = 0.8
    vol = _cube_volume(cube, density=rho)
    scene = Scene(
        camera=Camera(eyepoint=(0, 0, 4), view_dir=(0, 0, -1), up=(0, 1, 0)),
        objects=[vol],
    )
    data = scene.compile()
    n = 4096
    rng = np.random.default_rng(3)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = rng.uniform(-0.7, 0.7, n)
    o[:, 1] = rng.uniform(-0.7, 0.7, n)
    o[:, 2] = 5.0
    d = np.tile(np.array([[0, 0, -1.0]], np.float32), (n, 1))
    u = rng.uniform(0, 1, n).astype(np.float32)
    _, valid = isect.intersect_general_volume(
        data.gvol_tri[0], jnp.float32(rho), jnp.asarray(o), jnp.asarray(d),
        0.001, 100.0, jnp.asarray(u),
    )
    frac = float(np.mean(np.asarray(valid)))
    expect = 1.0 - np.exp(-rho * 2.0)
    assert abs(frac - expect) < 0.03, (frac, expect)


def test_triangle_boundary_compiles_and_sphere_unchanged():
    tri_vol = ConvexVolume(
        boundary=Triangle(a=(0, 0, 0), b=(1, 0, 0), c=(0, 1, 0),
                          material=Lambertian(albedo=(1, 1, 1))),
        phase_function=Isotropic(albedo=(0.5, 0.5, 0.5)),
        density=1.0,
    )
    sph_vol = ConvexVolume(
        boundary=Sphere(center=(0, 0, 0), radius=1.0,
                        material=Lambertian(albedo=(1, 1, 1))),
        phase_function=Isotropic(albedo=(0.5, 0.5, 0.5)),
        density=1.0,
    )
    scene = Scene(
        camera=Camera(eyepoint=(0, 0, 4), view_dir=(0, 0, -1), up=(0, 1, 0)),
        objects=[tri_vol, sph_vol],
    )
    data = scene.compile()
    assert data.n_gvols == 1
    assert data.n_volumes == 1
    assert data.gvol_tri[0].shape == (1, 9)


def test_render_with_mesh_boundary_volume(cube):
    """End-to-end: emissive sphere behind a cube-shaped fog volume —
    pixels through the fog must dim but stay lit (scatter + passthrough),
    and the render must be finite and deterministic."""
    scene = Scene(
        camera=Camera(
            eyepoint=(0, 0, 5), view_dir=(0, 0, -1), up=(0, 1, 0),
            screen_width=24, screen_height=24, aa_sample_count=16,
            path_depth=6,
        ),
        objects=[
            _cube_volume(cube, density=1.2, scale=1.2),
            # emissive backdrop: every pixel sees it unless scattered away
            Plane(point=(0, 0, -4), normal=(0, 0, 1),
                  material=Lambertian(albedo=(0, 0, 0), emission=(4, 4, 4))),
        ],
    )
    img1, _ = render_to_image(scene, seed=11, verbose=False)
    img2, _ = render_to_image(scene, seed=11, verbose=False)
    np.testing.assert_array_equal(img1, img2)
    assert np.isfinite(img1.astype(np.float64)).all()
    # center pixels look through the fog at the emitter: lit but dimmer
    # than the corner pixels' direct view
    center = img1[10:14, 10:14].mean()
    corner = img1[0:3, 0:3].mean()
    assert center > 5.0, center
    assert center < corner, (center, corner)


def test_small_scaled_boundary_keeps_reference_accept_set(cube):
    """A scale(0.05) cube boundary: world-space det = det(M)·det_obj
    shrinks by 1.25e-4, so a flat 1e-4 world reject would drop EVERY
    boundary triangle and the medium would silently never scatter. The
    per-volume eps (SceneData.gvol_eps = 1e-4·|det(M)|) reproduces the
    reference's object-space accept set (geometry.rs:335,505-510)."""
    s = 0.002  # cube det_w <= 4s^2|d| = 1.6e-5 < the flat 1e-4 reject
    vol = _cube_volume(cube, density=1e6, scale=s)  # dense: scatter certain
    scene = Scene(camera=Camera(), objects=[vol]).compile()
    np.testing.assert_allclose(scene.gvol_eps[0], MT_EPS * s**3, rtol=1e-5)

    n = 8
    o = jnp.tile(jnp.asarray([0.0, 0.0, 3.0])[None, :], (n, 1))
    d = jnp.tile(jnp.asarray([0.0, 0.0, -1.0])[None, :], (n, 1))
    u = jnp.full((n,), 1.0 - 1e-7)  # u→1 ⇒ immediate scatter at entry
    t, valid = isect.intersect_general_volume(
        scene.gvol_tri[0], scene.gvol_density[0], o, d, 1e-3, 100.0, u,
        eps=scene.gvol_eps[0],
    )
    assert bool(valid.all()), "scaled boundary must still scatter"
    # entry at z = +s·(cube half extent): cube.obj spans [-1, 1]
    np.testing.assert_allclose(np.asarray(t), 3.0 - s, atol=2e-3)

    # with the un-scaled flat epsilon every triangle is rejected —
    # the exact silent-fog failure this guards against
    t_bad, valid_bad = isect.intersect_general_volume(
        scene.gvol_tri[0], scene.gvol_density[0], o, d, 1e-3, 100.0, u,
        eps=MT_EPS,
    )
    assert not bool(valid_bad.any())


def test_zero_density_volume_passes_through():
    """density = 0: the reference computes -ln(u)/0.0 = +inf (free
    flight never scatters, geometry.rs:517) and renders the volume as
    fully transparent; compile must not crash and the volume test must
    never scatter."""
    scene = Scene(
        camera=Camera(screen_width=4, screen_height=4, aa_sample_count=1),
        objects=[
            ConvexVolume(
                boundary=Sphere(center=(0, 0, 0), radius=1.0,
                                material=Lambertian()),
                phase_function=Isotropic(albedo=(0.9,) * 3),
                density=0.0,
            ),
            Plane(point=(0, 0, -5), normal=(0, 0, 1),
                  material=Lambertian(albedo=(0.5,) * 3,
                                      emission=(2.0,) * 3)),
        ],
    )
    data = scene.compile()  # must not ZeroDivisionError

    n = 8
    o = jnp.tile(jnp.asarray([0.0, 0.0, 3.0])[None, :], (n, 1))
    d = jnp.tile(jnp.asarray([0.0, 0.0, -1.0])[None, :], (n, 1))
    u = jnp.full((n, 1), 1.0 - 1e-7)  # would scatter immediately if rho>0
    t, idx, valid = isect.intersect_volumes(data, o, d, 1e-3, 100.0, u)
    assert not bool(valid.any()), "zero-density medium never scatters"
