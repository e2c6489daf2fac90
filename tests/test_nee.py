"""Next-event estimation (render/nee.py) — the opt-in beyond-reference
estimator: same expectation as the plain depth-limited path trace, much
lower variance on small-light scenes, and hard gating everywhere the
light-set assumption doesn't hold."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cs397raytracingsp22 import Camera, Lambertian, Plane, Scene, Sphere
from cs397raytracingsp22.render import integrator
from cs397raytracingsp22.utils import threefry
from scenes import cornell


def test_light_extraction():
    """Cornell config3: the two light triangles become sampled lights."""
    data = cornell.build_config3(width=8, height=8, spp=1).compile()
    assert data.nee_ok
    assert data.n_lt_tri == 2
    assert data.n_lt_sph == 1  # config3's emissive sphere
    rows = np.asarray(data.lt_tri)[:2]
    # areas positive, emission matches the scene's light material
    assert (rows[:, 12] > 0).all()
    assert (rows[:, 9:12] > 1.0).all()


def test_emissive_sphere_extraction():
    scene = Scene(
        camera=Camera(screen_width=4, screen_height=4, aa_sample_count=1),
        objects=[
            Plane(point=(0, 0, 0), normal=(0, 1, 0), material=Lambertian()),
            Sphere(center=(0, 3, 0), radius=0.5,
                   material=Lambertian(albedo=(0, 0, 0), emission=(4, 4, 4))),
        ],
    )
    data = scene.compile()
    assert data.nee_ok
    assert data.n_lt_sph == 1
    row = np.asarray(data.lt_sph)[0]
    np.testing.assert_allclose(row, [0, 3, 0, 0.5, 4, 4, 4])


def test_nee_gating():
    """Emissive planes / lightless scenes void nee_ok, and the driver
    refuses Camera(nee=True) on them."""
    from cs397raytracingsp22.render.driver import render_to_image

    lit_plane = Scene(
        camera=Camera(screen_width=4, screen_height=4, aa_sample_count=1,
                      nee=True),
        objects=[
            Plane(point=(0, 0, 0), normal=(0, 1, 0), material=Lambertian()),
            Plane(point=(0, 8, 0), normal=(0, -1, 0),
                  material=Lambertian(emission=(3, 3, 3))),
        ],
    )
    assert not lit_plane.compile().nee_ok
    with pytest.raises(ValueError, match="nee"):
        render_to_image(lit_plane, verbose=False)

    no_light = Scene(
        camera=Camera(screen_width=4, screen_height=4, aa_sample_count=1),
        objects=[Plane(point=(0, 0, 0), normal=(0, 1, 0), material=Lambertian())],
    )
    assert not no_light.compile().nee_ok


def _paired_radiance(n_px=24, spp=256, depth=4):
    """Per-chain radiance from the plain and NEE estimators over the SAME
    primary rays and scatter draws (shared sites, utils/rng.py): the
    indirect chains are identical paths, so the estimator difference is
    exactly (NEE terms − suppressed emission) with expectation 0."""
    scene = cornell.build_config3(width=16, height=16, spp=spp, path_depth=depth)
    data = scene.compile()
    key = threefry.key_words(7)
    pixel_ids = jnp.arange(n_px, dtype=jnp.int32) * 7 % 256
    o, d = scene.camera.generate_rays(key, pixel_ids, spp=spp)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    uids = (
        pixel_ids[:, None] * jnp.int32(spp)
        + jnp.arange(spp, dtype=jnp.int32)[None, :]
    ).reshape(-1)

    plain, _ = integrator.path_trace(data, o, d, uids, key, depth, 100.0)
    neer, _ = integrator.path_trace_nee(data, o, d, uids, key, depth, 100.0)
    return (
        np.asarray(plain).reshape(n_px, spp, 3),
        np.asarray(neer).reshape(n_px, spp, 3),
    )


@pytest.mark.slow
@pytest.mark.heavy
def test_nee_same_mean_lower_variance():
    plain, neer = _paired_radiance()
    pm = plain.mean(axis=1)
    nm = neer.mean(axis=1)
    # equal expectation at equal depth (last-bounce NEE gate): per-pixel
    # means agree within the PAIRED estimator's noise
    scale = max(pm.mean(), 1e-3)
    assert np.abs(pm - nm).mean() < 0.12 * scale, (
        pm.mean(), nm.mean(), np.abs(pm - nm).mean()
    )
    # global means tighter still
    np.testing.assert_allclose(nm.mean(), pm.mean(), rtol=0.06)

    # config3's lights are LARGE (plain paths find them often), so the
    # variance win here is modest — assert it exists; the collapse is
    # asserted on the small-light scene below (measured ratio ~0.67
    # here, 2026-08-18)
    pv = plain.var(axis=1).mean()
    nv = neer.var(axis=1).mean()
    assert nv < 0.85 * pv, (nv, pv)


def _small_light_scene(spp, radius=0.08):
    # the light sits ABOVE AND BEHIND the down-pitched camera, outside
    # any (multi-jittered, >1px-capable) primary ray's reach: a single
    # direct 300-emission camera hit would spike the per-sample variance
    # identically in both estimators and mask NEE's collapse
    return Scene(
        camera=Camera(
            eyepoint=(0.0, 1.2, 3.0), view_dir=(0.0, -0.55, -1.0),
            up=(0.0, 1.0, 0.0), screen_width=8, screen_height=8,
            aa_sample_count=spp, path_depth=3,
        ),
        objects=[
            Plane(point=(0, 0, 0), normal=(0, 1, 0),
                  material=Lambertian(albedo=(0.7, 0.7, 0.7))),
            Sphere(center=(0.0, 2.5, 4.0), radius=radius,
                   material=Lambertian(albedo=(0, 0, 0),
                                       emission=(300.0, 300.0, 300.0))),
        ],
    )


@pytest.mark.slow
@pytest.mark.heavy
def test_nee_small_light_mean_and_collapse():
    """A small out-of-frame sphere light over a lambertian floor: plain
    paths rarely find it (spiky variance); NEE must (a) converge to the
    SAME mean — this pins the reference's hidden 3/4 ball-length factor
    in the diffuse transport (nee.py::_diffuse_mask doc; with albedo/π
    instead, NEE would read ~4/3 too bright, far outside the tolerance)
    — and (b) collapse the per-sample variance by orders of magnitude
    (measured ratio 0.0067 at this config, 2026-08-18; plain needs the
    0.3 radius to land enough hits for ITS mean to converge — at 0.08
    the plain mean itself is ±50% noise)."""
    spp = 4096
    scene = _small_light_scene(spp, radius=0.3)
    data = scene.compile()
    assert data.nee_ok and data.n_lt_sph == 1
    key = threefry.key_words(3)
    n_px = 12
    pixel_ids = jnp.arange(n_px, dtype=jnp.int32) * 5 % 64
    o, d = scene.camera.generate_rays(key, pixel_ids, spp=spp)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    uids = (
        pixel_ids[:, None] * jnp.int32(spp)
        + jnp.arange(spp, dtype=jnp.int32)[None, :]
    ).reshape(-1)

    plain, _ = integrator.path_trace(data, o, d, uids, key, 3, 100.0)
    neer, _ = integrator.path_trace_nee(data, o, d, uids, key, 3, 100.0)
    plain = np.asarray(plain).reshape(n_px, spp, 3)
    neer = np.asarray(neer).reshape(n_px, spp, 3)

    pm = plain.mean(axis=(0, 1))
    nm = neer.mean(axis=(0, 1))
    assert pm.mean() > 0.05, "scene must actually be lit"
    np.testing.assert_allclose(nm, pm, rtol=0.12)

    pv = plain.var(axis=1).mean()
    nv = neer.var(axis=1).mean()
    assert nv < 0.05 * pv, (nv, pv)


@pytest.mark.slow
@pytest.mark.heavy
def test_nee_parameterized_material_mean_parity():
    """NEE on a ParameterizedMaterial floor (roughness 0.5, metallic
    0.3): the diffuse lobe NEEs with f = (3/4-ball)·albedo/π and the
    SHARED branch uniform (bit-parity with ops/bsdf.py), the specular
    lobe keeps by-chance transport — so the full-path NEE mean must
    equal the plain mean while the variance collapses. Pins the weight
    convention (metallic tint is specular-only) that the executor
    bit-identity tests cannot see."""
    from cs397raytracingsp22 import ParameterizedMaterial

    # 48 px × 8192 spp: the PLAIN side is the noisy one (spiky
    # small-light hits); measured seed scatter of the mean ratio at
    # this size is ±5% with outliers to 11% (6-seed probe, 2026-08-19:
    # plain σ≈6%, NEE σ≈0.6%) vs the 25%+ shift a wrong diffuse weight
    # (4/3 or 3/4 factor) would produce
    spp = 8192
    scene = _small_light_scene(spp, radius=0.3)
    scene = dataclasses.replace(
        scene,
        objects=[
            Plane(point=(0, 0, 0), normal=(0, 1, 0),
                  material=ParameterizedMaterial(
                      albedo=(0.7, 0.7, 0.7), roughness=0.5,
                      metallic=0.3)),
            scene.objects[1],
        ],
    )
    data = scene.compile()
    assert data.nee_ok
    key = threefry.key_words(13)
    n_px = 48
    pixel_ids = jnp.arange(n_px, dtype=jnp.int32) % 64
    o, d = scene.camera.generate_rays(key, pixel_ids, spp=spp)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    uids = (
        pixel_ids[:, None] * jnp.int32(spp)
        + jnp.arange(spp, dtype=jnp.int32)[None, :]
    ).reshape(-1)

    plain, _ = integrator.path_trace(data, o, d, uids, key, 3, 100.0)
    neer, _ = integrator.path_trace_nee(data, o, d, uids, key, 3, 100.0)
    plain = np.asarray(plain).reshape(n_px, spp, 3)
    neer = np.asarray(neer).reshape(n_px, spp, 3)

    pm = plain.mean(axis=(0, 1))
    nm = neer.mean(axis=(0, 1))
    assert pm.mean() > 0.02, "scene must actually be lit"
    np.testing.assert_allclose(nm, pm, rtol=0.15)
    assert neer.var(axis=1).mean() < 0.1 * plain.var(axis=1).mean()


@pytest.mark.slow
@pytest.mark.heavy
def test_nee_fog_and_reach_parity():
    """direct_light at a vertex behind a participating medium, with and
    without a binding max_trace_dist, must match the plain estimator's
    converged direct transport. This pins the correlated-r design
    (nee.py::_diffuse_mask): the shadow ray's sampled ball length r
    scales its t-unit free-flight transmittance and its reach AND
    weights the sample — a mean-field 3/4 weight with independent r
    measured ~15% dim on this very geometry. The reference value is a
    deterministic direction-form quadrature of the plain estimator
    (uniform-hemisphere directions × analytic r-quadrature)."""
    from cs397raytracingsp22 import ConvexVolume, Isotropic
    from cs397raytracingsp22.ops.intersect import intersect_scene
    from cs397raytracingsp22.render import nee as neelib

    E, R, C, alb = 300.0, 0.3, np.array([0.0, 2.0, -0.5]), 0.7
    FOG_C, FOG_R, RHO = np.array([0.3, 1.0, -0.5]), 0.5, 2.0
    data = Scene(
        camera=Camera(),
        objects=[
            Plane(point=(0, 0, 0), normal=(0, 1, 0),
                  material=Lambertian(albedo=(alb,) * 3)),
            Sphere(center=tuple(C), radius=R,
                   material=Lambertian(albedo=(0, 0, 0), emission=(E,) * 3)),
            ConvexVolume(
                boundary=Sphere(center=tuple(FOG_C), radius=FOG_R,
                                material=Lambertian()),
                phase_function=Isotropic(albedo=(0.9,) * 3),
                density=RHO,
            ),
        ],
    ).compile()
    assert data.nee_ok

    p = np.array([0.3, 0.0, -0.5], np.float32)
    n = 400000
    o = jnp.tile(jnp.asarray(p + np.array([0, 1, 0], np.float32))[None, :], (n, 1))
    d = jnp.tile(jnp.asarray([0.0, -1.0, 0.0])[None, :], (n, 1))
    # tiny volume uniforms → free-flight far beyond the span: the probe
    # ray passes THROUGH the fog so the vertex is the floor
    u_vol = jnp.zeros((n, data.vol_center.shape[0])) + 1e-6
    hit = intersect_scene(data, o, d, 1e-3, 100.0, u_vol)
    assert float(jnp.mean((hit.mtype == 0).astype(jnp.float32))) == 1.0
    uids = jnp.arange(n, dtype=jnp.int32)
    key = threefry.key_words(5)
    live = jnp.ones((n,), bool)
    uc = jnp.zeros((n,))

    # plain-estimator direct transport by quadrature: uniform-hemisphere
    # directions; per direction, E_r[r·exp(−ρ·span/r)·1(reach)] over the
    # ball-length density 3r²
    rng = np.random.default_rng(3)
    M = 200000
    u2 = rng.random((M, 2))
    z = np.abs(1 - 2 * u2[:, 0])
    phi = 2 * np.pi * u2[:, 1]
    s = np.sqrt(np.maximum(1 - z * z, 0))
    w = np.stack([s * np.cos(phi), z, s * np.sin(phi)], axis=1)
    oc = p - C
    b = 2 * w @ oc
    cq = oc @ oc - R * R
    disc = b * b - 4 * cq
    hitl = (disc > 0)
    tl = (-b - np.sqrt(np.maximum(disc, 0))) / 2
    hitl &= tl > 0
    of = p - FOG_C
    bf = 2 * w @ of
    cf = of @ of - FOG_R * FOG_R
    df = bf * bf - 4 * cf
    t0 = np.where(df > 0, (-bf - np.sqrt(np.maximum(df, 0))) / 2, 0.0)
    t1 = np.where(df > 0, (-bf + np.sqrt(np.maximum(df, 0))) / 2, 0.0)
    span = np.clip(np.minimum(t1, tl) - np.maximum(t0, 0.0), 0.0, None)
    rq = ((np.arange(200) + 0.5) / 200)[None, :]
    wq = 3 * rq**2 / 200

    def plain_direct(max_trace_dist):
        reach = (tl[:, None] / rq) <= max_trace_dist
        inner = np.sum(
            wq * rq * np.exp(-RHO * span[:, None] / rq) * reach, axis=1
        )
        val = np.where(hitl, (alb / np.pi) * 2 * np.pi * E * w[:, 1] * inner, 0.0)
        return val.mean()

    for mtd in (100.0, 2.5):
        c, did, segs = neelib.direct_light(
            data, hit, d, uc, live, uids, key, 0, 1e-3, mtd
        )
        nee_val = float(jnp.mean(c[:, 0]))
        ref = plain_direct(mtd)
        np.testing.assert_allclose(nee_val, ref, rtol=0.04), (mtd, nee_val, ref)
        assert float(did.mean()) == 1.0  # suppression flag ignores gates


def test_nee_phong_rejected():
    """--nee under ShadingMode.PHONG is a silent no-op estimator-wise;
    the driver must refuse it instead of rendering Phong and letting the
    user believe they compared NEE."""
    from cs397raytracingsp22.models.camera import ShadingMode
    from cs397raytracingsp22.render.driver import render_to_image

    base = cornell.build_config3(width=4, height=4, spp=1)
    scene = dataclasses.replace(
        base,
        camera=dataclasses.replace(
            base.camera, nee=True, shading_mode=ShadingMode.PHONG
        ),
    )
    with pytest.raises(ValueError, match="PHONG"):
        render_to_image(scene, verbose=False)


@pytest.mark.slow
def test_nee_lambertian_phase_volume_excluded():
    """A ConvexVolume whose phase function is Lambertian: its zero-normal
    scatter vertices must NOT do NEE (nee.py::_diffuse_mask). The plain
    estimator there forces dot_term to 1 with a degenerate hemisphere
    frame — neither NEE cos_x convention matches (a 2M-sample probe
    measured 1.73× direct-light overcount when they were NEE'd with the
    surface weighting, 2026-08-18 review). Unit leg: direct_light at a
    forced in-fog vertex contributes nothing and does not suppress.
    Statistical leg: full-path NEE mean equals the plain mean."""
    from cs397raytracingsp22 import ConvexVolume
    from cs397raytracingsp22.models import materials as mat
    from cs397raytracingsp22.ops.intersect import intersect_scene
    from cs397raytracingsp22.render import nee as neelib
    from cs397raytracingsp22.utils import vecmath as vm

    scene = Scene(
        camera=Camera(
            eyepoint=(0.0, 1.0, 3.0), view_dir=(0.0, 0.0, -1.0),
            up=(0.0, 1.0, 0.0), screen_width=8, screen_height=8,
            aa_sample_count=1, path_depth=4,
        ),
        objects=[
            Plane(point=(0, 0, 0), normal=(0, 1, 0),
                  material=Lambertian(albedo=(0.7,) * 3)),
            Sphere(center=(0.0, 2.8, 0.0), radius=0.4,
                   material=Lambertian(albedo=(0, 0, 0),
                                       emission=(40.0,) * 3)),
            ConvexVolume(
                boundary=Sphere(center=(0.0, 1.0, 0.0), radius=0.8,
                                material=Lambertian()),
                phase_function=Lambertian(albedo=(0.8,) * 3),
                density=3.0,
            ),
        ],
    )
    data = scene.compile()
    assert data.nee_ok

    # unit leg: u→1 forces an immediate in-fog scatter (free-flight → 0)
    n = 4096
    o = jnp.tile(jnp.asarray([0.0, 1.0, 2.0])[None, :], (n, 1))
    d = jnp.tile(jnp.asarray([0.0, 0.0, -1.0])[None, :], (n, 1))
    n_vol = data.vol_center.shape[0]
    u_vol = jnp.full((n, n_vol), 1.0 - 1e-7)
    hit = intersect_scene(data, o, d, 1e-3, 100.0, u_vol)
    is_fog = (vm.magnitude2(hit.normal) == 0.0) & (
        hit.mtype == mat.LAMBERTIAN
    )
    assert bool(is_fog.all())
    c, did, _ = neelib.direct_light(
        data, hit, d, jnp.zeros((n,)), jnp.ones((n,), bool),
        jnp.arange(n, dtype=jnp.int32), threefry.key_words(5),
        0, 1e-3, 100.0,
    )
    assert not bool(did.any())
    assert float(jnp.abs(c).max()) == 0.0

    # statistical leg: paired chains (shared RNG sites) → the estimator
    # difference is exactly (NEE terms − suppressed emission), mean 0
    spp, n_px = 512, 16
    key = threefry.key_words(11)
    pixel_ids = jnp.arange(n_px, dtype=jnp.int32) * 3 % 64
    po, pd = scene.camera.generate_rays(key, pixel_ids, spp=spp)
    po = po.reshape(-1, 3)
    pd = pd.reshape(-1, 3)
    uids = (
        pixel_ids[:, None] * jnp.int32(spp)
        + jnp.arange(spp, dtype=jnp.int32)[None, :]
    ).reshape(-1)
    plain, _ = integrator.path_trace(data, po, pd, uids, key, 4, 100.0)
    neer, _ = integrator.path_trace_nee(data, po, pd, uids, key, 4, 100.0)
    pm = float(jnp.mean(plain))
    nm = float(jnp.mean(neer))
    assert pm > 0.01, "scene must actually be lit"
    np.testing.assert_allclose(nm, pm, rtol=0.1)


@pytest.mark.slow
def test_nee_executors_agree():
    """The three NEE executors — traceable path_trace_nee unsorted and
    sorted (the suppression flag rides the coherence sort) and the
    host-orchestrated shrinking path_trace_nee_shrink — must produce
    identical radiance and segment counts (content-keyed RNG); and the
    driver's staged --nee dispatch must match the plain-jnp driver
    image bit-for-bit on a textured (staged-path) scene."""
    from cs397raytracingsp22.render.driver import StagedOptions, render_to_image
    from tests.test_shrink import textured_scene

    scene = textured_scene()
    data = scene.compile()
    assert data.nee_ok  # the mesh's albedo texture doesn't void NEE
    rng = np.random.default_rng(1)
    n = 1024
    o = jnp.asarray(rng.uniform(-2, 3, (n, 3)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    uids = jnp.arange(n, dtype=jnp.int32)
    key = threefry.key_words(7)

    a, sa = integrator.path_trace_nee(
        data, o, d, uids, key, 6, 100.0, sort_rays=False
    )
    b, sb = integrator.path_trace_nee(
        data, o, d, uids, key, 6, 100.0, sort_rays=True
    )
    c, sc = integrator.path_trace_nee_shrink(
        data, o, d, uids, key, 6, 100.0, min_width=64
    )
    np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    np.testing.assert_array_equal(np.asarray(c), np.asarray(a))
    assert float(sa) == float(sb) == float(sc)

    nee_scene = dataclasses.replace(
        scene, camera=dataclasses.replace(scene.camera, nee=True)
    )
    img_jnp, _ = render_to_image(nee_scene, seed=3, verbose=False)
    img_staged, _ = render_to_image(
        nee_scene, seed=3, verbose=False, staged=StagedOptions()
    )
    np.testing.assert_array_equal(img_jnp, img_staged)
    assert img_staged.mean() > 1.0


@pytest.mark.slow
def test_nee_driver_end_to_end():
    """Full driver render with NEE on (CPU): runs, finite, and brighter-
    noise-free vs a same-spp plain render of a tiny cornell."""
    from cs397raytracingsp22.render.driver import render_to_image

    base = cornell.build_config3(width=16, height=16, spp=8, path_depth=4)
    scene = dataclasses.replace(
        base, camera=dataclasses.replace(base.camera, nee=True)
    )
    img, stats = render_to_image(scene, seed=0, verbose=False)
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img.astype(np.float64)).all()
    # with 2-triangle lights at 8 spp, plain renders are mostly black
    # speckle; NEE must actually light the scene
    assert img.mean() > 2.0
