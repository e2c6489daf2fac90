"""Next-event estimation (NEE): explicit direct-light sampling.

A BEYOND-REFERENCE opt-in feature (the reference's path tracer finds
lights only by chance — SURVEY.md §3.3 "no next-event estimation"), off
by default so every parity contract is untouched. With `Camera(nee=True)`
or `rt-render --nee`, each diffuse-like path vertex additionally samples
one point on one light (uniform over the scene's emissive Triangles and
Spheres, uniform over the chosen light's area) and adds

    thr · f · cosθ_x · V(x,y) · E · cosθ_y / (|x−y|² · p_area / n_lights)

where f is the SAME converged BRDF the reference's estimator integrates
to (Lambertian/parameterized-diffuse: albedo/π with cosθ_x; Isotropic:
albedo/4π with cosθ_x = 1 — the zero-normal volume convention), V is a
shadow ray through the full scene intersection (volume hits give
stochastic transmittance — an unbiased e^{-ρd} estimator for free), and
lights are two-sided (the reference adds emission on any hit of an
emissive surface regardless of face, so cosθ_y = |n_y·ω|).

Double counting is avoided the classic way: a vertex that performed NEE
suppresses emission at its scatter ray's NEXT vertex (everything a
scatter ray can hit first is straight-line visible, hence covered by
NEE's expectation). That is only correct when the sampled-light set
covers EVERY emitter, so scene compilation flags `nee_ok = False` for
scenes with emissive planes/meshes/media and the driver refuses --nee
there (models/scene.py light extraction).

ParameterizedMaterial inherits the reference's documented branch bias
(materials.rs:120-142, no division by the pick probability): NEE fires
exactly when the shared branch uniform picked the diffuse lobe, so the
NEE image converges to the same biased mixture the plain estimator does.

Equal-depth transport: the driver applies NEE at every vertex EXCEPT the
last bounce, because a depth-k path's NEE term equals emission at a
(k+1)-th vertex — skipping the last vertex keeps the NEE estimator's
expectation identical to the depth-limited plain path trace, which is
what tests/test_nee.py asserts (same mean, lower variance).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cs397raytracingsp22.models import materials as mat
from cs397raytracingsp22.models.scene import SceneData
from cs397raytracingsp22.ops.intersect import HitRecord, intersect_scene
from cs397raytracingsp22.utils import threefry
from cs397raytracingsp22.utils import vecmath as vm
from cs397raytracingsp22.utils.rng import SITE_NEE0

PI = 3.14159265358979
FOUR_PI = 4.0 * PI
# Shadow window upper bound as a fraction of the light's own ray
# parameter t_light: strictly below 1 so the sampled light itself never
# occludes its own sample. The 1e-3 relative gap mirrors the
# reference's 0.001 acne epsilon on the near side.
SHADOW_T_MAX = 1.0 - 1e-3


def _diffuse_mask(
    hit: HitRecord,
    d_in: jnp.ndarray,
    u_choice: jnp.ndarray,
    has_normal: jnp.ndarray,
):
    """NEE-applicability mask + converged BRDF value per ray.

    Lambertian: applies at surface vertices (nonzero normal),
    f = (3/4)·albedo/π. The 3/4 is the
    reference's hidden ball-length factor: its scatter direction is an
    UNNORMALIZED uniform-ball vector whose length feeds dot_term
    (tracing.rs:72 rand_sphere_vec, tracing.rs:313; bsdf.py carries the
    same convention), and E[|v|] over the unit ball is 3/4 — so the
    plain estimator's converged diffuse transport is (3/4)·albedo/π·cosθ
    per steradian, and NEE must integrate the SAME transport for the
    equal-expectation contract (tests/test_nee.py).
    Isotropic: always, f = albedo/4π (attenuation=albedo over a uniform
    sphere with dot FORCED to 1 — no ball-length factor there).
    ParameterizedMaterial: exactly when the SHARED branch uniform picked
    the diffuse lobe — reproduced bit-for-bit with ops/bsdf.py
    (u_choice < k_d, k_s = fresnel(d_in, n, 1.5)·(1−rough),
    k_d = (1−k_s)·(1−metallic)) so bsdf.scatter's signature stays
    untouched; f = (3/4)·albedo/π (the metallic tint is specular-only).
    Metal/Dielectric: never (delta lobes keep emission-on-hit).
    Isotropic ON A SURFACE (nonzero normal — possible since any object
    accepts any Material): excluded. Its plain transport is two-sided
    |cos| WITH the ball-length factor — neither of NEE's two cos_x
    conventions — so those vertices keep plain by-chance transport
    (emission un-suppressed, still consistent).
    Lambertian/Parameterized AT A ZERO-NORMAL VERTEX (a volume whose
    phase function is one of them): excluded, the exact mirror of the
    case above. The plain estimator there forces dot_term to 1
    (tracing.rs:313) and the hemisphere frame is degenerate, so the
    converged transport matches neither NEE weighting (a 2M-sample CPU
    probe measured a 1.73× direct-light overcount when these vertices
    were NEE'd with the surface convention, 2026-08-18); they keep
    plain by-chance transport instead.

    Returns (applies, f, ball_weighted): for ball_weighted rays the
    caller multiplies f by ITS sampled shadow ball length r — not the
    deterministic mean 3/4 — because the plain estimator's r appears in
    the dot_term AND in every t-unit quantity (volume free-flight
    transmittance, max_trace_dist reach), and those are positively
    correlated: E[r·T(r)] > E[r]·E[T(r)]. A mean-field 3/4 measured
    ~15% dim on a fog scene (2026-08-18 probe) — the shared sample
    captures the correlation exactly."""
    albedo = hit.albedo
    mtype = hit.mtype
    lam = (mtype == mat.LAMBERTIAN) & has_normal
    iso = (mtype == mat.ISOTROPIC) & ~has_normal
    par = (mtype == mat.PARAMETERIZED) & has_normal
    fres15 = vm.fresnel(d_in, hit.normal, 1.5)
    k_s = fres15 * (1.0 - hit.roughness)
    k_d = (1.0 - k_s) * (1.0 - hit.metallic)
    par_diffuse = par & (u_choice < k_d)
    applies = lam | iso | par_diffuse
    f = jnp.where(iso[:, None], albedo / FOUR_PI, albedo / PI)
    return applies, f, ~iso


def sample_light_point(scene: SceneData, u_pick, u1, u2):
    """One uniformly chosen light, one uniform-area point on it.

    Returns (x, n_l, emission, inv_pdf) with inv_pdf = n_lights · area
    (triangles) or n_lights · 4πr² (spheres) — the reciprocal of the
    joint pick×area density.
    """
    n_t = scene.n_lt_tri
    n_s = scene.n_lt_sph
    n_l = n_t + n_s
    assert n_l > 0, "sample_light_point on a scene with no NEE lights"
    pick = jnp.minimum((u_pick * n_l).astype(jnp.int32), n_l - 1)

    shape = u1.shape
    x = jnp.zeros(shape + (3,), jnp.float32)
    nrm = jnp.zeros(shape + (3,), jnp.float32)
    emi = jnp.zeros(shape + (3,), jnp.float32)
    inv_pdf = jnp.zeros(shape, jnp.float32)

    if n_t:
        idx = jnp.clip(pick, 0, n_t - 1)
        row = jnp.take(scene.lt_tri, idx, axis=0)  # (N, 13)
        a = row[:, 0:3]
        e1 = row[:, 3:6]
        e2 = row[:, 6:9]
        # uniform over the triangle: P = a + su(1−u2)e1 + su·u2·e2
        su = jnp.sqrt(jnp.maximum(u1, 0.0))
        xt = a + (su * (1.0 - u2))[:, None] * e1 + (su * u2)[:, None] * e2
        gn = jnp.cross(e1, e2)
        nt_ = vm.normalize(gn, eps=1e-30)
        is_t = (pick < n_t)[:, None]
        x = jnp.where(is_t, xt, x)
        nrm = jnp.where(is_t, nt_, nrm)
        emi = jnp.where(is_t, row[:, 9:12], emi)
        inv_pdf = jnp.where(pick < n_t, n_l * row[:, 12], inv_pdf)

    if n_s:
        idx = jnp.clip(pick - n_t, 0, n_s - 1)
        row = jnp.take(scene.lt_sph, idx, axis=0)  # (N, 7)
        c = row[:, 0:3]
        r = row[:, 3]
        z = 1.0 - 2.0 * u1
        rr = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
        phi = 2.0 * PI * u2
        w = jnp.stack([rr * jnp.cos(phi), rr * jnp.sin(phi), z], axis=-1)
        is_s = (pick >= n_t)[:, None]
        x = jnp.where(is_s, c + r[:, None] * w, x)
        nrm = jnp.where(is_s, w, nrm)
        emi = jnp.where(is_s, row[:, 4:7], emi)
        inv_pdf = jnp.where(pick >= n_t, n_l * FOUR_PI * r * r, inv_pdf)

    return x, nrm, emi, inv_pdf


def direct_light(
    scene: SceneData,
    hit: HitRecord,
    d_in: jnp.ndarray,
    u_choice: jnp.ndarray,
    live: jnp.ndarray,
    uids: jnp.ndarray,
    rng_key,
    depth: int,
    t_min: float,
    max_trace_dist: float,
):
    """One NEE sample per live diffuse-like vertex.

    Returns (contribution (N,3) — NOT yet multiplied by throughput —
    did_nee (N,) for the caller's next-vertex emission suppression, and
    the number of shadow rays actually traced this bounce, for honest
    Mrays/s accounting). Draws live at SITE_NEE0 + depth so the base
    path's draws are untouched (utils/rng.py).

    The shadow ray is length-matched to the plain estimator: its
    direction is the UNIT direction scaled by a sampled ball length
    r ~ u^(1/3) — the same |v| distribution the diffuse scatter
    directions carry. Everything the reference measures in ray-parameter
    units then agrees in distribution with the plain estimator's scatter
    ray toward the light: volume free-flight occlusion (sampled in t
    units, so transmittance is exp(−ρ·span_world/|v|)) and the
    max_trace_dist reach (a light at world distance L is reachable iff
    L ≤ max_trace_dist·|v|). A fixed-length shadow ray would attenuate
    media by exp(−ρ·span/L) and reach past the trace limit — an
    orders-of-magnitude direct-light bias on foggy or short-trace-range
    scenes.

    `did` (the caller's suppression flag) is the NEE ATTEMPT — it stays
    True when the sample lands occluded OR out of reach, because both
    gates are part of the stochastic estimator whose expectation already
    covers the emission; suppressing only on success would re-count the
    plain emission on every failed sample (a (2−p) double count).
    """
    n_vol = scene.vol_center.shape[0]
    u = threefry.counter_uniforms(
        rng_key, uids, SITE_NEE0 + depth, 4 + n_vol + scene.n_gvols
    )
    x, n_l, emission, inv_pdf = sample_light_point(
        scene, u[:, 0], u[:, 1], u[:, 2]
    )

    has_normal = vm.magnitude2(hit.normal) > 0.0
    applies, f, ball_weighted = _diffuse_mask(
        hit, d_in, u_choice, has_normal
    )
    did = live & applies

    to_l = x - hit.point
    dist2 = jnp.sum(to_l * to_l, axis=-1)
    inv_dist = jax.lax.rsqrt(jnp.maximum(dist2, 1e-12))
    dist = dist2 * inv_dist
    wl = to_l * inv_dist[:, None]

    # cosθ at the shading point: clip(·,0,1) like the estimator's
    # dot_term (tracing.rs:313), forced to 1 for zero-normal volume hits
    cos_x = jnp.where(
        has_normal,
        jnp.clip(jnp.sum(wl * hit.normal, axis=-1), 0.0, 1.0),
        1.0,
    )
    # two-sided lights (reference emission has no face test)
    cos_y = jnp.abs(jnp.sum(wl * n_l, axis=-1))

    # ball-length-matched shadow ray (docstring): |d| = r, light at
    # t = dist/r, window [t_min, (1−ε)·dist/r) finds every occluder
    # strictly between the vertex and the light but never the light
    # itself; dead/non-NEE rays get an empty window so kernels skip
    # them. A volume hit inside the window IS occlusion — the
    # free-flight draw makes V a stochastic transmittance estimator
    # with exactly the plain estimator's t-unit convention.
    r_len = jnp.maximum(u[:, 3] ** (1.0 / 3.0), 1e-6)
    t_light = dist / r_len
    shoot = did & (t_light <= jnp.float32(max_trace_dist))
    sh_o = jnp.where(shoot[:, None], hit.point, 0.0)
    sh_dir = jnp.where(shoot[:, None], wl * r_len[:, None], jnp.float32(1.0))
    t_max = jnp.where(shoot, jnp.float32(SHADOW_T_MAX) * t_light, 0.0)
    sh = intersect_scene(scene, sh_o, sh_dir, t_min, t_max, u[:, 4:])
    visible = ~sh.valid

    # the ball-length factor rides the SAME r as the shadow ray
    # (_diffuse_mask doc: correlated with transmittance and reach)
    geo = cos_x * cos_y / jnp.maximum(dist2, 1e-12) * inv_pdf
    geo = geo * jnp.where(ball_weighted, r_len, 1.0)
    ok = shoot & visible
    contrib = jnp.where(ok[:, None], f * emission * geo[:, None], 0.0)
    return contrib, did, jnp.sum(shoot.astype(jnp.float32))
