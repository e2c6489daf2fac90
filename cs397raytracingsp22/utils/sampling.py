"""Counter-based random sampling.

The reference draws from an ambient `rand::thread_rng()` everywhere
(tracing.rs:72, materials.rs:84, geometry.rs:517), making renders
non-deterministic. Here every draw comes from jax.random (threefry) keyed
by (seed, bounce, draw-site), so a render is a pure function of its seed —
the array-code replacement for ambient RNG.

The reference's rejection-sampled `rand_sphere_vec`/`rand_disk_vec`
(tracing.rs:70-89) have data-dependent trip counts that cannot be jitted;
we use exact analytic samplers with the *same distributions* (uniform in
the unit ball / unit disk, both UNNORMALIZED — the raw ball vector's length
matters downstream: the integrator's dot_term uses the unnormalized scatter
direction, see materials.rs:35 + tracing.rs:313).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cs397raytracingsp22.utils import vecmath as vm

TWO_PI = 6.283185307179586


def ball_vec(key: jax.Array, shape: tuple[int, ...]) -> jnp.ndarray:
    """Uniform random vectors in the unit ball, shape (*shape, 3).

    Same distribution as the reference's rejection sampler
    `rand_sphere_vec` (tracing.rs:71-79): direction uniform on the sphere,
    radius r with density ∝ r², vector NOT normalized.
    """
    k1, k2, k3 = jax.random.split(key, 3)
    z = jax.random.uniform(k1, shape, minval=-1.0, maxval=1.0)
    phi = jax.random.uniform(k2, shape, minval=0.0, maxval=TWO_PI)
    r = jax.random.uniform(k3, shape) ** (1.0 / 3.0)
    s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return r[..., None] * jnp.stack(
        [s * jnp.cos(phi), s * jnp.sin(phi), z], axis=-1
    )


def disk_vec(key: jax.Array, shape: tuple[int, ...]) -> jnp.ndarray:
    """Uniform random vectors in the unit xy-disk (z=0), shape (*shape, 3).

    Same distribution as `rand_disk_vec` (tracing.rs:81-89); unnormalized.
    """
    k1, k2 = jax.random.split(key)
    theta = jax.random.uniform(k1, shape, minval=0.0, maxval=TWO_PI)
    r = jnp.sqrt(jax.random.uniform(k2, shape))
    zeros = jnp.zeros(shape)
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta), zeros], axis=-1)


def sincos_2pi(u: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(cos 2πu, sin 2πu) for u in [0, 1): quadrant reduction + the
    Cephes f32 minimax polynomials (~1 ulp on the reduced range).

    ~27 elementwise ops replacing the transcendental sin+cos pair, with
    no libm call whose accuracy differs between backends. The circle
    distribution is as uniform as the libm pair it replaces (both are
    ≲1 ulp approximations of the exact map).
    """
    y = u * 4.0
    k = jnp.round(y)
    theta = (y - k) * jnp.float32(1.5707963267948966)
    z = theta * theta
    s = theta * (
        1.0
        + z
        * (
            jnp.float32(-1.6666654611e-1)
            + z
            * (
                jnp.float32(8.3321608736e-3)
                + z * jnp.float32(-1.9515295891e-4)
            )
        )
    )
    c = (
        1.0
        - 0.5 * z
        + (z * z)
        * (
            jnp.float32(4.166664568298827e-2)
            + z
            * (
                jnp.float32(-1.388731625493765e-3)
                + z * jnp.float32(2.443315711809948e-5)
            )
        )
    )
    ki = k.astype(jnp.int32)
    swap = (ki & 1) == 1
    neg = (ki & 2) == 2
    cos_out = jnp.where(swap, -s, c)
    sin_out = jnp.where(swap, c, s)
    cos_out = jnp.where(neg, -cos_out, cos_out)
    sin_out = jnp.where(neg, -sin_out, sin_out)
    return cos_out, sin_out


def cbrt_fast(u: jnp.ndarray) -> jnp.ndarray:
    """x^(1/3) for x in (0, 1]: bit-hack inverse-cbrt seed + 3
    division-free Newton steps (z ← z·(4 − x·z³)/3, fixed point
    z = x^(-1/3)), then r = x·z².

    ~21 elementwise ops replacing the exp+log pair. MORE accurate than the pow path it replaces: max 7 ulp / mean 1.2
    vs f64 cbrt (the f32 exp(log(x)/3) path was up to 41 ulp), measured
    on 2M uniforms + denormal-adjacent edge cases.
    Inputs are clamped to ≥ FLT_MIN (the smallest NORMAL f32 — XLA
    flushes denormals, which would break the bit-hack seed's
    arithmetic), mapping u = 0 to r ≈ 2.27e-13; uniform draws are
    multiples of ~2⁻²⁴, so only exact zero is affected."""
    x = jnp.maximum(u, jnp.float32(1.1754944e-38))
    i = jax.lax.bitcast_convert_type(x, jnp.int32)
    z = jax.lax.bitcast_convert_type(
        jnp.int32(0x54A21D2A) - i // 3, jnp.float32
    )
    third = jnp.float32(1.0 / 3.0)
    for _ in range(3):
        z = z * (jnp.float32(4.0) - x * z * z * z) * third
    return x * z * z


def ball_vec_from_uniform(u: jnp.ndarray) -> jnp.ndarray:
    """Map (..., 3) uniforms in [0,1) to uniform unit-ball vectors.

    Used when the caller already holds per-ray uniforms (e.g. drawn in one
    batched call per bounce).
    """
    z = 2.0 * u[..., 0] - 1.0
    cphi, sphi = sincos_2pi(u[..., 1])
    r = cbrt_fast(u[..., 2])
    s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return r[..., None] * jnp.stack([s * cphi, s * sphi, z], axis=-1)


def disk_vec_from_uniform(u: jnp.ndarray) -> jnp.ndarray:
    """Map (..., 2) uniforms in [0,1) to uniform unit-disk vectors (z=0)."""
    theta = TWO_PI * u[..., 0]
    r = jnp.sqrt(u[..., 1])
    return jnp.stack(
        [r * jnp.cos(theta), r * jnp.sin(theta), jnp.zeros_like(r)], axis=-1
    )


def hemisphere_vec(ball: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """Uniform-in-half-ball vector about `normal`, built from a ball sample.

    The reference's `sample_hemisphere` (materials.rs:171-178) takes a ball
    vector, folds it into the +y half-ball, and rotates y→normal. Folding
    the ball vector across the plane ⟂ normal produces the identical
    distribution (uniform in the half-ball over `normal`) without a
    rotation — cheaper and NaN-free for masked lanes with zero normals.
    Returns the UNNORMALIZED vector; pdf of the direction is 1/(2π).
    """
    d = vm.vdot(ball, normal)
    return jnp.where(d < 0.0, ball - 2.0 * d * normal, ball)


def hemisphere_pdf() -> float:
    """Directional pdf of hemisphere_vec: 1/(2π) (materials.rs:177)."""
    return 1.0 / TWO_PI


def hemisphere_inv_pdf() -> float:
    """Reciprocal pdf of hemisphere_vec, 2π: the integrators apply the
    pdf as `dot_term · (1/pdf)` — one multiply instead of a divide per
    ray per bounce. Within 1 ulp of the
    reference's division by 1/(2π) (tracing.rs:313); statistical
    parity is unchanged."""
    return TWO_PI


def alpha_sample(u: jnp.ndarray, normal: jnp.ndarray, alpha: float = 1.0):
    """Cosine-power-lobe sample about `normal` (materials.rs:181-193).

    Present for API parity — the reference defines but never uses it.
    u: (..., 2) uniforms. Returns (direction, pdf); the lobe is generated
    about +z and rotated to `normal` via a Rodrigues rotation (the
    cgmath Basis3::between_vectors equivalent).
    """
    cos_theta = u[..., 0] ** (1.0 / (alpha + 1.0))
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = TWO_PI * u[..., 1]
    local = jnp.stack(
        [jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta, cos_theta], axis=-1
    )
    z = jnp.zeros_like(normal)
    z = z.at[..., 2].set(1.0)
    # rotate +z to normal: v' = v cosA + (k×v) sinA + k (k·v)(1−cosA)
    k = jnp.cross(z, normal)
    s = jnp.sqrt(jnp.sum(k * k, axis=-1, keepdims=True))
    c = jnp.sum(z * normal, axis=-1, keepdims=True)
    k_unit = k / jnp.maximum(s, 1e-20)
    kv = jnp.cross(k_unit, local)
    kdv = jnp.sum(k_unit * local, axis=-1, keepdims=True)
    rotated = local * c + kv * s + k_unit * kdv * (1.0 - c)
    direction = jnp.where(s > 1e-12, rotated, jnp.where(c >= 0, local, -local))
    pdf = (alpha + 1.0) * cos_theta**alpha / TWO_PI
    return direction, pdf


def rtow_sample(ball: jnp.ndarray, hitpoint: jnp.ndarray, normal: jnp.ndarray):
    """Ray Tracing in One Weekend-style sample (materials.rs:196-199).

    Present for API parity (unused by the reference): returns
    (hitpoint + normal + ball_vec, 1/(2π)) — note the reference returns a
    *point*, not a direction, exactly as written there.
    """
    return hitpoint + normal + ball, 1.0 / TWO_PI
