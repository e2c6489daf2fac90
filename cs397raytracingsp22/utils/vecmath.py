"""Vector math utilities on batched (..., 3) arrays.

Semantics mirror the reference's scalar helpers (tracing.rs:54-97) but are
written batch-first: every function accepts arrays whose trailing axis is
the vector axis, so the same code runs per-ray over a megabatch under jit.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis. Returns (...)."""
    return jnp.sum(a * b, axis=-1)


def vdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product keeping the trailing axis: (..., 1)."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def magnitude2(v: jnp.ndarray) -> jnp.ndarray:
    """Squared length over the trailing axis."""
    return jnp.sum(v * v, axis=-1)


def magnitude(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(magnitude2(v))


def normalize(v: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """v / |v|.

    With eps=0 this matches cgmath's `normalize` (1/sqrt(|v|^2), inf/NaN on
    zero vectors). Pass a small eps only where the caller must be NaN-safe
    for masked-out lanes.
    """
    return v / jnp.sqrt(magnitude2(v) + eps)[..., None]


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Reflect v about normal n (reference tracing.rs:54-56).

    Preserves |v|; the reference deliberately feeds unnormalized directions
    through this after diffuse bounces, and we reproduce that.
    """
    return v - 2.0 * vdot(v, n) * n


def fresnel(v: jnp.ndarray, n: jnp.ndarray, ir) -> jnp.ndarray:
    """Schlick fresnel approximation (reference tracing.rs:58-62).

    NOTE reference quirk: callers pass the *full* index of refraction, never
    the direction-dependent eta (materials.rs:82,116); replicated here by
    simply evaluating the formula on whatever `ir` is given.
    """
    ir = jnp.asarray(ir, dtype=jnp.result_type(float))
    r0 = ((ir - 1.0) / (ir + 1.0)) ** 2
    return r0 + (1.0 - r0) * (1.0 - jnp.abs(dot(v, n))) ** 5


def refract(v: jnp.ndarray, n: jnp.ndarray, eta) -> jnp.ndarray:
    """Refraction per Ray Tracing in One Weekend (reference tracing.rs:64-69).

    cos_theta = min(-v.n, 1); perp = eta*(v + cos*n);
    parallel = -sqrt(|1 - |perp|^2|) * n. The abs() under the sqrt matches
    the reference; total internal reflection is the *caller's* job.
    """
    eta = jnp.asarray(eta)
    if eta.ndim == v.ndim - 1:
        eta = eta[..., None]
    cos_theta = jnp.minimum(dot(-v, n), 1.0)[..., None]
    r_out_perp = eta * (v + cos_theta * n)
    r_out_parallel = -jnp.sqrt(jnp.abs(1.0 - magnitude2(r_out_perp)))[..., None] * n
    return r_out_perp + r_out_parallel


def clampvec(v: jnp.ndarray, lo: float, hi: float) -> jnp.ndarray:
    """Componentwise clamp (reference tracing.rs:91-93)."""
    return jnp.clip(v, lo, hi)


def lerpvec(a: jnp.ndarray, b: jnp.ndarray, k) -> jnp.ndarray:
    """(1-k)*a + k*b (reference tracing.rs:95-97). k broadcasts."""
    k = jnp.asarray(k)
    if k.ndim == a.ndim - 1:
        k = k[..., None]
    return (1.0 - k) * a + k * b


def apply_mat3(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """(3,3) matrix times batched (..., 3) vectors: result = m @ v.

    Written as explicit multiply-adds instead of dot_general: tiny
    3-wide contractions are elementwise work, and XLA's default-precision
    matmul path may run them at reduced precision (TF32 on a GPU, about
    three decimal digits — unacceptable for ray directions/normals).
    """
    return (
        m[:, 0] * v[..., 0:1] + m[:, 1] * v[..., 1:2] + m[:, 2] * v[..., 2:3]
    )


def apply_mat4_point(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """(4,4) homogeneous transform of batched (..., 3) points (w=1)."""
    return (
        m[:3, 0] * p[..., 0:1]
        + m[:3, 1] * p[..., 1:2]
        + m[:3, 2] * p[..., 2:3]
        + m[:3, 3]
    )


def apply_mat4_vector(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """(4,4) transform of batched (..., 3) direction vectors (w=0)."""
    return (
        m[:3, 0] * v[..., 0:1] + m[:3, 1] * v[..., 1:2] + m[:3, 2] * v[..., 2:3]
    )


def signum(x: jnp.ndarray) -> jnp.ndarray:
    """Rust f32::signum — returns +1.0 for x >= +0.0 and -1.0 for x < 0.

    (jnp.sign would return 0 at 0, which diverges from the reference's
    plane-normal flip at geometry.rs:478.)
    """
    return jnp.where(x >= 0.0, 1.0, -1.0)
