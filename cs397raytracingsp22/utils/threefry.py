"""Counter-based Threefry-2x32 RNG, implemented in plain array ops.

Why not jax.random here: the draws are keyed by content (uid, site), not
by a split key, so any partition or permutation of the rays draws the
same numbers. Threefry-2x32 is pure uint32 adds/xors/rolls, so the exact
same function runs on every backend — bit-identical, which preserves the framework's determinism guarantee
(renders are a pure function of (seed, pixel, sample, bounce) no matter
the backend, chunking, or sharding).

Algorithm: Threefry-2x32 with 20 rounds (Salmon et al., SC'11), the same
core as jax.random's threefry2x32 — verified against it in
tests/test_threefry.py.
"""

from __future__ import annotations

import jax.numpy as jnp

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
# plain int, not jnp.uint32: module-level device constants would
# initialize the backend at import time (see ops/intersect._BIG)
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32-20 block: keys (k0, k1), counter (c0, c1) → 2 words.

    All args uint32 arrays (broadcastable); returns (x0, x1) uint32.
    """
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    ks2 = k0 ^ k1 ^ jnp.uint32(_PARITY)
    x0 = jnp.asarray(c0, jnp.uint32) + k0
    x1 = jnp.asarray(c1, jnp.uint32) + k1

    ks = (k1, ks2, k0)  # injected key schedule after each 4-round group
    for group in range(5):
        for i in range(4):
            x0 = x0 + x1
            x1 = _rotl(x1, _ROTATIONS[(group % 2) * 4 + i])
            x1 = x1 ^ x0
        x0 = x0 + ks[group % 3]
        x1 = x1 + ks[(group + 1) % 3] + jnp.uint32(group + 1)
    return x0, x1


def uniform_from_bits(bits):
    """uint32 → float32 uniform in [0, 1): top 24 bits scaled by 2^-24."""
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(2.0**-24)


def key_words(seed) -> jnp.ndarray:
    """Split a python-int seed into the (2,) uint32 key array the render
    path threads through jit (traced, so one compile serves all seeds)."""
    return jnp.asarray(
        [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF], dtype=jnp.uint32
    )


def bounce_uniforms(key, uids, site, m: int):
    """Bounce-site draws: (N, m) uniforms where the 4 HEAD draws (ball
    vector xyz + branch choice) are the 16-bit halves of ONE Threefry
    block — [x0>>16, x0&0xFFFF, x1>>16, x1&0xFFFF] · 2^-16 — and tail
    draws j ≥ 4 (volume free-flight) keep 24-bit precision, 2 per block,
    from block 1 + (j-4)//2.

    Why: one Threefry call instead of two saves ~130 integer ops per ray
    per bounce. 16-bit resolution on the ball/
    choice draws is far below render noise (the reference uses ambient
    thread_rng floats; equality is statistical — SURVEY §3.5.8), while
    free-flight distances keep 24 bits because -ln(U)/ρ amplifies the
    low tail.
    """
    if isinstance(key, int):
        key = key_words(key)
    k0 = key[0]
    k1 = key[1]
    u = jnp.asarray(uids).astype(jnp.uint32)
    s = jnp.asarray(site).astype(jnp.uint32) << jnp.uint32(16)
    cols = []
    x0, x1 = threefry2x32(k0, k1, u, s)
    s16 = jnp.float32(2.0**-16)
    for w in (x0, x1):
        cols.append((w >> jnp.uint32(16)).astype(jnp.float32) * s16)
        cols.append((w & jnp.uint32(0xFFFF)).astype(jnp.float32) * s16)
    for blk in range(1, 1 + (max(m - 4, 0) + 1) // 2):
        x0, x1 = threefry2x32(k0, k1, u, s + jnp.uint32(blk))
        cols.append(uniform_from_bits(x0))
        cols.append(uniform_from_bits(x1))
    return jnp.stack(cols[:m], axis=-1)


def counter_uniforms(key, uids, site, m: int):
    """m uniforms per uid for a draw site: (N, m) float32 in [0, 1).

    key: python int seed or (2,) uint32 array (key_words); uids (N,)
    int32; site a (traced ok) int32 scalar. Draw j comes from block
    (j // 2) at counter (uid, site * 2^16 + block) — distinct
    (uid, site, j) never share bits.
    """
    if isinstance(key, int):
        key = key_words(key)
    k0 = key[0]
    k1 = key[1]
    u = jnp.asarray(uids).astype(jnp.uint32)
    s = jnp.asarray(site).astype(jnp.uint32) << jnp.uint32(16)
    cols = []
    for blk in range((m + 1) // 2):
        x0, x1 = threefry2x32(k0, k1, u, s + jnp.uint32(blk))
        cols.append(uniform_from_bits(x0))
        cols.append(uniform_from_bits(x1))
    return jnp.stack(cols[:m], axis=-1)
