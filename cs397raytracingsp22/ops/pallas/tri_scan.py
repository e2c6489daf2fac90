"""Dense triangle scan as one Pallas kernel through Triton (Hopper).

`ops/bvh.intersect_tris_scan` is the specification: the nearest
Möller–Trumbore hit (reference geometry.rs:331-349) of every ray against
every triangle, ties broken by the earliest triangle index like
`jnp.argmin`. Under XLA it materialises (N, chunk) t/u/v/valid tiles and
gathers the winners from them. This kernel keeps everything in registers:

- one program per block of `BLOCK_RAYS` rays, held structure-of-arrays;
- a loop over power-of-two tiles of `BLOCK_TRIS` triangles, read from a
  component-planar (9, T) [a, e1, e2] table;
- the (rays × triangles) test in registers, with a running best per
  (ray, lane) so the loop has no cross-lane reduction;
- one reduction at the end: the least t, then the least triangle index
  among lanes that reach it (the earliest-index tie-break).

The division is IEEE round-to-nearest (`div.rn.f32`), like XLA's; the
Triton default for `/` on f32 is the two-ulp `div.full.f32`. Ragged ray
and triangle counts are padded with inert rows: a zero direction or a
zero triangle has det = 0 and is rejected by the epsilon test.

`interpret=True` runs the same kernel body on the CPU for the tests; the
caller decides, never the backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

MT_EPSILON = 1e-4  # geometry.rs:335, as ops/bvh.MT_EPSILON
# Block shape, read at each call (tools/gpu_bringup.py scan sweeps it).
# H100 at 400 W, 2^20 rays x 6,144 triangles, timed in turns: 17.44 and
# 17.41 ms at 16x16 with 1 warp, 18.64 and 18.60 ms at 32x32 with 2,
# 19.00 at 16x64 with 2, 19.11 at 16x32 with 1.
BLOCK_RAYS = 16
BLOCK_TRIS = 16
NUM_WARPS = 1
_NO_TRI = 2**31 - 1


def _div_rn(x, y, interpret: bool):
    """Correctly rounded f32 division (interpret mode: plain `/`)."""
    if interpret:
        return x / y
    [q] = plgpu.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;",
        args=[x, y],
        constraints="=f,f,f",
        pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(x.shape, jnp.float32)],
    )
    return q


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmn_ref, tmx_ref,
            tri_ref, t_out, id_out, u_out, v_out, *, n_tiles, block_tris,
            interpret):
    ox, oy, oz = ox_ref[...][:, None], oy_ref[...][:, None], oz_ref[...][:, None]
    dx, dy, dz = dx_ref[...][:, None], dy_ref[...][:, None], dz_ref[...][:, None]
    t_min = tmn_ref[...][:, None]
    shape = (ox.shape[0], block_tris)
    lane = jax.lax.broadcasted_iota(jnp.int32, shape, 1)

    def body(k, carry):
        best_t, best_id, best_u, best_v = carry
        cols = pl.ds(pl.multiple_of(k * block_tris, block_tris), block_tris)
        ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = (
            tri_ref[c, cols][None, :] for c in range(9)
        )
        # q = d × e2, det = e1 · q (ops/bvh.moller_trumbore, op for op)
        qx = dy * e2z - dz * e2y
        qy = dz * e2x - dx * e2z
        qz = dx * e2y - dy * e2x
        det = e1x * qx + e1y * qy + e1z * qz
        det_ok = jnp.abs(det) >= MT_EPSILON
        f = _div_rn(jnp.ones(shape, jnp.float32),
                    jnp.where(det_ok, det, 1.0), interpret)
        sx = ox - ax
        sy = oy - ay
        sz = oz - az
        u = f * (sx * qx + sy * qy + sz * qz)
        rx = sy * e1z - sz * e1y
        ry = sz * e1x - sx * e1z
        rz = sx * e1y - sy * e1x
        v = f * (dx * rx + dy * ry + dz * rz)
        t = f * (e2x * rx + e2y * ry + e2z * rz)
        ok = (
            det_ok
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t >= t_min)
            & (t < best_t)
        )
        return (
            jnp.where(ok, t, best_t),
            jnp.where(ok, k * block_tris + lane, best_id),
            jnp.where(ok, u, best_u),
            jnp.where(ok, v, best_v),
        )

    init = (
        jnp.broadcast_to(tmx_ref[...][:, None], shape),
        jnp.full(shape, _NO_TRI, jnp.int32),
        jnp.zeros(shape, jnp.float32),
        jnp.zeros(shape, jnp.float32),
    )
    best_t, best_id, best_u, best_v = jax.lax.fori_loop(0, n_tiles, body, init)

    t_win = jnp.min(best_t, axis=1)
    id_win = jnp.min(
        jnp.where(best_t == t_win[:, None], best_id, _NO_TRI), axis=1
    )
    pick = best_id == id_win[:, None]
    t_out[...] = t_win
    id_out[...] = jnp.where(id_win == _NO_TRI, -1, id_win)
    u_out[...] = jnp.max(jnp.where(pick, best_u, -jnp.inf), axis=1)
    v_out[...] = jnp.max(jnp.where(pick, best_v, -jnp.inf), axis=1)


def planar_table(tri_table: jnp.ndarray, block_tris: int = BLOCK_TRIS):
    """(T, 9) [a, e1, e2] rows → (9, T') component planes, T' a multiple
    of `block_tris`, padded with all-zero (never-hit) triangles."""
    nt = tri_table.shape[0]
    t_pad = -(-nt // block_tris) * block_tris
    return jnp.pad(tri_table.astype(jnp.float32).T, ((0, 0), (0, t_pad - nt)))


def tri_scan(o, d, tri_table, t_min, t_max, interpret: bool = False):
    """Nearest triangle hit for N rays, as `ops/bvh.intersect_tris_scan`.

    Args:
      o, d: (N, 3) rays (object space).
      tri_table: (T, 9) float32 rows [a, b - a, c - a].
      t_min, t_max: scalars or (N,) per-ray bounds.

    Returns (hit, t, tri_idx, u, v); t is t_max where there is no hit.
    """
    return _tri_scan(o, d, tri_table, t_min, t_max, BLOCK_RAYS, BLOCK_TRIS,
                     NUM_WARPS, interpret)


@functools.partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _tri_scan(o, d, tri_table, t_min, t_max, block_rays, block_tris,
              num_warps, interpret):
    n = o.shape[0]
    n_pad = -(-n // block_rays) * block_rays
    planes = planar_table(tri_table, block_tris)

    def col(x):
        x = jnp.broadcast_to(jnp.asarray(x, jnp.float32), (n,))
        return jnp.pad(x, (0, n_pad - n))

    rays = [col(o[:, 0]), col(o[:, 1]), col(o[:, 2]),
            col(d[:, 0]), col(d[:, 1]), col(d[:, 2]),
            col(t_min), col(t_max)]
    ray_spec = pl.BlockSpec((block_rays,), lambda i: (i,))
    f32 = jax.ShapeDtypeStruct((n_pad,), jnp.float32)
    kernel = functools.partial(
        _kernel,
        n_tiles=planes.shape[1] // block_tris,
        block_tris=block_tris,
        interpret=interpret,
    )
    t, tri, u, v = pl.pallas_call(
        kernel,
        grid=(n_pad // block_rays,),
        in_specs=[ray_spec] * 8 + [pl.BlockSpec(planes.shape, lambda i: (0, 0))],
        out_specs=[ray_spec] * 4,
        out_shape=[f32, jax.ShapeDtypeStruct((n_pad,), jnp.int32), f32, f32],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="tri_scan",
    )(*rays, planes)
    tri = tri[:n]
    return tri >= 0, t[:n], tri, u[:n], v[:n]
