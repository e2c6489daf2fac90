"""Flat threaded BVH: host-side build + device-side stackless traversal.

The reference builds a pointer tree of `Box<BVHNode>` with 1 triangle per
leaf and traverses it recursively (geometry.rs:86-123,175-217). Neither
pointers nor recursion map to array code, so the rebuild uses a *threaded* flat
BVH ("skip links"): nodes are laid out in DFS pre-order; on AABB hit the
ray advances to `i+1` (first child), on miss it jumps to `skip[i]` (the
node after i's subtree). Traversal state is then a single int per ray —
no stack — which vectorizes over a megabatch in one `lax.while_loop`.

The reference's builder is documented as low-quality (its sort is a no-op,
SURVEY.md §2 #22) and the survey allows a proper build: we split on the
largest centroid-extent axis at the median, with up to `leaf_size`
triangles per leaf so leaf tests are dense vectorized batches. Only the
rendered image must match, and BVH structure does not affect hit results
(nearest-hit is order-independent).

AABB test semantics replicate geometry.rs:52-68 including the strict
`tmax <= tmin` rejection and Rust's NaN-ignoring f32::max/min (jnp.fmax /
fmin) for the degenerate axis-parallel-ray case.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

MT_EPSILON = 1e-4  # Möller–Trumbore parallel-ray epsilon (geometry.rs:335)

# Meshes of at most DENSE_MESH_MAX_TRIS triangles take the dense
# all-triangles scan where the Triton kernel runs (CUDA); larger meshes
# traverse their BVH. Measured on an H100 (400 W) at 2^20 rays, Triton
# scan (16x16 block, 1 warp) vs bvh.traverse: 17.2 vs 40.9 ms at 6,016
# triangles, 34.5 vs 50.6 at 12,096, 45.8 vs 53.9 at 15,904, 50.7 vs
# 59.4 at 17,696, 66.1 vs 62.1 at 22,784 and 93.2 vs 57.2 at 32,512
# (tools/gpu_bringup.py cap). The crossover interpolates to ~21,200;
# the cap stays below it.
DENSE_MESH_MAX_TRIS = 20480
# Elsewhere the jnp scan (intersect_tris_scan) runs, and the dense path
# keeps the earlier cap. Not a measured crossover: on the CPU, at 2^14
# rays, the BVH was already ahead at 6,016 triangles (0.11 vs 0.80 s).
JNP_SCAN_MAX_TRIS = 8192


@dataclasses.dataclass
class FlatBVH:
    """Host-side build result (numpy)."""

    bounds_min: np.ndarray  # (NN, 3) float32
    bounds_max: np.ndarray  # (NN, 3) float32
    skip: np.ndarray  # (NN,) int32 — next node on AABB miss
    leaf_start: np.ndarray  # (NN,) int32 — first tri (reordered ids); -1 interior
    leaf_count: np.ndarray  # (NN,) int32
    tri_order: np.ndarray  # (NT,) int32 — reordered position → original tri id


def build_bvh(tri_verts: np.ndarray, leaf_size: int = 4, use_native: bool = True) -> FlatBVH:
    """Build a threaded flat BVH over (NT, 3, 3) triangle vertices.

    Median split on the largest centroid-extent axis (deterministic,
    replacing the reference's random-axis no-op sort, geometry.rs:199-207).
    Uses the C++ builder (utils/native.py) when available; this Python
    version is the specification and fallback. The two may order
    equal-centroid triangles differently — BVH structure does not affect
    hit results (nearest hit is order-independent).
    """
    nt = tri_verts.shape[0]
    assert nt > 0, "cannot build BVH over empty mesh"
    if use_native:
        from cs397raytracingsp22.utils import native

        raw = native.bvh_build(tri_verts, leaf_size) if native.available() else None
        if raw is not None:
            return FlatBVH(
                bounds_min=raw["bounds_min"],
                bounds_max=raw["bounds_max"],
                skip=raw["skip"],
                leaf_start=raw["leaf_start"],
                leaf_count=raw["leaf_count"],
                tri_order=raw["tri_order"],
            )
    tmin = tri_verts.min(axis=1)  # (NT, 3)
    tmax = tri_verts.max(axis=1)
    centroids = 0.5 * (tmin + tmax)

    bounds_min: list[np.ndarray] = []
    bounds_max: list[np.ndarray] = []
    skip: list[int] = []
    leaf_start: list[int] = []
    leaf_count: list[int] = []
    order: list[np.ndarray] = []

    def rec(ids: np.ndarray, out_base: int) -> None:
        """Emit the subtree over `ids`; out_base = len(order flattened)."""
        node = len(skip)
        bounds_min.append(tmin[ids].min(axis=0))
        bounds_max.append(tmax[ids].max(axis=0))
        skip.append(-1)  # patched after subtree is emitted
        if len(ids) <= leaf_size:
            leaf_start.append(out_base)
            leaf_count.append(len(ids))
            order.append(ids)
        else:
            leaf_start.append(-1)
            leaf_count.append(0)
            c = centroids[ids]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            mid = len(ids) // 2
            part = np.argsort(c[:, axis], kind="stable")
            rec(ids[part[:mid]], out_base)
            rec(ids[part[mid:]], out_base + mid)
        skip[node] = len(skip)

    rec(np.arange(nt, dtype=np.int64), 0)
    return FlatBVH(
        bounds_min=np.stack(bounds_min).astype(np.float32),
        bounds_max=np.stack(bounds_max).astype(np.float32),
        skip=np.asarray(skip, np.int32),
        leaf_start=np.asarray(leaf_start, np.int32),
        leaf_count=np.asarray(leaf_count, np.int32),
        tri_order=np.concatenate(order).astype(np.int32),
    )


def slab_test(o, d, bmin, bmax, t_min, t_max):
    """Vectorized AABB slab test (geometry.rs:52-68).

    All args broadcast; o/d/bmin/bmax are (..., 3), t_min/t_max (...).
    Returns a bool mask. Uses fmax/fmin to replicate Rust's NaN-ignoring
    f32::max/min when a ray direction component is exactly 0 on a face.
    """
    inv_d = 1.0 / d
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    lo = jnp.where(inv_d < 0.0, t1, t0)
    hi = jnp.where(inv_d < 0.0, t0, t1)
    # NaN lane (degenerate 0·inf) must not constrain the interval — Rust's
    # f32::max/min ignore NaN operands. Wash NaN lo→-inf and hi→+inf.
    tmin = jnp.maximum(jnp.max(jnp.fmax(lo, -jnp.inf), axis=-1), t_min)
    tmax = jnp.minimum(jnp.min(jnp.fmin(hi, jnp.inf), axis=-1), t_max)
    return tmax > tmin


def _slab_test_running(o, d, bmin, bmax, t_min, t_max):
    """Exact sequential-axis replication of the reference slab test.

    The vectorized `slab_test` reduces with plain max over axes after
    NaN-washing; this version folds axis-by-axis with fmax/fmin exactly
    like the Rust loop. Kept for the unit tests to cross-check.
    """
    tmin = jnp.broadcast_to(t_min, o.shape[:-1])
    tmax = jnp.broadcast_to(t_max, o.shape[:-1])
    for axis in range(3):
        inv_d = 1.0 / d[..., axis]
        t0 = (bmin[..., axis] - o[..., axis]) * inv_d
        t1 = (bmax[..., axis] - o[..., axis]) * inv_d
        lo = jnp.where(inv_d < 0.0, t1, t0)
        hi = jnp.where(inv_d < 0.0, t0, t1)
        tmin = jnp.fmax(lo, tmin)
        tmax = jnp.fmin(hi, tmax)
    return tmax > tmin


def moller_trumbore(o, d, va, vb, vc, t_min, t_max, eps=MT_EPSILON):
    """Batched Möller–Trumbore (geometry.rs:331-349 semantics).

    o, d: (..., 3); va/vb/vc: (..., 3) broadcastable triangle vertices.
    Returns (valid, t, u, v). Rejections exactly as the reference:
    |det| < eps (1e-4 default, geometry.rs:335), u < 0, v < 0, u+v > 1,
    t outside [t_min, t_max]. `eps` exists because det scales with the
    det of any linear map applied to the triangle: callers scanning
    PRE-TRANSFORMED (world-space) triangles must pass
    1e-4·|det(transform)| to reproduce the reference's object-space
    accept set (models/scene.py general-volume boundaries).
    """
    e1 = vb - va
    e2 = vc - va
    q = jnp.cross(d, e2)
    det = jnp.sum(e1 * q, axis=-1)
    safe_det = jnp.where(jnp.abs(det) < eps, 1.0, det)
    f = 1.0 / safe_det
    s = o - va
    u = f * jnp.sum(s * q, axis=-1)
    r = jnp.cross(s, e1)
    v = f * jnp.sum(d * r, axis=-1)
    t = f * jnp.sum(e2 * r, axis=-1)
    valid = (
        (jnp.abs(det) >= eps)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= t_min)
        & (t <= t_max)
    )
    return valid, t, u, v


def traverse(
    o: jnp.ndarray,
    d: jnp.ndarray,
    t_min,
    t_max,
    bounds_min: jnp.ndarray,
    bounds_max: jnp.ndarray,
    skip: jnp.ndarray,
    leaf_start: jnp.ndarray,
    leaf_count: jnp.ndarray,
    tri_verts: jnp.ndarray,
    leaf_size: int,
):
    """Stackless threaded-BVH traversal for a ray batch.

    Args:
      o, d: (N, 3) ray origins/directions (already in mesh object space).
      t_min, t_max: scalar bounds (object-space units — the reference's
        object-space-t quirk, SURVEY.md §3.5.1).
      bounds_*/skip/leaf_*: flat BVH node arrays (NN, ...).
      tri_verts: (NT, 3, 3) triangle vertices REORDERED by tri_order so
        leaves are contiguous slices.
      leaf_size: max triangles per leaf (static).

    Returns:
      (hit, t, tri_idx, u, v): per-ray nearest hit; tri_idx indexes the
      REORDERED triangle arrays (map through tri_order for original ids).

    Per while_loop step each ray: gathers its node's box, tests it, tests
    the leaf's ≤leaf_size triangles as a dense masked batch (leaves skip
    the box test like the reference, geometry.rs:95-97 — flat axis-aligned
    triangles would fail the strict slab test), and advances hit→i+1,
    miss→skip[i]. All rays step in lockstep; finished rays idle at
    node == NN.
    """
    n = o.shape[0]
    nn = bounds_min.shape[0]

    state = (
        jnp.zeros((n,), jnp.int32),  # node
        # best_t doubles as the running t_max (broadcast per-ray bounds)
        jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,)).astype(jnp.float32),
        jnp.full((n,), -1, jnp.int32),  # best_tri
        jnp.zeros((n,), jnp.float32),  # best_u
        jnp.zeros((n,), jnp.float32),  # best_v
    )

    def cond(state):
        node = state[0]
        return jnp.any(node < nn)

    def body(state):
        node, best_t, best_tri, best_u, best_v = state
        active = node < nn
        node_c = jnp.minimum(node, nn - 1)  # clamp for safe gathers
        bmin = bounds_min[node_c]
        bmax = bounds_max[node_c]
        ls = leaf_start[node_c]
        lc = leaf_count[node_c]
        is_leaf = ls >= 0

        box_hit = slab_test(o, d, bmin, bmax, t_min, best_t)

        # Dense leaf triangle tests (masked beyond leaf_count).
        for k in range(leaf_size):
            tid = ls + k
            tid_c = jnp.clip(tid, 0, tri_verts.shape[0] - 1)
            verts = tri_verts[tid_c]  # (N, 3, 3)
            valid, t, u, v = moller_trumbore(
                o, d, verts[:, 0], verts[:, 1], verts[:, 2], t_min, best_t
            )
            valid = valid & active & is_leaf & (k < lc)
            best_tri = jnp.where(valid, tid, best_tri)
            best_u = jnp.where(valid, u, best_u)
            best_v = jnp.where(valid, v, best_v)
            best_t = jnp.where(valid, t, best_t)

        nxt = jnp.where(is_leaf | ~box_hit, skip[node_c], node_c + 1)
        node = jnp.where(active, nxt, node)
        return node, best_t, best_tri, best_u, best_v

    _, best_t, best_tri, best_u, best_v = jax.lax.while_loop(cond, body, state)
    hit = best_tri >= 0
    return hit, best_t, best_tri, best_u, best_v


def intersect_tris_scan(o, d, tri_verts, t_min, t_max, chunk: int = 256):
    """Dense chunked all-triangles intersection: `lax.scan` over triangle
    chunks keeping a running nearest hit.

    The specification of the dense path (DENSE_MESH_MAX_TRIS) and its
    CPU implementation; on a GPU ops/intersect.dense_scan runs the
    Triton kernel of ops/pallas/tri_scan.py instead. The (N, chunk)
    Möller–Trumbore test is elementwise math with no gathers, while BVH
    traversal is gather-bound and lockstep-divergent.

    Returns (hit, t, tri_idx, u, v) like `traverse` (tri_idx in the
    array's own order).
    """
    nt = tri_verts.shape[0]
    n = o.shape[0]
    n_chunks = (nt + chunk - 1) // chunk
    pad = n_chunks * chunk - nt
    if pad:
        tri_verts = jnp.concatenate(
            [tri_verts, jnp.zeros((pad, 3, 3), tri_verts.dtype)], axis=0
        )
    chunks = tri_verts.reshape(n_chunks, chunk, 3, 3)
    t_min = jnp.asarray(t_min, jnp.float32)
    if t_min.ndim == 1:
        t_min = t_min[:, None]  # (N, 1) against (N, chunk)

    init = (
        jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,)),
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
    )

    def step(carry, inp):
        ci, tv = inp
        best_t, best_tri, best_u, best_v = carry
        valid, t, u, v = moller_trumbore(
            o[:, None, :], d[:, None, :], tv[None, :, 0], tv[None, :, 1],
            tv[None, :, 2], t_min, best_t[:, None],
        )  # (N, chunk)
        base = ci * chunk
        tri_ids = base + jax.lax.broadcasted_iota(jnp.int32, (1, chunk), 1)
        in_range = tri_ids < nt
        valid = valid & in_range
        t_m = jnp.where(valid, t, jnp.inf)
        k = jnp.argmin(t_m, axis=1)
        rows = jnp.arange(n)
        better = valid[rows, k] & (t[rows, k] < best_t)
        best_tri = jnp.where(better, base + k.astype(jnp.int32), best_tri)
        best_u = jnp.where(better, u[rows, k], best_u)
        best_v = jnp.where(better, v[rows, k], best_v)
        best_t = jnp.where(better, t[rows, k], best_t)
        return (best_t, best_tri, best_u, best_v), None

    (best_t, best_tri, best_u, best_v), _ = jax.lax.scan(
        step, init, (jnp.arange(n_chunks, dtype=jnp.int32), chunks)
    )
    hit = best_tri >= 0
    return hit, best_t, best_tri, best_u, best_v


def intersect_tris_bruteforce(o, d, tri_verts, t_min, t_max):
    """Reference implementation: test every triangle, keep the nearest.

    o, d: (N, 3); tri_verts: (NT, 3, 3). Returns (hit, t, tri_idx, u, v).
    Used to validate traversal.
    """
    valid, t, u, v = moller_trumbore(
        o[:, None, :],
        d[:, None, :],
        tri_verts[None, :, 0],
        tri_verts[None, :, 1],
        tri_verts[None, :, 2],
        t_min,
        t_max,
    )  # (N, NT)
    t_masked = jnp.where(valid, t, jnp.inf)
    idx = jnp.argmin(t_masked, axis=1)
    n_idx = jnp.arange(o.shape[0])
    hit = valid[n_idx, idx]
    return hit, t[n_idx, idx], idx.astype(jnp.int32), u[n_idx, idx], v[n_idx, idx]
