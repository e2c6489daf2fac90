"""Scene-level intersection: batched primitive tests + nearest-hit resolve.

The reference walks `Vec<Arc<dyn Intersectable>>` per ray and returns a
`RayHit` holding an `Arc<dyn Material>` (tracing.rs:326-350). The
array version tests each *primitive class* as one dense batched op
over the whole ray megabatch, reduces to the per-class nearest hit,
arg-mins across classes, and resolves a flat `HitRecord` SoA whose
material parameters are already gathered — downstream shading never
chases pointers.

Replicated reference quirks (SURVEY.md §3.5):
- Mesh hits keep OBJECT-SPACE t (geometry.rs:304-310) and are compared
  against world-space t of other primitives (tracing.rs:335); t_min/t_max
  are likewise applied in object-space units for meshes.
- Plane normals sign-flip toward the ray origin via Rust signum semantics
  (geometry.rs:477-478).
- ConvexVolume samples its scatter distance inside the intersection test
  (geometry.rs:517) and returns a zero normal (geometry.rs:520).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from cs397raytracingsp22.models import materials as mat
from cs397raytracingsp22.models.scene import MeshBlock, SceneData
from cs397raytracingsp22.ops import bvh as bvhlib
from cs397raytracingsp22.utils import vecmath as vm

# python float, NOT jnp.float32(...): a module-level device constant would
# initialize the JAX backend at import time, freezing platform selection
# before the CLI/tests can pick the platform.
_BIG = float("inf")


def dense_scan(mesh: MeshBlock, o_obj, d_obj, t_min, t_max):
    """Nearest hit against every triangle of a dense mesh: the Triton
    kernel (ops/pallas/tri_scan.py) where the computation is lowered for
    a CUDA device, the jnp scan (ops/bvh.intersect_tris_scan) elsewhere.
    Both return (hit, t, tri_idx, u, v) with t = t_max on a miss."""
    from cs397raytracingsp22.ops.pallas import tri_scan

    return jax.lax.platform_dependent(
        o_obj, d_obj, t_min, t_max,
        cuda=lambda o, d, lo, hi: tri_scan.tri_scan(o, d, mesh.tri_table, lo, hi),
        default=lambda o, d, lo, hi: bvhlib.intersect_tris_scan(
            o, d, mesh.tri_verts, lo, hi
        ),
    )


def _traverse(mesh: MeshBlock, o_obj, d_obj, t_min, t_max):
    return bvhlib.traverse(
        o_obj, d_obj, t_min, t_max, mesh.bounds_min, mesh.bounds_max,
        mesh.skip, mesh.leaf_start, mesh.leaf_count, mesh.tri_verts,
        mesh.leaf_size,
    )


def mesh_nearest(mesh: MeshBlock, o_obj, d_obj, t_min, t_max):
    """Nearest hit against one mesh by whichever of the dense scan and
    BVH traversal is faster where the computation is lowered: the dense
    scan up to bvh.DENSE_MESH_MAX_TRIS triangles on CUDA (the Triton
    kernel) and up to bvh.JNP_SCAN_MAX_TRIS elsewhere (the jnp scan),
    the BVH above."""
    n_tri = mesh.tri_verts.shape[0]
    if n_tri <= bvhlib.JNP_SCAN_MAX_TRIS:
        return dense_scan(mesh, o_obj, d_obj, t_min, t_max)
    if n_tri > bvhlib.DENSE_MESH_MAX_TRIS:
        return _traverse(mesh, o_obj, d_obj, t_min, t_max)
    return jax.lax.platform_dependent(
        o_obj, d_obj, t_min, t_max,
        cuda=partial(dense_scan, mesh),
        default=partial(_traverse, mesh),
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "valid",
        "t",
        "point",
        "normal",
        "frontface",
        "mtype",
        "albedo",
        "emission",
        "roughness",
        "metallic",
        "ior",
    ],
    meta_fields=[],
)
@dataclasses.dataclass
class HitRecord:
    """Flat per-ray hit SoA (the RayHit of tracing.rs:109-134, with the
    material dereferenced into its parameters)."""

    valid: jnp.ndarray  # (N,) bool
    t: jnp.ndarray  # (N,) raw hit distance (object-space for meshes!)
    point: jnp.ndarray  # (N, 3) world hitpoint
    normal: jnp.ndarray  # (N, 3) world shading normal (0 for volume hits)
    frontface: jnp.ndarray  # (N,) bool
    mtype: jnp.ndarray  # (N,) int32 material type enum
    albedo: jnp.ndarray  # (N, 3)
    emission: jnp.ndarray  # (N, 3)
    roughness: jnp.ndarray  # (N,)
    metallic: jnp.ndarray  # (N,)
    ior: jnp.ndarray  # (N,)


def _gather_material(scene: SceneData, mid: jnp.ndarray) -> dict:
    return dict(
        mtype=scene.mat_type[mid],
        albedo=scene.mat_albedo[mid],
        emission=scene.mat_emission[mid],
        roughness=scene.mat_roughness[mid],
        metallic=scene.mat_metallic[mid],
        ior=scene.mat_ior[mid],
    )


def _sphere_roots(o, d, center, radius):
    """Quadratic roots of the ray/sphere equation (geometry.rs:395-407).

    o, d: (N, 1, 3); center: (S, 3); radius: (S,).
    Returns (disc_ok, t1, t2) each (N, S); t1 <= t2 where disc_ok.
    """
    f = o - center  # (N, S, 3)
    a = vm.magnitude2(d)  # (N, 1)
    b = 2.0 * jnp.sum(f * d, axis=-1)
    c = vm.magnitude2(f) - radius * radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    return ok, t1, t2


def _col(x):
    """Broadcast a scalar-or-(N,) t bound against (N, K) candidate arrays."""
    x = jnp.asarray(x, jnp.float32)
    return x[:, None] if x.ndim == 1 else x


def intersect_spheres(scene: SceneData, o, d, t_min, t_max):
    """Nearest sphere hit per ray. Returns (t, idx, valid), t=(N,)."""
    t_min, t_max = _col(t_min), _col(t_max)
    ok, t1, t2 = _sphere_roots(o[:, None, :], d[:, None, :], scene.sph_center, scene.sph_radius)
    # Root selection per reference: t1 if t1 >= t_min else t2 (geometry.rs:408).
    t = jnp.where(t1 >= t_min, t1, t2)
    valid = ok & (t >= t_min) & (t <= t_max)
    valid &= jnp.arange(t.shape[1]) < scene.n_spheres
    t_m = jnp.where(valid, t, _BIG)
    idx = jnp.argmin(t_m, axis=1).astype(jnp.int32)
    n_idx = jnp.arange(o.shape[0])
    return t_m[n_idx, idx], idx, valid[n_idx, idx]


def intersect_planes(scene: SceneData, o, d, t_min, t_max):
    """Nearest plane hit per ray (geometry.rs:474-487 semantics)."""
    t_min, t_max = _col(t_min), _col(t_max)
    to_origin = o[:, None, :] - scene.pln_point  # (N, P, 3)
    od = jnp.sum(to_origin * scene.pln_normal, axis=-1)  # (N, P)
    n = vm.signum(od)[..., None] * scene.pln_normal  # flipped toward origin
    dd = jnp.sum(d[:, None, :] * n, axis=-1)
    t = jnp.abs(od) / jnp.abs(dd)
    valid = (dd < 0.0) & (t >= t_min) & (t <= t_max)
    valid &= jnp.arange(t.shape[1]) < scene.n_planes
    t_m = jnp.where(valid, t, _BIG)
    idx = jnp.argmin(t_m, axis=1).astype(jnp.int32)
    n_idx = jnp.arange(o.shape[0])
    return t_m[n_idx, idx], idx, valid[n_idx, idx]


def intersect_triangles(scene: SceneData, o, d, t_min, t_max):
    """Nearest standalone-triangle hit per ray (geometry.rs:431-449)."""
    valid, t, _, _ = bvhlib.moller_trumbore(
        o[:, None, :], d[:, None, :], scene.tri_a, scene.tri_b, scene.tri_c,
        _col(t_min), _col(t_max),
    )
    valid &= jnp.arange(t.shape[1]) < scene.n_tris
    t_m = jnp.where(valid, t, _BIG)
    idx = jnp.argmin(t_m, axis=1).astype(jnp.int32)
    n_idx = jnp.arange(o.shape[0])
    return t_m[n_idx, idx], idx, valid[n_idx, idx]


def intersect_volumes(scene: SceneData, o, d, t_min, t_max, u_vol):
    """Nearest participating-medium scatter event per ray.

    Replicates ConvexVolume::intersect_ray (geometry.rs:502-525): entry =
    smaller sphere root over (-inf, inf), exit = larger root (must exceed
    entry + 1e-4), clip to [t_min, t_max], then scatter iff the sampled
    free-flight distance -ln(U)/density fits inside the clipped span.

    u_vol: (N, V) uniforms in [0, 1) — one draw per ray per volume per
    bounce, replacing thread_rng at geometry.rs:517.
    """
    t_min, t_max = _col(t_min), _col(t_max)
    ok, t1, t2 = _sphere_roots(
        o[:, None, :], d[:, None, :], scene.vol_center, scene.vol_radius
    )
    t_entr = t1
    exit_ok = ok & (t2 >= t1 + 1e-4)
    t_exit = t2
    in_range = (t_exit >= t_min) & (t_entr <= t_max)
    t_start = jnp.maximum(t_entr, t_min)
    t_end = jnp.minimum(t_exit, t_max)
    dist_in_volume = t_end - t_start
    # -ln(U)/rho; U in [0,1) — ln(0) = -inf gives dist=inf → no scatter,
    # matching gen_range(0.0..1.0)'s open upper bound closely enough.
    dist_before_scatter = (-1.0 / scene.vol_density) * jnp.log(
        jnp.maximum(u_vol, 1e-38)
    )
    valid = ok & exit_ok & in_range & (dist_before_scatter < dist_in_volume)
    valid &= jnp.arange(t1.shape[1]) < scene.n_volumes
    t = t_start + dist_before_scatter
    t_m = jnp.where(valid, t, _BIG)
    idx = jnp.argmin(t_m, axis=1).astype(jnp.int32)
    n_idx = jnp.arange(o.shape[0])
    return t_m[n_idx, idx], idx, valid[n_idx, idx]


def intersect_general_volume(
    tri_table: jnp.ndarray, density, o, d, t_min, t_max, u,
    eps=bvhlib.MT_EPSILON,
):
    """One general-boundary ConvexVolume (geometry.rs:502-525 with a
    non-sphere `boundary`): two nearest-hit boundary queries — entry over
    (-inf, +inf) (the reference's `f32::MIN..f32::MAX`, geometry.rs:505),
    exit over (t_entr + 1e-4, +inf) — by scanning the boundary's triangle
    table, then the same free-flight sampling as the sphere path.

    tri_table: (T, 9) world-space [a, e1, e2] rows. `eps` is the
    grazing-reject threshold IN WORLD SPACE: the reference intersects a
    StaticMesh boundary in its object space where |det| >= 1e-4
    (geometry.rs:335), and det scales by det(transform) under the
    world pre-transform, so scene compilation passes
    1e-4·|det(transform)| per volume (SceneData.gvol_eps).
    Returns (t, valid), both (N,).
    """
    t_min = jnp.asarray(t_min, jnp.float32)
    t_max = jnp.asarray(t_max, jnp.float32)
    a = tri_table[:, 0:3]
    b = a + tri_table[:, 3:6]
    c = a + tri_table[:, 6:9]
    ok, t, _, _ = bvhlib.moller_trumbore(
        o[:, None, :], d[:, None, :], a, b, c, -_BIG, _BIG, eps=eps
    )
    t_all = jnp.where(ok, t, _BIG)
    t_entr = jnp.min(t_all, axis=1)
    entered = jnp.any(ok, axis=1)
    # exit: nearest boundary hit at least 1e-4 past the entry
    # (geometry.rs:508 `t_entr+0.0001`)
    t_all2 = jnp.where(t_all >= t_entr[:, None] + 1e-4, t_all, _BIG)
    t_exit = jnp.min(t_all2, axis=1)
    exited = jnp.isfinite(t_exit)
    in_range = (t_exit >= t_min) & (t_entr <= t_max)
    t_start = jnp.maximum(t_entr, t_min)
    t_end = jnp.minimum(t_exit, t_max)
    dist_before_scatter = (-1.0 / density) * jnp.log(jnp.maximum(u, 1e-38))
    valid = entered & exited & in_range & (
        dist_before_scatter < t_end - t_start
    )
    return t_start + dist_before_scatter, valid


def _transform_point(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """(4,4) @ (N,3) homogeneous point transform (exact elementwise arithmetic —
    see vecmath.apply_mat3 for why not a matmul)."""
    return vm.apply_mat4_point(m, p)


def _transform_vector(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    return vm.apply_mat4_vector(m, v)


def sample_texture(scene: SceneData, tex_id: int, uv: jnp.ndarray) -> jnp.ndarray:
    """Nearest-neighbor atlas sample, (N, 2) uv → (N, 3) in [0,1].

    Exact replication of texture.rs:26-32: u clamped to [0, 0.999],
    v flipped (1-v) after the same clamp, truncating float→int casts,
    final min with size-1. `tex_id` is static (per-mesh slot binding).
    """
    off = scene.tex_offset[tex_id]
    w = scene.tex_width[tex_id]
    h = scene.tex_height[tex_id]
    u = jnp.clip(uv[:, 0], 0.0, 0.999)
    v = jnp.clip(uv[:, 1], 0.0, 0.999)
    x = jnp.minimum((u * w).astype(jnp.int32), w - 1)
    y = jnp.minimum(((1.0 - v) * h).astype(jnp.int32), h - 1)
    px = scene.tex_pixels[off + y * w + x]
    return px.astype(jnp.float32) / 255.0


def intersect_mesh(mesh: MeshBlock, scene: SceneData, o, d, t_min, t_max):
    """One StaticMesh: object-space traversal + full shading resolve.

    Returns candidate fields dict (t in OBJECT space — but note the ray
    parameter is transform-invariant because the direction is transformed
    WITHOUT renormalization, geometry.rs:304, so t compares directly with
    other primitives').
    """
    o_obj = _transform_point(mesh.inv_transform, o)
    d_obj = _transform_vector(mesh.inv_transform, d)

    hit, t, tri, u, v = mesh_nearest(mesh, o_obj, d_obj, t_min, t_max)
    fields = resolve_mesh_hit(mesh, scene, o_obj, d_obj, t, tri, u, v)
    fields["valid"] = hit
    fields["t"] = jnp.where(hit, t, _BIG)
    return fields


def resolve_mesh_hit(mesh: MeshBlock, scene: SceneData, o_obj, d_obj, t, tri, u, v):
    """Shading resolve for mesh hits given (t, tri, u, v) in object space:
    smooth normals, texcoords, TBN normal mapping, world transform, and
    the explicit-or-texture-synthesized material (geometry.rs:274-321)."""
    tri = jnp.maximum(tri, 0)  # safe gather index for miss lanes
    w = 1.0 - u - v

    # Smooth vertex-normal interpolation (geometry.rs:350-351):
    # n = normalize(u*nb + v*nc + (1-u-v)*na).
    nabc = mesh.tri_normals[tri]  # (N, 3corners, 3)
    n_smooth = vm.normalize(
        u[:, None] * nabc[:, 1] + v[:, None] * nabc[:, 2] + w[:, None] * nabc[:, 0],
        eps=1e-30,
    )
    frontface = jnp.sum(n_smooth * d_obj, axis=-1) < 0.0
    n_flip = jnp.where(frontface[:, None], n_smooth, -n_smooth)

    # Texcoord interpolation (geometry.rs:355-356).
    uvabc = mesh.tri_uvs[tri]  # (N, 3, 2)
    uv = u[:, None] * uvabc[:, 1] + v[:, None] * uvabc[:, 2] + w[:, None] * uvabc[:, 0]

    # Normal mapping via per-triangle tangent + Gram-Schmidt TBN
    # (geometry.rs:359-363, 274-296), only when a normal map is bound.
    n_obj = n_flip
    if mesh.tex_ids[4] >= 0:
        tan_approx = mesh.tri_tangent[tri]
        bitangent = vm.normalize(jnp.cross(n_flip, tan_approx), eps=1e-30)
        tangent = vm.normalize(jnp.cross(bitangent, n_flip), eps=1e-30)
        nm = 2.0 * sample_texture(scene, mesh.tex_ids[4], uv) - 1.0
        n_obj = (
            tangent * nm[:, 0:1] + bitangent * nm[:, 1:2] + n_flip * nm[:, 2:3]
        )

    # Normal to world: inverse-transpose, then normalize (geometry.rs:297).
    n_world = vm.normalize(_transform_vector(mesh.normal_mat, n_obj), eps=1e-30)

    # World hitpoint from object-space hitpoint (geometry.rs:307); t stays
    # object-space.
    p_obj = o_obj + t[:, None] * d_obj
    p_world = _transform_point(mesh.transform, p_obj)

    # Material: explicit table row, or synthesized from textures
    # (geometry.rs:253-271).
    if mesh.mat_id >= 0:
        m = _gather_material(scene, jnp.full(t.shape, mesh.mat_id, jnp.int32))
    else:
        n = t.shape[0]
        zero3 = jnp.zeros((n, 3), jnp.float32)
        albedo = (
            sample_texture(scene, mesh.tex_ids[0], uv) if mesh.tex_ids[0] >= 0 else zero3
        )
        emission = (
            sample_texture(scene, mesh.tex_ids[1], uv) if mesh.tex_ids[1] >= 0 else zero3
        )
        metallic = (
            sample_texture(scene, mesh.tex_ids[2], uv)[:, 0]
            if mesh.tex_ids[2] >= 0
            else jnp.zeros((n,), jnp.float32)
        )
        roughness = (
            sample_texture(scene, mesh.tex_ids[3], uv)[:, 0]
            if mesh.tex_ids[3] >= 0
            else jnp.ones((n,), jnp.float32)
        )
        m = dict(
            mtype=jnp.full((n,), mat.PARAMETERIZED, jnp.int32),
            albedo=albedo,
            emission=emission,
            roughness=roughness,
            metallic=metallic,
            ior=jnp.full((n,), 1.5, jnp.float32),
        )

    return dict(
        point=p_world,
        normal=n_world,
        frontface=frontface,
        **m,
    )


def intersect_scene(
    scene: SceneData, o, d, t_min, t_max, u_vol: jnp.ndarray
) -> HitRecord:
    """Nearest hit across all primitive classes (tracing.rs:326-350).

    Args:
      o, d: (N, 3) world-space rays (directions may be unnormalized —
        all t values are in units of |d|, like the reference).
      t_min, t_max: scalar or per-ray bounds.
      u_vol: (N, V) uniforms for volume free-flight sampling.

    Ties across classes are broken by class order (measure-zero difference
    from the reference's list order, SURVEY.md §3.5).
    """
    n = o.shape[0]
    n_idx = jnp.arange(n)

    candidates: list[dict] = []

    # --- spheres ---
    t_s, i_s, v_s = intersect_spheres(scene, o, d, t_min, t_max)
    center = scene.sph_center[i_s]
    p = o + t_s[:, None] * d
    n_out = vm.normalize(p - center, eps=1e-30)
    ff = jnp.sum(n_out * d, axis=-1) < 0.0
    candidates.append(
        dict(
            valid=v_s,
            t=t_s,
            point=p,
            normal=jnp.where(ff[:, None], n_out, -n_out),
            frontface=ff,
            **_gather_material(scene, scene.sph_mat[i_s]),
        )
    )

    # --- planes ---
    t_p, i_p, v_p = intersect_planes(scene, o, d, t_min, t_max)
    pln_n = scene.pln_normal[i_p]
    pln_pt = scene.pln_point[i_p]
    od = jnp.sum((o - pln_pt) * pln_n, axis=-1)
    n_pre = vm.signum(od)[:, None] * pln_n
    ff = jnp.sum(n_pre * d, axis=-1) < 0.0
    candidates.append(
        dict(
            valid=v_p,
            t=t_p,
            point=o + t_p[:, None] * d,
            normal=jnp.where(ff[:, None], n_pre, -n_pre),
            frontface=ff,
            **_gather_material(scene, scene.pln_mat[i_p]),
        )
    )

    # --- standalone triangles ---
    t_t, i_t, v_t = intersect_triangles(scene, o, d, t_min, t_max)
    e1 = scene.tri_b[i_t] - scene.tri_a[i_t]
    e2 = scene.tri_c[i_t] - scene.tri_a[i_t]
    n_geo = vm.normalize(jnp.cross(e1, e2), eps=1e-30)
    ff = jnp.sum(n_geo * d, axis=-1) < 0.0
    candidates.append(
        dict(
            valid=v_t,
            t=t_t,
            point=o + t_t[:, None] * d,
            normal=jnp.where(ff[:, None], n_geo, -n_geo),
            frontface=ff,
            **_gather_material(scene, scene.tri_mat[i_t]),
        )
    )

    # --- convex volumes (sphere boundaries) ---
    n_vcols = scene.vol_center.shape[0]
    t_v, i_v, v_v = intersect_volumes(
        scene, o, d, t_min, t_max, u_vol[:, :n_vcols]
    )
    candidates.append(
        dict(
            valid=v_v,
            t=t_v,
            point=o + t_v[:, None] * d,
            normal=jnp.zeros((n, 3), jnp.float32),
            frontface=jnp.zeros((n,), bool),
            **_gather_material(scene, scene.vol_mat[i_v]),
        )
    )

    # --- general-boundary convex volumes (static unroll, few per scene) ---
    for g in range(scene.n_gvols):
        t_g, v_g = intersect_general_volume(
            scene.gvol_tri[g], scene.gvol_density[g], o, d, t_min, t_max,
            u_vol[:, n_vcols + g], eps=scene.gvol_eps[g],
        )
        candidates.append(
            dict(
                valid=v_g,
                t=jnp.where(v_g, t_g, _BIG),
                point=o + t_g[:, None] * d,
                normal=jnp.zeros((n, 3), jnp.float32),
                frontface=jnp.zeros((n,), bool),
                **_gather_material(
                    scene, jnp.full((n,), scene.gvol_mat[g], jnp.int32)
                ),
            )
        )

    # --- meshes (static unroll; each traverses its own BVH) ---
    for mesh in scene.meshes:
        candidates.append(intersect_mesh(mesh, scene, o, d, t_min, t_max))

    # Winner: argmin of raw t across classes (object-space t for meshes
    # compares against world t — reference quirk, SURVEY.md §3.5.1).
    ts = jnp.stack([c["t"] for c in candidates], axis=1)  # (N, G)
    winner = jnp.argmin(ts, axis=1)

    def select(field):
        out = candidates[0][field]
        for g in range(1, len(candidates)):
            sel = winner == g
            cg = candidates[g][field]
            if out.ndim > 1:
                sel = sel[:, None]
            out = jnp.where(sel, cg, out)
        return out

    valid = jnp.zeros((n,), bool)
    for g, c in enumerate(candidates):
        valid |= (winner == g) & c["valid"]

    return HitRecord(
        valid=valid,
        t=select("t"),
        point=select("point"),
        normal=select("normal"),
        frontface=select("frontface"),
        mtype=select("mtype"),
        albedo=select("albedo"),
        emission=select("emission"),
        roughness=select("roughness"),
        metallic=select("metallic"),
        ior=select("ior"),
    )
