"""Scene description → flat SoA compilation.

The reference's scene is a `Vec<Arc<dyn Intersectable>>` walked per ray
(tracing.rs:326-350). The compiled scene is a pytree of flat arrays —
per-primitive-type tables, concatenated mesh buffers with threaded BVHs,
a deduplicated material table, and a packed texture atlas — built once on
the host and placed on device; rendering is then pure array code.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from cs397raytracingsp22.models.camera import Camera
from cs397raytracingsp22.models.geometry import (
    ConvexVolume,
    Plane,
    Sphere,
    StaticMesh,
    Triangle,
)
from cs397raytracingsp22.models.materials import MaterialTableBuilder
from cs397raytracingsp22.ops import bvh as bvhlib
from cs397raytracingsp22.utils.texture import TextureAtlasBuilder

SceneObject = Union[Sphere, Triangle, Plane, ConvexVolume, StaticMesh]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "tri_verts",
        "tri_table",
        "tri_normals",
        "tri_uvs",
        "tri_tangent",
        "bounds_min",
        "bounds_max",
        "skip",
        "leaf_start",
        "leaf_count",
        "transform",
        "inv_transform",
        "normal_mat",
    ],
    meta_fields=["mat_id", "tex_ids", "leaf_size", "has_uv"],
)
@dataclasses.dataclass
class MeshBlock:
    """One compiled StaticMesh: reordered triangle SoA + threaded BVH.

    Triangle arrays are pre-gathered per corner (no index-buffer
    indirection on device) and reordered by the BVH's tri_order so leaf
    ranges are contiguous.
    """

    tri_verts: jnp.ndarray  # (NT, 3, 3) object-space corners
    tri_table: jnp.ndarray  # (NT, 9) [a, b-a, c-a] rows for the scan kernel
    tri_normals: jnp.ndarray  # (NT, 3, 3) per-corner normals (oct-quantized)
    tri_uvs: jnp.ndarray  # (NT, 3, 2) per-corner texcoords
    tri_tangent: jnp.ndarray  # (NT, 3) per-triangle tangent approx
    bounds_min: jnp.ndarray  # (NN, 3)
    bounds_max: jnp.ndarray  # (NN, 3)
    skip: jnp.ndarray  # (NN,)
    leaf_start: jnp.ndarray  # (NN,)
    leaf_count: jnp.ndarray  # (NN,)
    transform: jnp.ndarray  # (4, 4)
    inv_transform: jnp.ndarray  # (4, 4)
    normal_mat: jnp.ndarray  # (3, 3) = inv_transform[:3,:3].T
    mat_id: int  # static; -1 → material synthesized from textures
    tex_ids: Tuple[int, int, int, int, int]  # static; -1 → absent
    leaf_size: int  # static
    has_uv: bool  # static


_SCENE_DATA_FIELDS = [
    "mat_type",
    "mat_albedo",
    "mat_emission",
    "mat_roughness",
    "mat_metallic",
    "mat_ior",
    "sph_center",
    "sph_radius",
    "sph_mat",
    "pln_point",
    "pln_normal",
    "pln_mat",
    "tri_a",
    "tri_b",
    "tri_c",
    "tri_mat",
    "vol_center",
    "vol_radius",
    "vol_density",
    "vol_mat",
    "gvol_tri",
    "gvol_density",
    "gvol_mat",
    "meshes",
    "tex_pixels",
    "tex_offset",
    "tex_width",
    "tex_height",
    "point_light_pos",
    "ambient",
    # NEE light tables (render/nee.py — opt-in, beyond the reference)
    "lt_tri",
    "lt_sph",
]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=_SCENE_DATA_FIELDS,
    meta_fields=[
        "n_spheres",
        "n_planes",
        "n_tris",
        "n_volumes",
        "dense_mesh_ids",
        "n_gvols",
        "n_lt_tri",
        "n_lt_sph",
        "nee_ok",
        "gvol_eps",
    ],
)
@dataclasses.dataclass
class SceneData:
    """Compiled scene: the pytree every device-side op consumes.

    Every table is padded to length ≥ 1 (inert rows) so shapes are never
    zero; actual counts are static metadata used to mask padding.
    """

    # material table
    mat_type: jnp.ndarray
    mat_albedo: jnp.ndarray
    mat_emission: jnp.ndarray
    mat_roughness: jnp.ndarray
    mat_metallic: jnp.ndarray
    mat_ior: jnp.ndarray
    # spheres
    sph_center: jnp.ndarray
    sph_radius: jnp.ndarray
    sph_mat: jnp.ndarray
    # planes
    pln_point: jnp.ndarray
    pln_normal: jnp.ndarray
    pln_mat: jnp.ndarray
    # standalone triangles
    tri_a: jnp.ndarray
    tri_b: jnp.ndarray
    tri_c: jnp.ndarray
    tri_mat: jnp.ndarray
    # convex volumes (sphere boundaries — the fast path every kernel
    # tier supports)
    vol_center: jnp.ndarray
    vol_radius: jnp.ndarray
    vol_density: jnp.ndarray
    vol_mat: jnp.ndarray
    # general convex volumes (Triangle / convex-StaticMesh boundaries,
    # geometry.rs:495-530 `Arc<dyn Intersectable>`): per-volume
    # world-space triangle tables (T, 9) = [a, e1, e2]; entry/exit by
    # nearest-hit scan (ops/intersect.intersect_general_volumes)
    gvol_tri: Tuple[jnp.ndarray, ...]
    gvol_density: jnp.ndarray
    gvol_mat: jnp.ndarray
    # meshes
    meshes: Tuple[MeshBlock, ...]
    # texture atlas
    tex_pixels: jnp.ndarray  # (P, 3) uint8
    tex_offset: jnp.ndarray
    tex_width: jnp.ndarray
    tex_height: jnp.ndarray
    # phong-mode lighting
    point_light_pos: jnp.ndarray
    ambient: jnp.ndarray
    # NEE light tables (opt-in next-event estimation, render/nee.py —
    # a beyond-reference feature, default off): emissive standalone
    # Triangles as (Lt, 13) = [a(3), e1(3), e2(3), emission(3), area]
    # and emissive Spheres as (Ls, 7) = [center(3), radius, emission(3)],
    # both world-space, padded to ≥ 1 inert row
    lt_tri: jnp.ndarray
    lt_sph: jnp.ndarray
    # static actual counts (arrays are padded)
    n_spheres: int
    n_planes: int
    n_tris: int
    n_volumes: int
    # indices into `meshes` of the meshes small enough for the dense
    # scan on some backend (ops/intersect.mesh_nearest); the rest
    # traverse their BVH everywhere
    dense_mesh_ids: Tuple[int, ...]
    n_gvols: int = 0
    # NEE statics: light counts + whether EVERY emissive object in the
    # scene is a standalone Triangle or Sphere (the sampled-light set) —
    # emission suppression at NEE'd vertices is only correct when the
    # light set covers all emitters, so the driver refuses --nee on
    # scenes with emissive planes/meshes (nee_ok False)
    n_lt_tri: int = 0
    n_lt_sph: int = 0
    nee_ok: bool = False
    # per-gvol world-space grazing-reject epsilon, 1e-4·|det(transform)|
    # (static metadata — see _boundary_tri_table)
    gvol_eps: Tuple[float, ...] = ()


@dataclasses.dataclass
class Scene:
    """User-facing scene (reference tracing.rs:213-218 equivalent)."""

    camera: Camera
    objects: Sequence[SceneObject]
    point_light_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ambient: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def compile(self, leaf_size: int = 4) -> SceneData:
        return compile_scene(self, leaf_size=leaf_size)


def _boundary_tri_table(boundary) -> tuple[np.ndarray, float]:
    """Lower a non-sphere ConvexVolume boundary to a world-space
    (T, 9) = [a, e1, e2] triangle table for the entry/exit scan, plus
    the volume's world-space grazing-reject epsilon.

    Supported: Triangle (one row) and StaticMesh (all triangles,
    transformed to world space — the reference intersects the boundary
    through its normal `intersect_ray`, geometry.rs:505-510, and the
    unnormalized-direction transform makes mesh t world-comparable, so
    pre-transforming vertices yields the same t values directly).

    The epsilon: the reference rejects |det| < 1e-4 in the mesh's
    OBJECT space (geometry.rs:335). det = (e1×e2)·d transforms as
    det_world = det(M)·det_object under the linear part M of the mesh
    transform (exactly, for any invertible M), so scanning the
    pre-transformed triangles with 1e-4·|det(M)| reproduces the
    reference's accept set — a plain 1e-4 would silently reject every
    triangle of a small-scaled finely-tessellated boundary."""
    from cs397raytracingsp22.models.geometry import StaticMesh, Triangle
    from cs397raytracingsp22.ops.bvh import MT_EPSILON

    if isinstance(boundary, Triangle):
        a = np.asarray(boundary.a, np.float32)
        rows = np.concatenate(
            [a, np.asarray(boundary.b, np.float32) - a,
             np.asarray(boundary.c, np.float32) - a]
        ).reshape(1, 9)
        return rows, MT_EPSILON
    if isinstance(boundary, StaticMesh):
        pos = boundary.mesh.positions.astype(np.float64)
        m = np.asarray(boundary.transform, np.float64)
        pos_w = pos @ m[:3, :3].T + m[:3, 3]
        tri = pos_w[boundary.mesh.indices]  # (T, 3, 3)
        a = tri[:, 0]
        rows = np.concatenate(
            [a, tri[:, 1] - a, tri[:, 2] - a], axis=1
        ).astype(np.float32)
        eps = MT_EPSILON * float(abs(np.linalg.det(m[:3, :3])))
        return rows, eps
    raise TypeError(
        f"unsupported ConvexVolume boundary {type(boundary)!r} "
        "(Sphere, Triangle, and StaticMesh are supported)"
    )


def _pad_rows(arr: np.ndarray, min_rows: int, fill: float) -> np.ndarray:
    if arr.shape[0] >= min_rows:
        return arr
    pad_shape = (min_rows - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)], axis=0)


def compile_scene(scene: Scene, leaf_size: int = 4) -> SceneData:
    """Lower a Scene description into device SoA arrays."""
    mats = MaterialTableBuilder()
    atlas = TextureAtlasBuilder()

    sph_center, sph_radius, sph_mat = [], [], []
    pln_point, pln_normal, pln_mat = [], [], []
    tri_a, tri_b, tri_c, tri_mat = [], [], [], []
    vol_center, vol_radius, vol_density, vol_mat = [], [], [], []
    gvol_tris, gvol_density, gvol_mat, gvol_eps = [], [], [], []
    mesh_blocks: list[MeshBlock] = []

    # NEE light extraction (render/nee.py, opt-in): emissive standalone
    # Triangles and Spheres become area-sampled lights; any OTHER
    # emissive object (plane, mesh, phase function) voids nee_ok because
    # NEE's next-vertex emission suppression is only correct when the
    # sampled-light set covers every emitter in the scene.
    lt_tri_rows: list = []
    lt_sph_rows: list = []
    nee_ok = True

    def _emission_of(m):
        e = np.asarray(getattr(m, "emission", (0.0, 0.0, 0.0)), np.float32)
        return e if float(np.abs(e).max()) > 0.0 else None

    for obj in scene.objects:
        if isinstance(obj, Sphere):
            sph_center.append(obj.center)
            sph_radius.append(obj.radius)
            sph_mat.append(mats.add(obj.material))
            e = _emission_of(obj.material)
            if e is not None:
                lt_sph_rows.append(
                    tuple(obj.center) + (obj.radius,) + tuple(e)
                )
        elif isinstance(obj, Plane):
            pln_point.append(obj.point)
            pln_normal.append(obj.normal)
            pln_mat.append(mats.add(obj.material))
            if _emission_of(obj.material) is not None:
                nee_ok = False  # infinite plane: not area-sampleable
        elif isinstance(obj, Triangle):
            tri_a.append(obj.a)
            tri_b.append(obj.b)
            tri_c.append(obj.c)
            tri_mat.append(mats.add(obj.material))
            e = _emission_of(obj.material)
            if e is not None:
                a = np.asarray(obj.a, np.float32)
                e1 = np.asarray(obj.b, np.float32) - a
                e2 = np.asarray(obj.c, np.float32) - a
                area = 0.5 * float(np.linalg.norm(np.cross(e1, e2)))
                lt_tri_rows.append(
                    tuple(a) + tuple(e1) + tuple(e2) + tuple(e) + (area,)
                )
        elif isinstance(obj, ConvexVolume):
            if _emission_of(obj.phase_function) is not None:
                nee_ok = False  # emissive media are not sampled lights
            if isinstance(obj.boundary, Sphere):
                # fast path: analytic entry/exit
                vol_center.append(obj.boundary.center)
                vol_radius.append(obj.boundary.radius)
                vol_density.append(obj.density)
                vol_mat.append(mats.add(obj.phase_function))
            else:
                # general boundary (geometry.rs:495 `Arc<dyn Intersectable>`):
                # lower to a world-space triangle table scanned for
                # entry/exit (intersect_general_volumes)
                rows, g_eps = _boundary_tri_table(obj.boundary)
                gvol_tris.append(rows)
                gvol_eps.append(g_eps)
                gvol_density.append(obj.density)
                gvol_mat.append(mats.add(obj.phase_function))
        elif isinstance(obj, StaticMesh):
            mesh_blocks.append(_compile_mesh(obj, mats, atlas, leaf_size))
            block = mesh_blocks[-1]
            explicit_emissive = (
                obj.material is not None
                and _emission_of(obj.material) is not None
            )
            if explicit_emissive or block.tex_ids[1] >= 0:
                nee_ok = False  # mesh-face lights not sampled (v1)
        else:
            raise TypeError(f"unsupported scene object {type(obj)!r}")

    if not (lt_tri_rows or lt_sph_rows):
        nee_ok = False  # nothing to sample

    table = mats.build()
    packed = atlas.build()

    def f32(rows, width=None, fill=0.0):
        if rows:
            a = np.asarray(rows, np.float32)
        else:
            a = np.zeros((0, width) if width else (0,), np.float32)
        return jnp.asarray(_pad_rows(a, 1, fill))

    def i32(rows):
        a = np.asarray(rows, np.int32) if rows else np.zeros((0,), np.int32)
        return jnp.asarray(_pad_rows(a, 1, 0).astype(np.int32))

    def np_pad(rows, width, fill=0.0):
        a = (
            np.asarray(rows, np.float32).reshape(-1, width)
            if rows
            else np.zeros((0, width), np.float32)
        )
        return _pad_rows(a, 1, fill)

    from cs397raytracingsp22.ops.bvh import DENSE_MESH_MAX_TRIS

    dense_ids = tuple(
        i
        for i, m in enumerate(mesh_blocks)
        if m.tri_verts.shape[0] <= DENSE_MESH_MAX_TRIS
    )

    return SceneData(
        mat_type=jnp.asarray(table["mat_type"]),
        mat_albedo=jnp.asarray(table["mat_albedo"]),
        mat_emission=jnp.asarray(table["mat_emission"]),
        mat_roughness=jnp.asarray(table["mat_roughness"]),
        mat_metallic=jnp.asarray(table["mat_metallic"]),
        mat_ior=jnp.asarray(table["mat_ior"]),
        sph_center=f32(sph_center, 3, 1e30),
        sph_radius=f32(sph_radius, None, 0.0),
        sph_mat=i32(sph_mat),
        pln_point=f32(pln_point, 3, 0.0),
        pln_normal=f32(pln_normal, 3, 0.0),
        pln_mat=i32(pln_mat),
        tri_a=f32(tri_a, 3, 0.0),
        tri_b=f32(tri_b, 3, 0.0),
        tri_c=f32(tri_c, 3, 0.0),
        tri_mat=i32(tri_mat),
        vol_center=f32(vol_center, 3, 1e30),
        vol_radius=f32(vol_radius, None, 0.0),
        vol_density=f32(vol_density, None, 1.0),
        vol_mat=i32(vol_mat),
        gvol_tri=tuple(jnp.asarray(t) for t in gvol_tris),
        gvol_density=f32(gvol_density, None, 1.0),
        gvol_mat=i32(gvol_mat),
        gvol_eps=tuple(gvol_eps),
        meshes=tuple(mesh_blocks),
        tex_pixels=jnp.asarray(packed.pixels),
        tex_offset=jnp.asarray(packed.offset),
        tex_width=jnp.asarray(packed.width),
        tex_height=jnp.asarray(packed.height),
        point_light_pos=jnp.asarray(scene.point_light_pos, jnp.float32),
        ambient=jnp.asarray(scene.ambient, jnp.float32),
        lt_tri=jnp.asarray(np_pad(lt_tri_rows, 13, 0.0)),
        lt_sph=jnp.asarray(np_pad(lt_sph_rows, 7, 0.0)),
        n_spheres=len(sph_center),
        n_planes=len(pln_point),
        n_tris=len(tri_a),
        n_volumes=len(vol_center),
        dense_mesh_ids=dense_ids,
        n_gvols=len(gvol_tris),
        n_lt_tri=len(lt_tri_rows),
        n_lt_sph=len(lt_sph_rows),
        nee_ok=nee_ok,
    )


def _oct_encode(n: np.ndarray) -> np.ndarray:
    """Octahedral-encode directions: (N, 3) float → (N,) uint32 packing
    two 16-bit snorm components (lo = u, hi = v).

    Mesh corner normals are stored quantized (angular error ≤ ~5e-4 rad
    ≈ 0.03°, measured worst case near octahedron diagonals — far below
    u8 image quantization). Every path decodes to the SAME f32 values,
    and a missing (all-zero) normal decodes to +z. Directions only: magnitudes
    normalize away (OBJ vn are unit in practice; geometry.rs:350 then
    normalizes the interpolation anyway).
    """
    v = n.astype(np.float64)
    norm = np.linalg.norm(v, axis=-1, keepdims=True)
    v = v / np.where(norm > 0, norm, 1.0)
    l1 = np.abs(v).sum(axis=-1, keepdims=True)
    p = v[..., :2] / np.where(l1 > 0, l1, 1.0)
    neg = v[..., 2] < 0.0
    flip = (1.0 - np.abs(p[..., ::-1])) * np.where(p >= 0.0, 1.0, -1.0)
    p = np.where(neg[..., None], flip, p)
    q = np.round(np.clip(p, -1.0, 1.0) * 32767.0).astype(np.int64) + 32767
    return (q[..., 0] | (q[..., 1] << 16)).astype(np.uint32)


def _oct_decode(packed: np.ndarray) -> np.ndarray:
    """Decode _oct_encode output to unit f32 vectors."""
    w = packed.astype(np.int64)
    fu = ((w & 0xFFFF) - 32767).astype(np.float32) * np.float32(1.0 / 32767.0)
    fv = (((w >> 16) & 0xFFFF) - 32767).astype(np.float32) * np.float32(
        1.0 / 32767.0
    )
    z = np.float32(1.0) - np.abs(fu) - np.abs(fv)
    t = np.maximum(-z, np.float32(0.0))
    x = fu + np.where(fu >= 0.0, -t, t)
    y = fv + np.where(fv >= 0.0, -t, t)
    v = np.stack([x, y, z], axis=-1).astype(np.float32)
    n = np.sqrt((v.astype(np.float32) ** 2).sum(axis=-1, keepdims=True))
    return (v / np.maximum(n, np.float32(1e-30))).astype(np.float32)


def _compile_mesh(
    sm: StaticMesh, mats: MaterialTableBuilder, atlas: TextureAtlasBuilder, leaf_size: int
) -> MeshBlock:
    mesh = sm.mesh
    idx = mesh.indices  # (NT, 3)
    verts = mesh.positions[idx]  # (NT, 3, 3)
    normals = mesh.normals[idx]  # (NT, 3, 3)
    uvs = mesh.texcoords[idx]  # (NT, 3, 2)

    # Per-triangle tangent approximation (geometry.rs:245-250):
    # t = ((v3-v1)(p2-p1) - (v2-v1)(p3-p1)) / ((u2-u1)(v3-v1) - (v2-v1)(u3-u1))
    p1, p2, p3 = verts[:, 0], verts[:, 1], verts[:, 2]
    u1, u2, u3 = uvs[:, 0, 0], uvs[:, 1, 0], uvs[:, 2, 0]
    v1, v2, v3 = uvs[:, 0, 1], uvs[:, 1, 1], uvs[:, 2, 1]
    denom = (u2 - u1) * (v3 - v1) - (v2 - v1) * (u3 - u1)
    with np.errstate(divide="ignore", invalid="ignore"):
        tangent = (
            (v3 - v1)[:, None] * (p2 - p1) - (v2 - v1)[:, None] * (p3 - p1)
        ) / denom[:, None]

    flat = bvhlib.build_bvh(verts, leaf_size=leaf_size)
    order = flat.tri_order

    tex_ids = []
    for img in sm.textures:
        tex_ids.append(atlas.add(img) if img is not None else -1)

    mat_id = mats.add(sm.material) if sm.material is not None else -1

    rv = verts[order]
    tri_table = np.concatenate(
        [rv[:, 0], rv[:, 1] - rv[:, 0], rv[:, 2] - rv[:, 0]], axis=1
    ).astype(np.float32)
    normals_q = _oct_decode(_oct_encode(normals[order].astype(np.float64)))

    return MeshBlock(
        tri_verts=jnp.asarray(verts[order]),
        tri_table=jnp.asarray(tri_table),
        tri_normals=jnp.asarray(normals_q),
        tri_uvs=jnp.asarray(uvs[order]),
        tri_tangent=jnp.asarray(tangent[order].astype(np.float32)),
        bounds_min=jnp.asarray(flat.bounds_min),
        bounds_max=jnp.asarray(flat.bounds_max),
        skip=jnp.asarray(flat.skip),
        leaf_start=jnp.asarray(flat.leaf_start),
        leaf_count=jnp.asarray(flat.leaf_count),
        transform=jnp.asarray(sm.transform),
        inv_transform=jnp.asarray(sm.inv_transform),
        normal_mat=jnp.asarray(sm.inv_transform[:3, :3].T.copy()),
        mat_id=mat_id,
        tex_ids=tuple(tex_ids),
        leaf_size=leaf_size,
        has_uv=mesh.has_texcoords,
    )
